"""Declarative python-module config system.

Functional-parity targets: reference ``bf/training/helpers.py:29-42``
(config file IS a python module), ``bf/utils/config_wrapper.py`` (attribute
access with ``{}`` default, phase filtering) and
``bf/utils/object_formatter.py`` (recursive ``{field}`` interpolation against
env vars + config attrs + runtime-injected context, with post-interpolation
eval/int coercion enabling values like ``'{total_train_steps} * 2'``).
"""

from __future__ import annotations

import importlib.util
import logging
import os
import re
from typing import Any

from single_shot_detection_tpu_torch.utils.misc import try_eval, try_int

_FIELD_RE = re.compile(r'\{([A-Za-z_][A-Za-z0-9_]*)\}')


class Interpolator:
    """Recursive ``{field}`` string interpolation (parity:
    object_formatter.py:7-63).  Strings whose fields all resolve get
    formatted, then eval'd (arithmetic) and int-coerced; partially
    resolvable strings are left untouched until more context arrives."""

    def __init__(self, module):
        self.module = module
        self.context: dict = {}
        self.update(dict(os.environ))
        self.update({k: v for k, v in vars(module).items()
                     if not k.startswith('__')})

    def update(self, ctx: dict):
        self.context.update(ctx)
        self._apply()

    def _format_value(self, value: Any) -> Any:
        if isinstance(value, str):
            fields = _FIELD_RE.findall(value)
            if not fields:
                return value
            if all(f in self.context and self.context[f] is not None
                   for f in fields):
                out = value
                for f in set(fields):
                    out = out.replace('{%s}' % f, str(self.context[f]))
                return try_int(try_eval(out))
            return value
        if isinstance(value, dict):
            return {k: self._format_value(v) for k, v in value.items()}
        if isinstance(value, list):
            return [self._format_value(v) for v in value]
        if isinstance(value, tuple):
            return tuple(self._format_value(v) for v in value)
        return value

    def _apply(self):
        for name in dir(self.module):
            if name.startswith('__'):
                continue
            value = getattr(self.module, name)
            if isinstance(value, (str, dict, list, tuple)):
                setattr(self.module, name, self._format_value(value))


class ConfigWrapper:
    """Attribute access with ``{}`` default + phase filtering
    (parity: config_wrapper.py:4-22)."""

    def __init__(self, module):
        self.config = module
        self.interpolator = Interpolator(module)
        self.phases = ['train', 'eval']

    def update(self, ctx: dict):
        self.interpolator.update(ctx)

    def override(self, overrides: dict):
        """Set top-level config values.  A dict merges into a dict entry one
        level deep (``{'train': {'fused_bn': True}}`` keeps the rest of
        ``train``); interpolation then runs again."""
        merged = {}
        for key, value in overrides.items():
            old = getattr(self.config, key, None)
            if isinstance(value, dict) and isinstance(old, dict):
                value = {**old, **value}
            setattr(self.config, key, value)
            merged[key] = value
        self.interpolator.update(merged)

    def __getattr__(self, name):
        return getattr(self.config, name, {})

    def set_phases(self, phases):
        self.phases = phases
        for phase in ('train', 'eval'):
            if phase not in phases and phase in self.config.dataset:
                del self.config.dataset[phase]


def load_config(path: str, phases=('train', 'eval')) -> ConfigWrapper:
    """Exec a config file as a python module (parity: helpers.py:29-42)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f'config file does not exist: {path}')
    logging.info(f'>> Loading configuration from {path}')
    spec = importlib.util.spec_from_file_location('config', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    wrapper = ConfigWrapper(module)
    wrapper.set_phases(list(phases))
    return wrapper
