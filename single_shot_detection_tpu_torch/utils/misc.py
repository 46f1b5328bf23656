"""Small config-glue utilities.

Parity: reference ``bf/utils/misc_utils.py`` — ``filter_kwargs`` is the glue
that lets declarative configs over-specify constructor arguments.
"""

from __future__ import annotations

import functools
import inspect


def filter_kwargs(func):
    """Wrap ``func`` so unknown keyword args are silently dropped.

    Parity: misc_utils.py:22-26.  Functions taking ``**kwargs`` are passed
    everything unchanged.
    """

    @functools.wraps(func)
    def wrapped(*args, **kwargs):
        sig = inspect.signature(func)
        if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()):
            return func(*args, **kwargs)
        allowed = {k: v for k, v in kwargs.items() if k in sig.parameters}
        return func(*args, **allowed)

    return wrapped


def try_int(value):
    try:
        return int(value)
    except (TypeError, ValueError):
        return value


def try_eval(value):
    """Evaluate arithmetic-looking strings, pass everything else through.

    Parity: misc_utils.py:16-20 — enables config values like
    ``'{total_train_steps} * 2'`` after interpolation.
    """
    if not isinstance(value, str):
        return value
    try:
        return eval(value, {'__builtins__': {}}, {})
    except Exception:
        return value
