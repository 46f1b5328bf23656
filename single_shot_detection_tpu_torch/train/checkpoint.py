"""Checkpoint save and resume.

Port of ``single_shot_detection_tpu/train/checkpoint.py``: step-numbered
checkpoints in a timestamped directory, the latest one found by step,
``--new-checkpoint`` and ``--load-weights`` semantics, a ``.meta.json``
sidecar with the epoch and global step, and a config copy next to the
checkpoints.

The port's own files are ``ckpt-{step}.pt``, written by ``torch.save`` and
holding only tensors and plain values: ``{'step', 'model': the model's
state_dict, 'optimizer': the optimizer's state_dict, 'lr_scale'}``.  They
load with ``torch.load(weights_only=True)``; no module is pickled.
:func:`restore` also reads the JAX package's ``ckpt-{step}.msgpack`` files
(``utils/flax_msgpack.py``, ``utils/weights.py::from_jax_state``), with no
flax or msgpack.  Every file is written under a temporary name and renamed,
so a crash mid-write never leaves a truncated checkpoint that
:func:`find_latest` would pick.

Not ported: the JAX package's ``AsyncSaver`` (``train.async_checkpoint``
raises ``NotImplementedError``) and its multi-host gather.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import re
import shutil
from typing import Dict, Optional, Tuple

import torch

from single_shot_detection_tpu_torch.train.state import TrainState
from single_shot_detection_tpu_torch.utils import flax_msgpack, weights

_CKPT_RE = re.compile(r'^ckpt-([0-9]+)\.(pt|msgpack)$')
# at an equal step a ``.pt`` (the port's own, with its optimizer state as
# written) is preferred to a ``.msgpack`` (the JAX package's)
_PREFERENCE = {'pt': 1, 'msgpack': 0}


def find_latest(checkpoint_path: str) -> Optional[str]:
    """A file as it is, or the highest-step ``ckpt-N.pt`` or
    ``ckpt-N.msgpack`` in a directory (``.pt`` on a tie); None if there is
    none."""
    if os.path.isfile(checkpoint_path):
        return checkpoint_path
    if os.path.isdir(checkpoint_path):
        best = None
        for name in os.listdir(checkpoint_path):
            m = _CKPT_RE.match(name)
            if m:
                key = (int(m[1]), _PREFERENCE[m[2]])
                if best is None or key > best[1]:
                    best = (name, key)
        if best:
            return os.path.join(checkpoint_path, best[0])
    return None


def save(checkpoint_dir: str, state: TrainState, epoch: int) -> str:
    """Write ``ckpt-{step}.pt`` and its ``.meta.json``; returns the path."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, f'ckpt-{state.step}.pt')
    tmp = path + '.tmp'
    torch.save({'step': int(state.step),
                'model': state.model.state_dict(),
                'optimizer': state.optimizer.state_dict(),
                'lr_scale': float(state.lr_scale)}, tmp)
    with open(path + '.meta.json.tmp', 'w') as f:
        json.dump({'epoch': epoch, 'global_step': int(state.step)}, f)
    os.replace(tmp, path)
    os.replace(path + '.meta.json.tmp', path + '.meta.json')
    logging.info(f'>> Saved checkpoint {path}')
    return path


# ---------------------------------------------------------------- migration
# Name-migration rules: ``(regex, replacement)`` pairs applied with
# ``re.sub`` to each name of an incoming model state_dict that the model no
# longer has; the first matching rule wins.  Empty: no parameter has been
# renamed yet.  Append an entry when a refactor renames one, e.g.
#   (r'^features\.base_v1\.', 'features.base.'),
MIGRATION_RULES: list = []


def migrate_state_dict(raw: Dict[str, torch.Tensor],
                       template: Dict[str, torch.Tensor],
                       rules=None) -> Dict[str, torch.Tensor]:
    """Rewrite the stale names of the state_dict ``raw`` to match
    ``template``'s.

    ``rules`` (default: ``MIGRATION_RULES``) apply only to names absent
    from the template; two names landing on one raise ``ValueError``.  Logs
    every rewrite."""
    rules = MIGRATION_RULES if rules is None else rules
    out = {}
    for name, value in raw.items():
        dest = name
        if name not in template:
            for pattern, repl in rules:
                migrated, n = re.subn(pattern, repl, name)
                if n:
                    dest = migrated
                    break
        if dest in out:
            raise ValueError(f'checkpoint migration collision: {name} -> '
                             f'{dest} (destination already produced by '
                             'another name)')
        if dest != name:
            logging.info(f'>> checkpoint migration: {name} -> {dest}')
        out[dest] = value
    return out


def _load_model(state: TrainState, model_state: Dict[str, torch.Tensor],
                rules=None) -> None:
    template = state.model.state_dict()
    if model_state.keys() != template.keys():
        model_state = migrate_state_dict(model_state, template, rules)
    state.model.load_state_dict(model_state, strict=True)


def _install_momentum(state: TrainState,
                      momentum: Optional[Dict[str, torch.Tensor]]) -> None:
    """The JAX trace as each parameter's ``momentum_buffer``, created on
    the parameter's device in f32 (a fresh SGD has no buffers until its
    first step)."""
    uses_momentum = any(g.get('momentum', 0) for g in state.optimizer.param_groups)
    if (momentum is not None) != bool(uses_momentum):
        raise ValueError(
            'the checkpoint and this optimizer disagree on momentum: the '
            f'checkpoint {"has" if momentum is not None else "has no"} '
            f'trace, the optimizer {"uses" if uses_momentum else "does not use"} '
            'momentum')
    if momentum is None:
        return
    params = dict(state.model.named_parameters())
    if momentum.keys() != params.keys():
        missing = sorted(params.keys() - momentum.keys())
        extra = sorted(momentum.keys() - params.keys())
        raise KeyError(f'momentum trace does not match the parameters: '
                       f'missing {missing[:5]}, unexpected {extra[:5]}')
    for name, p in params.items():
        buf = momentum[name]
        if buf.shape != p.shape:
            raise ValueError(f'{name}: trace shape {tuple(buf.shape)} != '
                             f'parameter shape {tuple(p.shape)}')
        state.optimizer.state[p]['momentum_buffer'] = buf.to(
            device=p.device, dtype=torch.float32).clone()


def _read_meta(path: str, step: int) -> dict:
    meta = {'epoch': 0, 'global_step': step}
    if os.path.exists(path + '.meta.json'):
        with open(path + '.meta.json') as f:
            meta.update(json.load(f))
    return meta


def restore(path: str, state: TrainState, rules=None) -> Tuple[TrainState, dict]:
    """Restore ``state`` in place from a ``.pt`` or a JAX ``.msgpack``
    file; returns ``(state, meta)``, ``meta`` being ``{'epoch',
    'global_step'}`` from the sidecar (epoch 0 without one).  Model names
    that predate a rename go through :func:`migrate_state_dict`."""
    if path.endswith('.msgpack'):
        restored = weights.from_jax_state(flax_msgpack.read(path))
        _load_model(state, restored['model'], rules)
        state.optimizer.state.clear()
        _install_momentum(state, restored['momentum'])
    else:
        restored = torch.load(path, map_location='cpu', weights_only=True)
        _load_model(state, restored['model'], rules)
        state.optimizer.load_state_dict(restored['optimizer'])
    state.step = int(restored['step'])
    state.lr_scale = float(restored['lr_scale'])
    meta = _read_meta(path, state.step)
    logging.info(f'>> Restored checkpoint {path} (epoch {meta["epoch"]}, '
                 f'step {meta["global_step"]})')
    return state, meta


def restore_weights_only(path: str, state: TrainState) -> TrainState:
    """``--load-weights``: the model's parameters and BN statistics from a
    ``.pt`` or ``.msgpack`` file; the optimizer, step and ``lr_scale`` stay
    as they are."""
    if path.endswith('.msgpack'):
        model_state = weights.from_jax_variables(flax_msgpack.read(path))
    else:
        model_state = torch.load(path, map_location='cpu',
                                 weights_only=True)['model']
    _load_model(state, model_state)
    logging.info(f'>> Restored weights from {path}')
    return state


def prepare_checkpoint_dir(save_dir: str, checkpoint: Optional[str],
                           config_path: Optional[str], debug: bool,
                           train: bool, new_checkpoint: bool = False) -> str:
    """Pick or create the checkpoint directory and copy the config into it:
    an existing ``checkpoint`` directory is reused unless
    ``new_checkpoint``, else a timestamped one under ``save_dir``; nothing
    is written with ``debug`` or without ``train``."""
    if checkpoint and os.path.isdir(checkpoint) and not new_checkpoint:
        checkpoint_dir = checkpoint
    else:
        stamp = f'{datetime.datetime.today():%F-%H%M%S}'
        checkpoint_dir = os.path.join(save_dir, stamp)

    if not debug and train:
        os.makedirs(checkpoint_dir, exist_ok=True)
        logging.info(f'>> Checkpoints will be saved to {checkpoint_dir}')
        if config_path and os.path.exists(config_path):
            dest = os.path.join(checkpoint_dir, 'config.py')
            if not os.path.exists(dest) or not os.path.samefile(config_path, dest):
                shutil.copy(config_path, dest)
    return checkpoint_dir
