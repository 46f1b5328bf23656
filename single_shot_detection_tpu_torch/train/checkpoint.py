"""Checkpoint save and resume.

Port of ``single_shot_detection_tpu/train/checkpoint.py``: step-numbered
checkpoints in a timestamped directory, the latest one found by step,
``--new-checkpoint`` and ``--load-weights`` semantics, a ``.meta.json``
sidecar with the epoch and global step, and a config copy next to the
checkpoints.

The port's own files are ``ckpt-{step}.pt``, written by ``torch.save`` and
holding only tensors and plain values: ``{'step', 'model': the model's
state_dict, 'optimizer': the optimizer's state_dict (its buffers, the
accumulation's ``acc_grad`` among them, and NAdam's ``mu_product``),
'lr_scale'}``, for a ``train.pruner`` run ``'mask'``, its pruning mask
(the JAX package keeps it in the optimizer state), and for a
``train.ema`` run ``'ema'``, the shadow.  They load with
``torch.load(weights_only=True)``; no module is pickled.  The EMA shadow
is reconciled as the JAX package's ``_reconcile_ema`` does it: a file
without one seeds the shadow with a copy of its own parameters, and a
shadow the run does not keep is dropped with a log line.
:func:`restore` also reads the JAX package's ``ckpt-{step}.msgpack`` files
(``utils/flax_msgpack.py``, ``utils/weights.py::from_jax_state``), with no
flax or msgpack.  Every file is written under a temporary name and renamed,
so a crash mid-write never leaves a truncated checkpoint that
:func:`find_latest` would pick.

:class:`AsyncSaver` (``train.async_checkpoint``) writes the same file off
the train loop: a copy of the state on its device, ordered on the stream
before the next step's in-place updates, then the copy to the host and the
write on a background thread.

A run of several processes saves from process 0 only; under ZeRO-1 the
sliced optimizer buffers and EMA shadow are first made whole by
:func:`gather_for_save`, a collective every rank enters, as the JAX
engine's ``gather_for_save`` runs before its rank gate.  A restore slices
them again (``Optimizer.shard_state``), so a ZeRO checkpoint restores into
a plain run and the other way round.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import re
import shutil
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from single_shot_detection_tpu_torch.parallel import tensor
from single_shot_detection_tpu_torch.train import optimizers
from single_shot_detection_tpu_torch.train.state import TrainState, gather_shadow
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


def saved_dict(state: TrainState) -> dict:
    """What a ``.pt`` file holds for ``state``: the live tensors, not
    copies (under ZeRO-1 take :func:`gather_for_save`'s instead)."""
    saved = {'step': int(state.step),
             'model': state.model.state_dict(),
             'optimizer': state.optimizer.state_dict(),
             'lr_scale': float(state.lr_scale)}
    if state.mask is not None:
        saved['mask'] = state.mask
    if state.ema_params:
        saved['ema'] = state.ema_params
    return saved


def gather_for_save(state: TrainState) -> dict:
    """:func:`saved_dict` with ZeRO-1's slices made whole (the optimizer's
    buffers gathered and the EMA shadow refreshed from every rank's slice)
    and tensor sharding's too (``parallel/tensor.py::gather_saved_``: the
    whole state, in today's format).  Under either a collective every rank
    must enter; otherwise the plain :func:`saved_dict`."""
    if state.zero is None and state.tensor is None:
        return saved_dict(state)
    gather_shadow(state)
    saved = saved_dict(state)
    if state.zero is not None:
        saved['optimizer'] = state.optimizer.full_state_dict()
    if state.tensor is not None:
        if state.zero is None:
            saved['optimizer'] = state.optimizer.state_dict()
        saved = tensor.gather_saved_(saved, state, state.tensor)
    return saved


def write(checkpoint_dir: str, saved: dict, epoch: int) -> str:
    """Write ``saved`` (:func:`saved_dict`) as ``ckpt-{step}.pt`` and its
    ``.meta.json``, each under a temporary name renamed into place (removed
    if the write fails); returns the path."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    step = saved['step']
    path = os.path.join(checkpoint_dir, f'ckpt-{step}.pt')
    tmp, meta_tmp = path + '.tmp', path + '.meta.json.tmp'
    try:
        torch.save(saved, tmp)
        with open(meta_tmp, 'w') as f:
            json.dump({'epoch': epoch, 'global_step': step}, f)
        os.replace(tmp, path)
        os.replace(meta_tmp, path + '.meta.json')
    finally:
        for name in (tmp, meta_tmp):
            if os.path.exists(name):
                os.unlink(name)
    logging.info(f'>> Saved checkpoint {path}')
    return path


def save(checkpoint_dir: str, state: TrainState, epoch: int) -> str:
    """Write ``ckpt-{step}.pt`` and its ``.meta.json``; returns the path."""
    return write(checkpoint_dir, saved_dict(state), epoch)


def _map_tensors(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, _map_tensors(v, fn)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


class AsyncSaver:
    """Checkpoint writer off the train loop (``train.async_checkpoint``;
    port of the JAX package's ``AsyncSaver``).

    ``save`` copies every tensor of the state on its device (cheap, and
    enqueued on the current stream ahead of the next step's in-place
    updates, so the copy holds the state at the save) and hands the copy to
    the host and the write to a background thread, while the loop goes on.
    One save is in flight at a time (a second ``save`` first waits for the
    previous one); ``wait()`` joins it and re-raises its failure.  Call
    ``wait()`` before an emergency synchronous save and before exiting.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.path: Optional[str] = None  # the last file written

    def save(self, checkpoint_dir: str, state: TrainState, epoch: int) -> None:
        self.wait()
        snapshot = _map_tensors(saved_dict(state),
                                lambda t: t.detach().clone())
        devices = {t.device for t in _tensors(snapshot) if t.is_cuda}
        events = []
        for device in devices:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            events.append((device, event))

        def run():
            try:
                host = snapshot
                if events:
                    # the copy to the host runs on a stream of its own after
                    # the snapshot, not behind the steps queued since
                    for device, event in events:
                        stream = torch.cuda.Stream(device)
                        stream.wait_event(event)
                        with torch.cuda.stream(stream):
                            host = _map_tensors(
                                host, lambda t: t.to('cpu') if t.device == device
                                else t)
                self.path = write(checkpoint_dir, host, epoch)
            except BaseException as exc:  # noqa: BLE001 — raised by wait()
                self._error = exc

        self._thread = threading.Thread(target=run, daemon=True,
                                        name='ckpt-async-save')
        self._thread.start()

    def wait(self) -> None:
        """Join the save in flight, if any; re-raise its failure."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error


def _tensors(tree):
    out = []
    _map_tensors(tree, out.append)
    return out


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
        model_state = weights.reconcile_qat(
            migrate_state_dict(model_state, template, rules), template)
    state.model.load_state_dict(model_state, strict=True)


def _disagree(file_has, run_keeps) -> ValueError:
    noun = ('momentum' if 'momentum_buffer' in set(file_has) ^ set(run_keeps)
            else 'the optimizer buffers')
    return ValueError(
        f'the checkpoint and this optimizer disagree on {noun}: the '
        f'checkpoint has {sorted(file_has) or "no buffers"}, the optimizer '
        f'keeps {sorted(run_keeps) or "none"}')


def _install_jax_optimizer(state: TrainState, parsed: dict, step: int) -> None:
    """A JAX optimizer state (``utils/weights.py::parse_opt_state``) into
    ``state.optimizer``: each group's buffers by its ``label``, created on
    each parameter's device in f32, NAdam's ``mu_product``, and the
    accumulation's running mean.  The counts must be the ones the port
    derives from the step (``step // k`` updates, ``step % k`` into the
    window)."""
    optimizer = state.optimizer
    optimizer.state.clear()
    names = {p: n for n, p in state.model.named_parameters()}
    k = optimizer.accumulation_steps
    accumulation = parsed['accumulation']
    if (accumulation is not None) != (k > 1):
        raise ValueError(
            'the checkpoint and this optimizer disagree on gradient '
            f'accumulation: the checkpoint {"has" if accumulation else "has no"} '
            f'MultiSteps state, the run has accumulation_steps={k}')
    updates = step // k
    counts = [c for g in parsed['groups'].values() for c in g['counts']]
    if accumulation is not None:
        counts.append(accumulation['gradient_step'])
        if accumulation['mini_step'] != step % k:
            raise ValueError(f'the checkpoint is {accumulation["mini_step"]} '
                             f'micro-steps into its window at step {step}, not '
                             f'{step % k}')
    if any(c != updates for c in counts):
        raise ValueError(f'the checkpoint counts {sorted(set(counts))} updates '
                         f'at step {step}; the port derives {updates} from the '
                         'step')
    for group in optimizer.param_groups:
        label = group['label']
        stored = parsed['groups'].get(label, {'buffers': {}, 'mu_product': None})
        buffers = {n: b for n, b in stored['buffers'].items() if b}
        keeps = [n for n in optimizer.buffer_names(group) if n != 'acc_grad']
        if set(buffers) != set(keeps):
            raise _disagree(buffers, keeps)
        if stored['mu_product'] is not None and 'mu_product' in group:
            group['mu_product'] = stored['mu_product']
        sources = dict(buffers)
        if accumulation is not None:
            sources['acc_grad'] = accumulation['acc_grads']
        for buffer, tree in sources.items():
            for p in group['params']:
                name = names[p]
                if name not in tree:
                    raise KeyError(f'{buffer} of {name} missing from the '
                                   f'checkpoint\'s group {label!r}')
                if tree[name].shape != p.shape:
                    raise ValueError(f'{name}: {buffer} shape '
                                     f'{tuple(tree[name].shape)} != parameter '
                                     f'shape {tuple(p.shape)}')
                optimizer.state[p][buffer] = tree[name].to(
                    device=p.device, dtype=torch.float32).clone()


def _load_optimizer(state: TrainState, saved: dict, step: int) -> None:
    """The optimizer's state from a ``.pt``, its configuration (rates,
    hyperparameters, groups) from the config, as the JAX package rebuilds
    its optax chain from the config on a resume and restores only the
    chain's state.  Buffers that cannot apply (a config without momentum,
    or one with momentum after a step saved without buffers; another
    optimizer) raise, as the ``.msgpack`` path does."""
    optimizer = state.optimizer
    config = [{k: v for k, v in g.items()
               if k != 'params' and k not in optimizers.GROUP_STATE_KEYS}
              for g in optimizer.param_groups]
    has = set().union(*[s.keys() for s in saved['state'].values()])
    keeps = set().union(*[optimizer.buffer_names(g)
                          for g in optimizer.param_groups])
    # the buffers exist from the first step on
    if has != keeps and (has or step > 0):
        raise _disagree(has, keeps)
    optimizer.load_state_dict(saved)
    for group, hyper in zip(optimizer.param_groups, config):
        group.update(hyper)


def _install_ema(state: TrainState, ema: Optional[Dict[str, torch.Tensor]],
                 rules=None) -> None:
    """The file's EMA shadow into ``state.ema_params`` (in place: the
    tensors are the evaluation model's parameters), as the JAX package's
    ``_reconcile_ema``: a parameter the file has no shadow of takes a copy
    of the (just loaded) parameter; shadow leaves this run does not keep
    (a run without ``train.ema``) are dropped with a log line."""
    ema = dict(ema or {})
    if ema and state.ema_params:
        ema = migrate_state_dict(ema, state.ema_params, rules)
    dropped = [k for k in ema if k not in state.ema_params]
    if dropped:
        logging.info(f'>> checkpoint carries EMA but this run disables it: '
                     f'dropped {len(dropped)} ema_params leaves')
    if not state.ema_params:
        return
    params = dict(state.model.named_parameters())
    seeded = 0
    with torch.no_grad():
        for name, shadow in state.ema_params.items():
            if name in ema:
                shadow.copy_(ema[name])
            else:
                shadow.copy_(params[name])
                seeded += 1
    if seeded:
        logging.info(f'>> checkpoint predates EMA: seeded {seeded} '
                     'ema_params leaves from its params')


def _install_mask(state: TrainState, mask) -> None:
    """A checkpoint's pruning mask into a run with ``train.pruner`` (on each
    parameter's device); a run without it drops the mask with a log line
    (its pruned channels are free to regrow), and a pruned run restored
    from an unpruned checkpoint starts with an all-ones mask."""
    if state.mask is None:
        if mask:
            logging.warning(f'WW the checkpoint carries a pruning mask of '
                            f'{len(mask)} tensors but this run has no '
                            'train.pruner: dropped')
        return
    params = dict(state.model.named_parameters())
    state.mask = {name: m.to(params[name].device) for name, m in
                  (mask or {}).items()}


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
    that predate a rename go through :func:`migrate_state_dict`; QAT's
    ``act_amax`` entries are reconciled both ways
    (``utils/weights.py::reconcile_qat``); a pruning mask goes to
    ``state.mask`` (:func:`_install_mask`), the EMA shadow to
    ``state.ema_params`` (:func:`_install_ema`)."""
    if path.endswith('.msgpack'):
        restored = weights.from_jax_state(flax_msgpack.read(path))
        _load_model(state, restored['model'], rules)
        _install_jax_optimizer(state, restored['optimizer'],
                               int(restored['step']))
    else:
        restored = torch.load(path, map_location='cpu', weights_only=True)
        _load_model(state, restored['model'], rules)
        _load_optimizer(state, restored['optimizer'], int(restored['step']))
    state.optimizer.shard_state()  # ZeRO-1: this rank's slices
    _install_mask(state, restored.get('mask'))
    _install_ema(state, restored.get('ema'), rules)
    state.step = int(restored['step'])
    state.lr_scale = float(restored['lr_scale'])
    meta = _read_meta(path, state.step)
    logging.info(f'>> Restored checkpoint {path} (epoch {meta["epoch"]}, '
                 f'step {meta["global_step"]})')
    return state, meta


def read_weights(path: str) -> dict:
    """A ``.pt`` or ``.msgpack`` file's weights without a model: ``{'model':
    state_dict, 'ema': {parameter name: shadow} or None, 'meta': {'epoch',
    'global_step'}}`` (the sidecar's, else epoch 0 at the file's step)."""
    if path.endswith('.msgpack'):
        raw = flax_msgpack.read(path)
        ema = raw.get('ema_params') or None
        if ema:
            ema = weights.from_jax_variables({'params': ema})
        return {'model': weights.from_jax_variables(raw), 'ema': ema,
                'meta': _read_meta(path, int(np.asarray(raw.get('step', 0))))}
    saved = torch.load(path, map_location='cpu', weights_only=True)
    return {'model': saved['model'], 'ema': saved.get('ema'),
            'meta': _read_meta(path, int(saved['step']))}


def restore_weights_only(path: str, state: TrainState) -> TrainState:
    """``--load-weights``: the model's parameters and BN statistics from a
    ``.pt`` or ``.msgpack`` file, and the EMA shadow with them (reconciled
    as :func:`restore` does); the optimizer, step and ``lr_scale`` stay as
    they are."""
    saved = read_weights(path)
    _load_model(state, saved['model'])
    _install_ema(state, saved['ema'])
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
