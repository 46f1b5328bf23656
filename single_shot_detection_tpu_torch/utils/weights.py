"""Weights from the JAX package into the port.

The port's modules carry the flax submodule names
(``features.base.stage3.expand_conv``, ``extra0.expand.depthwise_bn``,
``score_head2``, ...), so a JAX variable tree maps onto the port's
``state_dict`` by a plain walk; the result loads with ``strict=True``.
:func:`from_jax_state` does the same for a whole restored JAX ``TrainState``
(``single_shot_detection_tpu/train/state.py``), with its step, ``lr_scale``
and SGD momentum.
"""

from __future__ import annotations

import logging
from typing import Dict, Mapping, Optional

import numpy as np
import torch

# flax leaf -> torch name, per collection
_PARAM_LEAVES = {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias'}
_STAT_LEAVES = {'mean': 'running_mean', 'var': 'running_var'}


def _walk(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _walk(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _to_torch_layout(path, value: np.ndarray) -> np.ndarray:
    if path[-1] != 'kernel':
        return value
    if value.ndim != 4:
        raise ValueError(f'{"/".join(path)}: expected a conv kernel [kh, kw, '
                         f'in, out], got shape {value.shape}')
    # HWIO -> OIHW; a depthwise [kh, kw, 1, C] becomes [C, 1, kh, kw]
    return value.transpose(3, 2, 0, 1)


def _params_to_torch(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``params``-shaped tree -> ``{torch parameter name: tensor}``."""
    out = {}
    for path, value in _walk(tree):
        *module, leaf = path
        if leaf not in _PARAM_LEAVES:
            raise KeyError(f'unexpected parameter {"/".join(path)}')
        arr = _to_torch_layout(path, np.asarray(value, dtype=np.float32))
        out['.'.join(module + [_PARAM_LEAVES[leaf]])] = torch.from_numpy(
            np.array(arr, order='C'))  # a writable copy
    return out


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX ``{'params', 'batch_stats'}`` tree of arrays -> ``state_dict``.

    Conv kernels go HWIO -> OIHW; BatchNorm ``scale``/``bias``/``mean``/
    ``var`` become ``weight``/``bias``/``running_mean``/``running_var``, and
    each BatchNorm gets ``num_batches_tracked = 0``.  Other collections
    (``opt_state``, ``step``, ...) are ignored.
    """
    state = _params_to_torch(variables.get('params', {}))
    for path, value in _walk(variables.get('batch_stats', {})):
        *module, leaf = path
        if leaf not in _STAT_LEAVES:
            raise KeyError(f'unexpected batch statistic {"/".join(path)}')
        state['.'.join(module + [_STAT_LEAVES[leaf]])] = torch.from_numpy(
            np.array(value, dtype=np.float32))
        if leaf == 'mean':
            state['.'.join(module + ['num_batches_tracked'])] = torch.tensor(
                0, dtype=torch.long)
    return state


def _sgd_trace(opt_state) -> Optional[Mapping]:
    """The momentum tree of an optax SGD chain state, or None without
    momentum.  The chain is found by structure: its members are
    ``add_decayed_weights`` (``{}``), ``trace`` (``{'trace': tree}``) and
    ``scale_by_learning_rate`` (``{'count': n}``), in a tuple stored as
    ``{'0': ..., '1': ...}``; with weight decay the flagship's is
    ``{'0': {}, '1': {'trace'}, '2': {'count'}}``, without it
    ``{'0': {'trace'}, '1': {'count'}}``.  Any other state (another
    optimizer, ``lr_groups``, accumulation, clipping) raises
    ``NotImplementedError``."""
    traces = []

    def visit(node, path):
        if not isinstance(node, Mapping):
            raise NotImplementedError(
                f'optimizer state leaf at {"/".join(path) or "opt_state"}: '
                'only the SGD chain is ported yet')
        keys = set(node)
        if keys == {'trace'}:
            traces.append(node['trace'])
        elif keys and keys != {'count'}:
            if not all(str(k).isdigit() for k in keys):
                raise NotImplementedError(
                    f'optimizer state {sorted(keys)} at '
                    f'{"/".join(path) or "opt_state"}: only the SGD chain '
                    '(add_decayed_weights, trace, scale_by_learning_rate) is '
                    'ported yet')
            for k in sorted(keys, key=int):
                visit(node[k], path + (str(k),))

    visit(opt_state, ())
    if len(traces) > 1:
        raise NotImplementedError(f'{len(traces)} momentum traces in one '
                                  'optimizer state')
    return traces[0] if traces else None


def from_jax_state(raw: Mapping) -> dict:
    """A restored JAX ``TrainState`` dict (``ckpt-N.msgpack`` through
    ``utils/flax_msgpack.py``) -> the port's state:

    ``{'step': int, 'lr_scale': float, 'model': state_dict, 'momentum':
    {parameter name: momentum buffer} or None}``.

    The model is :func:`from_jax_variables`'.  optax's ``trace`` (``t = g +
    m * t``, zero at init) is ``torch.optim.SGD``'s ``momentum_buffer`` with
    ``dampening=0``; its kernels go HWIO -> OIHW as the weights do.  An EMA
    shadow (``ema_params``) is dropped with a log line: the port does not
    run the EMA yet.
    """
    ema = list(_walk(raw.get('ema_params') or {}))
    if ema:
        logging.info(f'>> checkpoint carries EMA but the port does not run '
                     f'it: dropped {len(ema)} ema_params leaves')
    trace = _sgd_trace(raw.get('opt_state', {}))
    return {'step': int(np.asarray(raw['step'])),
            'lr_scale': float(np.asarray(raw.get('lr_scale', 1.0))),
            'model': from_jax_variables(raw),
            'momentum': None if trace is None else _params_to_torch(trace)}
