"""Weights from the JAX package into the port.

The port's modules carry the flax submodule names
(``features.base.stage3.expand_conv``, ``extra0.expand.depthwise_bn``,
``score_head2``, ...), so a JAX variable tree maps onto the port's
``state_dict`` by a plain walk; the result loads with ``strict=True``.
"""

from __future__ import annotations

from typing import Dict, Mapping

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


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX ``{'params', 'batch_stats'}`` tree of arrays -> ``state_dict``.

    Conv kernels go HWIO -> OIHW; BatchNorm ``scale``/``bias``/``mean``/
    ``var`` become ``weight``/``bias``/``running_mean``/``running_var``, and
    each BatchNorm gets ``num_batches_tracked = 0``.  Other collections
    (``opt_state``, ``step``, ...) are ignored.
    """
    state = {}
    for path, value in _walk(variables.get('params', {})):
        *module, leaf = path
        if leaf not in _PARAM_LEAVES:
            raise KeyError(f'unexpected parameter {"/".join(path)}')
        arr = _to_torch_layout(path, np.asarray(value, dtype=np.float32))
        state['.'.join(module + [_PARAM_LEAVES[leaf]])] = torch.from_numpy(
            np.array(arr, order='C'))  # a writable copy
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
