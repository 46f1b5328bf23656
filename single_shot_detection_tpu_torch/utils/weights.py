"""Weights from the JAX package into the port.

The port's modules carry the flax submodule names
(``features.base.stage3.expand_conv``, ``extra0.expand.depthwise_bn``,
``score_head2``, ...), so a JAX variable tree maps onto the port's
``state_dict`` by a plain walk; the result loads with ``strict=True``.
:func:`from_jax_state` does the same for a whole restored JAX ``TrainState``
(``single_shot_detection_tpu/train/state.py``), with its step, ``lr_scale``,
optimizer state and EMA shadow.
"""

from __future__ import annotations

import logging
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# flax leaf -> torch name, per collection
_PARAM_LEAVES = {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias'}
# ``act_amax``: a conv's QAT activation scale (``export/quantize.py``)
_STAT_LEAVES = {'mean': 'running_mean', 'var': 'running_var',
                'act_amax': 'act_amax'}


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
    each BatchNorm gets ``num_batches_tracked = 0``; a QAT conv's
    ``act_amax`` keeps its name.  Other collections (``opt_state``,
    ``step``, ...) are ignored.
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


def variable_path(name: str, ndim: int) -> Optional[Tuple[str, ...]]:
    """The JAX variable path of a ``state_dict`` entry, with its collection
    (``('params', ..., 'kernel' | 'scale' | 'bias')``, ``('batch_stats',
    ..., 'mean' | 'var' | 'act_amax')``); None for ``num_batches_tracked``,
    which flax does not keep."""
    *module, leaf = name.split('.')
    stats = {v: k for k, v in _STAT_LEAVES.items()}
    if leaf in stats:
        return ('batch_stats', *module, stats[leaf])
    if leaf == 'num_batches_tracked':
        return None
    if leaf == 'weight':
        leaf = 'kernel' if ndim == 4 else 'scale'
    return ('params', *module, leaf)


def state_name(path: Tuple[str, ...]) -> str:
    """The ``state_dict`` name of a JAX variable path (with its
    collection): the inverse of :func:`variable_path`."""
    leaves = _PARAM_LEAVES if path[0] == 'params' else _STAT_LEAVES
    return '.'.join((*path[1:-1], leaves[path[-1]]))


def to_jax_variables(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of :func:`from_jax_variables`: a ``state_dict`` as a JAX
    ``{'params', 'batch_stats'}`` tree of numpy arrays (OIHW -> HWIO,
    ``num_batches_tracked`` dropped, ``act_amax`` in ``batch_stats``)."""
    variables = {'params': {}, 'batch_stats': {}}
    for name, value in state_dict.items():
        path = variable_path(name, value.ndim)
        if path is None:
            continue
        arr = value.detach().cpu().numpy()
        node = variables[path[0]]
        for part in path[1:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = arr.transpose(2, 3, 1, 0) if path[-1] == 'kernel' else arr
    return variables


def reconcile_qat(incoming: Dict[str, torch.Tensor],
                  template: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """QAT's ``act_amax`` entries are auxiliary (port of the JAX package's
    ``checkpoint.py::_reconcile_qat``): a float state loaded into a QAT
    model takes the model's zeros (uncalibrated, so the conv's input is not
    quantized until the first train batch seeds it); a QAT state loaded
    into a float model drops them.  Any other mismatch is left for the
    strict load to report."""
    out = {k: v for k, v in incoming.items()
           if not k.endswith('.act_amax') or k in template}
    dropped = len(incoming) - len(out)
    filled = 0
    for k, v in template.items():
        if k not in out and k.endswith('.act_amax'):
            out[k] = v.detach().clone()
            filled += 1
    if dropped:
        logging.info(f'>> checkpoint carries QAT act_amax but this run '
                     f'disables QAT: dropped {dropped} leaves')
    if filled:
        logging.info(f'>> checkpoint predates QAT: {filled} act_amax '
                     'stats start uncalibrated')
    return out


# optax state leaves holding a tree of per-parameter buffers -> the port's
# buffer names (``train/optimizers.py``): ``trace`` is torch's
# ``momentum_buffer``; the hand-written optimizers' dicts keep their names
_OPT_BUFFERS = {'trace': 'momentum_buffer', 'mu': 'mu', 'nu': 'nu',
                'acc': 'acc', 'square_avg': 'square_avg',
                'acc_delta': 'acc_delta', 'm': 'm', 'u': 'u', 'v': 'v'}
_OPT_SCALARS = ('count', 'mu_product')
_MULTI_STEPS = {'mini_step', 'gradient_step', 'inner_opt_state', 'acc_grads'}
DEFAULT_LABEL = '__default__'


def parse_opt_state(opt_state) -> dict:
    """A JAX optimizer state (``train/optimizers.py::create_optimizer``'s,
    as ``utils/flax_msgpack.py`` reads it) by structure:

    ``{'groups': {label: {'buffers': {buffer name: {parameter name:
    tensor}}, 'counts': [update counts], 'mu_product': float or None}},
    'accumulation': None or {'mini_step', 'gradient_step', 'acc_grads':
    {parameter name: tensor}}}``.

    The members recognized: a chain (a tuple stored as ``{'0': ..., '1':
    ...}``); the empty states of ``add_decayed_weights``, a constant rate,
    the decoupled decay and ``clip_by_global_norm`` (``{}``);
    ``scale_by_learning_rate``'s ``{'count'}``; ``trace``,
    ``scale_by_adam``, ``scale_by_rms`` and the five hand-written dicts;
    ``multi_transform``'s ``{'inner_states': {label: {'inner_state'}}}``
    for ``lr_groups`` (the default group's label ``__default__``, a
    parameter outside a label an empty leaf); ``MultiSteps``; and the
    pruning wrapper's ``{'inner', 'mask'}``, whose inner state is parsed.
    Anything else raises ``ValueError``."""
    out = {'groups': {}, 'accumulation': None}

    def group(label):
        return out['groups'].setdefault(
            label, {'buffers': {}, 'counts': [], 'mu_product': None})

    def visit(node, path, label):
        where = '/'.join(path) or 'opt_state'
        if not isinstance(node, Mapping):
            raise ValueError(f'unexpected optimizer state leaf at {where}')
        keys = set(node)
        if not keys:
            return
        if keys == {'inner', 'mask'}:
            visit(node['inner'], path + ('inner',), label)
        elif _MULTI_STEPS <= keys:
            out['accumulation'] = {
                'mini_step': int(np.asarray(node['mini_step'])),
                'gradient_step': int(np.asarray(node['gradient_step'])),
                'acc_grads': _params_to_torch(node['acc_grads'])}
            visit(node['inner_opt_state'], path + ('inner_opt_state',), label)
        elif keys == {'inner_states'}:
            for name, inner in node['inner_states'].items():
                inner = inner.get('inner_state', inner)
                visit(inner, path + ('inner_states', name), name)
        elif all(str(k).isdigit() for k in keys):
            for k in sorted(keys, key=int):
                visit(node[k], path + (str(k),), label)
        elif keys <= set(_OPT_BUFFERS) | set(_OPT_SCALARS):
            g = group(label)
            for key in keys & set(_OPT_BUFFERS):
                name = _OPT_BUFFERS[key]
                if name in g['buffers']:
                    raise ValueError(f'two {key!r} states in one optimizer '
                                     f'group ({where})')
                g['buffers'][name] = _params_to_torch(node[key])
            if 'count' in keys:
                g['counts'].append(int(np.asarray(node['count'])))
            if 'mu_product' in keys:
                g['mu_product'] = float(np.asarray(node['mu_product']))
        else:
            raise ValueError(f'optimizer state {sorted(keys)} at {where}: '
                             'not a state of the JAX package\'s optimizers')

    visit(opt_state, (), DEFAULT_LABEL)
    return out


def _pruning_mask(opt_state) -> Optional[Dict[str, torch.Tensor]]:
    """The pruning wrapper's mask (``opt_state = {'inner', 'mask'}``) as
    ``{parameter name: mask}``, or None without the wrapper.  An untouched
    leaf is a scalar 1 and is left out; a conv kernel's ``[1, 1, 1, C]``
    becomes ``[C, 1, 1, 1]``, a vector stays ``[C]``."""
    if not (isinstance(opt_state, Mapping) and set(opt_state) == {'inner', 'mask'}):
        return None
    out = {}
    for path, value in _walk(opt_state['mask']):
        value = np.asarray(value, dtype=np.float32)
        if value.ndim == 0:
            continue
        *module, leaf = path
        if leaf not in _PARAM_LEAVES:
            raise KeyError(f'unexpected mask leaf {"/".join(path)}')
        if leaf == 'kernel':
            value = value.reshape(-1, 1, 1, 1)
        out['.'.join(module + [_PARAM_LEAVES[leaf]])] = torch.from_numpy(
            np.array(value, order='C'))
    return out


def from_jax_state(raw: Mapping) -> dict:
    """A restored JAX ``TrainState`` dict (``ckpt-N.msgpack`` through
    ``utils/flax_msgpack.py``) -> the port's state:

    ``{'step': int, 'lr_scale': float, 'model': state_dict, 'optimizer':
    parse_opt_state(...), 'momentum': {parameter name: momentum buffer} or
    None, 'mask': {parameter name: pruning mask} or None, 'ema':
    {parameter name: shadow} or None}``.

    The model is :func:`from_jax_variables`'.  The optimizer's buffers
    (:func:`parse_opt_state`) go HWIO -> OIHW as the weights do; optax's
    ``trace`` (``t = g + m * t``, zero at init) is ``torch.optim.SGD``'s
    ``momentum_buffer`` with ``dampening=0``, and ``momentum`` gathers it
    over the groups.  A pruned run's state (``train.pruner``) carries its
    mask across (:func:`_pruning_mask`), an EMA run's its shadow
    (``ema_params``).
    """
    opt_state = raw.get('opt_state', {})
    parsed = parse_opt_state(opt_state)
    traces = [g['buffers']['momentum_buffer'] for g in parsed['groups'].values()
              if 'momentum_buffer' in g['buffers']]
    ema = raw.get('ema_params') or {}
    return {'step': int(np.asarray(raw['step'])),
            'lr_scale': float(np.asarray(raw.get('lr_scale', 1.0))),
            'model': from_jax_variables(raw),
            'optimizer': parsed,
            'momentum': ({k: v for t in traces for k, v in t.items()}
                         if traces else None),
            'mask': _pruning_mask(opt_state),
            'ema': _params_to_torch(ema) if ema else None}
