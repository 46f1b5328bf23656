"""Structured channel pruning.

Port of ``single_shot_detection_tpu/train/pruning.py``: ``Pruner``, the
importance criteria (``RandomSampling``, ``MinL1Norm``, ``MinL2Norm``,
``MeanActivation``, ``TaylorExpansion``), the residual writer groups and the
optimizer mask.

Channel "removal" while training is **exact masking**, as in the JAX
package: pruning channel ``c`` of a conv zeroes its weight's out-slice, its
bias and its BatchNorm's weight and bias (a BN with zero weight and bias
emits exactly 0 whatever its running statistics, and every activation in
the zoo maps 0 to 0), so the consumers see the math of a physically
removed channel.  The mask (``TrainState.mask``: ``{parameter name: 0/1
tensor}``, ``[C, 1, 1, 1]`` for a conv weight and ``[C]`` for a vector)
keeps gradients from reviving dead channels: ``train/step.py::
apply_gradients`` multiplies each masked parameter by it after the
optimizer's step.  That holds the JAX ``masked`` wrapper's invariants: dead
entries stay exactly 0 (possibly ``-0.0``); live entries equal an unmasked
step bit for bit; the SGD momentum buffers keep accumulating the dead
entries' gradients, as optax's trace does under the mask.
``train/materialize.py`` turns a masked model into a physically narrow one.

Keys are the JAX package's variable paths without the collection
(``('features', 'base', 'stage3', 'expand_conv', 'kernel')``), so dead sets
and scores compare one to one with the JAX ``Pruner``'s and the log lines
read the same; :func:`param_tree` maps them to the model's tensors, in the
sorted order of the JAX engine's state (its pytree round trips sort every
dict's keys), which is the order ``RandomSampling`` draws in.
"""

from __future__ import annotations

import logging
import random
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from single_shot_detection_tpu_torch.utils.weights import (state_name,
                                                           variable_path)

Path = Tuple[str, ...]


# ---------------------------------------------------------------------------
# parameters by variable path
# ---------------------------------------------------------------------------

def param_tree(model: torch.nn.Module) -> Dict[Path, torch.Tensor]:
    """The model's parameters by variable path (without ``'params'``), in
    sorted path order."""
    out = {variable_path(name, p.ndim)[1:]: p
           for name, p in model.named_parameters()}
    return dict(sorted(out.items()))


def param_name(path: Path) -> str:
    """The ``state_dict`` name of a parameter's variable path."""
    return state_name(('params',) + tuple(path))


def conv_kernel_paths(params: Mapping[Path, torch.Tensor]) -> List[Path]:
    """All 4-D conv weights in ``params``, in its order."""
    return [p for p, v in params.items()
            if p[-1] == 'kernel' and v.ndim == 4]


def _module_path(kernel_path: Path) -> Path:
    """Drop the trailing ('conv-ish', 'kernel') to get the block path."""
    return kernel_path[:-2]


def _host(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """1-D device tensors to numpy in one transfer."""
    if not tensors:
        return []
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors]).cpu()
    return [a.numpy() for a in torch.split(flat, [t.numel() for t in tensors])]


def _companions(params: Mapping[Path, torch.Tensor],
                kernel_path: Path) -> List[Tuple[Path, int]]:
    """Arrays zeroed with a conv's out-channel when the kernel is in no
    analyzed space: the conv bias and the sibling BatchNorm's weight and
    bias, by name.  Returns ``(path, axis)`` pairs; the weight's own axis
    is 0 (OIHW)."""
    module = _module_path(kernel_path)
    conv_name = kernel_path[-2]
    out = [(kernel_path, 0)]
    bias_path = module + (conv_name, 'bias')
    if bias_path in params:
        out.append((bias_path, 0))
    bn_name = {'conv': 'bn',
               'depthwise_conv': 'depthwise_bn',
               'pointwise_conv': 'pointwise_bn',
               'expand_conv': 'expand_bn',
               'project_conv': 'project_bn'}.get(conv_name)
    if bn_name is not None:
        for field in ('scale', 'bias'):
            p = module + (bn_name, field)
            if p in params:
                out.append((p, 0))
    return out


# ---------------------------------------------------------------------------
# residual writer groups (the structural fallback without spaces)
# ---------------------------------------------------------------------------

def residual_groups(params: Mapping[Path, torch.Tensor]) -> Dict[Path, List[Path]]:
    """Map each conv weight to the weights writing into the same channel
    space through residual adds, by MobileNetV2's naming convention:
    consecutive ``stageN/project_conv`` weights with equal out-channels form
    one group."""
    kernels = conv_kernel_paths(params)
    groups: Dict[Path, List[Path]] = {k: [k] for k in kernels}
    by_parent: Dict[Path, Dict[int, Path]] = {}
    for k in kernels:
        if len(k) >= 3 and k[-2] == 'project_conv' and k[-3].startswith('stage'):
            try:
                idx = int(k[-3][5:])
            except ValueError:
                continue
            by_parent.setdefault(k[:-3], {})[idx] = k

    for stage_map in by_parent.values():
        chain: List[Path] = []
        prev_c = None
        for idx in sorted(stage_map):
            k = stage_map[idx]
            c = params[k].shape[0]
            if prev_c == c:
                chain.append(k)
            else:
                if len(chain) > 1:
                    for member in chain:
                        groups[member] = list(chain)
                chain = [k]
            prev_c = c
        if len(chain) > 1:
            for member in chain:
                groups[member] = list(chain)
    return groups


# ---------------------------------------------------------------------------
# criteria
# ---------------------------------------------------------------------------

class Criterion:
    """Scores channels; lower = pruned first."""

    needs_activations = False

    def __init__(self, params, include_paths: Optional[Sequence[str]] = None,
                 **_):
        self.include_paths = include_paths

    def _included(self, params) -> List[Path]:
        kernels = conv_kernel_paths(params)
        if not self.include_paths:
            return kernels
        return [k for k in kernels
                if any('.'.join(k).startswith(ip) or ip in '.'.join(k)
                       for ip in self.include_paths)]

    def scores(self, params) -> Dict[Path, np.ndarray]:
        raise NotImplementedError


class MinL1Norm(Criterion):
    def scores(self, params):
        keys = self._included(params)
        return dict(zip(keys, _host([params[k].abs().sum(dim=(1, 2, 3))
                                     for k in keys])))


class MinL2Norm(Criterion):
    def scores(self, params):
        keys = self._included(params)
        return dict(zip(keys, _host([params[k].pow(2).sum(dim=(1, 2, 3)).sqrt()
                                     for k in keys])))


class RandomSampling(Criterion):
    def __init__(self, params, include_paths=None, seed: int = 0, **_):
        super().__init__(params, include_paths)
        self.rng = random.Random(seed)

    def scores(self, params):
        return {k: np.asarray([self.rng.random()
                               for _ in range(params[k].shape[0])])
                for k in self._included(params)}


class MeanActivation(Criterion):
    """EMA of per-channel mean activations, fed by ``Pruner.observe`` with
    :func:`activation_means`."""

    needs_activations = True

    def __init__(self, params, include_paths=None, momentum: float = 0.9, **_):
        super().__init__(params, include_paths)
        self.momentum = momentum
        self.ema: Dict[Path, np.ndarray] = {}

    def update(self, acts: Dict[Path, np.ndarray]):
        for k, v in acts.items():
            if k in self.ema:
                self.ema[k] = self.momentum * self.ema[k] + (1 - self.momentum) * v
            else:
                self.ema[k] = v

    def scores(self, params):
        out = {}
        for k in self._included(params):
            # the conv's own output (its channel count), else the block's
            # output when the lengths agree
            for key in (k[:-1], _module_path(k)):
                mean = self.ema.get(key)
                if mean is not None and len(mean) == params[k].shape[0]:
                    out[k] = mean
                    break
        return out


class TaylorExpansion(Criterion):
    """|dL/dW * W| per out-channel, normalized and EMA'd (the weight-level
    form of Molchanov pruning, arXiv 1611.06440)."""

    def __init__(self, params, include_paths=None, momentum: float = 0.9, **_):
        super().__init__(params, include_paths)
        self.momentum = momentum
        self.ema: Dict[Path, np.ndarray] = {}

    def update_from_grads(self, params, grads):
        keys = [k for k in self._included(params) if grads.get(k) is not None]
        values = _host([(grads[k] * params[k]).abs().mean(dim=(1, 2, 3))
                        for k in keys])
        for k, value in zip(keys, values):
            norm = np.linalg.norm(value) + 1e-8
            value = value / norm
            if k in self.ema:
                self.ema[k] = self.momentum * self.ema[k] + (1 - self.momentum) * value
            else:
                self.ema[k] = value

    def scores(self, params):
        return {k: v for k, v in self.ema.items() if k in self._included(params)}


CRITERIONS = {
    'RandomSampling': RandomSampling,
    'MinL1Norm': MinL1Norm,
    'MinL2Norm': MinL2Norm,
    'MeanActivation': MeanActivation,
    'TaylorExpansion': TaylorExpansion,
}


# ---------------------------------------------------------------------------
# the optimizer mask
# ---------------------------------------------------------------------------

@torch.no_grad()
def apply_mask(model: torch.nn.Module, mask: Mapping[str, torch.Tensor]) -> None:
    """Multiply each masked parameter by its mask (after an optimizer step:
    dead entries back to exactly 0, live ones untouched)."""
    if not mask:
        return
    params = dict(model.named_parameters())
    torch._foreach_mul_([params[name] for name in mask], list(mask.values()))


class Pruner:
    """Iterative channel pruner.

    ``prune(state)`` scores channels, picks the global bottom-``num`` (with
    writer-group sharing and last-channel protection), zeroes them in the
    model and masks them in ``state.mask``.  With ``spaces``
    (``train/deps.py``) the writer groups and each channel's companion
    tensors come from the traced graph; without, from the MobileNetV2
    naming convention (``residual_groups``, ``_companions``).
    ``params`` is :func:`param_tree`'s dict.
    """

    def __init__(self, params, criterion: dict,
                 include_paths: Optional[Sequence[str]] = None, num: int = 1,
                 spaces=None):
        self.num = num
        name = criterion['name']
        self.criterion = CRITERIONS[name](params, include_paths,
                                          **criterion.get('args', {}))
        self.spaces = spaces
        self._space_index = None
        if spaces is not None:
            self._space_index = self._index_spaces(spaces)
            self.groups = self._groups_from_spaces(spaces, params)
            for k in conv_kernel_paths(params):
                self.groups.setdefault(k, [k])
        else:
            self.groups = residual_groups(params)
        self.dead: Dict[Path, set] = {}

    @staticmethod
    def _index_spaces(spaces):
        """kernel path -> [(space, writer member)]."""
        idx: Dict[Path, list] = {}
        for s in spaces:
            for m in s.members:
                if m.role in ('producer', 'depthwise') and m.path[0] == 'params':
                    idx.setdefault(m.path[1:], []).append((s, m))
        return idx

    @staticmethod
    def _groups_from_spaces(spaces, params) -> Dict[Path, List[Path]]:
        """Writers of one space prune together; only full-width, zero-offset
        writers join a group (a depthwise weight spanning a concatenation
        keeps its own scores)."""
        def _full_width(m, s):
            return (m.offset == 0
                    and params[m.path[1:]].shape[m.axis] == s.width)

        groups: Dict[Path, List[Path]] = {}
        for s in spaces:
            writers = [m.path[1:] for m in s.members
                       if m.role in ('producer', 'depthwise')
                       and m.path[0] == 'params' and _full_width(m, s)]
            if len(writers) > 1:
                for w in writers:
                    groups[w] = list(writers)
        return groups

    def _space_companions(self, kernel_path: Path, channel: int):
        """``(path, axis, index)`` triples to zero for one pruned channel,
        from the traced graph; None when the kernel is in no analyzed
        space."""
        entries = self._space_index.get(kernel_path) if self._space_index else None
        if not entries:
            return None
        for s, m in entries:
            if m.offset <= channel < m.offset + s.width:
                space_ch = channel - m.offset
                out = [(kernel_path, 0, channel)]
                for v in s.members:
                    if v.role == 'vector' and v.path[0] == 'params':
                        out.append((v.path[1:], 0, v.offset + space_ch))
                return out
        return None

    def _group_scores(self, scores: Dict[Path, np.ndarray]) -> Dict[Path, np.ndarray]:
        """Share scores across writer groups by elementwise max."""
        out = {}
        seen = set()
        for k in scores:
            group = [g for g in self.groups.get(k, [k]) if g in scores]
            key = tuple(sorted(group))
            if key in seen:
                continue
            seen.add(key)
            out[k] = np.stack([scores[g] for g in group]).max(axis=0)
        return out

    def select(self, params) -> List[Tuple[Path, int]]:
        scores = self.criterion.scores(params)
        if not scores:
            return []
        grouped = self._group_scores(scores)

        entries = []
        for k, s in grouped.items():
            dead = self.dead.get(k, set())
            alive = [c for c in range(len(s)) if c not in dead]
            if len(alive) <= 1:
                continue  # never kill a layer
            for c in alive:
                entries.append((float(s[c]), k, c))
        entries.sort()
        picked = []
        per_layer_alive = {k: len(s) - len(self.dead.get(k, set()))
                           for k, s in grouped.items()}
        for _, k, c in entries:
            if len(picked) >= self.num:
                break
            if per_layer_alive[k] <= 1:
                continue
            picked.append((k, c))
            per_layer_alive[k] -= 1
        return picked

    @torch.no_grad()
    def prune(self, state):
        """Zero the selected channels in ``state.model`` and mask them in
        ``state.mask``; returns ``state`` (updated in place)."""
        params = param_tree(state.model)
        picked = self.select(params)
        if not picked:
            logging.info('Pruned channels: Nothing!')
            return state

        mask_updates: Dict[Path, np.ndarray] = {}
        logging.info('Pruned channels:')
        for kernel_path, channel in picked:
            for member in self.groups.get(kernel_path, [kernel_path]):
                self.dead.setdefault(member, set()).add(channel)
                logging.info(f'{".".join(member)} #{channel}')
                companions = self._space_companions(member, channel)
                if companions is None:
                    companions = [(p, a, channel)
                                  for p, a in _companions(params, member)]
                for path, axis, index in companions:
                    arr = params[path]
                    arr.select(axis, index).zero_()
                    m = mask_updates.get(path)
                    if m is None:
                        m = np.ones(arr.shape[axis], np.float32)
                    m[index] = 0.0
                    mask_updates[path] = m
        self._apply_mask_updates(state, params, mask_updates)
        return state

    @staticmethod
    def _apply_mask_updates(state, params, mask_updates) -> None:
        """Fold per-channel masks into ``state.mask``."""
        if state.mask is None:
            logging.warning('WW the train state has no optimizer mask — '
                            'pruned channels may regrow; build the Trainer '
                            'with train.pruner set')
            return
        for path, m in mask_updates.items():
            target = params[path]
            shape = [1] * target.ndim
            shape[0] = target.shape[0]
            new = torch.from_numpy(m).to(target.device).reshape(shape)
            name = param_name(path)
            current = state.mask.get(name)
            state.mask[name] = new if current is None else new * current

    def observe(self, acts: Mapping[Path, np.ndarray]) -> None:
        """Feed per-channel activation means (:func:`activation_means`) to
        an activation-based criterion."""
        if isinstance(self.criterion, MeanActivation):
            self.criterion.update(
                {k: np.asarray(v) for k, v in acts.items()})

    def observe_grads(self, params, grads) -> None:
        """Feed a step's loss gradients, beside the parameters after the
        step, to ``TaylorExpansion``."""
        if isinstance(self.criterion, TaylorExpansion):
            self.criterion.update_from_grads(params, grads)


def _first_map(output):
    """A module call's 4-D output, as the JAX package reads a flax
    intermediate: the first element of a tuple output."""
    if isinstance(output, tuple):
        output = output[0]
    return output if isinstance(output, torch.Tensor) and output.ndim == 4 else None


@torch.no_grad()
def activation_means(model: torch.nn.Module,
                     images: torch.Tensor) -> Dict[Path, np.ndarray]:
    """Per-channel means of every module's first 4-D output over the batch
    and the plane, from forward hooks on an eval-mode forward of
    ``images`` (NCHW, on the model's device), computed on the device and
    brought to the host in one transfer; keyed by module path.  The
    counterpart of the JAX package's flax ``capture_intermediates``."""
    means: Dict[Path, torch.Tensor] = {}

    def hook(path):
        def record(module, inputs, output):
            x = _first_map(output)
            if x is not None and path not in means:
                means[path] = x.float().mean(dim=(0, 2, 3))
        return record

    hooks = [m.register_forward_hook(hook(tuple(name.split('.'))))
             for name, m in model.named_modules() if name]
    was_training = model.training
    model.eval()
    try:
        model(images)
    finally:
        model.train(was_training)
        for h in hooks:
            h.remove()
    return dict(zip(means, _host(list(means.values()))))
