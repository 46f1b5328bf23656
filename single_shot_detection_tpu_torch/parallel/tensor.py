"""Tensor (channel) sharding over the model axis: ``train.tensor_sharding``.

Port of the JAX package's ``tensor_state_sharding`` (``parallel/mesh.py``)
and the step it pins (``train/engine.py``).  There GSPMD propagates the
parameters' layout through the program and places the collectives; here
they are written by hand, Megatron's column-parallel pair:

- a leaf whose ``cout`` divides the model axis holds only rank ``k``'s
  slice ``[k C/m, (k+1) C/m)`` (:func:`shard_tensors_`; the placement is
  ``mesh.tensor_state_sharding``);
- a dense conv with a sliced weight takes its input through
  :func:`to_model_region` (identity forward, all-reduce over the model
  group backward) and gives a channel-sliced output;
- a sliced activation flows through BN (its statistics are its own
  channels', synced over the data group only), the activation and a
  depthwise conv with a sliced weight, with no collective;
- a consumer that needs full channels (a conv with a whole weight, a
  head, a concat, a channel shuffle, an elementwise op against a whole
  map) first gathers it (:func:`gather_channels`: all-gather along
  channels; backward, the rank's own slice);
- a whole map feeding a depthwise conv with a sliced weight is cut to
  the rank's channels (:func:`slice_channels`: backward, an all-gather).

An activation is known to be sliced by its width: a consumer built for
``C`` channels that receives fewer holds a rank's slice.  The ranks of a
model group see the same batch, so every whole activation and every
whole leaf's gradient is the same on each; the gradients are then summed
over the data group only.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F

from single_shot_detection_tpu_torch.parallel import mesh

# the bytes this rank's collectives received (all-gathers) and reduced
# (all-reduces), read by the chip smoke's per-step count
STATS = {'gathered_bytes': 0, 'reduced_bytes': 0}


def active() -> bool:
    return mesh.model_mode() == 'tensor'


def _own(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    axis = mesh.model_axis()
    size = x.shape[dim] // axis.size
    return x.narrow(dim, axis.index * size, size)


class _Gather(torch.autograd.Function):
    """All-gather along channels over the model group; backward, the
    rank's own slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x):
        return _gather(x)

    @staticmethod
    def backward(ctx, grad):
        return _own(grad).contiguous()


class _Region(torch.autograd.Function):
    """Identity forward; backward, the gradient summed over the model
    group (each rank's sliced conv contributes its channels' part)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        STATS['reduced_bytes'] += grad.numel() * grad.element_size()
        return mesh.all_reduce_(grad, axis='model')


class _Slice(torch.autograd.Function):
    """The rank's channels of a whole map; backward, the gradients of
    every rank's channels gathered whole."""

    @staticmethod
    def forward(ctx, x):
        return _own(x).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad.contiguous())


def _gather(x: torch.Tensor) -> torch.Tensor:
    """All-gather along channels over the model group."""
    STATS['gathered_bytes'] += (x.numel() * x.element_size()
                                * (mesh.model_axis().size - 1))
    return torch.cat(mesh.all_gather(x, 'model'), dim=1)


def gather_channels(x: torch.Tensor) -> torch.Tensor:
    return _Gather.apply(x)


def to_model_region(x: torch.Tensor) -> torch.Tensor:
    return _Region.apply(x)


def slice_channels(x: torch.Tensor) -> torch.Tensor:
    return _Slice.apply(x)


def full(x: torch.Tensor, channels: int) -> torch.Tensor:
    """``x`` with all its ``channels``: gathered when it holds a rank's
    slice under tensor sharding, else as it is."""
    if active() and x.shape[1] != channels:
        return gather_channels(x)
    return x


def align(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two maps of one width for an elementwise op: a sliced one is
    gathered when the other is whole."""
    if active() and a.shape[1] != b.shape[1]:
        if a.shape[1] < b.shape[1]:
            a = gather_channels(a)
        else:
            b = gather_channels(b)
    return a, b


def conv(module, x: torch.Tensor, weight: torch.Tensor,
         bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``module``'s conv (a ``layers.Conv2d``, whose ``pad`` is applied by
    the caller) on ``x`` with its weight and bias as they are held: whole,
    or this rank's output channels.  Returns a sliced output for a sliced
    weight, a whole one otherwise."""
    sliced_w = weight.shape[0] != module.out_channels
    sliced_x = x.shape[1] != module.in_channels
    groups = module.groups
    if groups > 1 and groups == module.in_channels:  # depthwise
        if sliced_w and not sliced_x:
            x = slice_channels(x)
        elif sliced_x and not sliced_w:
            x = gather_channels(x)
        groups = x.shape[1]
    else:
        if sliced_x:
            x = gather_channels(x)
        if sliced_w:
            if groups > 1:
                # a grouped conv: this rank's output channels are whole
                # groups, which read their own input groups
                axis = mesh.model_axis()
                if groups % axis.size:
                    raise ValueError(
                        f'train.tensor_sharding={axis.size} does not divide '
                        f'the {groups} groups of a grouped conv')
                n = groups // axis.size
                per = module.in_channels // groups
                x = to_model_region(x).narrow(1, axis.index * n * per,
                                              n * per)
                groups = n
            else:
                x = to_model_region(x)
    return F.conv2d(x, weight, bias, module.stride, module.padding,
                    module.dilation, groups)


def slice_(tensor: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
    """This rank's model slice of a whole leaf along ``axis`` (a copy), or
    the leaf itself when ``axis`` is None."""
    if axis is None:
        return tensor
    return _own(tensor, axis).clone()


def gather_leaf(tensor: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
    """The whole leaf from every model rank's slice along ``axis``."""
    if axis is None:
        return tensor
    return torch.cat(mesh.all_gather(tensor.contiguous(), 'model'), dim=axis)


def shard_tensors_(tensors: Iterable[Tuple[str, torch.Tensor]],
                   axes: Dict[str, Optional[int]]) -> int:
    """Cut each named tensor (a parameter or buffer, its ``.data``
    replaced in place) to this rank's slice where ``axes`` names an axis;
    returns the count cut."""
    count = 0
    for name, t in tensors:
        axis = axes.get(name)
        if axis is not None:
            t.data = slice_(t.data, axis)
            count += 1
    return count


def shard_state_(state, axes: Dict[str, Optional[int]]) -> int:
    """Cut a whole ``train/state.py::TrainState`` to this rank's slices:
    the model's parameters and buffers, each parameter's optimizer
    buffers (those of its shape, whole or ZeRO-sliced on another axis),
    the EMA shadow and the pruning mask.  Returns the count of sliced
    ``state_dict`` entries."""
    names = {p: n for n, p in state.model.named_parameters()}
    for p, buffers in state.optimizer.state.items():
        axis = axes.get(names.get(p))
        if axis is None:
            continue
        for key, buf in buffers.items():
            if (isinstance(buf, torch.Tensor) and buf.dim() == p.dim()
                    and buf.shape[axis] == p.shape[axis]):
                buffers[key] = slice_(buf, axis)
    for name, shadow in state.ema_params.items():
        if axes.get(name) is not None:
            shadow.data = slice_(shadow.data, axes[name])
    for name in list(state.mask or {}):
        if axes.get(name) is not None:
            state.mask[name] = slice_(state.mask[name], axes[name])
    return shard_tensors_(list(state.model.named_parameters())
                          + list(state.model.named_buffers()), axes)


def gather_saved_(saved: dict, state, axes: Dict[str, Optional[int]]) -> dict:
    """A ``train/checkpoint.py::saved_dict`` of a tensor-sharded state
    made whole (a collective over the model group, every rank in one
    order): the model's entries, the optimizer's buffers of sliced
    parameters, the EMA shadow and the mask."""
    saved['model'] = {k: gather_leaf(v, axes.get(k))
                      for k, v in saved['model'].items()}
    params = [p for g in state.optimizer.param_groups for p in g['params']]
    names = {p: n for n, p in state.model.named_parameters()}
    opt = saved['optimizer']
    opt['state'] = dict(opt['state'])
    for i, p in enumerate(params):
        axis = axes.get(names[p])
        if axis is None or i not in opt['state']:
            continue
        entry = opt['state'][i] = dict(opt['state'][i])
        for key in sorted(entry):
            t = entry[key]
            if (isinstance(t, torch.Tensor) and t.dim() == p.dim()
                    and t.shape[axis] == p.shape[axis]):
                entry[key] = gather_leaf(t, axis)
    if 'ema' in saved:
        saved['ema'] = {k: gather_leaf(v, axes.get(k))
                        for k, v in saved['ema'].items()}
    if 'mask' in saved:
        saved['mask'] = {k: gather_leaf(v, axes.get(k))
                         for k, v in saved['mask'].items()}
    return saved
