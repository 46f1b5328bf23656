"""GroupNorm over a BatchNorm's own parameters (``train.group_norm``).

Port of ``single_shot_detection_tpu/models/norm.py``.  The JAX package swaps
every BatchNorm application for GroupNorm (Wu & He, arXiv:1803.08494) with a
flax method interceptor; here it is a mode of ``layers.BatchNorm``
(``layers.set_group_norm``), so the ``state_dict`` stays BN's: the affine
``weight``/``bias`` are the BN's, the running statistics are kept but never
written (they stay at their 0/1 init in a GroupNorm run), and checkpoints
and ``from_jax_variables`` are unchanged.  It applies in train and eval mode
alike, as the JAX engine applies its override to the train step, the eval
step and ``predict``.

The JAX package has no Pallas kernel for it; this is plain PyTorch.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

DEFAULT_GROUPS = 8


def num_groups(channels: int, groups: int) -> int:
    """Largest divisor of ``channels`` not above ``groups`` (1 makes it a
    LayerNorm over the channels)."""
    g = min(groups, channels)
    while channels % g:
        g -= 1
    return g


def groups_from_config(value: Any) -> Optional[int]:
    """``train.group_norm`` as a group count: ``True`` is
    ``DEFAULT_GROUPS``, an int that count, ``{'groups': g}`` g; anything
    false is off (``None``)."""
    if not value:
        return None
    if isinstance(value, dict):
        return int(value.get('groups', DEFAULT_GROUPS))
    if isinstance(value, bool):
        return DEFAULT_GROUPS
    return int(value)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float) -> torch.Tensor:
    """GroupNorm of NCHW ``x``: moments per sample and per group of
    ``C // g`` consecutive channels over the spatial positions, in f32, the
    variance biased; ``(x - mean) / sqrt(var + eps) * weight + bias``, in
    ``x``'s dtype."""
    b, c = x.shape[:2]
    g = num_groups(c, groups)
    xf = x.float().reshape(b, g, c // g, *x.shape[2:])
    axes = tuple(range(2, xf.ndim))
    mean = xf.mean(dim=axes, keepdim=True)
    var = (xf - mean).square().mean(dim=axes, keepdim=True)
    y = ((xf - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.ndim - 2)
    y = y * weight.float().reshape(shape) + bias.float().reshape(shape)
    return y.to(x.dtype)
