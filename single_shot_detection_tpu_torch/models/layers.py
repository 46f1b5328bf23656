"""Reusable conv blocks (NCHW).

Port of ``single_shot_detection_tpu/models/layers.py``.  Child modules carry
the flax submodule names (``conv``/``bn``, ``depthwise_conv``/...), so a JAX
variable tree maps onto the ``state_dict`` by a plain walk
(``utils/weights.py``).

BatchNorm (:class:`BatchNorm`): flax's ``momentum=0.9`` is torch's
``momentum=0.1``, and both use ``eps=1e-5``.  Eval mode normalizes with the
running statistics; train mode follows flax ``nn.BatchNorm`` (batch
statistics, running statistics updated with the *biased* batch variance).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from single_shot_detection_tpu_torch.ops.bn_fused import fused_bn_train

ACTIVATIONS = {
    'ReLU': F.relu,
    'ReLU6': lambda x: torch.clamp(F.relu(x), max=6.0),
    'LeakyReLU': lambda x: F.leaky_relu(x, 0.01),  # flax's default slope
    'SiLU': F.silu,
    'GELU': lambda x: F.gelu(x, approximate='tanh'),  # flax's default form
    'Sigmoid': torch.sigmoid,
    'Tanh': torch.tanh,
    'Identity': lambda x: x,
}


def tf_same_pad(kernel_size: int, stride: int) -> Tuple[int, int, int, int]:
    """``F.pad`` widths ``(left, right, top, bottom)`` of the custom
    MobileNets: symmetric ``k // 2`` at stride 1, TF-style asymmetric
    ``(0, 1)`` at stride 2."""
    if stride == 2:
        return (0, 1, 0, 1)
    p = kernel_size // 2
    return (p, p, p, p)


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same ``state_dict`` keys) with flax's train mode.

    Eval mode is ``nn.BatchNorm2d``'s: the running statistics.  Train mode
    normalizes with the batch statistics and updates the running statistics
    in the forward as flax does: ``ra = 0.9 * ra + 0.1 * batch``, with the
    biased batch variance (stock ``nn.BatchNorm2d`` uses the unbiased one).
    ``num_batches_tracked`` is not advanced (flax keeps no such count).

    ``fused`` (the config's ``train.fused_bn``) selects the batch-statistic
    pass: on, ``ops/bn_fused.py::fused_bn_train`` (the four CUDA kernels on
    the card); off, PyTorch's own ``torch.native_batch_norm``, the
    counterpart of flax's XLA-lowered BN.  It is a configuration: neither
    path stands in for the other when one fails.
    """

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)
        self.fused = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.fused:
            z, mean, var = fused_bn_train(x, self.weight, self.bias, self.eps)
        else:
            z, mean, invstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps)
            mean = mean.detach()
            var = torch.clamp(invstd.detach().pow(-2) - self.eps, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(
                mean * self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(
                var * self.momentum)
        return z


def batch_norm(channels: int) -> BatchNorm:
    return BatchNorm(channels)


def set_fused_bn(model: nn.Module, fused: bool) -> int:
    """Set every :class:`BatchNorm`'s ``fused`` flag; returns their count."""
    layers = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in layers:
        m.fused = fused
    return len(layers)


def xavier_(weight: torch.Tensor, generator: torch.Generator,
            uniform: bool) -> None:
    """Glorot init of a conv weight ``[O, I/groups, kh, kw]`` with an
    explicit generator (fans as flax and torch count them)."""
    receptive = weight[0, 0].numel()
    fan_in, fan_out = weight.shape[1] * receptive, weight.shape[0] * receptive
    std = math.sqrt(2.0 / (fan_in + fan_out))
    with torch.no_grad():
        if uniform:
            bound = math.sqrt(3.0) * std
            weight.copy_((torch.rand(weight.shape, generator=generator) * 2 - 1)
                         * bound)
        else:
            weight.copy_(torch.randn(weight.shape, generator=generator) * std)


class ConvBn(nn.Module):
    """conv + BN + activation; ``padding`` is symmetric."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 0,
                 activation: str = 'ReLU'):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              stride=stride, padding=padding, bias=False)
        self.bn = batch_norm(out_channels)
        self.activation = activation

    def forward(self, x):
        return ACTIVATIONS[self.activation](self.bn(self.conv(x)))


class DepthwiseConvBn(nn.Module):
    """depthwise conv + BN + activation, then pointwise conv + BN +
    activation.  ``padding`` is symmetric (the SSD extras pad their stride-2
    depthwise conv by 1 on every side, unlike the backbone)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 0,
                 activation: str = 'ReLU'):
        super().__init__()
        self.depthwise_conv = nn.Conv2d(in_channels, in_channels, kernel_size,
                                        stride=stride, padding=padding,
                                        groups=in_channels, bias=False)
        self.depthwise_bn = batch_norm(in_channels)
        self.pointwise_conv = nn.Conv2d(in_channels, out_channels, 1,
                                        bias=False)
        self.pointwise_bn = batch_norm(out_channels)
        self.activation = activation

    def forward(self, x):
        act = ACTIVATIONS[self.activation]
        x = act(self.depthwise_bn(self.depthwise_conv(x)))
        return act(self.pointwise_bn(self.pointwise_conv(x)))
