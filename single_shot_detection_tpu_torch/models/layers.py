"""Reusable conv blocks (NCHW).

Port of ``single_shot_detection_tpu/models/layers.py``.  Child modules carry
the flax submodule names (``conv``/``bn``, ``depthwise_conv``/...), so a JAX
variable tree maps onto the ``state_dict`` by a plain walk
(``utils/weights.py``).

BatchNorm: flax's ``momentum=0.9`` is torch's ``momentum=0.1``, and both use
``eps=1e-5``.  Eval mode (running statistics) is all this slice runs.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

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


def batch_norm(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)


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
