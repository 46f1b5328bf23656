"""MobileNet v1 backbone (NCHW).

Port of ``single_shot_detection_tpu/models/mobilenet.py``: the TF-flavoured
MobileNet v1 with 14 public stages (a conv + BN, then 13
depthwise-separable blocks), ReLU6, TF-style asymmetric zero padding
``(0, 1, 0, 1)`` on stride-2 convs, and widths ``max(int(d *
depth_multiplier), min_depth)``.  Every conv is xavier-uniform without
bias, as in the JAX package.  Children carry the flax names
(``stage0_conv``, ``stage0_bn``, ``stage{1..13}.{depthwise,pointwise}_
{conv,bn}``).

``width_overrides`` (``{stage: width}``) gives the narrow output widths of
a pruned model (``train/materialize.py``): stage 0's conv, a block's
pointwise conv; a block's depthwise conv follows its input.
"""

from __future__ import annotations

from typing import List, Optional

from torch import nn

from single_shot_detection_tpu_torch.models.layers import (batch_norm, conv2d,
                                                           relu6, tf_same_pad,
                                                           xavier_uniform)

# (features, stride) for the 13 depthwise-separable stages 1..13
_MBV1_STAGES = [
    (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
    (1024, 2), (1024, 1),
]


class _SeparableBlock(nn.Module):
    """Depthwise 3x3 + BN + ReLU6, then pointwise 1x1 + BN + ReLU6."""

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.depthwise_conv = conv2d(in_channels, in_channels, 3,
                                     stride=stride, groups=in_channels,
                                     kernel_init=xavier_uniform,
                                     pad=tf_same_pad(3, stride))
        self.depthwise_bn = batch_norm(in_channels)
        self.pointwise_conv = conv2d(in_channels, features, 1,
                                     kernel_init=xavier_uniform)
        self.pointwise_bn = batch_norm(features)

    def forward(self, x):
        x = relu6(self.depthwise_bn(self.depthwise_conv(x)))
        return relu6(self.pointwise_bn(self.pointwise_conv(x)))


class MobileNet(nn.Module):
    """14-stage MobileNet v1 feature extractor.

    ``forward(x, max_stage=None)`` returns ``(stages, {})``;
    ``stage_channels[i]`` is stage ``i``'s width."""

    num_stages = 14

    def __init__(self, depth_multiplier: float = 1.0, min_depth: int = 4,
                 width_overrides=None):
        super().__init__()
        self.depth_multiplier = depth_multiplier
        self.min_depth = min_depth
        overrides = width_overrides or {}
        c = overrides.get(0, self.depth(32))
        self.stage0_conv = conv2d(3, c, 3, stride=2, kernel_init=xavier_uniform,
                                  pad=tf_same_pad(3, 2))
        self.stage0_bn = batch_norm(c)
        self.stage_channels: List[int] = [c]
        self.aux_channels = {}
        for i, (features, stride) in enumerate(_MBV1_STAGES, start=1):
            width = overrides.get(i, self.depth(features))
            self.add_module(f'stage{i}', _SeparableBlock(c, width, stride))
            c = width
            self.stage_channels.append(c)

    def depth(self, d: int) -> int:
        return max(int(d * self.depth_multiplier), self.min_depth)

    def forward(self, x, max_stage: Optional[int] = None):
        last = self.num_stages - 1 if max_stage is None else max_stage
        x = relu6(self.stage0_bn(self.stage0_conv(x)))
        stages = [x]
        for i in range(1, min(last, self.num_stages - 1) + 1):
            x = getattr(self, f'stage{i}')(x)
            stages.append(x)
        return stages, {}
