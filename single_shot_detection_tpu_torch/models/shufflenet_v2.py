"""ShuffleNetV2 backbone (NCHW).

Port of ``single_shot_detection_tpu/models/shufflenet_v2.py``: torchvision's
shufflenet_v2_x{0.5,1.0,1.5,2.0} with the stage indexing
``stages = [conv1, maxpool, stage2, stage3, stage4, conv5]``
(``samples/ssd_sh2_voc.py`` taps stages 3 and 5).  Children carry the flax
names (``conv1``, ``conv1_bn``, ``stage{2..4}_{j}`` units with
``branch1_dw``, ..., ``branch2_pw2_bn``, ``conv5``, ``conv5_bn``); every
conv is flax's default ``lecun_normal``, every BN the port's
``layers.BatchNorm``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from single_shot_detection_tpu_torch.models.layers import (batch_norm, conv2d,
                                                           max_pool2d)
from single_shot_detection_tpu_torch.parallel import tensor

SHUFFLENET_WIDTHS = {
    0.5: (48, 96, 192, 1024),
    1.0: (116, 232, 464, 1024),
    1.5: (176, 352, 704, 1024),
    2.0: (244, 488, 976, 2048),
}

_STAGE_REPEATS = (4, 8, 4)


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """Interleave ``groups`` channel groups of NCHW ``x``: output channel
    ``i * groups + j`` is input channel ``j * (C // groups) + i``, as the
    JAX package's NHWC reshape-swap-reshape orders them."""
    b, c, h, w = x.shape
    return (x.reshape(b, groups, c // groups, h, w).transpose(1, 2)
            .reshape(b, c, h, w))


class ShuffleUnit(nn.Module):
    """At stride 1 the first half of the channels passes through and the
    second goes through branch 2; at stride 2 both branches see the whole
    input (branch 1: depthwise 3x3 + BN, pointwise + BN + ReLU).  Branch 2:
    pointwise + BN + ReLU, depthwise 3x3 + BN (no ReLU), pointwise + BN +
    ReLU.  The two halves are concatenated and shuffled."""

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        branch = features // 2
        self.stride = stride
        self.widths = (in_channels, branch)
        if stride == 1:
            if in_channels != features:
                raise ValueError(f'a stride-1 unit keeps its width: '
                                 f'{in_channels} -> {features}')
            branch_in = in_channels // 2
        else:
            branch_in = in_channels
            self.branch1_dw = conv2d(in_channels, in_channels, 3,
                                     stride=stride, padding=1,
                                     groups=in_channels)
            self.branch1_dw_bn = batch_norm(in_channels)
            self.branch1_pw = conv2d(in_channels, branch, 1)
            self.branch1_pw_bn = batch_norm(branch)
        self.branch2_pw1 = conv2d(branch_in, branch, 1)
        self.branch2_pw1_bn = batch_norm(branch)
        self.branch2_dw = conv2d(branch, branch, 3, stride=stride, padding=1,
                                 groups=branch)
        self.branch2_dw_bn = batch_norm(branch)
        self.branch2_pw2 = conv2d(branch, branch, 1)
        self.branch2_pw2_bn = batch_norm(branch)

    def forward(self, x):
        in_channels, branch = self.widths
        if self.stride == 1:
            # halves of the whole map (a tensor-sharded one is gathered)
            x1, x2 = tensor.full(x, in_channels).chunk(2, dim=1)
        else:
            x1 = self.branch1_dw_bn(self.branch1_dw(x))
            x1 = F.relu(self.branch1_pw_bn(self.branch1_pw(x1)))
            x2 = x
        out = F.relu(self.branch2_pw1_bn(self.branch2_pw1(x2)))
        out = self.branch2_dw_bn(self.branch2_dw(out))
        out = F.relu(self.branch2_pw2_bn(self.branch2_pw2(out)))
        return channel_shuffle(torch.cat([tensor.full(x1, branch),
                                          tensor.full(out, branch)], dim=1), 2)


class ShuffleNetV2(nn.Module):
    """6-stage feature extractor: conv1, maxpool, stage2..4, conv5.

    ``forward(x, max_stage=None)`` returns ``(stages, {})``;
    ``stage_channels[i]`` is stage ``i``'s width."""

    num_stages = 6

    def __init__(self, channels: Sequence[int] = SHUFFLENET_WIDTHS[1.0]):
        super().__init__()
        self.conv1 = conv2d(3, 24, 3, stride=2, padding=1)
        self.conv1_bn = batch_norm(24)
        self.stage_channels: List[int] = [24, 24]
        self.aux_channels = {}
        c = 24
        self.units: List[List[str]] = []
        for i, (features, repeats) in enumerate(zip(channels[:3],
                                                    _STAGE_REPEATS)):
            names = []
            for j in range(repeats):
                name = f'stage{i + 2}_{j}'
                self.add_module(name, ShuffleUnit(c, features,
                                                  stride=2 if j == 0 else 1))
                names.append(name)
                c = features
            self.units.append(names)
            self.stage_channels.append(c)
        self.conv5 = conv2d(c, channels[3], 1)
        self.conv5_bn = batch_norm(channels[3])
        self.stage_channels.append(channels[3])

    def forward(self, x, max_stage: Optional[int] = None):
        last = self.num_stages - 1 if max_stage is None else max_stage
        x = F.relu(self.conv1_bn(self.conv1(x)))
        stages = [x]
        if last >= 1:
            x = max_pool2d(x, 3, 2, padding=1)
            stages.append(x)
        for i, names in enumerate(self.units):
            if last < 2 + i:
                return stages, {}
            for name in names:
                x = getattr(self, name)(x)
            stages.append(x)
        if last >= 5:
            stages.append(F.relu(self.conv5_bn(self.conv5(x))))
        return stages, {}
