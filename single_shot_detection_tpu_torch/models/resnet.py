"""ResNet, ResNeXt and SE-ResNet backbones (NCHW).

Port of ``single_shot_detection_tpu/models/resnet.py``, with its stage
indexing: ``ResNet`` has 8 stages ``[conv1, bn1, relu, maxpool, layer1,
layer2, layer3, layer4]`` (so ``retina_rn50``'s ``out_layers (5, 6, 7)`` tap
C3, C4 and C5), ``SEResNet`` 5 ``[layer0 (the stem), layer1..layer4]``.
Blocks are children ``layer{i}_{j}`` with the flax names (``conv1``,
``bn1``, ..., ``downsample_conv``, ``downsample_bn``, ``se.fc1``).  Every
conv takes flax's default initializer (``lecun_normal``, zero bias).

``ResNet(width_overrides=)`` (``{block: {'conv1', 'conv2', 'out'}}``, e.g.
``{'layer2_0': {'conv1': 100, 'out': 120}}``) gives the narrow widths of a
pruned model (``train/materialize.py``); a block's downsample branch stays
as configured (the stride or the configured widths decide it), and the stem
keeps its 64 channels, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from single_shot_detection_tpu_torch.models.layers import (batch_norm, conv2d,
                                                           max_pool2d,
                                                           mean_hw)
from single_shot_detection_tpu_torch.parallel import tensor


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 downsample: bool = False, width1: Optional[int] = None,
                 out_width: Optional[int] = None):
        super().__init__()
        w1, out = width1 or features, out_width or features
        self.conv1 = conv2d(in_channels, w1, 3, stride=stride, padding=1)
        self.bn1 = batch_norm(w1)
        self.conv2 = conv2d(w1, out, 3, padding=1)
        self.bn2 = batch_norm(out)
        self.downsample = downsample
        self.out_channels = out
        if downsample:
            self.downsample_conv = conv2d(in_channels, out, 1, stride=stride)
            self.downsample_bn = batch_norm(out)

    def residual(self, x):
        return self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))

    def forward(self, x):
        identity = (self.downsample_bn(self.downsample_conv(x))
                    if self.downsample else x)
        residual, identity = tensor.align(self.residual(x), identity)
        return F.relu(residual + identity)


class Bottleneck(BasicBlock):
    """1x1 -> 3x3 (``groups``, ``base_width``: ResNeXt) -> 1x1 to
    ``features * 4``."""

    expansion = 4

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1,
                 base_width: int = 64, width1: Optional[int] = None,
                 width2: Optional[int] = None,
                 out_width: Optional[int] = None):
        nn.Module.__init__(self)
        width = int(features * (base_width / 64.0)) * groups
        w1, w2 = width1 or width, width2 or width
        out = out_width or features * self.expansion
        self.conv1 = conv2d(in_channels, w1, 1)
        self.bn1 = batch_norm(w1)
        self.conv2 = conv2d(w1, w2, 3, stride=stride, padding=1,
                            groups=groups)
        self.bn2 = batch_norm(w2)
        self.conv3 = conv2d(w2, out, 1)
        self.bn3 = batch_norm(out)
        self.downsample = downsample
        self.out_channels = out
        if downsample:
            self.downsample_conv = conv2d(in_channels, out, 1, stride=stride)
            self.downsample_bn = batch_norm(out)

    def residual(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return self.bn3(self.conv3(out))


class SEBlock(nn.Module):
    """Squeeze-and-excitation gate: global mean, 1x1 ``fc1`` to
    ``channels // reduction``, ReLU, 1x1 ``fc2``, sigmoid, scale."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = conv2d(channels, channels // reduction, 1, bias=True)
        self.fc2 = conv2d(channels // reduction, channels, 1, bias=True)

    def forward(self, x):
        g = torch.sigmoid(self.fc2(F.relu(self.fc1(mean_hw(x)))))
        x, g = tensor.align(x, g)
        return x * g


class SEBottleneck(Bottleneck):
    """Bottleneck with an SE gate before the residual add."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1,
                 base_width: int = 64, reduction: int = 16):
        super().__init__(in_channels, features, stride, downsample, groups,
                         base_width)
        self.se = SEBlock(features * self.expansion, reduction)

    def residual(self, x):
        return self.se(super().residual(x))


def _make_layers(module: nn.Module, block_cls, layers: Sequence[int],
                 groups: int = 1, width_per_group: int = 64,
                 width_overrides: Optional[Mapping] = None) -> List[int]:
    """Add ``layer{i}_{j}`` blocks to ``module``; returns each layer's
    output width.  A block's downsample comes from its configured widths,
    its convs' widths from ``width_overrides``."""
    in_channels, configured, widths = 64, 64, []
    for i, (features, count) in enumerate(zip((64, 128, 256, 512), layers)):
        stride = 1 if i == 0 else 2
        out = features * block_cls.expansion
        for j in range(count):
            name = f'layer{i + 1}_{j}'
            kwargs = {} if block_cls is BasicBlock else dict(
                groups=groups, base_width=width_per_group)
            ov = (width_overrides or {}).get(name)
            if ov:
                kwargs.update(width1=ov.get('conv1'), out_width=ov.get('out'))
                if block_cls is not BasicBlock:
                    kwargs['width2'] = ov.get('conv2')
            block = block_cls(
                in_channels, features, stride=stride if j == 0 else 1,
                downsample=j == 0 and (stride != 1 or configured != out),
                **kwargs)
            module.add_module(name, block)
            in_channels, configured = block.out_channels, out
        widths.append(in_channels)
    return widths


def _run_layer(module: nn.Module, i: int, x):
    j = 0
    while hasattr(module, f'layer{i + 1}_{j}'):
        x = getattr(module, f'layer{i + 1}_{j}')(x)
        j += 1
    return x


class ResNet(nn.Module):
    """8-stage feature extractor (the reference wrapper's indexing)."""

    num_stages = 8

    def __init__(self, block: str = 'bottleneck',
                 layers: Sequence[int] = (3, 4, 6, 3), groups: int = 1,
                 width_per_group: int = 64,
                 width_overrides: Optional[Mapping] = None):
        super().__init__()
        self.conv1 = conv2d(3, 64, 7, stride=2, padding=3)
        self.bn1 = batch_norm(64)
        block_cls = Bottleneck if block == 'bottleneck' else BasicBlock
        self.stage_channels = [64] * 4 + _make_layers(
            self, block_cls, layers, groups, width_per_group,
            width_overrides)
        self.aux_channels = {}

    def forward(self, x, max_stage: Optional[int] = None):
        last = self.num_stages - 1 if max_stage is None else max_stage
        stem = (self.conv1, self.bn1, F.relu,
                lambda h: max_pool2d(h, 3, 2, padding=1))
        stages = []
        for i in range(last + 1):
            x = stem[i](x) if i < 4 else _run_layer(self, i - 4, x)
            stages.append(x)
        return stages, {}


RESNET_CONFIGS = {
    18: dict(block='basic', layers=(2, 2, 2, 2)),
    34: dict(block='basic', layers=(3, 4, 6, 3)),
    50: dict(block='bottleneck', layers=(3, 4, 6, 3)),
    101: dict(block='bottleneck', layers=(3, 4, 23, 3)),
    152: dict(block='bottleneck', layers=(3, 8, 36, 3)),
}


class SEResNet(nn.Module):
    """SE-ResNet(Xt) with 5 stages: ``[layer0 (stem), layer1..layer4]``."""

    num_stages = 5

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), groups: int = 1,
                 width_per_group: int = 64):
        super().__init__()
        self.conv1 = conv2d(3, 64, 7, stride=2, padding=3)
        self.bn1 = batch_norm(64)
        self.stage_channels = [64] + _make_layers(
            self, SEBottleneck, layers, groups, width_per_group)
        self.aux_channels = {}

    def forward(self, x, max_stage: Optional[int] = None):
        last = self.num_stages - 1 if max_stage is None else max_stage
        x = max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, padding=1)
        stages = [x]
        for i in range(last):
            x = _run_layer(self, i, x)
            stages.append(x)
        return stages, {}
