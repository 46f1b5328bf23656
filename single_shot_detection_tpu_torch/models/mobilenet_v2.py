"""MobileNetV2 backbone (NCHW).

Port of ``single_shot_detection_tpu/models/mobilenet_v2.py``: the custom
TF-flavoured MobileNetV2 with inverted-residual bottlenecks, ReLU6, residual
iff same-shape stride-1, TF-style asymmetric zero padding ``(0, 1, 0, 1)`` on
stride-2 convs (a ``padding=0`` conv with the explicit ``pad`` of
``layers.Conv2d``, since ``nn.Conv2d`` pads symmetrically), and 19 public stages (0..18) whose indices
configs tap (``out_layers=(13, 18)``).  The inner tap ``expand_relu`` is
returned in ``aux``.

``width_overrides`` (``{stage: {'features': n, 'inner': n}}``) gives the
narrow widths of a pruned model (``train/materialize.py``).  A block's
structure comes from its configured widths, never from its overridden
ones: a stage whose configured input and output widths differ gets no
residual even when pruning has made its narrowed widths equal.  (The JAX
package decides the residual from the widths at call time, and so adds one
to such a stage of its narrow model.)
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from single_shot_detection_tpu_torch.models.layers import (batch_norm, conv2d,
                                                           relu6, tf_same_pad,
                                                           xavier_uniform)


class _ConvBn(nn.Module):
    """conv + BN + ReLU6 with TF-asymmetric stride-2 padding."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1):
        super().__init__()
        self.conv = conv2d(in_channels, out_channels, kernel_size,
                           stride=stride, kernel_init=xavier_uniform,
                           pad=tf_same_pad(kernel_size, stride))
        self.bn = batch_norm(out_channels)

    def forward(self, x):
        return relu6(self.bn(self.conv(x)))


class InvertedResidual(nn.Module):
    """Inverted-residual bottleneck.  ``forward`` returns ``(out, aux)``
    where ``aux['expand_relu']`` is the post-expansion activation.

    ``inner_channels`` (default ``in_channels * expansion_ratio``) is the
    expanded width; ``residual`` (default: same width at stride 1) is the
    block's structure, which a narrowed block takes from its configured
    widths."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 expansion_ratio: int, inner_channels: Optional[int] = None,
                 residual: Optional[bool] = None):
        super().__init__()
        inner = (in_channels * expansion_ratio if inner_channels is None
                 else inner_channels)
        self.residual = (in_channels == out_channels and stride == 1
                         if residual is None else residual)
        self.expand = expansion_ratio > 1
        if self.expand:
            self.expand_conv = conv2d(in_channels, inner, 1,
                                      kernel_init=xavier_uniform)
            self.expand_bn = batch_norm(inner)
        self.depthwise_conv = conv2d(inner, inner, 3, stride=stride,
                                     groups=inner, kernel_init=xavier_uniform,
                                     pad=tf_same_pad(3, stride))
        self.depthwise_bn = batch_norm(inner)
        self.project_conv = conv2d(inner, out_channels, 1,
                                   kernel_init=xavier_uniform)
        self.project_bn = batch_norm(out_channels)
        self.aux_channels = {'expand_relu': inner} if self.expand else {}

    def forward(self, x) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        aux = {}
        h = x
        if self.expand:
            h = relu6(self.expand_bn(self.expand_conv(h)))
            aux['expand_relu'] = h
        h = relu6(self.depthwise_bn(self.depthwise_conv(h)))
        h = self.project_bn(self.project_conv(h))
        return (x + h if self.residual else h), aux


# (features, stride, expansion) per stage 1..17; stage 0 and 18 are _ConvBn.
_MBV2_STAGES = [
    (16, 1, 1),
    (24, 2, 6), (24, 1, 6),
    (32, 2, 6), (32, 1, 6), (32, 1, 6),
    (64, 2, 6), (64, 1, 6), (64, 1, 6), (64, 1, 6),
    (96, 1, 6), (96, 1, 6), (96, 1, 6),
    (160, 2, 6), (160, 1, 6), (160, 1, 6),
    (320, 1, 6),
]


class MobileNetV2(nn.Module):
    """19-stage MobileNetV2 feature extractor.

    ``forward(x, max_stage=None)`` returns ``(stages, aux)``: ``stages[i]``
    is the output of stage ``i`` (0..18, or up to ``max_stage``),
    ``aux[(i, name)]`` holds inner taps.  Every conv is xavier-uniform, as
    in the JAX package.
    ``stage_channels[i]`` and ``aux_channels[(i, name)]`` give their widths.
    ``width_overrides`` as the module docstring says.
    """

    def __init__(self, depth_multiplier: float = 1.0, min_depth: int = 4,
                 width_overrides: Optional[Mapping] = None):
        super().__init__()
        self.depth_multiplier = depth_multiplier
        self.min_depth = min_depth
        self.width_overrides = width_overrides
        configured = self.depth(32)
        c = self._width(0, configured)
        self.stage0 = _ConvBn(3, c, 3, stride=2)
        self.stage_channels: List[int] = [c]
        self.aux_channels: Dict[Tuple[int, str], int] = {}
        for i, (f, s, e) in enumerate(_MBV2_STAGES, start=1):
            out = self._width(i, self.depth(f))
            block = InvertedResidual(
                c, out, s, e, inner_channels=self._inner(i),
                residual=configured == self.depth(f) and s == 1)
            self.add_module(f'stage{i}', block)
            for name, width in block.aux_channels.items():
                self.aux_channels[(i, name)] = width
            c, configured = out, self.depth(f)
            self.stage_channels.append(c)
        self.stage18 = _ConvBn(c, self._width(18, self.depth(1280)), 1)
        self.stage_channels.append(self._width(18, self.depth(1280)))

    def depth(self, d: int) -> int:
        return max(int(d * self.depth_multiplier), self.min_depth)

    def _width(self, stage: int, default: int, key: str = 'features') -> int:
        entry = (self.width_overrides or {}).get(stage) or {}
        return entry.get(key) or default

    def _inner(self, stage: int) -> Optional[int]:
        return ((self.width_overrides or {}).get(stage) or {}).get('inner')

    def forward(self, x, max_stage: Optional[int] = None):
        last = 18 if max_stage is None else max_stage
        x = self.stage0(x)
        stages, aux = [x], {}
        for i in range(1, min(last, 17) + 1):
            x, block_aux = getattr(self, f'stage{i}')(x)
            stages.append(x)
            for k, v in block_aux.items():
                aux[(i, k)] = v
        if last >= 18:
            stages.append(self.stage18(x))
        return stages, aux
