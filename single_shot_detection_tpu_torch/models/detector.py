"""Detector assembly: SSD extras and per-scale heads (NCHW).

Port of ``single_shot_detection_tpu/models/detector.py`` (``ExtraLayer``,
``Detector``), without the shared-conv predictor towers and the
pipeline-parallel stage seam.

Anchor order: the JAX heads are NHWC, and ``[B, H, W, nb*C]`` reshapes to
``[B, H*W*nb, C]``, the anchors' ``(H, W, box)`` order.  Here the heads are
NCHW, so each output is permuted to NHWC before that reshape.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from single_shot_detection_tpu_torch.models.layers import (ConvBn,
                                                           DepthwiseConvBn,
                                                           xavier_)


class ExtraLayer(nn.Module):
    """One SSD extra-scale block from a spec tuple.

    type 'm': 3x3/2 maxpool (channels preserved);
    type 's': 1x1 reduce to out//2, then 3x3/2 conv to out (padding 1);
    type '':  1x1 reduce to out//2, then 3x3 valid conv to out.
    """

    def __init__(self, type: str, in_channels: int, out_channels: int,
                 use_depthwise: bool = False):
        super().__init__()
        if type not in ('m', 's', ''):
            raise ValueError(f'Unknown layer type: {type}')
        self.type = type
        self.out_channels = in_channels if type == 'm' else out_channels
        if type == 'm':
            self.pool = nn.MaxPool2d(3, stride=2, padding=1)
            return
        reduce_f = out_channels // 2
        self.reduce = ConvBn(in_channels, reduce_f, kernel_size=1)
        conv_op = DepthwiseConvBn if use_depthwise else ConvBn
        self.expand = conv_op(reduce_f, out_channels, kernel_size=3,
                              stride=2 if type == 's' else 1,
                              padding=1 if type == 's' else 0)

    def forward(self, x):
        if self.type == 'm':
            return self.pool(x)
        return self.expand(self.reduce(x))


class Detector(nn.Module):
    """features -> extras -> per-scale heads -> concatenated
    ``(scores [B, A, C], locs [B, A, 4])``.

    Children carry the flax names: ``features``, ``extra{i}``,
    ``score_head{i}``, ``loc_head{i}``.
    """

    def __init__(self, features: nn.Module, num_classes: int,
                 extras: Sequence[Tuple[str, int]] = (),
                 num_boxes: Sequence[int] = (), use_depthwise: bool = False,
                 score_head_bias_init: float = 0.0):
        super().__init__()
        self.features = features
        self.num_classes = num_classes
        self.num_extras = len(extras)
        self.score_head_bias_init = score_head_bias_init
        channels = list(features.channels)
        c = features.out_channels
        for i, (type_, out_channels) in enumerate(extras):
            extra = ExtraLayer(type_, c, out_channels, use_depthwise)
            self.add_module(f'extra{i}', extra)
            c = extra.out_channels
            channels.append(c)
        if len(channels) != len(num_boxes):
            raise ValueError(f'{len(channels)} scales vs {len(num_boxes)} '
                             f'anchor generators')
        for i, (nb, ch) in enumerate(zip(num_boxes, channels)):
            self.add_module(f'score_head{i}',
                            nn.Conv2d(ch, nb * num_classes, 3, padding=1))
            self.add_module(f'loc_head{i}', nn.Conv2d(ch, nb * 4, 3, padding=1))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initializers, drawn from ``generator``:
        xavier-uniform backbone convs, xavier-normal extras convs,
        normal(0.01) heads, zero biases, identity BatchNorms."""
        for name, module in self.named_modules():
            if isinstance(module, nn.Conv2d):
                if name.startswith('features.'):
                    xavier_(module.weight, generator, uniform=True)
                elif name.startswith('extra'):
                    xavier_(module.weight, generator, uniform=False)
                else:
                    with torch.no_grad():
                        module.weight.copy_(torch.randn(
                            module.weight.shape, generator=generator) * 0.01)
                if module.bias is not None:
                    nn.init.constant_(module.bias, self.score_head_bias_init
                                      if name.startswith('score_head') else 0.0)
            elif isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()

    def forward(self, x, return_sources: bool = False):
        sources, x = self.features(x)
        sources = list(sources)
        for i in range(self.num_extras):
            x = getattr(self, f'extra{i}')(x)
            sources.append(x)

        batch = x.shape[0]
        scores, locs = [], []
        for i, src in enumerate(sources):
            s = getattr(self, f'score_head{i}')(src)
            l = getattr(self, f'loc_head{i}')(src)
            # NCHW -> NHWC, then [B, H*W*nb, C]: the anchors' order
            scores.append(s.permute(0, 2, 3, 1).reshape(batch, -1,
                                                        self.num_classes))
            locs.append(l.permute(0, 2, 3, 1).reshape(batch, -1, 4))
        out_scores = torch.cat(scores, dim=1)
        out_locs = torch.cat(locs, dim=1)
        if return_sources:
            return out_scores, out_locs, sources
        return out_scores, out_locs
