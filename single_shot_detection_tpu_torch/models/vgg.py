"""VGG backbones (NCHW) with torchvision's per-layer stage indexing.

Port of ``single_shot_detection_tpu/models/vgg.py``: each conv, BN, ReLU
and max-pool of torchvision's ``vggN(_bn).features`` is its own stage, so
the sample configs' taps carry over unchanged (``ssd_300_vgg16_voc`` taps
stage 32, conv4_3's ReLU, and 42, conv5_3's, with ``last_feature_layer:
42``).  Convs are 3x3 with padding 1 and a bias, flax's default
initializer (``lecun_normal``, zero bias); the 2x2/2 pools floor odd sizes
as flax's VALID ``max_pool`` does (75 -> 37).

``width_overrides`` (``{conv_idx: width}``) gives the narrow widths of a
pruned model (``train/materialize.py``).  Not ported: ``packed_stem`` (a
TPU lane-layout form of the first block with the same numbers), which
raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch.nn.functional as F
from torch import nn

from single_shot_detection_tpu_torch.models.layers import (batch_norm, conv2d,
                                                           max_pool2d)

VGG_CONFIGS = {
    11: (64, 'M', 128, 'M', 256, 256, 'M', 512, 512, 'M', 512, 512, 'M'),
    13: (64, 64, 'M', 128, 128, 'M', 256, 256, 'M', 512, 512, 'M',
         512, 512, 'M'),
    16: (64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M', 512, 512, 512, 'M',
         512, 512, 512, 'M'),
    19: (64, 64, 'M', 128, 128, 'M', 256, 256, 256, 256, 'M',
         512, 512, 512, 512, 'M', 512, 512, 512, 512, 'M'),
}


class VGG(nn.Module):
    """``stages[i]`` is torchvision ``vggN(_bn).features[i]``'s output.

    Children ``conv{i}`` and ``bn{i}`` (the flax names).
    ``stage_channels[i]`` is stage ``i``'s width.
    """

    def __init__(self, config: Sequence[Union[int, str]] = VGG_CONFIGS[16],
                 use_bn: bool = True, packed_stem: bool = False,
                 width_overrides=None):
        super().__init__()
        if packed_stem:
            raise NotImplementedError(
                'base.packed_stem is not ported: a TPU lane layout of the '
                'first VGG block with the same numbers')
        self.use_bn = use_bn
        self.layers: List[str] = []  # per stage: 'conv', 'bn', 'relu', 'pool'
        self.stage_channels: List[int] = []
        self.aux_channels = {}
        c, conv = 3, 0
        for item in config:
            if item == 'M':
                self.layers.append('pool')
                self.stage_channels.append(c)
                continue
            item = (width_overrides or {}).get(conv, item)
            self.add_module(f'conv{conv}', conv2d(c, item, 3, padding=1,
                                                  bias=True))
            self.layers.append(f'conv{conv}')
            if use_bn:
                self.add_module(f'bn{conv}', batch_norm(item))
                self.layers.append(f'bn{conv}')
            self.layers.append('relu')
            c = item
            self.stage_channels += [c] * (3 if use_bn else 2)
            conv += 1

    def forward(self, x, max_stage: Optional[int] = None):
        last = len(self.layers) - 1 if max_stage is None else max_stage
        stages = []
        for layer in self.layers[:last + 1]:
            if layer == 'pool':
                x = max_pool2d(x, 2, 2)
            elif layer == 'relu':
                x = F.relu(x)
            else:
                x = getattr(self, layer)(x)
            stages.append(x)
        return stages, {}
