"""Feature necks: plain backbone taps and the FPN (NCHW).

Port of ``single_shot_detection_tpu/models/features.py``: ``Features`` and
``FeaturePyramid`` (the depthwise FPN and M2Det's MLFPN belong to a later
slice).  Every neck's ``forward(x)`` returns ``(sources, x)``: the
per-scale maps (large -> small) and the map that feeds the SSD extras.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from single_shot_detection_tpu_torch.models.layers import (ConvBn, conv2d,
                                                           get_initializer,
                                                           xavier_normal)


def interpolate(x: torch.Tensor, size: Tuple[int, int],
                mode: str = 'nearest') -> torch.Tensor:
    """Resize ``[B, C, H, W]`` to ``size = (h, w)`` as ``jax.image.resize``
    does: its ``nearest`` takes source index ``floor((i + 0.5) * in /
    out)``, which is torch's ``nearest-exact`` (torch's ``nearest`` takes
    ``floor(i * in / out)`` and differs on sizes that are not exact
    multiples, such as 32 -> 63)."""
    if mode != 'nearest':
        raise NotImplementedError(f'interpolation mode {mode!r} is not '
                                  'ported yet (ported: nearest)')
    return F.interpolate(x, size=tuple(size), mode='nearest-exact')


def _taps(out_layers: Sequence) -> list:
    return [tuple(l) if isinstance(l, (tuple, list)) else l
            for l in out_layers]


def _tap_channels(base: nn.Module, layer) -> int:
    return (base.aux_channels[layer] if isinstance(layer, tuple)
            else base.stage_channels[layer])


def _select(stages, aux, out_layers) -> list:
    return [aux[l] if isinstance(l, tuple) else stages[l] for l in out_layers]


class Features(nn.Module):
    """Backbone tap selector.

    ``out_layers`` entries are stage indices or ``(stage, inner_name)`` pairs
    (e.g. ``(13, 'expand_relu')``).  The base runs up to
    ``last_feature_layer`` (all of it by default), whose output is the
    returned ``x``: VGG's configs stop at stage 42, conv5_3's ReLU, so the
    extras start from its map rather than the last pool's.
    """

    def __init__(self, base: nn.Module, out_layers: Sequence,
                 last_feature_layer: Optional[int] = None):
        super().__init__()
        self.base = base
        self.out_layers = _taps(out_layers)
        self.last_feature_layer = last_feature_layer

    @property
    def channels(self) -> List[int]:
        """Widths of ``sources``."""
        return [_tap_channels(self.base, l) for l in self.out_layers]

    @property
    def out_channels(self) -> int:
        """Width of the returned ``x``."""
        last = (-1 if self.last_feature_layer is None
                else self.last_feature_layer)
        return self.base.stage_channels[last]

    def forward(self, x):
        stages, aux = self.base(x, max_stage=self.last_feature_layer)
        return _select(stages, aux, self.out_layers), stages[-1]


class FeaturePyramid(nn.Module):
    """FPN: 1x1 laterals ``lateral{i}`` (with bias), top-down nearest
    upsampling adds, 3x3 ``ConvBn`` outputs ``output{i}``, and the levels
    beyond the backbone's taps at stride 2 from the previous output.

    Convs take the config's ``initializer``, xavier-normal by default.
    ``use_depthwise`` makes each output conv grouped by its input's width.
    """

    def __init__(self, base: nn.Module, out_layers: Sequence,
                 pyramid_layers: int, pyramid_channels: int,
                 interpolation_mode: str = 'nearest',
                 use_depthwise: bool = False,
                 activation: Optional[str] = 'ReLU',
                 last_feature_layer: Optional[int] = None,
                 initializer: Optional[Mapping] = None):
        super().__init__()
        if pyramid_layers < len(out_layers):
            raise ValueError(f'pyramid_layers={pyramid_layers} < '
                             f'{len(out_layers)} out_layers')
        if interpolation_mode != 'nearest':
            raise NotImplementedError(f'interpolation mode {interpolation_mode!r} '
                                      'is not ported yet (ported: nearest)')
        self.base = base
        self.out_layers = _taps(out_layers)
        self.pyramid_layers = pyramid_layers
        self.interpolation_mode = interpolation_mode
        self.last_feature_layer = last_feature_layer
        init = get_initializer(initializer, xavier_normal)
        for i, layer in enumerate(self.out_layers):
            self.add_module(f'lateral{i}', conv2d(
                _tap_channels(base, layer), pyramid_channels, 1, bias=True,
                kernel_init=init))
        for i in range(pyramid_layers):
            extra = i >= len(self.out_layers)
            self.add_module(f'output{i}', ConvBn(
                pyramid_channels, pyramid_channels, kernel_size=3,
                stride=2 if extra else 1, padding=1,
                groups=pyramid_channels if use_depthwise else 1,
                activation=activation, kernel_init=init))
        self.channels = [pyramid_channels] * pyramid_layers
        self.out_channels = pyramid_channels

    def forward(self, x):
        stages, aux = self.base(x, max_stage=self.last_feature_layer)
        sources = _select(stages, aux, self.out_layers)
        feats = [getattr(self, f'lateral{i}')(s) for i, s in enumerate(sources)]
        for i in reversed(range(len(feats) - 1)):
            feats[i] = feats[i] + interpolate(feats[i + 1], feats[i].shape[2:],
                                              self.interpolation_mode)
        outputs = []
        for i in range(self.pyramid_layers):
            inp = outputs[-1] if i >= len(feats) else feats[i]
            outputs.append(getattr(self, f'output{i}')(inp))
        return outputs, outputs[-1]


NECKS = {'Features': Features, 'FeaturePyramid': FeaturePyramid}
