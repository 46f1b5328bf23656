"""Feature necks: plain backbone taps, the FPN, the depthwise FPN and
M2Det's MLFPN (NCHW).

Port of ``single_shot_detection_tpu/models/features.py``: ``Features``,
``FeaturePyramid``, ``DepthwiseFeaturePyramid`` and
``MultilevelFeaturePyramid`` with its ``ThinnedUshapeModule`` and
``ScalewiseFeatureAggregationModule``.  Every neck's ``forward(x)`` returns
``(sources, x)``: the per-scale maps (large -> small) and the map that
feeds the SSD extras.  Flax infers a conv's input width; here each module
computes it when it is built, and exposes its outputs' widths as
``channels`` and ``out_channels``.  The MLFPN runs in ``tum_range``
segments for the pipeline's stages (``parallel/pipeline.py``).

The model axis: a resize's target size is the global one
(``layers.spatial_size``), and a resize, pool or mean runs height-sharded
under ``spatial_sharding``; under ``tensor_sharding`` a concat and an
elementwise op gather a channel-sliced map first (``parallel/tensor.py``).
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from single_shot_detection_tpu_torch.models.layers import (ConvBn,
                                                           DepthwiseConvBn,
                                                           conv2d,
                                                           get_initializer,
                                                           max_pool2d, mean_hw,
                                                           spatial_size,
                                                           xavier_normal)
from single_shot_detection_tpu_torch.parallel import spatial, tensor


# the JAX package's modes -> ``F.interpolate``'s
_MODES = {'nearest': 'nearest-exact', 'bilinear': 'bilinear',
          'linear': 'bilinear'}


def interpolate(x: torch.Tensor, size: Tuple[int, int],
                mode: str = 'nearest') -> torch.Tensor:
    """Resize ``[B, C, H, W]`` to ``size = (h, w)`` as ``jax.image.resize``
    does.  Its ``nearest`` takes source index ``floor((i + 0.5) * in /
    out)``, which is torch's ``nearest-exact`` (torch's ``nearest`` takes
    ``floor(i * in / out)`` and differs on sizes that are not exact
    multiples, such as 32 -> 63).  Its ``linear`` (the modes ``'bilinear'``
    and ``'linear'``) is torch's ``bilinear`` at half-pixel centres: on an
    enlargement, the only resize the necks make, neither antialiases, and
    the edge weights agree (JAX renormalizes the taps inside the map, torch
    clamps to the edge); the interior weights differ by the rounding of the
    source coordinate, at most 1e-6 of a weight at 32 -> 63.  Under
    ``spatial_sharding`` ``size`` is the global size and ``x`` a height
    shard (``parallel/spatial.py``)."""
    _check_mode(mode)
    if spatial.active():
        return spatial.interpolate(
            x, size, 'bilinear' if _MODES[mode] == 'bilinear' else 'nearest')
    if _MODES[mode] == 'bilinear':
        return F.interpolate(x, size=tuple(size), mode='bilinear',
                             align_corners=False, antialias=False)
    return F.interpolate(x, size=tuple(size), mode='nearest-exact')


def _check_mode(mode: str) -> None:
    if mode not in _MODES:
        raise ValueError(f'interpolation mode {mode!r} is not one of '
                         f'{sorted(_MODES)}')


def _taps(out_layers: Sequence) -> list:
    return [tuple(l) if isinstance(l, (tuple, list)) else l
            for l in out_layers]


def _tap_channels(base: nn.Module, layer) -> int:
    return (base.aux_channels[layer] if isinstance(layer, tuple)
            else base.stage_channels[layer])


def _select(stages, aux, out_layers) -> list:
    return [aux[l] if isinstance(l, tuple) else stages[l] for l in out_layers]


def _cat(maps, widths) -> torch.Tensor:
    """Concatenate along channels, each map with all its ``widths``
    (gathered where tensor sharding holds a slice)."""
    return torch.cat([tensor.full(m, c) for m, c in zip(maps, widths)], dim=1)


def _add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = tensor.align(a, b)
    return a + b


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
    ``width_overrides`` (``{'lateral': n, 'output': (n0, ...)}``) gives the
    narrow widths of a pruned model (``train/materialize.py``): one width
    for the laterals, which the top-down adds join, and one per output
    conv; a depthwise output conv follows its input's width.
    """

    def __init__(self, base: nn.Module, out_layers: Sequence,
                 pyramid_layers: int, pyramid_channels: int,
                 interpolation_mode: str = 'nearest',
                 use_depthwise: bool = False,
                 activation: Optional[str] = 'ReLU',
                 last_feature_layer: Optional[int] = None,
                 initializer: Optional[Mapping] = None,
                 width_overrides: Optional[Mapping] = None):
        super().__init__()
        if pyramid_layers < len(out_layers):
            raise ValueError(f'pyramid_layers={pyramid_layers} < '
                             f'{len(out_layers)} out_layers')
        _check_mode(interpolation_mode)
        self.base = base
        self.out_layers = _taps(out_layers)
        self.pyramid_layers = pyramid_layers
        self.interpolation_mode = interpolation_mode
        self.last_feature_layer = last_feature_layer
        init = get_initializer(initializer, xavier_normal)
        overrides = width_overrides or {}
        lateral = overrides.get('lateral', pyramid_channels)
        outputs = overrides.get('output')
        for i, layer in enumerate(self.out_layers):
            self.add_module(f'lateral{i}', conv2d(
                _tap_channels(base, layer), lateral, 1, bias=True,
                kernel_init=init))
        self.channels = []
        for i in range(pyramid_layers):
            extra = i >= len(self.out_layers)
            c = self.channels[-1] if extra else lateral
            width = c if use_depthwise else (
                outputs[i] if outputs and outputs[i] else pyramid_channels)
            self.add_module(f'output{i}', ConvBn(
                c, width, kernel_size=3, stride=2 if extra else 1, padding=1,
                groups=c if use_depthwise else 1,
                activation=activation, kernel_init=init))
            self.channels.append(width)
        self.out_channels = self.channels[-1]

    def forward(self, x):
        stages, aux = self.base(x, max_stage=self.last_feature_layer)
        sources = _select(stages, aux, self.out_layers)
        feats = [getattr(self, f'lateral{i}')(s) for i, s in enumerate(sources)]
        for i in reversed(range(len(feats) - 1)):
            feats[i] = _add(feats[i], interpolate(
                feats[i + 1], spatial_size(feats[i]), self.interpolation_mode))
        outputs = []
        for i in range(self.pyramid_layers):
            inp = outputs[-1] if i >= len(feats) else feats[i]
            outputs.append(getattr(self, f'output{i}')(inp))
        return outputs, outputs[-1]


class DepthwiseFeaturePyramid(nn.Module):
    """Lightweight dual-path FPN (arXiv 1807.11013): 1x1 laterals
    ``lateral{i}`` (with bias); per level beyond the taps, the concatenation
    of a pool branch (pad by ``(0, 1)`` with ``-inf`` along each spatial
    axis longer than 2, a 2x2 max-pool, the 1x1 ``down{i}_pool_conv``) and
    the depthwise-separable 3x3 stride-2 ``down{i}_dw``, each
    ``pyramid_channels // 2`` wide; then top-down: nearest upsample, the
    grouped 3x3 ``up{i}`` (``groups = pyramid_channels``), a lateral add.
    Convs take the config's ``initializer``, xavier-normal by default."""

    def __init__(self, base: nn.Module, out_layers: Sequence,
                 pyramid_layers: int, pyramid_channels: int,
                 interpolation_mode: str = 'nearest',
                 activation: Optional[str] = 'ReLU',
                 last_feature_layer: Optional[int] = None,
                 initializer: Optional[Mapping] = None):
        super().__init__()
        _check_mode(interpolation_mode)
        self.base = base
        self.out_layers = _taps(out_layers)
        self.num_down = pyramid_layers - len(self.out_layers)
        self.interpolation_mode = interpolation_mode
        self.last_feature_layer = last_feature_layer
        init = get_initializer(initializer, xavier_normal)
        common = dict(activation=activation, kernel_init=init)
        for i, layer in enumerate(self.out_layers):
            self.add_module(f'lateral{i}', conv2d(
                _tap_channels(base, layer), pyramid_channels, 1, bias=True,
                kernel_init=init))
        half = pyramid_channels // 2
        self.half = half
        for i in range(self.num_down):
            self.add_module(f'down{i}_pool_conv', ConvBn(
                pyramid_channels, half, kernel_size=1, **common))
            self.add_module(f'down{i}_dw', DepthwiseConvBn(
                pyramid_channels, half, kernel_size=3, stride=2, padding=1,
                **common))
        for i in range(pyramid_layers - 1):
            self.add_module(f'up{i}', ConvBn(
                pyramid_channels, pyramid_channels, kernel_size=3, padding=1,
                groups=pyramid_channels, **common))
        self.channels = [pyramid_channels] * pyramid_layers
        self.out_channels = pyramid_channels

    def forward(self, x):
        stages, aux = self.base(x, max_stage=self.last_feature_layer)
        sources = _select(stages, aux, self.out_layers)
        feats = [getattr(self, f'lateral{i}')(s) for i, s in enumerate(sources)]
        for i in range(self.num_down):
            prev = feats[-1]
            height, width = spatial_size(prev)
            # F.pad's widths: (left, right) of W, then (top, bottom) of H
            pad = (0, int(width > 2), 0, int(height > 2))
            pooled = max_pool2d(prev, 2, 2, pad=pad)
            feats.append(_cat([getattr(self, f'down{i}_pool_conv')(pooled),
                               getattr(self, f'down{i}_dw')(prev)],
                              (self.half, self.half)))
        output = [feats[-1]]
        for i in reversed(range(len(feats) - 1)):
            up = interpolate(output[-1], spatial_size(feats[i]),
                             self.interpolation_mode)
            output.append(_add(getattr(self, f'up{i}')(up), feats[i]))
        output.reverse()
        return output, output[-1]


class ThinnedUshapeModule(nn.Module):
    """M2Det's TUM: ``num_scales - 1`` 3x3 stride-2 down convs ``down{i}``
    of ``inner_channels``; up the path, a 1x1 ``up{i}`` to the skip's width,
    a nearest upsample to its size and the add; a 1x1 ``smooth`` conv to
    ``out_channels`` on each up-path output, named ``smooth{S - 1 - i}``
    for the i-th (deepest first, as the JAX module names them).
    ``forward`` returns the outputs deepest (small) -> shallowest (large).
    ``use_depthwise`` makes every conv depthwise-separable."""

    def __init__(self, in_channels: int, inner_channels: int,
                 out_channels: int, num_scales: int,
                 interpolation_mode: str = 'nearest',
                 use_depthwise: bool = False,
                 activation: Optional[str] = 'ReLU',
                 initializer: Optional[Mapping] = None):
        super().__init__()
        _check_mode(interpolation_mode)
        conv_op = DepthwiseConvBn if use_depthwise else ConvBn
        common = dict(activation=activation,
                      kernel_init=get_initializer(initializer, xavier_normal))
        self.num_scales = num_scales
        self.interpolation_mode = interpolation_mode
        # the down path's widths, the input's first
        widths = [in_channels] + [inner_channels] * (num_scales - 1)
        for i in range(1, num_scales):
            self.add_module(f'down{i}', conv_op(
                widths[i - 1], inner_channels, kernel_size=3, stride=2,
                padding=1, **common))
        up_widths = [widths[-1]]
        for i in reversed(range(1, num_scales)):
            self.add_module(f'up{i}', conv_op(up_widths[-1], widths[i - 1],
                                              kernel_size=1, **common))
            up_widths.append(widths[i - 1])
        for i, width in enumerate(up_widths):
            self.add_module(f'smooth{num_scales - 1 - i}', conv_op(
                width, out_channels, kernel_size=1, **common))

    def forward(self, x) -> List[torch.Tensor]:
        down_path = [x]
        for i in range(1, self.num_scales):
            x = getattr(self, f'down{i}')(x)
            down_path.append(x)
        up_path = [x]
        for i in reversed(range(1, self.num_scales)):
            skip = down_path[i - 1]
            x = _add(interpolate(getattr(self, f'up{i}')(x),
                                 spatial_size(skip), self.interpolation_mode),
                     skip)
            up_path.append(x)
        return [getattr(self, f'smooth{self.num_scales - 1 - i}')(feat)
                for i, feat in enumerate(up_path)]


class ScalewiseFeatureAggregationModule(nn.Module):
    """M2Det's SFAM: per scale ``i``, a squeeze-excite gate (the spatial
    mean, the 1x1 ``fc1_{i}`` with bias down to ``C // reduction_ratio``,
    ReLU, the 1x1 ``fc2_{i}`` with bias, a sigmoid) multiplied onto the
    map.  Convs take the neck's ``initializer``, xavier-normal by
    default.

    JAX's SFAM gives its convs no ``dtype``, so under bf16 flax promotes
    the bf16 mean with the f32 kernels to f32: the gates and the outputs
    (``feature * g``) are f32 there, and so they are here."""

    def __init__(self, channels: Sequence[int], reduction_ratio: int = 16,
                 initializer: Optional[Mapping] = None):
        super().__init__()
        init = get_initializer(initializer, xavier_normal)
        self.num_scales = len(channels)
        for i, c in enumerate(channels):
            self.add_module(f'fc1_{i}', conv2d(c, c // reduction_ratio, 1,
                                               bias=True, kernel_init=init))
            self.add_module(f'fc2_{i}', conv2d(c // reduction_ratio, c, 1,
                                               bias=True, kernel_init=init))

    def forward(self, features) -> List[torch.Tensor]:
        if len(features) != self.num_scales:
            raise ValueError(f'{len(features)} maps for {self.num_scales} '
                             'scales')
        result = []
        for i, feature in enumerate(features):
            g = mean_hw(feature).float()
            g = F.relu(getattr(self, f'fc1_{i}')(g))
            g = torch.sigmoid(getattr(self, f'fc2_{i}')(g))
            feature, g = tensor.align(feature, g)
            result.append(feature * g)
        return result


class MultilevelFeaturePyramid(nn.Module):
    """M2Det's MLFPN: 1x1 ``base_reducer{i}`` ``ConvBn``s on the taps, the
    smaller maps upsampled to the first's size and concatenated (the base
    feature); a chain of ``num_tums`` TUMs, TUM 0 on the base feature and
    TUM ``i > 0`` on ``[TUM i-1's shallowest output || reducer{i}(base)]``;
    each scale's outputs concatenated over the TUMs, large -> small, then
    the SFAM gates.  ``tum`` reads ``inner_channels``/``out_channels``
    (default 256/128), ``sfam`` reads ``reduction_ratio`` (16)."""

    def __init__(self, base: nn.Module, out_layers: Sequence,
                 num_scales: int, num_tums: int,
                 base_reduced_channels: Sequence[int] = (256, 512),
                 reduced_channels: int = 128,
                 interpolation_mode: str = 'nearest',
                 use_depthwise: bool = False,
                 activation: Optional[str] = 'ReLU',
                 tum: Optional[Mapping] = None,
                 sfam: Optional[Mapping] = None,
                 last_feature_layer: Optional[int] = None,
                 initializer: Optional[Mapping] = None):
        super().__init__()
        if len(out_layers) != len(base_reduced_channels):
            raise ValueError(f'{len(out_layers)} out_layers vs '
                             f'{len(base_reduced_channels)} '
                             'base_reduced_channels')
        if num_tums < 1:
            raise ValueError(f'num_tums={num_tums}: at least one TUM')
        _check_mode(interpolation_mode)
        tum_cfg = dict(tum or {'inner_channels': 256, 'out_channels': 128})
        tum_cfg = {k: v for k, v in tum_cfg.items()
                   if k in ('inner_channels', 'out_channels')}
        self.base = base
        self.out_layers = _taps(out_layers)
        self.num_tums = num_tums
        self.interpolation_mode = interpolation_mode
        self.last_feature_layer = last_feature_layer
        common = dict(activation=activation,
                      kernel_init=get_initializer(initializer, xavier_normal))
        for i, (layer, c) in enumerate(zip(self.out_layers,
                                           base_reduced_channels)):
            self.add_module(f'base_reducer{i}', ConvBn(
                _tap_channels(base, layer), c, kernel_size=1, **common))
        base_width = sum(base_reduced_channels)
        tum_kw = dict(num_scales=num_scales,
                      interpolation_mode=interpolation_mode,
                      use_depthwise=use_depthwise, activation=activation,
                      initializer=initializer, **tum_cfg)
        out = tum_cfg['out_channels']
        self.tum0 = ThinnedUshapeModule(base_width, **tum_kw)
        for i in range(1, num_tums):
            self.add_module(f'reducer{i}', ConvBn(
                base_width, reduced_channels, kernel_size=1, **common))
            self.add_module(f'tum{i}', ThinnedUshapeModule(
                out + reduced_channels, **tum_kw))
        self.base_widths = list(base_reduced_channels)
        self.tum_widths = (out, reduced_channels)
        self.channels = [out * num_tums] * num_scales
        self.out_channels = out * num_tums
        self.sfam = ScalewiseFeatureAggregationModule(
            self.channels,
            reduction_ratio=dict(sfam or {}).get('reduction_ratio', 16),
            initializer=initializer)

    def forward(self, x, tum_range: Optional[Tuple[int, int]] = None,
                stage_state=None):
        """``tum_range=(a, b)`` runs a segment for the pipeline's stages,
        as the JAX module does: ``a == 0`` includes the backbone and the
        base feature, ``b == num_tums`` the final concat and SFAM
        (returning ``(features, last)``); an interior segment takes and
        returns the chain's state ``(base feature, per-scale outputs so
        far)``."""
        a, b = (0, self.num_tums) if tum_range is None else tum_range
        if a == 0:
            stages, aux = self.base(x, max_stage=self.last_feature_layer)
            sources = _select(stages, aux, self.out_layers)
            reduced = [getattr(self, f'base_reducer{i}')(s)
                       for i, s in enumerate(sources)]
            size = spatial_size(reduced[0])
            base_features = _cat([reduced[0]] + [
                interpolate(r, size, self.interpolation_mode)
                for r in reduced[1:]], self.base_widths)
            per_scale = None
        else:
            base_features, per_scale_t = stage_state
            per_scale = [list(fs) for fs in per_scale_t]
        out, red_width = self.tum_widths
        for i in range(a, b):
            if i == 0:
                per_scale = [[f] for f in self.tum0(base_features)]
                continue
            red = getattr(self, f'reducer{i}')(base_features)
            tum_in = _cat([per_scale[-1][-1], red], (out, red_width))
            for s, feat in enumerate(getattr(self, f'tum{i}')(tum_in)):
                per_scale[s].append(feat)
        if tum_range is not None and b < self.num_tums:
            return base_features, tuple(tuple(fs) for fs in per_scale)
        features = self.sfam([_cat(fs, [out] * len(fs))
                              for fs in reversed(per_scale)])
        return features, features[-1]


NECKS = {
    'Features': Features,
    'FeaturePyramid': FeaturePyramid,
    'DepthwiseFeaturePyramid': DepthwiseFeaturePyramid,
    'MultilevelFeaturePyramid': MultilevelFeaturePyramid,
}
