"""Detector assembly: SSD extras, the shared-conv predictor, per-scale heads
(NCHW).

Port of ``single_shot_detection_tpu/models/detector.py`` (``ExtraLayer``,
``SharedConvPredictor``, ``Detector``, ``tum_stage_chunks``), with the
pipeline-parallel stage seam (``Detector.forward``'s ``stage``).

The model axis (``parallel/``): under ``spatial_sharding`` the detector
keeps this rank's rows of the image at its entry and gathers each head's
output along the anchor axis; under ``tensor_sharding`` a head whose
``cout`` is sliced is gathered along channels before its reshape.

Anchor order: the JAX heads are NHWC, and ``[B, H, W, nb*C]`` reshapes to
``[B, H*W*nb, C]``, the anchors' ``(H, W, box)`` order.  Here the heads are
NCHW, so each output is permuted to NHWC before that reshape.

Initializers: every conv carries its own (``layers.conv2d``), as the JAX
package gives each flax module its ``kernel_init``; ``reset_parameters``
draws them in module order from one generator.

Compute dtype: ``Detector(dtype=torch.bfloat16)`` casts the image once at
its entry and every layer follows its input (``models/layers.py``); the
score and loc heads run at ``head_dtype`` (None: the body's).  Where the
JAX modules take a ``dtype`` and are handed a map of another (M2Det's f32
SFAM outputs under bf16), their convs cast it: the extras (but a max-pool
extra) and the predictor's towers to ``dtype``, the heads to
``head_dtype``.
"""

from __future__ import annotations

import itertools
from typing import Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from single_shot_detection_tpu_torch.models.layers import (ACTIVATIONS,
                                                           ConvBn,
                                                           DepthwiseConvBn,
                                                           batch_norm, conv2d,
                                                           get_initializer,
                                                           max_pool2d, normal,
                                                           reset_conv,
                                                           xavier_normal)
from single_shot_detection_tpu_torch.parallel import spatial, tensor

# the JAX package's defaults: normal(0.01) towers and heads, xavier-normal
# extras
head_kernel_init = normal(0.01)
_TOKENS = itertools.count()


class ExtraLayer(nn.Module):
    """One SSD extra-scale block from a spec tuple.

    type 'm': 3x3/2 maxpool (channels preserved);
    type 's': 1x1 reduce to out//2, then 3x3/2 conv to out (padding 1);
    type '':  1x1 reduce to out//2, then 3x3 valid conv to out.
    Convs take the config's ``initializer``, xavier-normal by default.
    ``reduce_features`` (default ``out_channels // 2``) is the reduce conv's
    width, a pruned model's narrow one (``train/materialize.py``).
    """

    def __init__(self, type: str, in_channels: int, out_channels: int,
                 use_depthwise: bool = False,
                 initializer: Optional[Mapping] = None,
                 reduce_features: Optional[int] = None):
        super().__init__()
        if type not in ('m', 's', ''):
            raise ValueError(f'Unknown layer type: {type}')
        self.type = type
        self.out_channels = in_channels if type == 'm' else out_channels
        if type == 'm':
            return
        init = get_initializer(initializer, xavier_normal)
        reduce_f = (out_channels // 2 if reduce_features is None
                    else reduce_features)
        self.reduce = ConvBn(in_channels, reduce_f, kernel_size=1,
                             kernel_init=init)
        conv_op = DepthwiseConvBn if use_depthwise else ConvBn
        self.expand = conv_op(reduce_f, out_channels, kernel_size=3,
                              stride=2 if type == 's' else 1,
                              padding=1 if type == 's' else 0,
                              kernel_init=init)

    def forward(self, x):
        if self.type == 'm':
            return max_pool2d(x, 3, 2, padding=1)
        return self.expand(self.reduce(x))


class SharedConvPredictor(nn.Module):
    """RetinaNet-style towers: per head (``score``, ``loc``) ``num_layers``
    convs, each one module applied to every pyramid level (so its gradient
    sums over them), each followed by the activation and then a BatchNorm of
    its own per level.

    Children: ``{head}_conv{l}`` (a bias-carrying ``ConvBn`` without BN, or
    ``DepthwiseConvBn``) and ``{head}_norm{l}_{level}``.  Convs take the
    config's ``initializer``, normal(0.01) by default.
    """

    def __init__(self, in_channels: int, num_levels: int, num_layers: int = 0,
                 num_channels: int = 256, kernel_size: int = 3,
                 use_depthwise: bool = False, activation='ReLU',
                 initializer: Optional[Mapping] = None):
        super().__init__()
        if isinstance(activation, Mapping):  # the configs' {'name': ...}
            activation = activation['name']
        self.activation = activation
        self.num_layers = num_layers
        self.num_channels = num_channels
        init = get_initializer(initializer, head_kernel_init)
        for head in ('score', 'loc'):
            c = in_channels
            for layer in range(num_layers):
                conv_op = DepthwiseConvBn if use_depthwise else ConvBn
                self.add_module(f'{head}_conv{layer}', conv_op(
                    c, num_channels, kernel_size=kernel_size, padding=1,
                    use_bias=True, use_bn=False, activation=None,
                    kernel_init=init))
                for level in range(num_levels):
                    self.add_module(f'{head}_norm{layer}_{level}',
                                    batch_norm(num_channels))
                c = num_channels

    def forward(self, sources):
        act = ACTIVATIONS[self.activation]
        outputs = []
        for head in ('score', 'loc'):
            feats = list(sources)
            for layer in range(self.num_layers):
                conv = getattr(self, f'{head}_conv{layer}')
                feats = [getattr(self, f'{head}_norm{layer}_{level}')(act(conv(f)))
                         for level, f in enumerate(feats)]
            outputs.append(feats)
        return outputs[0], outputs[1]


def tum_stage_chunks(num_tums: int, n_stages: int):
    """Split a TUM chain into per-pipeline-stage ``(a, b)`` segments (the
    JAX package's): an even spread, the remainder to the early stages
    (the last also runs SFAM, the extras, the predictor and the heads).
    The first segment must not be empty (stage 0 prepares the base feature
    the first TUM reads)."""
    if n_stages < 2:
        raise ValueError(f'n_stages must be >= 2, got {n_stages}')
    base, rem = divmod(num_tums, n_stages)
    sizes = [base + (1 if i < rem else 0) for i in range(n_stages)]
    if sizes[0] == 0:
        raise ValueError(
            f'{n_stages} pipeline stages need at least {n_stages - 1} TUMs '
            f'(got {num_tums})')
    bounds = []
    start = 0
    for s in sizes:
        bounds.append((start, start + s))
        start += s
    return bounds


class Detector(nn.Module):
    """features -> extras -> [predictor towers] -> per-scale heads ->
    concatenated ``(scores [B, A, C], locs [B, A, 4])``.

    Children carry the flax names: ``features``, ``extra{i}``,
    ``predictor``, ``score_head{i}``, ``loc_head{i}``.  ``predictor`` is the
    config's block (``num_layers``, ``num_channels``, ``kernel_size``,
    ``activation``, ``initializer``); heads take ``head_initializer``
    (normal(0.01) by default) and the score heads' bias
    ``score_head_bias_init``.  ``dtype`` is the compute dtype and
    ``head_dtype`` the heads' (None: ``dtype``); parameters stay f32.
    ``extras_overrides`` (one ``{'reduce': n, 'out': n}`` or None per
    extra) gives a pruned model's narrow extras (``train/materialize.py``).
    """

    def __init__(self, features: nn.Module, num_classes: int,
                 extras: Sequence[Tuple[str, int]] = (),
                 num_boxes: Sequence[int] = (), use_depthwise: bool = False,
                 predictor: Optional[Mapping] = None,
                 score_head_bias_init: float = 0.0,
                 extras_initializer: Optional[Mapping] = None,
                 head_initializer: Optional[Mapping] = None,
                 dtype: torch.dtype = torch.float32,
                 head_dtype: Optional[torch.dtype] = None,
                 extras_overrides: Optional[Sequence[Optional[Mapping]]] = None):
        super().__init__()
        self.token = next(_TOKENS)  # the detector's key of spatial heights
        self.dtype = dtype
        self.head_dtype = dtype if head_dtype is None else head_dtype
        self.features = features
        self.num_classes = num_classes
        self.num_extras = len(extras)
        channels = list(features.channels)
        c = features.out_channels
        for i, (type_, out_channels) in enumerate(extras):
            override = (extras_overrides[i] if extras_overrides else None) or {}
            extra = ExtraLayer(type_, c, override.get('out', out_channels),
                               use_depthwise, extras_initializer,
                               reduce_features=override.get('reduce'))
            self.add_module(f'extra{i}', extra)
            c = extra.out_channels
            channels.append(c)
        if len(channels) != len(num_boxes):
            raise ValueError(f'{len(channels)} scales vs {len(num_boxes)} '
                             f'anchor generators')
        self.predictor = None
        if predictor is not None:
            kwargs = {k: v for k, v in dict(predictor).items()
                      if k in ('num_layers', 'num_channels', 'kernel_size',
                               'activation', 'initializer')}
            self.predictor = SharedConvPredictor(
                channels[0], len(channels), use_depthwise=use_depthwise,
                **kwargs)
            if self.predictor.num_layers:
                if len(set(channels)) != 1:
                    raise ValueError(f'the shared predictor needs one width '
                                     f'on every level, got {channels}')
                channels = [self.predictor.num_channels] * len(channels)
        init = get_initializer(head_initializer, head_kernel_init)
        for i, (nb, ch) in enumerate(zip(num_boxes, channels)):
            self.add_module(f'score_head{i}', conv2d(
                ch, nb * num_classes, 3, padding=1, bias=True,
                kernel_init=init, bias_init=score_head_bias_init))
            self.add_module(f'loc_head{i}', conv2d(
                ch, nb * 4, 3, padding=1, bias=True, kernel_init=init))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Every conv from its own initializer, drawn from ``generator`` in
        module order; identity BatchNorms."""
        for module in self.modules():
            if isinstance(module, nn.Conv2d):
                reset_conv(module, generator)
            elif isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()

    def forward(self, x, return_sources: bool = False,
                stage: Optional[int] = None, stage_state=None,
                n_stages: int = 2):
        """``return_sources`` also returns the maps the loc heads read (the
        predictor's loc towers, or the neck's and extras' maps).

        ``stage`` is the pipeline seam (``parallel/pipeline.py``), as the
        JAX module's: with ``n_stages=2`` stage 0 runs the backbone and
        neck and returns ``(sources, x)``, stage 1 takes that as
        ``stage_state`` and runs the extras, predictor and heads; with
        more stages (an MLFPN neck) stage 0 is the backbone, the base
        feature and the first TUM segment, the interior stages are TUM
        segments, and the last is the final segment, SFAM and the rest.
        Staged and full application share one ``state_dict``."""
        if stage is not None and n_stages > 2:
            num_tums = getattr(self.features, 'num_tums', None)
            if num_tums is None:
                raise ValueError(
                    f'n_stages={n_stages} pipeline stages need a '
                    f'MultilevelFeaturePyramid neck (a TUM chain to split); '
                    f'{type(self.features).__name__} supports 2 stages')
            a, b = tum_stage_chunks(num_tums, n_stages)[stage]
            if stage == 0:
                return self.features(x.to(self.dtype), tum_range=(a, b))
            if stage < n_stages - 1:
                return self.features(None, tum_range=(a, b),
                                     stage_state=stage_state)
            sources, x = self.features(None, tum_range=(a, b),
                                       stage_state=stage_state)
            sources = list(sources)
        elif stage == 1:
            sources, x = stage_state
            sources = list(sources)
        else:
            x = x.to(self.dtype)
            if spatial.active():
                spatial.begin(self.token, x.shape[2])
                x = spatial.own_rows(x)
            sources, x = self.features(x)
            sources = list(sources)
            if stage == 0:
                return tuple(sources), x
        for i in range(self.num_extras):
            extra = getattr(self, f'extra{i}')
            x = extra(x if extra.type == 'm' else x.to(self.dtype))
            sources.append(x)
        if self.predictor is not None and self.predictor.num_layers:
            score_sources, loc_sources = self.predictor(
                [s.to(self.dtype) for s in sources])
        else:
            score_sources = loc_sources = sources

        batch = x.shape[0]
        scores, locs = [], []
        for i, (ss, ls) in enumerate(zip(score_sources, loc_sources)):
            s_head = getattr(self, f'score_head{i}')
            l_head = getattr(self, f'loc_head{i}')
            s = tensor.full(s_head(ss.to(self.head_dtype)),
                            s_head.out_channels)
            l = tensor.full(l_head(ls.to(self.head_dtype)),
                            l_head.out_channels)
            if spatial.active():
                scores.append(spatial.gather_anchors(
                    s, s.shape[1] // self.num_classes))
                locs.append(spatial.gather_anchors(l, l.shape[1] // 4))
                continue
            # NCHW -> NHWC, then [B, H*W*nb, C]: the anchors' order
            scores.append(s.permute(0, 2, 3, 1).reshape(batch, -1,
                                                        self.num_classes))
            locs.append(l.permute(0, 2, 3, 1).reshape(batch, -1, 4))
        out_scores = torch.cat(scores, dim=1)
        out_locs = torch.cat(locs, dim=1)
        if return_sources:
            return out_scores, out_locs, loc_sources
        return out_scores, out_locs
