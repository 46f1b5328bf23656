"""Backbone registry: ``name -> factory``.

Port of ``single_shot_detection_tpu/models/backbones.py``, every name of it:
MobileNetV2, MobileNet v1, VGG, ResNet, ResNeXt, SE-ResNet(Xt) and
ShuffleNetV2.  Every backbone's ``forward(x, max_stage=None)``
returns ``(stages, aux)`` with the JAX package's stage indexing, so sample
configs carry over unchanged.  A factory drops the config's keyword
arguments that the JAX package's factory drops.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

from single_shot_detection_tpu_torch.models.mobilenet import MobileNet
from single_shot_detection_tpu_torch.models.mobilenet_v2 import MobileNetV2
from single_shot_detection_tpu_torch.models.resnet import (RESNET_CONFIGS,
                                                           ResNet, SEResNet)
from single_shot_detection_tpu_torch.models.shufflenet_v2 import (
    SHUFFLENET_WIDTHS, ShuffleNetV2)
from single_shot_detection_tpu_torch.models.vgg import VGG, VGG_CONFIGS


def _mbv2(depth_multiplier: float = 1.0, min_depth: int = 4,
          width_overrides=None, **_):
    return MobileNetV2(depth_multiplier=depth_multiplier, min_depth=min_depth,
                       width_overrides=width_overrides)


def _mbv1(depth_multiplier: float = 1.0, min_depth: int = 4,
          width_overrides=None, **_):
    return MobileNet(depth_multiplier=depth_multiplier, min_depth=min_depth,
                     width_overrides=width_overrides)


def _shufflenet_v2(mult: float, **_):
    return ShuffleNetV2(SHUFFLENET_WIDTHS[mult])


def _vgg(depth: int, bn: bool, packed_stem: bool = False,
         width_overrides=None, **_):
    return VGG(VGG_CONFIGS[depth], use_bn=bn, packed_stem=packed_stem,
               width_overrides=width_overrides)


def _resnet(depth: int, groups: int, width_per_group: int,
            width_overrides=None, **_):
    return ResNet(**RESNET_CONFIGS[depth], groups=groups,
                  width_per_group=width_per_group,
                  width_overrides=width_overrides)


def _se_resnet(layers, groups: int, width_per_group: int, **_):
    return SEResNet(layers=layers, groups=groups,
                    width_per_group=width_per_group)


_REGISTRY: Dict[str, Callable] = {
    'mobilenet_v2': _mbv2,
    'torchvision_mobilenet_v2': _mbv2,
    # custom width multipliers ('05' is a compat alias of '050')
    **{f'mobilenet_v2_{suffix}': functools.partial(_mbv2, depth_multiplier=mult)
       for mult, suffix in [(1.0, '10'), (0.75, '075'), (0.5, '050'),
                            (0.5, '05'), (0.35, '035')]},
    'mobilenet_v1': _mbv1,
    **{f'mobilenet_{suffix}': functools.partial(_mbv1, depth_multiplier=mult)
       for mult, suffix in [(1.0, '10'), (0.75, '075'), (0.5, '050'),
                            (0.5, '05'), (0.25, '025')]},
    **{f'torchvision_vgg{depth}' + ('_bn' if bn else ''):
       functools.partial(_vgg, depth, bn)
       for depth in (11, 13, 16, 19) for bn in (False, True)},
    **{f'torchvision_resnet{depth}': functools.partial(_resnet, depth, 1, 64)
       for depth in (18, 34, 50, 101, 152)},
    **{f'torchvision_resnext{depth}_{groups}x{width}d': functools.partial(
        _resnet, depth, groups, width)
       for depth, groups, width in [(50, 32, 4), (101, 32, 8)]},
    **{f'pretrainedmodels_{name}': functools.partial(
        _se_resnet, layers, groups, width)
       for name, layers, groups, width in [
           ('se_resnet50', (3, 4, 6, 3), 1, 64),
           ('se_resnet101', (3, 4, 23, 3), 1, 64),
           ('se_resnet152', (3, 8, 36, 3), 1, 64),
           ('se_resnext50_32x4d', (3, 4, 6, 3), 32, 4),
           ('se_resnext101_32x4d', (3, 4, 23, 3), 32, 4)]},
    **{f'torchvision_shufflenet_v2_{suffix}': functools.partial(
        _shufflenet_v2, mult)
       for mult, suffix in [(0.5, 'x0_5'), (1.0, 'x1_0'), (1.5, 'x1_5'),
                            (2.0, 'x2_0')]},
}


def available() -> list:
    return sorted(_REGISTRY)


def get(name: str) -> Callable:
    if name not in _REGISTRY:
        raise KeyError(f'Unknown backbone: {name!r}. '
                       f'Available: {sorted(_REGISTRY)}')
    return _REGISTRY[name]
