"""Backbone registry: ``name -> factory``.

Port of ``single_shot_detection_tpu/models/backbones.py``, holding the
MobileNetV2 names only (the rest of the model zoo is a later slice).  Every
backbone's ``forward(x)`` returns ``(stages, aux)`` with the
JAX package's stage indexing, so sample configs carry over unchanged.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

from single_shot_detection_tpu_torch.models.mobilenet_v2 import MobileNetV2


def _mbv2(depth_multiplier: float = 1.0, min_depth: int = 4, **_):
    return MobileNetV2(depth_multiplier=depth_multiplier, min_depth=min_depth)


_REGISTRY: Dict[str, Callable] = {
    'mobilenet_v2': _mbv2,
    'torchvision_mobilenet_v2': _mbv2,
    # custom width multipliers ('05' is a compat alias of '050')
    **{f'mobilenet_v2_{suffix}': functools.partial(_mbv2, depth_multiplier=mult)
       for mult, suffix in [(1.0, '10'), (0.75, '075'), (0.5, '050'),
                            (0.5, '05'), (0.35, '035')]},
}


def get(name: str) -> Callable:
    if name not in _REGISTRY:
        raise KeyError(f'Unknown backbone: {name!r}. '
                       f'Available: {sorted(_REGISTRY)}')
    return _REGISTRY[name]
