"""Config -> detector assembly.

Port of ``single_shot_detection_tpu/models/builder.py::build`` and
``DetectorBundle``.  Anchors are generated in numpy from the per-scale
feature-map sizes, which are probed once by a forward pass of a copy of the
model on the ``meta`` device (shapes only, no arithmetic, no memory).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from single_shot_detection_tpu_torch.models import backbones
from single_shot_detection_tpu_torch.models.detector import Detector
from single_shot_detection_tpu_torch.models.features import NECKS
from single_shot_detection_tpu_torch.ops import anchors as anchor_ops


@dataclasses.dataclass
class DetectorBundle:
    """Assembled model + anchors.

    ``module`` is the Detector (built on the CPU); ``anchors`` the flat
    ``[A, 4]`` centroid priors at ``input_size``, from the per-scale
    ``feature_map_sizes``.
    """

    module: Detector
    anchor_generators: list
    feature_map_sizes: List[Tuple[int, int]]  # per scale (w, h)
    anchors: np.ndarray
    input_size: Tuple[int, int]  # (w, h)
    num_classes: int


def feature_map_sizes(make_module: Callable[[], Detector],
                      img_size: Tuple[int, int]) -> List[Tuple[int, int]]:
    """Per-scale ``(w, h)`` feature-map sizes, from a forward of a copy of
    the model on the ``meta`` device."""
    w, h = img_size
    with torch.device('meta'):
        probe = make_module().eval()
        _, _, sources = probe(torch.empty(1, 3, h, w), return_sources=True)
    return [(s.shape[3], s.shape[2]) for s in sources]


def create_base(name: str, **kwargs):
    """Instantiate a backbone by registry name.  ``pretrained``/``weight``
    are not read here: weights come in through ``utils/weights.py``."""
    kwargs = {k: v for k, v in kwargs.items()
              if k not in ('pretrained', 'weight', 'hub_dir')}
    return backbones.get(name)(**kwargs)


def build(base: dict,
          anchor_generator: dict,
          num_classes: int,
          features: dict,
          use_depthwise: bool = False,
          extras: Optional[dict] = None,
          heads: Optional[dict] = None,
          input_size: Tuple[int, int] = (300, 300)) -> DetectorBundle:
    """Assemble backbone -> Features -> extras -> heads -> Detector."""
    extras = extras or {}
    heads = heads or {}
    extra_layers = tuple(tuple(l) for l in extras.get('layers', ()))

    features_cfg = dict(features)
    neck_name = features_cfg.pop('name')
    if neck_name not in NECKS:
        raise NotImplementedError(f'neck {neck_name!r} is not ported yet')
    generators = anchor_ops.build_anchor_generators(**anchor_generator)
    num_boxes = tuple(g.num_boxes for g in generators)

    def make_module() -> Detector:
        base_module = create_base(base['name'],
                                  **{k: v for k, v in base.items()
                                     if k != 'name'})
        neck = NECKS[neck_name](base_module, features_cfg['out_layers'])
        return Detector(neck, num_classes=num_classes, extras=extra_layers,
                        num_boxes=num_boxes, use_depthwise=use_depthwise,
                        score_head_bias_init=heads.get('score_head_bias_init',
                                                       0.0))

    fms = feature_map_sizes(make_module, tuple(input_size))
    return DetectorBundle(
        module=make_module(),
        anchor_generators=generators,
        feature_map_sizes=fms,
        anchors=anchor_ops.generate_anchors(generators, tuple(input_size), fms),
        input_size=tuple(input_size),
        num_classes=num_classes)
