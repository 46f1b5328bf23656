"""Config -> detector assembly.

Port of ``single_shot_detection_tpu/models/builder.py::build`` and
``DetectorBundle``.  Anchors are generated in numpy from the per-scale
feature-map sizes, which are probed once by a forward pass of a copy of the
model on the ``meta`` device (shapes only, no arithmetic, no memory).

``dtype`` is the compute dtype (``torch.bfloat16`` under ``--bf16``) and
``model.detector.heads.dtype`` (``'float32'``, ``'bfloat16'`` or
``'float16'``) the heads'; parameters are f32 in either.
"""

from __future__ import annotations

import dataclasses
import inspect
import os
from typing import Callable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from single_shot_detection_tpu_torch import parallel
from single_shot_detection_tpu_torch.export import quantize
from single_shot_detection_tpu_torch.models import backbones
from single_shot_detection_tpu_torch.models.detector import Detector
from single_shot_detection_tpu_torch.models.features import NECKS
from single_shot_detection_tpu_torch.ops import anchors as anchor_ops
from single_shot_detection_tpu_torch.utils.weights import (from_jax_variables,
                                                           reconcile_qat)


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
    # :func:`build`'s arguments, from which ``train/materialize.py``
    # rebuilds a pruned model at its narrow widths
    build_args: Optional[dict] = None


def feature_map_sizes(make_module: Callable[[], Detector],
                      img_size: Tuple[int, int]) -> List[Tuple[int, int]]:
    """Per-scale ``(w, h)`` feature-map sizes, from a forward of a copy of
    the model on the ``meta`` device (a whole model: no model axis)."""
    w, h = img_size
    with torch.device('meta'), parallel.model_axis_off():
        probe = make_module().eval()
        _, _, sources = probe(torch.empty(1, 3, h, w), return_sources=True)
    return [(s.shape[3], s.shape[2]) for s in sources]


def _torchhub_cache_dirs(hub_dir=None) -> List[str]:
    if hub_dir:
        return [str(hub_dir)]
    dirs = []
    if os.environ.get('TORCH_HOME'):
        dirs.append(os.path.join(os.environ['TORCH_HOME'], 'hub'))
    dirs.append(os.path.expanduser('~/.cache/torch/hub'))
    return dirs


def resolve_torchhub(name: str, hub_dir=None) -> Tuple[str, Optional[str]]:
    """Resolve a ``torchhub://repo:model`` backbone offline: ``model`` must
    be a registry backbone, and its weights, if any, are the first
    ``<model>*.pth`` or ``.pt`` in the ``checkpoints/`` of a torch-hub cache
    (``base.hub_dir``, else ``$TORCH_HOME/hub``, then
    ``~/.cache/torch/hub``).  Returns ``(registry name, weight path or
    None)``; another model raises ``ValueError``."""
    spec = name[len('torchhub://'):]
    model = spec.rsplit(':', 1)[-1].strip()
    if model not in backbones.available():
        raise ValueError(
            f'{name!r}: torch-hub modules are not run by the port; only '
            f'registry backbones can be resolved offline '
            f'({", ".join(backbones.available()[:6])}, ...). Either use a '
            f'registry name directly, or load torch weights from a file '
            f"via base={{'weight': 'state_dict.pt'}} "
            f'(utils/torch_import.py).')
    for d in _torchhub_cache_dirs(hub_dir):
        ckpt_dir = os.path.join(d, 'checkpoints')
        if not os.path.isdir(ckpt_dir):
            continue
        hits = sorted(f for f in os.listdir(ckpt_dir)
                      if f.startswith(model) and f.endswith(('.pth', '.pt')))
        if hits:
            return model, os.path.join(ckpt_dir, hits[0])
    return model, None


def create_base(name: str, **kwargs):
    """Instantiate a backbone by registry name, or a ``torchhub://repo:model``
    name that :func:`resolve_torchhub` resolves.  ``pretrained``/``weight``
    are not read here: weights come in through ``utils/torch_import.py``.
    ``width_overrides`` reaches the backbones that take it (MobileNetV2,
    MobileNet v1, VGG, ResNet)."""
    if name.startswith('torchhub://'):
        name, _ = resolve_torchhub(name, kwargs.get('hub_dir'))
    kwargs = {k: v for k, v in kwargs.items()
              if k not in ('pretrained', 'weight', 'hub_dir')}
    return backbones.get(name)(**kwargs)


# ``model.detector`` keys the builder reads; ``weight`` and
# ``torch_weight`` are read by ``train/engine.py``; any other raises
DETECTOR_KEYS = ('num_classes', 'use_depthwise', 'features', 'extras',
                 'predictor', 'heads')
_ENGINE_KEYS = ('weight', 'torch_weight')
HEAD_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
               'float16': torch.float16}


def build(base: dict,
          anchor_generator: dict,
          num_classes: int,
          features: dict,
          use_depthwise: bool = False,
          extras: Optional[dict] = None,
          predictor: Optional[dict] = None,
          heads: Optional[dict] = None,
          input_size: Tuple[int, int] = (300, 300),
          dtype: torch.dtype = torch.float32,
          width_overrides: Optional[Mapping] = None) -> DetectorBundle:
    """Assemble backbone -> neck -> extras -> predictor -> heads ->
    Detector.  Neck keyword arguments are filtered by the neck's signature,
    as the JAX builder filters them by the flax module's fields (so
    ``features.width_overrides`` reaches the FPN, as in the JAX package).
    ``width_overrides`` (``{'base': ..., 'extras': ...}``) are a pruned
    model's narrow widths for the backbone and the extras
    (``train/materialize.py``), which the JAX package sets on the flax
    modules themselves."""
    build_args = dict(base=base, anchor_generator=anchor_generator,
                      num_classes=num_classes, features=features,
                      use_depthwise=use_depthwise, extras=extras,
                      predictor=predictor, heads=heads,
                      input_size=tuple(input_size), dtype=dtype)
    narrow = dict(width_overrides or {})
    extras = extras or {}
    heads = heads or {}
    extra_layers = tuple(tuple(l) for l in extras.get('layers', ()))
    head_dtype = heads.get('dtype')
    if isinstance(head_dtype, str):
        head_dtype = HEAD_DTYPES[head_dtype]

    features_cfg = dict(features)
    neck_name = features_cfg.pop('name')
    if neck_name not in NECKS:
        raise NotImplementedError(f'neck {neck_name!r} is not ported yet')
    Neck = NECKS[neck_name]
    accepted = inspect.signature(Neck).parameters
    neck_kwargs = {k: v for k, v in features_cfg.items() if k in accepted}
    if 'use_depthwise' in accepted:
        neck_kwargs.setdefault('use_depthwise', use_depthwise)
    # the neck's output count (``channels``) against the generators is
    # checked by ``Detector``
    generators = anchor_ops.build_anchor_generators(**anchor_generator)
    num_boxes = tuple(g.num_boxes for g in generators)
    # a config's base.width_overrides is dropped, as the JAX package's
    # backbone factories drop it
    base_kwargs = {k: v for k, v in base.items()
                   if k not in ('name', 'width_overrides')}
    if narrow.get('base') is not None:
        base_kwargs['width_overrides'] = narrow['base']

    def make_module() -> Detector:
        return Detector(
            NECKS[neck_name](create_base(base['name'], **base_kwargs),
                             **neck_kwargs),
            num_classes=num_classes, extras=extra_layers,
            num_boxes=num_boxes, use_depthwise=use_depthwise,
            predictor=predictor,
            score_head_bias_init=heads.get('score_head_bias_init', 0.0),
            extras_initializer=extras.get('initializer'),
            head_initializer=heads.get('initializer'),
            dtype=dtype, head_dtype=head_dtype,
            extras_overrides=narrow.get('extras'))

    fms = feature_map_sizes(make_module, tuple(input_size))
    return DetectorBundle(
        module=make_module(),
        anchor_generators=generators,
        feature_map_sizes=fms,
        anchors=anchor_ops.generate_anchors(generators, tuple(input_size), fms),
        input_size=tuple(input_size),
        num_classes=num_classes,
        build_args=build_args)


def from_config(cfg, variables: Optional[Mapping] = None,
                seed: Optional[int] = None,
                dtype: torch.dtype = torch.float32) -> DetectorBundle:
    """Build the detector of a loaded config, with weights.

    ``variables``: a JAX ``{'params', 'batch_stats'}`` tree (e.g. a restored
    checkpoint) loaded with ``strict=True``; without it the weights are the
    JAX package's initializers drawn from a ``torch.Generator`` seeded with
    ``seed`` (default: the config's).  ``dtype`` is the compute dtype.
    Under ``train.qat`` every dense conv gets its ``act_amax`` buffer and
    QAT's mode first (``export/quantize.py::qat_init``), and the variables'
    ``act_amax`` entries are reconciled as a checkpoint restore does.  A
    ``model.detector`` key the port does not read raises
    ``NotImplementedError``.
    """
    model_cfg = dict(cfg.model)
    detector_cfg = dict(model_cfg.get('detector', {}))
    if 'num_classes' not in detector_cfg:
        raise ValueError('model.detector.num_classes is required')
    unread = sorted(k for k, v in detector_cfg.items()
                    if k not in DETECTOR_KEYS + _ENGINE_KEYS
                    and v is not None)
    if unread:
        raise NotImplementedError(f'model.detector.{", ".join(unread)}: not '
                                  'ported yet')
    bundle = build(
        base=model_cfg['base'],
        anchor_generator=model_cfg['anchor_generator'],
        input_size=tuple(cfg.input_size), dtype=dtype,
        **{k: v for k, v in detector_cfg.items() if k in DETECTOR_KEYS})
    qat = quantize.qat_options(dict(cfg.train or {}).get('qat'))
    if qat is not None:
        quantize.qat_init(bundle.module, **qat)
    if variables is not None:
        bundle.module.load_state_dict(reconcile_qat(
            from_jax_variables(variables), bundle.module.state_dict()),
            strict=True)
    else:
        generator = torch.Generator().manual_seed(
            int(cfg.seed if seed is None else seed))
        bundle.module.reset_parameters(generator)
    return bundle
