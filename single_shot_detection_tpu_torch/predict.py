"""Serving entry point: ``Predictor``.

Port of the JAX package's serving path: ``Experiment.predict``
(``train/engine.py``), built from ``make_predict_step`` and the serving
postprocessor.  Staged uint8 images go through preprocessing, the eval-mode
forward (every BatchNorm a GroupNorm under ``train.group_norm``, as the JAX
engine serves such a model) and the postprocessor (hard NMS on the CUDA
kernel on a GPU) to ``[B, max_total, 6]`` detections and a ``valid`` mask.

``amax`` (``{conv key: input amax}``, from ``export/quantize.py::
calibrate`` or a QAT run's ``amax_from_batch_stats``) serves with those
convs in int8 (``make_quantized_predict_step``; ``spatial_limit`` keeps the
convs of larger inputs float), and composes with ``bf16``.

``bf16=True`` serves with bfloat16 activations (the heads at
``model.detector.heads.dtype`` when the config sets it; the postprocessor
takes f32 scores and locs) and ``matmul_precision`` sets the precision of
the convolutions (``device.py::numeric_policy``); each call runs under the
predictor's own flags.

Runs on ``cuda`` unless the caller passes ``device='cpu'``.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple, Union

import numpy as np
import torch

from single_shot_detection_tpu_torch.data.preprocess import Preprocess
from single_shot_detection_tpu_torch.device import (NumericPolicy,
                                                    numeric_policy,
                                                    resolve_device)
from single_shot_detection_tpu_torch.export import quantize
from single_shot_detection_tpu_torch.models import builder, norm
from single_shot_detection_tpu_torch.models.layers import set_group_norm
from single_shot_detection_tpu_torch.ops.box_coder import BoxCoder
from single_shot_detection_tpu_torch.ops.postprocess import Postprocessor
from single_shot_detection_tpu_torch.train.step import make_predict_step
from single_shot_detection_tpu_torch.utils.config import load_config
from single_shot_detection_tpu_torch.utils.misc import filter_kwargs


class Predictor:
    """A detector ready to answer requests on one device.

    Build it with :meth:`from_config`.  ``predict_batch`` takes a batch of
    uint8 ``[B, H, W, 3]`` RGB images; ``predict`` answers one image of any
    size in its own pixel coordinates.
    """

    def __init__(self, bundle: builder.DetectorBundle,
                 postprocessor: Postprocessor, preprocess: Preprocess,
                 device: torch.device, policy: NumericPolicy,
                 amax: Optional[Mapping[str, float]] = None,
                 spatial_limit: Optional[int] = None):
        self.bundle = bundle
        self.policy = policy
        self.device = device
        self.input_size = bundle.input_size
        self.model = bundle.module.to(device).eval()
        self.anchors = torch.from_numpy(bundle.anchors).to(device)
        self.postprocessor = postprocessor
        self.preprocess = preprocess
        if amax is None:
            self.predict_step = make_predict_step(self.model, postprocessor,
                                                  self.anchors)
        else:
            self.predict_step = quantize.make_quantized_predict_step(
                self.model, postprocessor, self.anchors, amax, spatial_limit)

    @classmethod
    def from_config(cls, path: str, variables: Optional[Mapping] = None,
                    device: Optional[Union[str, torch.device]] = None,
                    seed: Optional[int] = None, bf16: bool = False,
                    matmul_precision: Optional[str] = None,
                    amax: Optional[Mapping[str, float]] = None,
                    spatial_limit: Optional[int] = None) -> 'Predictor':
        """Build from a ``samples/*.py`` config.

        ``variables``: a JAX ``{'params', 'batch_stats'}`` tree (e.g. a
        restored checkpoint) loaded with ``strict=True``; without it the
        weights are the JAX package's initializers drawn from a
        ``torch.Generator`` seeded with ``seed`` (default: the config's).
        ``bf16`` and ``matmul_precision`` as ``device.py::numeric_policy``
        takes them; ``amax`` and ``spatial_limit`` serve int8.
        """
        device = resolve_device(device)
        cfg = load_config(path, phases=('eval',))
        quantize.check_composes(dict(cfg.train or {}), amax is not None)
        policy = numeric_policy(bf16, matmul_precision, cfg.train)
        bundle = builder.from_config(cfg, variables, seed, policy.dtype)
        set_group_norm(bundle.module, norm.groups_from_config(
            dict(cfg.train or {}).get('group_norm')))
        box_coder = filter_kwargs(BoxCoder)(**(cfg.box_coder or {}))
        pp_cfg = Postprocessor.serving_preset(
            cfg.postprocess, len(bundle.anchors))
        postprocessor = filter_kwargs(Postprocessor)(box_coder=box_coder,
                                                     **pp_cfg)
        preprocess = Preprocess(cfg.preprocessing, bundle.input_size)
        return cls(bundle, postprocessor, preprocess, device, policy, amax,
                   spatial_limit)

    def predict_batch(self, images: Union[np.ndarray, torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """uint8 ``[B, H, W, 3]`` RGB -> ``(detections [B, max_total, 6],
        valid [B, max_total])`` on the device, in input-size pixels.  Images
        of another size are resized to the input size first."""
        images = torch.as_tensor(images).to(self.device, non_blocking=True)
        with self.policy.scope():
            return self.predict_step(self.preprocess(images))

    def predict(self, image: Union[np.ndarray, torch.Tensor]) -> np.ndarray:
        """One uint8 ``[H, W, 3]`` RGB image of any size -> ``[n, 6]`` valid
        detections ``[x0, y0, x1, y1, class, score]`` in its own pixels."""
        h, w = image.shape[:2]
        dets, valid = self.predict_batch(torch.as_tensor(image)[None])
        dets = dets[0][valid[0]].cpu().numpy()
        dets[:, [0, 2]] *= w / self.input_size[0]
        dets[:, [1, 3]] *= h / self.input_size[1]
        return dets
