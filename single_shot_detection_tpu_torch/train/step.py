"""Step functions.

Port of ``single_shot_detection_tpu/train/step.py::make_predict_step``; the
train and eval steps belong to the training slice.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn


def make_predict_step(module: nn.Module, postprocessor: Callable,
                      anchors: torch.Tensor) -> Callable:
    """Inference-only step: ``predict_step(images) -> (detections, valid)``
    for normalized ``[B, 3, H, W]`` images on the module's device."""

    @torch.inference_mode()
    def predict_step(images: torch.Tensor):
        scores, locs = module(images)
        return postprocessor(scores.float(), locs.float(), anchors)

    return predict_step
