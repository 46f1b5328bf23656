"""Step functions.

Port of ``single_shot_detection_tpu/train/step.py``: ``make_train_step``
(without mixup, ``frozen_bn``, EMA, QAT and the pipeline-parallel pinning,
which are not ported yet) and ``make_predict_step``.  The eval step belongs
to a later slice.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from single_shot_detection_tpu_torch.train.state import TrainState


def make_train_step(criterion, assigner, anchors: torch.Tensor,
                    schedule: Callable[[int], float],
                    preprocess) -> Callable:
    """Build ``train_step(state, images, boxes, box_mask) -> metrics``.

    One step: preprocess (``Preprocess.train_batch``) -> ``TargetAssigner``
    -> train-mode forward (BN batch statistics; the running statistics are
    updated in the forward) -> ``MultiboxLoss`` on f32 heads -> backward ->
    SGD step at ``schedule(state.step) * state.lr_scale``.  ``state`` is
    updated in place; the metrics ``{'loss', 'class_loss', 'loc_loss'}``
    are 0-dim tensors on the device (reading them waits for the step).
    """

    def train_step(state: TrainState, images: torch.Tensor,
                   boxes: torch.Tensor, box_mask: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
        x, boxes, box_mask = preprocess.train_batch(images, boxes, box_mask)
        target = assigner(boxes[..., :6], box_mask, anchors)
        state.model.train()
        scores, locs = state.model(x)
        loss, class_loss, loc_loss = criterion(scores.float(), locs.float(),
                                               anchors, target)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        lr = schedule(state.step) * state.lr_scale
        for group in state.optimizer.param_groups:
            group['lr'] = lr
        state.optimizer.step()
        state.step += 1
        return {'loss': loss.detach(), 'class_loss': class_loss.detach(),
                'loc_loss': loc_loss.detach()}

    return train_step


def make_predict_step(module: nn.Module, postprocessor: Callable,
                      anchors: torch.Tensor) -> Callable:
    """Inference-only step: ``predict_step(images) -> (detections, valid)``
    for normalized ``[B, 3, H, W]`` images on the module's device."""

    @torch.inference_mode()
    def predict_step(images: torch.Tensor):
        scores, locs = module(images)
        return postprocessor(scores.float(), locs.float(), anchors)

    return predict_step
