"""Step functions.

Port of ``single_shot_detection_tpu/train/step.py``: ``make_train_step``
(with the pruning mask; without mixup, ``frozen_bn``, EMA and the
pipeline-parallel pinning, which are not ported yet; QAT runs inside the
model's convs, ``export/quantize.py``), ``make_eval_step`` and
``make_predict_step``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from single_shot_detection_tpu_torch.train.pruning import apply_mask
from single_shot_detection_tpu_torch.train.state import TrainState


def apply_gradients(state: TrainState, schedule: Callable[[int], float]) -> None:
    """The optimizer step on the gradients in ``state.model``'s parameters
    at ``schedule(state.step) * state.lr_scale`` (the JAX step scales its
    updates by ``lr_scale``, the same for SGD), the pruning mask
    (``state.mask``) applied to the stepped parameters, then ``state.step
    += 1``.  The dead entries were zeroed when they were pruned, so
    masking the parameters after the step equals the JAX package's masking
    of the update."""
    lr = schedule(state.step) * state.lr_scale
    for group in state.optimizer.param_groups:
        group['lr'] = lr
    state.optimizer.step()
    if state.mask:
        apply_mask(state.model, state.mask)
    state.step += 1


def make_update_step(criterion, assigner, anchors: torch.Tensor,
                     schedule: Callable[[int], float]) -> Callable:
    """Build ``update(state, x, boxes, box_mask) -> metrics`` on model input
    ``x [B, 3, h, w]`` and boxes ``[B, G, 6]`` in its pixels.

    ``TargetAssigner`` -> train-mode forward (BN batch statistics; the
    running statistics are updated in the forward) -> ``MultiboxLoss`` on
    f32 heads -> backward -> SGD step at ``schedule(state.step) *
    state.lr_scale``.  ``state`` is updated in place; the metrics ``{'loss',
    'class_loss', 'loc_loss'}`` are 0-dim tensors on the device (reading
    them waits for the step).
    """

    def update(state: TrainState, x: torch.Tensor, boxes: torch.Tensor,
               box_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        target = assigner(boxes, box_mask, anchors)
        state.model.train()
        scores, locs = state.model(x)
        loss, class_loss, loc_loss = criterion(scores.float(), locs.float(),
                                               anchors, target)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        apply_gradients(state, schedule)
        return {'loss': loss.detach(), 'class_loss': class_loss.detach(),
                'loc_loss': loc_loss.detach()}

    return update


def make_train_step(criterion, assigner, anchors: torch.Tensor,
                    schedule: Callable[[int], float], pipeline) -> Callable:
    """Build ``train_step(state, images, boxes, box_mask, draws) ->
    metrics``: the augmentation ``pipeline.apply(draws, ...)`` on staged
    uint8 images and ``[B, G, R>=6]`` boxes in staged pixels, then
    :func:`make_update_step`'s update on ``boxes[..., :6]``."""
    update = make_update_step(criterion, assigner, anchors, schedule)

    def train_step(state: TrainState, images: torch.Tensor,
                   boxes: torch.Tensor, box_mask: torch.Tensor,
                   draws: list) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            x, boxes, box_mask = pipeline.apply(draws, images, boxes, box_mask)
        return update(state, x, boxes[..., :6], box_mask)

    return train_step


def make_eval_step(criterion, assigner, anchors: torch.Tensor,
                   postprocessor: Callable) -> Callable:
    """Build ``eval_step(model, x, boxes, box_mask, image_valid=None) ->
    (metrics, detections, valid)``: targets, eval-mode forward, the loss
    (padded rows, ``image_valid`` False, add nothing) and the
    postprocessor, whose hard NMS runs on the CUDA kernel for CUDA
    tensors."""

    @torch.inference_mode()
    def eval_step(model: nn.Module, x: torch.Tensor, boxes: torch.Tensor,
                  box_mask: torch.Tensor,
                  image_valid: Optional[torch.Tensor] = None):
        target = assigner(boxes, box_mask, anchors)
        model.eval()
        scores, locs = model(x)
        scores, locs = scores.float(), locs.float()
        loss, class_loss, loc_loss = criterion(scores, locs, anchors, target,
                                               image_mask=image_valid)
        detections, valid = postprocessor(scores, locs, anchors)
        return ({'loss': loss, 'class_loss': class_loss, 'loc_loss': loc_loss},
                detections, valid)

    return eval_step


def make_predict_step(module: nn.Module, postprocessor: Callable,
                      anchors: torch.Tensor) -> Callable:
    """Inference-only step: ``predict_step(images) -> (detections, valid)``
    for normalized ``[B, 3, H, W]`` images on the module's device."""

    @torch.inference_mode()
    def predict_step(images: torch.Tensor):
        scores, locs = module(images)
        return postprocessor(scores.float(), locs.float(), anchors)

    return predict_step
