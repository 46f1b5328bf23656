"""Step functions.

Port of ``single_shot_detection_tpu/train/step.py``: ``apply_mixup``,
``make_train_step`` (the pruning mask, the EMA shadow, mixup and
``frozen_bn``; QAT runs inside the model's convs, ``export/quantize.py``;
the global-batch step of several processes, ``parallel/mesh.py``; the
model axis's forward and gradient reduction, ``parallel/``),
``make_fused_train_step``, ``make_eval_step`` and ``make_predict_step``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from single_shot_detection_tpu_torch import parallel
from single_shot_detection_tpu_torch.parallel import pipeline
from single_shot_detection_tpu_torch.ops.matching import SCORE_INDEX
from single_shot_detection_tpu_torch.train.pruning import apply_mask
from single_shot_detection_tpu_torch.train.state import TrainState


def apply_gradients(state: TrainState, schedule: Callable[[int], float]) -> bool:
    """The optimizer's micro-step on the gradients in ``state.model``'s
    parameters (``train/optimizers.py``: the update count and the window
    from ``state.step``, the whole update times ``state.lr_scale``), the
    pruning mask (``state.mask``) applied to the stepped parameters, then
    ``state.step += 1``.  Returns whether the parameters moved.  The dead
    entries were zeroed when they were pruned, so masking the parameters
    after the step equals the JAX package's masking of the update."""
    moved = state.optimizer.step(count=state.step, schedule=schedule,
                                 lr_scale=state.lr_scale)
    if moved and state.mask:
        apply_mask(state.model, state.mask)
    state.step += 1
    return moved


def update_ema(state: TrainState, ema: float) -> None:
    """The shadow after a step: ``e += (1 - decay) * (p - e)`` over every
    parameter, in one multi-tensor op, with ``decay = min(ema, (1 + t) /
    (10 + t))`` at the incremented step ``t`` in f32 as the JAX step
    computes it; the shadow stays f32."""
    params = dict(state.model.named_parameters())
    names = list(state.ema_params)
    t = np.float32(state.step)
    decay = min(np.float32(ema), (np.float32(1.0) + t) / (np.float32(10.0) + t))
    weight = float(np.float32(1.0) - decay)
    # ZeRO-1: this rank's slice of each leaf (``state.zero``)
    cut = ((lambda n, x: x) if state.zero is None else state.zero.slice)
    torch._foreach_lerp_([cut(n, state.ema_params[n]) for n in names],
                         [cut(n, params[n].detach()) for n in names], weight)


def sample_mixup(generator: torch.Generator, batch: int, alpha: float,
                 p: float) -> Dict[str, torch.Tensor]:
    """Mixup's draws from the step's generator: ``lam`` from Beta(alpha,
    alpha) (numpy's sampler, seeded from the generator: torch's Beta takes
    no generator), a partner permutation and the images that mix (each
    with probability ``p``)."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
    lam = np.random.default_rng(seed).beta(alpha, alpha)
    index = torch.randperm(batch, generator=generator)
    roll = torch.rand(batch, generator=generator) < p
    return {'lam': torch.tensor(lam, dtype=torch.float32), 'index': index,
            'roll': roll}


def apply_mixup(draws: Dict[str, torch.Tensor], images: torch.Tensor,
                boxes: torch.Tensor, box_mask: torch.Tensor):
    """Batch mixup on ``images [B, ...]``, ``boxes [B, G, R]`` and
    ``box_mask [B, G]``: each rolled image becomes ``lam * image + (1 -
    lam) * partner``; the GT lists concatenate to ``2G`` rows, the own
    scores (column ``SCORE_INDEX``) times ``lam`` where rolled, the
    partner's times ``1 - lam`` and masked where not rolled."""
    lam, index, roll = draws['lam'], draws['index'], draws['roll']
    partner = images[index]
    mixed = lam * images + (1.0 - lam) * partner
    images = torch.where(roll.view(-1, *([1] * (images.dim() - 1))), mixed,
                         images)
    own = boxes.clone()
    own[..., SCORE_INDEX] *= torch.where(roll, lam, 1.0)[:, None]
    other = boxes[index]
    other[..., SCORE_INDEX] *= 1.0 - lam
    return (images, torch.cat([own, other], dim=1),
            torch.cat([box_mask, box_mask[index] & roll[:, None]], dim=1))


def make_update_step(criterion, assigner, anchors: torch.Tensor,
                     schedule: Callable[[int], float],
                     ema: Optional[float] = None,
                     frozen_bn: bool = False,
                     grad_axis: str = 'data',
                     microbatches: int = 0) -> Callable:
    """Build ``update(state, x, boxes, box_mask) -> metrics`` on model input
    ``x [B, 3, h, w]`` and boxes ``[B, G, 6]`` in its pixels.

    ``TargetAssigner`` -> train-mode forward (BN batch statistics; the
    running statistics are updated in the forward) -> ``MultiboxLoss`` on
    f32 heads -> backward -> the optimizer's micro-step
    (:func:`apply_gradients`) -> with ``ema``, the shadow
    (:func:`update_ema`).  ``frozen_bn`` runs every BatchNorm in eval mode
    (the running statistics read, not written; no BN kernel launches)
    while the rest of the model, QAT's ``act_amax`` updates included,
    stays in train mode.  ``state`` is updated in place; the metrics
    ``{'loss', 'class_loss', 'loc_loss'}`` are 0-dim tensors on the device
    (reading them waits for the step).

    In a run of several processes each rank holds its rows of the global
    batch, and the step is the JAX engine's global-batch step: the
    criterion divides by the global positive count, the BNs take global
    statistics (``layers.BatchNorm.sync``, set by the ``Trainer``), the
    gradients are summed over the ranks in one bucketed all-reduce before
    the optimizer (its clipping sees the global gradient), and the metrics
    are the global batch's, summed over the ranks, on every rank.

    With a model axis (``parallel/``) the ranks of a model group hold one
    batch; ``grad_axis`` is what the gradients are summed over (``'data'``
    under tensor sharding, ``'world'``, the model group then the data
    axis, under spatial and pipeline sharding), and ``microbatches`` (the
    pipeline's) runs the forward as ``parallel/pipeline.py``'s GPipe
    schedule, in eval mode, with each stage's backward driven after the
    loss's.  The loss and metrics reduce over the data axis only.
    """
    frozen: Dict[int, List[nn.Module]] = {}

    def update(state: TrainState, x: torch.Tensor, boxes: torch.Tensor,
               box_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        target = assigner(boxes, box_mask, anchors)
        if microbatches:
            state.model.eval()
            scores, locs, stages_backward = pipeline.pipeline_apply(
                state.model, x, microbatches)
            state.optimizer.zero_grad(set_to_none=True)
            loss, class_loss, loc_loss = criterion(
                scores.float(), locs.float(), anchors, target)
            loss.backward()
            stages_backward()
            return finish(state, loss, class_loss, loc_loss)
        state.model.train()
        if frozen_bn:
            key = id(state.model)
            if key not in frozen:
                frozen[key] = [m for m in state.model.modules()
                               if isinstance(m, nn.BatchNorm2d)]
            for m in frozen[key]:
                m.eval()
        scores, locs = state.model(x)
        loss, class_loss, loc_loss = criterion(scores.float(), locs.float(),
                                               anchors, target)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        return finish(state, loss, class_loss, loc_loss)

    def finish(state, loss, class_loss, loc_loss):
        parallel.all_reduce_grads(list(state.model.parameters()), grad_axis)
        apply_gradients(state, schedule)
        if ema is not None:
            update_ema(state, ema)
        metrics = parallel.all_reduce_(
            torch.stack([loss, class_loss, loc_loss]).detach())
        return dict(zip(('loss', 'class_loss', 'loc_loss'), metrics.unbind()))

    return update


def make_train_step(criterion, assigner, anchors: torch.Tensor,
                    schedule: Callable[[int], float], pipeline,
                    ema: Optional[float] = None,
                    frozen_bn: bool = False,
                    process_index: int = 0, grad_axis: str = 'data',
                    microbatches: int = 0) -> Callable:
    """Build ``train_step(state, images, boxes, box_mask, draws,
    mixup_draws=None) -> metrics``: the augmentation ``pipeline.apply(draws,
    ...)`` on staged uint8 images and ``[B, G, R>=6]`` boxes in staged
    pixels, then :func:`apply_mixup` with ``mixup_draws`` (None: no mixup),
    then :func:`make_update_step`'s update on ``boxes[..., :6]``.

    In a run of several processes the batch is this rank's rows of the
    global batch (rank ``process_index`` holds rows ``[index * b, (index +
    1) * b)``) and ``mixup_draws`` are the global batch's: mixup pairs rows
    over the global batch, as the JAX step does, so the augmented rows of
    every rank are gathered first and this rank keeps its own mixed rows.
    With a model axis ``process_index`` is the data index, and the rows
    are gathered over the data axis; ``grad_axis`` and ``microbatches`` as
    :func:`make_update_step` takes them."""
    update = make_update_step(criterion, assigner, anchors, schedule, ema,
                              frozen_bn, grad_axis, microbatches)

    def train_step(state: TrainState, images: torch.Tensor,
                   boxes: torch.Tensor, box_mask: torch.Tensor,
                   draws: list, mixup_draws: Optional[dict] = None
                   ) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            x, boxes, box_mask = pipeline.apply(draws, images, boxes, box_mask)
            boxes = boxes[..., :6]
            if mixup_draws is not None:
                rows = slice(process_index * x.shape[0],
                             (process_index + 1) * x.shape[0])
                x, boxes, box_mask = (
                    t[rows] for t in apply_mixup(
                        mixup_draws, *(parallel.all_gather_rows(t)
                                       for t in (x, boxes, box_mask))))
        return update(state, x, boxes, box_mask)

    return train_step


def make_fused_train_step(train_step: Callable, k: int) -> Callable:
    """``fused(state, batches, draws) -> metric sums``: ``k`` train steps
    in one host call, on ``k`` ``(images, boxes, box_mask)`` batches and
    their ``(draws, mixup_draws)``, returning the per-step metrics summed
    as the JAX package's ``lax.scan`` returns them.  The port's draws come
    from each step's own ``(seed, step)``, so the k steps equal k single
    steps exactly."""

    def fused(state: TrainState, batches: Sequence, draws: Sequence
              ) -> Dict[str, torch.Tensor]:
        if len(batches) != k or len(draws) != k:
            raise ValueError(f'fused step of {k} took {len(batches)} batches '
                             f'and {len(draws)} draws')
        sums = None
        for batch, step_draws in zip(batches, draws):
            metrics = train_step(state, *batch, *step_draws)
            sums = metrics if sums is None else {
                key: sums[key] + value for key, value in metrics.items()}
        return sums

    return fused


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
