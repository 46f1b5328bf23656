"""Losses and ``MultiboxLoss``.

Port of ``single_shot_detection_tpu/ops/losses.py``: the masked reduction,
label smoothing (``epsilon``), the 16 named losses, ``build_loss`` and
``MultiboxLoss`` with its multiclass, soft-target and IoU branches.  Every
loss takes a ``mask`` and reduces over fixed shapes instead of gathering a
variable-length subset.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from single_shot_detection_tpu_torch import parallel
from single_shot_detection_tpu_torch.ops import boxes as box_ops
from single_shot_detection_tpu_torch.ops.matching import (CLASS_INDEX, IGNORE_CLASS,
                                                          LOC_INDEX_END,
                                                          LOC_INDEX_START,
                                                          NEGATIVE_CLASS,
                                                          SCORE_INDEX)
from single_shot_detection_tpu_torch.ops.ties import ZERO
from single_shot_detection_tpu_torch.utils.misc import filter_kwargs


def _masked_reduce(values: torch.Tensor, mask: torch.Tensor,
                   reduction: str) -> torch.Tensor:
    """Reduce per-row loss ``values`` over rows where ``mask`` is True."""
    values = torch.where(mask, values, 0.0)
    if reduction == 'sum':
        return values.sum()
    if reduction == 'mean':
        return values.sum() / torch.clamp(mask.sum(), min=1)
    return values


class _Loss:
    """Base: the reduction and label smoothing.  ``SOFT_TARGET`` losses take
    a ``[..., C]`` plane of class scores, ``MULTICLASS`` ones a multi-hot
    ``[..., C]`` plane of scores at ``class - 1``, and ``IOU_LOSS`` ones
    corner boxes instead of encoded offsets."""

    SOFT_TARGET = False
    MULTICLASS = False
    IOU_LOSS = False

    def __init__(self, reduction: str = 'mean', epsilon: float = 0.0, **_):
        if reduction not in ('mean', 'sum', 'none'):
            raise ValueError(f'Wrong value for reduction: {reduction}')
        assert 0.0 <= epsilon < 1
        self.reduction = reduction
        self.epsilon = epsilon

    def _soften(self, target: torch.Tensor) -> torch.Tensor:
        """Label smoothing over soft targets: ``epsilon`` of each row's mass
        moves from its positive classes to the others, spread evenly."""
        pos = (target > 0).to(target.dtype)
        num_classes = target.shape[-1]
        spread = (self.epsilon * target.sum(-1, keepdim=True)
                  / (num_classes - pos.sum(-1, keepdim=True)))
        target = target + (1.0 - pos) * spread
        return target - pos * self.epsilon * target

    def _reduce_rows(self, per_row: torch.Tensor,
                     mask: Optional[torch.Tensor]) -> torch.Tensor:
        if mask is None:
            mask = torch.ones(per_row.shape, dtype=torch.bool,
                              device=per_row.device)
        return _masked_reduce(per_row, mask, self.reduction)


_LOG_FLOOR = torch.tensor(-100.0)  # a clamp's bound, as in ops/ties.py


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` with ``jnp.abs``'s gradient at 0: 1 (``torch.abs`` gives 0)."""
    return torch.where(x >= 0, x, -x)


def _bce_with_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``max(x, 0) - x t + log1p(exp(-|x|))``, elementwise."""
    return (torch.maximum(logits, ZERO) - logits * target
            + torch.log1p(torch.exp(-_abs(logits))))


class CrossEntropyLoss(_Loss):
    """Hard-label cross entropy with ``ignore_index``."""

    def __init__(self, ignore_index: int = -100, **kwargs):
        super().__init__(**kwargs)
        self.ignore_index = ignore_index

    def __call__(self, logits: torch.Tensor, target: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        valid = target != self.ignore_index
        if mask is not None:
            valid = valid & mask
        logp = torch.log_softmax(logits, dim=-1)
        safe = torch.clamp(target, min=0).long()
        ce = -torch.gather(logp, -1, safe[..., None])[..., 0]
        return _masked_reduce(ce, valid, self.reduction)


class SmoothL1Loss(_Loss):
    """Huber / smooth-L1 summed over the last axis per row."""

    def __init__(self, beta: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.beta = beta

    def __call__(self, pred: torch.Tensor, target: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        diff = torch.abs(pred - target)
        per_elem = torch.where(diff < self.beta,
                               0.5 * diff * diff / self.beta,
                               diff - 0.5 * self.beta)
        return self._reduce_rows(per_elem.sum(dim=-1), mask)


class L1Loss(_Loss):
    """Plain L1 summed over the last axis per row."""

    def __call__(self, pred, target, mask=None):
        return self._reduce_rows(_abs(pred - target).sum(dim=-1), mask)


class MSELoss(_Loss):
    """Squared error summed over the last axis per row."""

    def __call__(self, pred, target, mask=None):
        return self._reduce_rows(((pred - target) ** 2).sum(dim=-1), mask)


class HuberLoss(_Loss):
    """Huber loss in torch's ``delta`` form: ``0.5 d^2`` for ``|d| <
    delta``, else ``delta (|d| - delta / 2)``; the quadratic zone is not
    divided by the threshold as :class:`SmoothL1Loss`'s is."""

    def __init__(self, delta: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.delta = delta

    def __call__(self, pred, target, mask=None):
        diff = torch.abs(pred - target)
        per_elem = torch.where(diff < self.delta, 0.5 * diff * diff,
                               self.delta * (diff - 0.5 * self.delta))
        return self._reduce_rows(per_elem.sum(dim=-1), mask)


class NLLLoss(_Loss):
    """Negative log likelihood over the last axis; no softmax is applied
    (the input holds log-probabilities)."""

    def __init__(self, ignore_index: int = -100, **kwargs):
        super().__init__(**kwargs)
        self.ignore_index = ignore_index

    def __call__(self, logp, target, mask=None):
        valid = target != self.ignore_index
        if mask is not None:
            valid = valid & mask
        safe = torch.clamp(target, min=0).long()
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
        return _masked_reduce(nll, valid, self.reduction)


class BCEWithLogitsLoss(_Loss):
    """Elementwise sigmoid BCE on logits against the multi-hot ``{0,
    score}`` plane; ``pos_weight`` (a number or one per class) multiplies
    the positive term."""

    MULTICLASS = True

    def __init__(self, pos_weight=None, **kwargs):
        super().__init__(**kwargs)
        self.pos_weight = pos_weight

    def __call__(self, logits, target, mask=None):
        if self.pos_weight is not None:
            weight = torch.as_tensor(self.pos_weight, dtype=logits.dtype,
                                     device=logits.device)
            per_elem = -(weight * target * F.logsigmoid(logits)
                         + (1.0 - target) * F.logsigmoid(-logits))
        else:
            per_elem = _bce_with_logits(logits, target)
        return self._reduce_rows(per_elem.sum(dim=-1), mask)


class BCELoss(_Loss):
    """Binary cross entropy on probabilities, each log term clamped at
    -100 as torch clamps it."""

    def __call__(self, probs, target, mask=None):
        log_p = torch.maximum(torch.log(probs), _LOG_FLOOR)
        log_1p = torch.maximum(torch.log1p(-probs), _LOG_FLOOR)
        per_elem = -(target * log_p + (1.0 - target) * log_1p)
        return self._reduce_rows(per_elem.sum(dim=-1), mask)


class KLDivLoss(_Loss):
    """Pointwise KL divergence on log-probabilities, ``t (log t - x)`` with
    ``0 log 0 = 0``."""

    def __call__(self, log_pred, target, mask=None):
        positive = target > 0
        safe_log_t = torch.where(
            positive, torch.log(torch.clamp(target, min=1e-38)), 0.0)
        per_elem = torch.where(positive, target * (safe_log_t - log_pred), 0.0)
        return self._reduce_rows(per_elem.sum(dim=-1), mask)


class PoissonNLLLoss(_Loss):
    """Poisson negative log likelihood, ``exp(x) - t x`` (torch's defaults
    ``log_input=True, full=False``; the JAX package implements only
    those, and so does the port)."""

    def __init__(self, log_input: bool = True, full: bool = False, **kwargs):
        super().__init__(**kwargs)
        if not log_input or full:
            raise NotImplementedError(
                'PoissonNLLLoss: only the torch defaults '
                '(log_input=True, full=False) are implemented')

    def __call__(self, log_pred, target, mask=None):
        return self._reduce_rows(
            (torch.exp(log_pred) - target * log_pred).sum(dim=-1), mask)


class SoftMarginLoss(_Loss):
    """Two-class logistic margin loss ``softplus(-y x)``, labels in {-1,
    +1}."""

    def __call__(self, pred, target, mask=None):
        return self._reduce_rows(F.softplus(-target * pred).sum(dim=-1), mask)


class SigmoidFocalLoss(_Loss):
    """Multi-hot sigmoid focal loss, summed over the classes per row."""

    MULTICLASS = True

    def __init__(self, gamma: float = 2.0, alpha: float = 0.25, **kwargs):
        super().__init__(**kwargs)
        self.gamma = gamma
        self.alpha = alpha

    def __call__(self, logits: torch.Tensor, target: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        # logits/target [..., C]; target is a {0, score} multi-hot plane
        alpha_weight = target * self.alpha + (1.0 - target) * (1.0 - self.alpha)
        pb = torch.sigmoid(logits)
        pt = pb * target + (1.0 - pb) * (1.0 - target)
        ce = _bce_with_logits(logits, target)
        return self._reduce_rows(
            (alpha_weight * (1.0 - pt) ** self.gamma * ce).sum(dim=-1), mask)


class SoftmaxFocalLoss(_Loss):
    """Hard-label softmax focal loss; ``alpha`` weighs the background class
    by ``1 - alpha`` and the others by ``alpha``."""

    def __init__(self, gamma: float = 0.0, alpha=None, ignore_index: int = -100,
                 **kwargs):
        super().__init__(**kwargs)
        self.gamma = gamma
        self.alpha = alpha
        self.ignore_index = ignore_index

    def __call__(self, logits, target, mask=None):
        valid = target != self.ignore_index
        if mask is not None:
            valid = valid & mask
        logp = torch.log_softmax(logits, dim=-1)
        safe = torch.clamp(target, min=0).long()
        logpb = torch.gather(logp, -1, safe[..., None])[..., 0]
        pb = torch.exp(logpb)
        loss = -((1.0 - pb) ** self.gamma) * logpb
        if self.alpha is not None:
            loss = loss * torch.where(target == 0, 1.0 - self.alpha, self.alpha)
        return _masked_reduce(loss, valid, self.reduction)


class CrossEntropyWithSoftTargetsLoss(_Loss):
    """Soft-target cross entropy, scaled by one over the mean target mass
    of the masked rows."""

    SOFT_TARGET = True

    def __call__(self, logits, target, mask=None):
        if self.epsilon:
            target = self._soften(target)
        logp = torch.log_softmax(logits, dim=-1)
        row_sum = target.sum(dim=-1)
        if mask is None:
            mask = torch.ones(row_sum.shape, dtype=torch.bool,
                              device=row_sum.device)
        mean_mass = (torch.where(mask, row_sum, 0.0).sum()
                     / torch.clamp(mask.sum(), min=1))
        scale = 1.0 / torch.clamp(mean_mass, min=1e-12)
        per_row = -scale * (logp * target).sum(dim=-1)
        return _masked_reduce(per_row, mask, self.reduction)


class BinaryCrossEntropyWithSoftTargetsLoss(_Loss):
    """Soft-target sigmoid BCE, scaled by the count of rows with mass over
    their summed mean target."""

    SOFT_TARGET = True
    MULTICLASS = True

    def __call__(self, logits, target, mask=None):
        if self.epsilon:
            target = self._soften(target)
        if mask is None:
            mask = torch.ones(target.shape[:-1], dtype=torch.bool,
                              device=target.device)
        row_mean = torch.where(mask, target.mean(dim=-1), 0.0)
        positive_rows = (row_mean > 0).sum()
        scale = (torch.clamp(positive_rows, min=1)
                 / torch.clamp(row_mean.sum(), min=1e-12))
        per_row = _bce_with_logits(logits, target).sum(dim=-1)
        return scale * _masked_reduce(per_row, mask, self.reduction)


class GeneralizedIoULoss(_Loss):
    """``1 - GIoU`` of corner boxes."""

    IOU_LOSS = True

    def __call__(self, boxes, target, mask=None):
        return self._reduce_rows(
            1.0 - box_ops.generalized_iou(boxes, target, cartesian=False), mask)


LOSSES = {
    'CrossEntropyLoss': CrossEntropyLoss,
    'SmoothL1Loss': SmoothL1Loss,
    'L1Loss': L1Loss,
    'MSELoss': MSELoss,
    'HuberLoss': HuberLoss,
    'NLLLoss': NLLLoss,
    'BCEWithLogitsLoss': BCEWithLogitsLoss,
    'BCELoss': BCELoss,
    'KLDivLoss': KLDivLoss,
    'PoissonNLLLoss': PoissonNLLLoss,
    'SoftMarginLoss': SoftMarginLoss,
    'SigmoidFocalLoss': SigmoidFocalLoss,
    'SoftmaxFocalLoss': SoftmaxFocalLoss,
    'CrossEntropyWithSoftTargetsLoss': CrossEntropyWithSoftTargetsLoss,
    'BinaryCrossEntropyWithSoftTargetsLoss': BinaryCrossEntropyWithSoftTargetsLoss,
    'GeneralizedIoULoss': GeneralizedIoULoss,
}


def build_loss(name: str, **kwargs):
    """Config-driven loss factory; unknown keyword arguments are dropped."""
    if name not in LOSSES:
        raise KeyError(f'Unknown loss {name!r}. Supported names: '
                       f'{", ".join(sorted(LOSSES))}.')
    return filter_kwargs(LOSSES[name])(**kwargs)


class MultiboxLoss:
    """Classification + localization multibox loss.

    ``__call__(scores, locs, anchors, target)`` with
      scores  ``[B, A, C]`` raw logits,
      locs    ``[B, A, 4]`` raw regression outputs,
      anchors ``[A, 4]`` centroid priors,
      target  ``[B, A, 6]`` assigned targets (raw corner loc, class, score)
    returns ``(loss, class_loss, loc_loss)``, each divided by the clamped
    positive count.

    In a run of several processes (``parallel/mesh.py``) the positive
    count is summed over the ranks: each rank's loss is then its share of
    the global batch's loss, the JAX engine's, and the ranks' gradients
    add up to that loss's gradient.
    """

    def __init__(self, sampler, box_coder, classification_loss: dict,
                 localization_loss: dict, classification_weight: float = 1.0,
                 localization_weight: float = 1.0):
        self.sampler = sampler
        self.box_coder = box_coder
        self.classification_loss = build_loss(
            classification_loss['name'], reduction='sum',
            ignore_index=IGNORE_CLASS,
            **{k: v for k, v in classification_loss.items() if k != 'name'})
        self.soft_target = self.classification_loss.SOFT_TARGET
        self.multiclass = self.classification_loss.MULTICLASS
        self.localization_loss = build_loss(
            localization_loss['name'], reduction='sum',
            **{k: v for k, v in localization_loss.items() if k != 'name'})
        self.iou_loss = self.localization_loss.IOU_LOSS
        self.classification_weight = classification_weight
        self.localization_weight = localization_weight

    def __call__(self, scores, locs, anchors, target, image_mask=None):
        """``image_mask [B]`` (optional) drops whole images from the loss:
        the zero-padded rows of a partial eval batch, which would otherwise
        each add ``min_negative_per_image`` hard negatives."""
        target_locs = target[..., LOC_INDEX_START:LOC_INDEX_END]
        target_classes = target[..., CLASS_INDEX].to(torch.int32)
        target_scores = target[..., SCORE_INDEX]

        positive_mask = ((target_classes != NEGATIVE_CLASS)
                         & (target_classes != IGNORE_CLASS))
        sampled_mask = self.sampler(scores, target_classes)
        if image_mask is not None:
            positive_mask = positive_mask & image_mask[:, None]
            sampled_mask = sampled_mask & image_mask[:, None]
        classes = torch.arange(scores.shape[-1], device=scores.device)
        if self.multiclass:
            # a row at (class - 1) carrying the GT score; background (0)
            # and ignored (-1) anchors get a zero row, as jax.nn.one_hot
            # gives for a negative index
            onehot = ((target_classes - 1)[..., None] == classes).to(scores.dtype)
            score = torch.where(positive_mask, target_scores, 0.0)
            class_loss = self.classification_loss(
                scores, onehot * score[..., None], sampled_mask)
        elif self.soft_target:
            # a row at the class (background 0 included) carrying the GT
            # score; ignored anchors get a zero row
            onehot = (target_classes[..., None] == classes).to(scores.dtype)
            score = torch.where(target_classes != IGNORE_CLASS, target_scores,
                                0.0)
            class_loss = self.classification_loss(
                scores, onehot * score[..., None], sampled_mask)
        else:
            class_loss = self.classification_loss(scores, target_classes,
                                                  sampled_mask)
        if self.iou_loss:
            # decoded corner boxes against the raw corner targets
            pred_boxes = box_ops.to_corners(self.box_coder.decode(locs, anchors))
            loc_loss = self.localization_loss(pred_boxes, target_locs,
                                              positive_mask)
        else:
            encoded_target = self.box_coder.encode(
                box_ops.to_centroids(target_locs), anchors)
            loc_loss = self.localization_loss(locs, encoded_target,
                                              positive_mask)

        positives = parallel.all_reduce_(positive_mask.sum().to(scores.dtype))
        divider = torch.clamp(positives, min=1)
        loc_loss = loc_loss * self.localization_weight / divider
        class_loss = class_loss * self.classification_weight / divider
        return class_loss + loc_loss, class_loss, loc_loss
