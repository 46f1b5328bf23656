"""Losses and ``MultiboxLoss``.

Port of ``single_shot_detection_tpu/ops/losses.py``: the masked reduction,
``CrossEntropyLoss``, ``SmoothL1Loss``, ``SigmoidFocalLoss``, ``build_loss``
and ``MultiboxLoss`` (with its multiclass branch for the focal loss).  Every
loss takes a ``mask`` and reduces over fixed shapes instead of gathering a
variable-length subset.  The JAX package's other 13 named losses are not
ported yet: ``build_loss`` raises on them with the supported list.
"""

from __future__ import annotations

from typing import Optional

import torch

from single_shot_detection_tpu_torch.ops import boxes as box_ops
from single_shot_detection_tpu_torch.ops.matching import (CLASS_INDEX, IGNORE_CLASS,
                                                          LOC_INDEX_END,
                                                          LOC_INDEX_START,
                                                          NEGATIVE_CLASS,
                                                          SCORE_INDEX)
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
    """Base: the reduction.  ``MULTICLASS`` losses take a multi-hot
    ``[..., C]`` target plane instead of class indices."""

    MULTICLASS = False

    def __init__(self, reduction: str = 'mean', **_):
        if reduction not in ('mean', 'sum', 'none'):
            raise ValueError(f'Wrong value for reduction: {reduction}')
        self.reduction = reduction


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
        per_row = per_elem.sum(dim=-1)
        if mask is None:
            mask = torch.ones(per_row.shape, dtype=torch.bool,
                              device=per_row.device)
        return _masked_reduce(per_row, mask, self.reduction)


class SigmoidFocalLoss(_Loss):
    """Multi-hot sigmoid focal loss (parity: losses.py:34-54), summed over
    the classes per row."""

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
        ce = (torch.clamp(logits, min=0) - logits * target
              + torch.log1p(torch.exp(-torch.abs(logits))))
        per_row = (alpha_weight * (1.0 - pt) ** self.gamma * ce).sum(dim=-1)
        if mask is None:
            mask = torch.ones(per_row.shape, dtype=torch.bool,
                              device=per_row.device)
        return _masked_reduce(per_row, mask, self.reduction)


LOSSES = {
    'CrossEntropyLoss': CrossEntropyLoss,
    'SmoothL1Loss': SmoothL1Loss,
    'SigmoidFocalLoss': SigmoidFocalLoss,
}


def build_loss(name: str, **kwargs):
    """Config-driven loss factory; unknown keyword arguments are dropped."""
    if name not in LOSSES:
        raise KeyError(f'Unknown loss {name!r}. Supported names: '
                       f'{", ".join(sorted(LOSSES))}. (The other losses of '
                       f'the JAX package are not ported yet.)')
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
        self.multiclass = self.classification_loss.MULTICLASS
        self.localization_loss = build_loss(
            localization_loss['name'], reduction='sum',
            **{k: v for k, v in localization_loss.items() if k != 'name'})
        self.classification_weight = classification_weight
        self.localization_weight = localization_weight

    def __call__(self, scores, locs, anchors, target, image_mask=None):
        """``image_mask [B]`` (optional) drops whole images from the loss:
        the zero-padded rows of a partial eval batch, which would otherwise
        each add ``min_negative_per_image`` hard negatives."""
        target_locs = target[..., LOC_INDEX_START:LOC_INDEX_END]
        target_classes = target[..., CLASS_INDEX].to(torch.int32)

        positive_mask = ((target_classes != NEGATIVE_CLASS)
                         & (target_classes != IGNORE_CLASS))
        sampled_mask = self.sampler(scores, target_classes)
        if image_mask is not None:
            positive_mask = positive_mask & image_mask[:, None]
            sampled_mask = sampled_mask & image_mask[:, None]
        if self.multiclass:
            # a row at (class - 1) carrying the GT score; background (0)
            # and ignored (-1) anchors get a zero row, as jax.nn.one_hot
            # gives for a negative index
            classes = torch.arange(scores.shape[-1], device=scores.device)
            onehot = ((target_classes - 1)[..., None] == classes).to(scores.dtype)
            score = torch.where(positive_mask, target[..., SCORE_INDEX], 0.0)
            class_loss = self.classification_loss(
                scores, onehot * score[..., None], sampled_mask)
        else:
            class_loss = self.classification_loss(scores, target_classes,
                                                  sampled_mask)
        encoded_target = self.box_coder.encode(
            box_ops.to_centroids(target_locs), anchors)
        loc_loss = self.localization_loss(locs, encoded_target, positive_mask)

        divider = torch.clamp(positive_mask.sum(), min=1).to(scores.dtype)
        loc_loss = loc_loss * self.localization_weight / divider
        class_loss = class_loss * self.classification_weight / divider
        return class_loss + loc_loss, class_loss, loc_loss
