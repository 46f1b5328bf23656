"""Anchor sampling for the classification loss.

Port of ``single_shot_detection_tpu/ops/sampling.py``.  Both samplers return
a boolean ``[B, A]`` mask.  Hard-negative mining ranks with two *stable*
argsorts, as ``jnp.argsort`` does, so tied losses keep the lower anchor
index first.
"""

from __future__ import annotations

import functools
import inspect

import torch

from single_shot_detection_tpu_torch.ops.matching import IGNORE_CLASS, NEGATIVE_CLASS


def naive_sampler(scores: torch.Tensor, target_classes: torch.Tensor) -> torch.Tensor:
    """Positives-only mask."""
    del scores
    return (target_classes != NEGATIVE_CLASS) & (target_classes != IGNORE_CLASS)


def hard_negative_mining(scores: torch.Tensor,
                         target_classes: torch.Tensor,
                         negative_per_positive_ratio: float,
                         min_negative_per_image: int) -> torch.Tensor:
    """Positives + hardest negatives by background ``-log_softmax`` rank.

    Args:
      scores: ``[B, A, C]`` raw class logits.
      target_classes: ``[B, A]`` int class targets (0 = negative, -1 = ignore).
    Returns:
      ``[B, A]`` bool sampled mask.
    """
    with torch.no_grad():
        loss = -torch.log_softmax(scores, dim=-1)[..., NEGATIVE_CLASS]
        negative_mask = target_classes == NEGATIVE_CLASS
        positive_mask = ((target_classes != NEGATIVE_CLASS)
                         & (target_classes != IGNORE_CLASS))
        num_negatives = negative_mask.sum(dim=1, keepdim=True)
        num_positives = positive_mask.sum(dim=1, keepdim=True)

        wanted = torch.clamp(num_positives * negative_per_positive_ratio,
                             min=min_negative_per_image)
        num_keep = torch.minimum(wanted, num_negatives)

        loss = torch.where(negative_mask, loss, -torch.inf)
        order = torch.argsort(-loss, dim=1, stable=True)  # descending
        rank = torch.argsort(order, dim=1, stable=True)
        return positive_mask | (rank < num_keep)


SAMPLERS = {
    'naive_sampler': naive_sampler,
    'hard_negative_mining': hard_negative_mining,
}


def build_sampler(name: str, **kwargs):
    """Config-driven sampler factory; unknown keyword arguments are dropped."""
    if name not in SAMPLERS:
        raise KeyError(f'Unknown sampler {name!r}. Supported names: '
                       f'{", ".join(sorted(SAMPLERS))}')
    fn = SAMPLERS[name]
    if not kwargs:
        return fn
    allowed = {k: v for k, v in kwargs.items()
               if k in inspect.signature(fn).parameters}
    return functools.partial(fn, **allowed)
