"""Exact greedy hard NMS and Gaussian soft-NMS in plain PyTorch, batched
over leading dims.

Port of ``single_shot_detection_tpu/ops/nms.py`` (``nms_mask``,
``soft_nms``).  Hard NMS: process boxes in
descending score order and suppress any later box whose IoU with a kept box
is **strictly greater** than the threshold.  A NaN IoU (two empty boxes)
never suppresses; a ``-inf`` score marks an invalid candidate, which is never
kept.

:func:`nms_keep_sorted` is the plain version of the CUDA kernel
(``kernels/nms.cu``, wrapped by ``ops/nms_kernel.py``): the kernel's CPU path
and its oracle on the card.  :func:`soft_nms` has no kernel: the JAX
package computes it outside its Pallas kernel too.
"""

from __future__ import annotations

import torch

from single_shot_detection_tpu_torch.ops import boxes as box_ops


def nms_keep_sorted(boxes: torch.Tensor, scores: torch.Tensor,
                    overlap_threshold: float) -> torch.Tensor:
    """Keep mask for candidates already **sorted by score descending**.

    Args:
      boxes: ``[..., K, 4]`` corner boxes.
      scores: ``[..., K]``; ``-inf`` marks invalid candidates.
    Returns:
      ``[..., K]`` bool keep mask.
    """
    k = boxes.shape[-2]
    ious = box_ops.iou(boxes, boxes)                      # [..., K, K]
    idx = torch.arange(k, device=boxes.device)
    later = idx[None, :] > idx[:, None]
    suppress_rows = (ious > overlap_threshold) & later    # NaN -> False
    suppressed = torch.zeros(scores.shape, dtype=torch.bool,
                             device=boxes.device)
    for i in range(k):
        alive = ~suppressed[..., i]
        suppressed |= suppress_rows[..., i, :] & alive[..., None]
    return ~suppressed & (scores > float('-inf'))


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
             overlap_threshold: float) -> torch.Tensor:
    """Keep mask for candidates in any order (returned in the input order).

    Args:
      boxes: ``[..., N, 4]`` corner boxes.
      scores: ``[..., N]``; ``-inf`` marks invalid candidates.
    """
    # stable: equal scores keep their input order, as jnp.argsort does
    order = torch.argsort(scores, dim=-1, descending=True, stable=True)
    sorted_boxes = torch.gather(
        boxes, -2, order[..., None].expand(*order.shape, 4))
    sorted_scores = torch.gather(scores, -1, order)
    keep_sorted = nms_keep_sorted(sorted_boxes, sorted_scores,
                                  overlap_threshold)
    return torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)


def soft_nms(boxes: torch.Tensor, scores: torch.Tensor,
             score_threshold: float, sigma: float = 0.5) -> torch.Tensor:
    """Gaussian soft-NMS pick mask, batched over leading dims.

    Each round picks the best working score (the lowest index among ties)
    of every row that still holds one above ``score_threshold``, decays
    that row's working scores above the threshold by ``exp(-iou^2 /
    sigma)`` with the picked box and zeroes the picked box's.  The JAX
    package runs ``K`` rounds for each row; a row with no score above the
    threshold is left as it is, so the rounds stop once no row has one,
    with the same mask.  Callers keep the *original* scores of picked
    boxes.

    Args:
      boxes: ``[..., K, 4]`` corner boxes.
      scores: ``[..., K]`` finite scores.
    Returns:
      ``[..., K]`` bool pick mask.
    """
    k = boxes.shape[-2]
    ious = torch.nan_to_num(box_ops.iou(boxes, boxes))    # [..., K, K]
    working = scores.clone()
    picked = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    index = torch.arange(k, device=scores.device)
    for _ in range(k):
        above = working > score_threshold
        active = above.any(dim=-1, keepdim=True)
        if not bool(active.any()):
            break
        # the first maximum, as jnp.argmax takes it (torch.argmax on CUDA
        # does not promise which of tied maxima it returns)
        best = working.max(dim=-1, keepdim=True).values
        idx = torch.where(working == best, index, k).min(
            dim=-1, keepdim=True).values
        row = torch.gather(ious, -2, idx[..., None].expand(
            *idx.shape, k)).squeeze(-2)                   # [..., K]
        decayed = torch.where(above, working * torch.exp(-(row * row) / sigma),
                              working)
        decayed = decayed.scatter(-1, idx, 0.0)
        working = torch.where(active, decayed, working)
        picked |= torch.zeros_like(picked).scatter(-1, idx, True) & active
    return picked
