"""Exact greedy hard NMS in plain PyTorch, batched over leading dims.

Port of ``single_shot_detection_tpu/ops/nms.py::nms_mask``.  Process boxes in
descending score order and suppress any later box whose IoU with a kept box
is **strictly greater** than the threshold.  A NaN IoU (two empty boxes)
never suppresses; a ``-inf`` score marks an invalid candidate, which is never
kept.

:func:`nms_keep_sorted` is the plain version of the CUDA kernel
(``kernels/nms.cu``, wrapped by ``ops/nms_kernel.py``): the kernel's CPU path
and its oracle on the card.
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
