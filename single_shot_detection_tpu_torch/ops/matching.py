"""Anchor <-> ground-truth matching and target assignment.

Port of ``single_shot_detection_tpu/ops/matching.py``.  Ground truth is a
padded ``[B, G, 6]`` tensor with a validity mask; matching is a fixed-shape
tensor op batched over ``B`` (the JAX package ``vmap``s one image).

Ground-truth row format: ``[xmin, ymin, xmax, ymax, class, score]`` with
``NEGATIVE_CLASS = 0``.

Ties follow the reference: an argmax returns the first maximal index
(``torch.argmax`` and ``jnp.argmax`` agree), and when several GTs force-match
the same anchor the highest GT index wins, computed as a max over GT indices
(a scatter with duplicate indices has no defined winner on CUDA).
"""

from __future__ import annotations

from typing import Optional

import torch

from single_shot_detection_tpu_torch.ops import boxes as box_ops

NOT_MATCHED = -2
IGNORE = -1

NEGATIVE_CLASS = 0
IGNORE_CLASS = -1

# target row layout
LOC_INDEX_START = 0
LOC_INDEX_END = 4
CLASS_INDEX = 4
SCORE_INDEX = 5
TARGET_SIZE = 6


def match_bipartite(weights: torch.Tensor, gt_mask: torch.Tensor) -> torch.Tensor:
    """Greedy global-argmax bipartite matching.

    ``weights [..., G, A]``, ``gt_mask [..., G]``.  Each round picks the
    globally best (gt, anchor) pair, then zeroes that row and column.
    Returns ``anchor_idx [..., G]`` int32 (padded rows get arbitrary values —
    mask with ``gt_mask``).
    """
    num_gt, num_anchors = weights.shape[-2:]
    w = torch.where(gt_mask[..., None], torch.nan_to_num(weights), 0.0)
    lead = w.shape[:-2]
    w = w.reshape(-1, num_gt, num_anchors)
    anchor_idx = torch.zeros(w.shape[0], num_gt, dtype=torch.int32,
                             device=w.device)
    rows = torch.arange(num_gt, device=w.device)
    cols = torch.arange(num_anchors, device=w.device)
    batch = torch.arange(w.shape[0], device=w.device)
    for _ in range(num_gt):
        flat = torch.argmax(w.reshape(w.shape[0], -1), dim=1)
        row, col = flat // num_anchors, flat % num_anchors
        anchor_idx[batch, row] = col.to(torch.int32)
        w = w * (cols[None, None, :] != col[:, None, None])
        w = w * (rows[None, :, None] != row[:, None, None])
    return anchor_idx.reshape(*lead, num_gt)


def match_per_prediction(weights: torch.Tensor,
                         gt_mask: torch.Tensor,
                         matched_threshold: float,
                         unmatched_threshold: Optional[float] = None,
                         force_match_for_each_target: bool = True
                         ) -> torch.Tensor:
    """Per-anchor argmax matching with dual thresholds.

    Args:
      weights: ``[..., G, A]`` IoU matrix (padded rows may be garbage/NaN).
      gt_mask: ``[..., G]`` bool validity of each GT row.
      matched_threshold / unmatched_threshold: anchors with best overlap below
        ``unmatched`` -> NOT_MATCHED (-2); in ``[unmatched, matched)`` ->
        IGNORE (-1).
      force_match_for_each_target: every valid GT claims its best anchor; on
        conflicts the highest GT index wins.

    Returns:
      ``[..., A]`` int32 GT indices, or the NOT_MATCHED / IGNORE sentinels.
    """
    if unmatched_threshold is None:
        unmatched_threshold = matched_threshold
    if matched_threshold < unmatched_threshold:
        raise ValueError(f'matched_threshold {matched_threshold} < '
                         f'unmatched_threshold {unmatched_threshold}')
    num_gt = weights.shape[-2]
    # padded rows must never win the per-anchor argmax
    w = torch.where(gt_mask[..., None], torch.nan_to_num(weights), -1.0)

    overlap = torch.amax(w, dim=-2)
    box_idx = torch.argmax(w, dim=-2).to(torch.int32)
    below_matched = overlap < matched_threshold
    below_unmatched = overlap < unmatched_threshold
    box_idx = torch.where(below_matched & ~below_unmatched, IGNORE, box_idx)
    box_idx = torch.where(below_unmatched, NOT_MATCHED, box_idx)

    if force_match_for_each_target:
        anchor_idx = torch.argmax(w, dim=-1)  # [..., G] best anchor per GT
        anchors = torch.arange(w.shape[-1], device=w.device)
        hits = (anchor_idx[..., :, None] == anchors) & gt_mask[..., :, None]
        g_ids = torch.where(
            hits, torch.arange(num_gt, dtype=torch.int32,
                               device=w.device)[:, None], -1)
        g_sel = torch.max(g_ids, dim=-2).values
        box_idx = torch.where(g_sel >= 0, g_sel, box_idx)
    return box_idx


class TargetAssigner:
    """Batched target assignment.

    ``__call__(gt, gt_mask, anchors)`` with padded GT ``[B, G, 6]`` (corner
    boxes, class, score), mask ``[B, G]`` and centroid anchors ``[A, 4]``
    returns a ``[B, A, 6]`` target: raw corner loc, class (0 = negative,
    -1 = ignore), score (1 for negatives, -1 for ignores).
    """

    def __init__(self, matched_threshold: float,
                 unmatched_threshold: Optional[float] = None):
        self.matched_threshold = float(matched_threshold)
        self.unmatched_threshold = (float(unmatched_threshold)
                                    if unmatched_threshold is not None
                                    else self.matched_threshold)

    def __call__(self, gt: torch.Tensor, gt_mask: torch.Tensor,
                 anchors: torch.Tensor) -> torch.Tensor:
        corner_anchors = box_ops.to_corners(anchors)
        weights = box_ops.iou(gt[..., LOC_INDEX_START:LOC_INDEX_END],
                              corner_anchors)  # [B, G, A]
        box_idx = match_per_prediction(weights, gt_mask,
                                       self.matched_threshold,
                                       self.unmatched_threshold)
        matched = box_idx >= 0
        ignored = box_idx == IGNORE
        safe_idx = box_idx.clamp(min=0).long()
        picked = torch.gather(
            gt, 1, safe_idx[..., None].expand(-1, -1, gt.shape[-1]))  # [B, A, 6]

        loc = torch.where(matched[..., None],
                          picked[..., LOC_INDEX_START:LOC_INDEX_END], 0.0)
        cls = torch.where(matched, picked[..., CLASS_INDEX], torch.where(
            ignored, float(IGNORE_CLASS), float(NEGATIVE_CLASS)))
        score = torch.where(matched, picked[..., SCORE_INDEX],
                            torch.where(ignored, float(IGNORE_CLASS), 1.0))
        return torch.cat([loc, cls[..., None], score[..., None]], dim=-1)
