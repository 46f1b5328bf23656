"""Batched detection postprocessing: score conversion, box decoding,
per-class top-k, hard NMS, global top-k.

Port of ``single_shot_detection_tpu/ops/postprocess.py``.  The whole batch is
one fixed-shape pass: scores and boxes of every (image, class) pair are ranked
and suppressed together, and the result is a padded ``[B, max_total, 6]``
detection tensor plus a ``valid`` mask.  The hard NMS runs on the CUDA kernel
(``ops/nms_kernel.py``) for CUDA tensors; Gaussian soft-NMS (``nms.soft``)
is plain PyTorch (``ops/nms.py::soft_nms``), as the JAX package runs it
outside its Pallas kernel.

The dict form of ``pre_nms_top_k`` (``{'k': n, 'approx': True,
'recall_target': r}``) asks JAX for ``jax.lax.approx_max_k``, whose TPU
partial reduction returns at least ``r`` of the true top ``n``; off a TPU
it is an exact top-k, and here it is always the exact one (which meets any
recall target).

Every top-k is a stable descending sort: among equal scores the lower index
comes first, as ``jax.lax.top_k`` orders them (``torch.topk`` on CUDA does not
promise an order among ties, which would reorder the ``-inf`` slots).
"""

from __future__ import annotations

import torch

from single_shot_detection_tpu_torch.ops import boxes as box_ops
from single_shot_detection_tpu_torch.ops import nms as nms_ops
from single_shot_detection_tpu_torch.ops import nms_kernel
from single_shot_detection_tpu_torch.ops.box_coder import BoxCoder


def stable_top_k(values: torch.Tensor, k: int):
    """``(top values, indices)`` along the last dim, lower index first
    among ties (``jax.lax.top_k``'s order)."""
    top, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return top[..., :k], idx[..., :k]


class Postprocessor:
    """Config-driven postprocessor.

    ``__call__(scores, locs, anchors)`` with raw head outputs
      scores ``[B, A, C_raw]``, locs ``[B, A, 4]``, anchors ``[A, 4]`` centroid
    returns ``detections [B, max_total, 6]`` rows ``[x0, y0, x1, y1, class,
    score]`` (class ids are 1-based) and ``valid [B, max_total]``.
    ``nms`` holds ``overlap_threshold``, ``max_per_class``, and ``soft``
    with its ``sigma`` for Gaussian soft-NMS (picks keep their original
    scores).
    """

    SERVING_TOP_K = 1000          # standard candidate budget
    SERVING_ANCHOR_THRESHOLD = 10000  # above this, per-class NMS is sort-bound

    def __init__(self,
                 box_coder: BoxCoder,
                 score_threshold: float,
                 nms: dict,
                 score_converter: str = 'SOFTMAX',
                 max_total: int = 200,
                 pre_nms_top_k=None):
        if score_converter not in ('SOFTMAX', 'SIGMOID'):
            raise ValueError(f'Wrong value for score_converter: {score_converter}')
        if isinstance(pre_nms_top_k, dict):
            # 'approx' and 'recall_target' ask for at least that recall of
            # the top k: the exact top-k gives all of it
            pre_nms_top_k = pre_nms_top_k.get('k')
        self.box_coder = box_coder
        self.score_threshold = float(score_threshold)
        self.overlap_threshold = float(nms['overlap_threshold'])
        self.max_per_class = int(nms.get('max_per_class', 100))
        self.soft = bool(nms.get('soft', False))
        self.sigma = float(nms.get('sigma', 0.5))
        self.score_converter = score_converter
        self.max_total = int(max_total) if max_total is not None else None
        self.pre_nms_top_k = int(pre_nms_top_k) if pre_nms_top_k else None

    @staticmethod
    def serving_preset(postprocess_cfg: dict, num_anchors: int) -> dict:
        """The serving paths' preset: ``pre_nms_top_k=1000`` on configs with
        more than 10000 anchors, unless the config pins the key itself
        (pinning it, even to None, wins).  The flagship's 2006 anchors are
        below the threshold, so its serving postprocessor is the config's."""
        pp = dict(postprocess_cfg or {})
        if ('pre_nms_top_k' not in pp
                and int(num_anchors) > Postprocessor.SERVING_ANCHOR_THRESHOLD):
            pp['pre_nms_top_k'] = Postprocessor.SERVING_TOP_K
        return pp

    def nms_keep(self, boxes: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
        """Keep mask of ``[N, K]`` score-sorted problems: the CUDA kernel
        for CUDA tensors, its plain version for CPU tensors."""
        return nms_kernel.nms_keep_batched(boxes, scores,
                                           self.overlap_threshold)

    def __call__(self, scores: torch.Tensor, locs: torch.Tensor,
                 anchors: torch.Tensor):
        batch, num_anchors = scores.shape[0], anchors.shape[0]
        scores = scores.reshape(batch, num_anchors, -1).float()
        locs = locs.reshape(batch, num_anchors, 4).float()

        if self.score_converter == 'SOFTMAX':
            probs = torch.softmax(scores, dim=-1)[..., 1:]  # drop background
        else:
            probs = torch.sigmoid(scores)
        num_classes = probs.shape[-1]

        boxes = box_ops.to_corners(self.box_coder.decode(locs, anchors))
        rows = torch.arange(batch, device=scores.device)

        # Optional candidate pre-selection: one exact top-k over anchors by
        # best-class score (the approximate one too, see the module's
        # docstring).
        if self.pre_nms_top_k is not None and self.pre_nms_top_k < num_anchors:
            _, cand = stable_top_k(probs.max(dim=-1).values, self.pre_nms_top_k)
            probs = probs[rows[:, None], cand]                 # [B, N, C]
            boxes = boxes[rows[:, None], cand]                 # [B, N, 4]
            num_anchors = self.pre_nms_top_k

        # Per (image, class): score threshold -> top max_per_class -> NMS.
        k = min(self.max_per_class, num_anchors)
        cls_scores = probs.transpose(1, 2)                     # [B, C, A]
        gated = torch.where(cls_scores > self.score_threshold, cls_scores,
                            float('-inf'))
        top_scores, top_idx = stable_top_k(gated, k)           # [B, C, K]
        top_scores = top_scores.contiguous()
        top_boxes = boxes[rows[:, None, None], top_idx]        # [B, C, K, 4]

        if self.soft:
            valid_in = top_scores > float('-inf')
            keep = nms_ops.soft_nms(
                top_boxes, torch.where(valid_in, top_scores, 0.0),
                self.score_threshold, self.sigma) & valid_in
        else:
            keep = self.nms_keep(top_boxes.reshape(-1, k, 4),
                                 top_scores.reshape(-1, k)
                                 ).reshape(top_scores.shape)
        kept_scores = torch.where(keep, top_scores, float('-inf'))

        # Flatten classes, attach 1-based class ids, take the global top.
        class_ids = torch.arange(1, num_classes + 1, dtype=torch.float32,
                                 device=scores.device)
        flat_scores = kept_scores.reshape(batch, -1)
        flat_boxes = top_boxes.reshape(batch, -1, 4)
        flat_classes = class_ids[:, None].expand(num_classes, k).reshape(-1)

        total = flat_scores.shape[1]
        if self.max_total is not None:
            total = min(self.max_total, total)
        final_scores, idx = stable_top_k(flat_scores, total)
        final_boxes = flat_boxes[rows[:, None], idx]
        final_classes = flat_classes[idx]

        valid = final_scores > float('-inf')
        out_scores = torch.where(valid, final_scores, 0.0)
        detections = torch.cat(
            [final_boxes, final_classes[..., None], out_scores[..., None]],
            dim=-1)
        return detections, valid
