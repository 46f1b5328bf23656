"""Box math on tensors: format conversion, areas, IoU.

Port of ``single_shot_detection_tpu/ops/boxes.py``; shape-polymorphic over
leading dims.  The arithmetic order is the reference's, so results agree
bit-for-bit wherever no fused multiply-add is involved.

Conventions:
  * "corners"   = ``[xmin, ymin, xmax, ymax]``
  * "centroids" = ``[cx, cy, w, h]``
"""

from __future__ import annotations

import torch

from single_shot_detection_tpu_torch.ops.ties import ZERO


def to_corners(boxes: torch.Tensor) -> torch.Tensor:
    """Centroid ``[cx, cy, w, h]`` -> corner ``[x0, y0, x1, y1]``."""
    xy, wh = boxes[..., :2], boxes[..., 2:]
    return torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)


def to_centroids(boxes: torch.Tensor) -> torch.Tensor:
    """Corner ``[x0, y0, x1, y1]`` -> centroid ``[cx, cy, w, h]``."""
    mins, maxs = boxes[..., :2], boxes[..., 2:]
    return torch.cat([(mins + maxs) / 2, maxs - mins], dim=-1)


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of corner-format boxes; degenerate boxes clamp to 0 (NaN stays
    NaN, as ``jnp.clip`` leaves it).  The clamp is ``torch.maximum``, which
    passes half the gradient at a zero width as ``jnp.clip`` does
    (``torch.clamp`` passes all of it)."""
    w = torch.maximum(boxes[..., 2] - boxes[..., 0], ZERO)
    h = torch.maximum(boxes[..., 3] - boxes[..., 1], ZERO)
    return w * h


def intersection(a: torch.Tensor, b: torch.Tensor,
                 cartesian: bool = True) -> torch.Tensor:
    """Intersection *boxes* (corner format).

    ``cartesian=True``:  a ``[..., N, 4]`` x b ``[..., M, 4]`` -> ``[..., N, M, 4]``.
    ``cartesian=False``: elementwise over identical shapes.
    """
    if cartesian:
        mins = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
        maxs = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    else:
        mins = torch.maximum(a[..., :2], b[..., :2])
        maxs = torch.minimum(a[..., 2:], b[..., 2:])
    return torch.cat([mins, maxs], dim=-1)


def iou(a: torch.Tensor, b: torch.Tensor, cartesian: bool = True) -> torch.Tensor:
    """IoU of corner-format boxes; ``[..., N, M]`` if cartesian else
    elementwise.  ``0 / 0`` (two empty boxes) gives NaN, as in the
    reference."""
    inter = area(intersection(a, b, cartesian=cartesian))
    area_a = area(a)
    area_b = area(b)
    if cartesian:
        area_a = area_a[..., :, None]
        area_b = area_b[..., None, :]
    return inter / (area_a + area_b - inter)


def generalized_iou(a: torch.Tensor, b: torch.Tensor,
                    cartesian: bool = True) -> torch.Tensor:
    """GIoU (arXiv 1902.09630) of corner-format boxes; ``[..., N, M]`` if
    cartesian else elementwise."""
    inter = area(intersection(a, b, cartesian=cartesian))
    area_a = area(a)
    area_b = area(b)
    if cartesian:
        area_a = area_a[..., :, None]
        area_b = area_b[..., None, :]
        enc_mins = torch.minimum(a[..., :, None, :2], b[..., None, :, :2])
        enc_maxs = torch.maximum(a[..., :, None, 2:], b[..., None, :, 2:])
    else:
        enc_mins = torch.minimum(a[..., :2], b[..., :2])
        enc_maxs = torch.maximum(a[..., 2:], b[..., 2:])
    union = area_a + area_b - inter
    enclosing = area(torch.cat([enc_mins, enc_maxs], dim=-1))
    return inter / union - (enclosing - union) / enclosing
