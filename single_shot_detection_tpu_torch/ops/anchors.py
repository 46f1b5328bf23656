"""Anchor (prior box) generation for SSD heads (numpy).

A copy of ``single_shot_detection_tpu/ops/anchors.py`` (the SSD and
RetinaNet generators).  Anchors are pure functions of
``(img_size, feature_map_size)``, computed once in numpy when the model is
built and moved to the device as a constant tensor.

All anchors are centroid format ``[cx, cy, w, h]`` in *pixel* units of the
input image, flattened in ``(H, W, box)`` order: the order of the heads'
outputs after their ``NCHW -> NHWC`` permute (models/detector.py).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np


class SsdAnchorGenerator:
    """Per-scale SSD prior boxes (parity: ssd.py:55-151).

    Box set per cell: one box per (expanded) aspect ratio at ``min`` size, plus
    an extra ``sqrt(min*max)`` box, repeated for each of ``num_branches`` size
    interpolation branches.  Aspect ratios > 1 are auto-flipped (``r`` and
    ``1/r``) when ``flip``.
    """

    def __init__(self,
                 aspect_ratios: Sequence[float],
                 min_scale: Optional[float] = None,
                 max_scale: Optional[float] = None,
                 min_size: Optional[float] = None,
                 max_size: Optional[float] = None,
                 step: Optional[float] = None,
                 offset: Sequence[float] = (0.5, 0.5),
                 num_branches: int = 1,
                 flip: bool = True,
                 clip: bool = False):
        # scale-vs-size exclusivity (same constraints the reference enforces,
        # ssd.py:69-76): max_* requires its min_*, and the relative-scale /
        # absolute-size parameterizations are mutually exclusive
        if max_scale is not None and min_scale is None:
            raise ValueError('max_scale requires min_scale to be set too')
        if max_size is not None and min_size is None:
            raise ValueError('max_size requires min_size to be set too')
        if min_scale is not None and min_size is not None:
            raise ValueError('min_scale and min_size are mutually exclusive — '
                             'configure scales or absolute sizes, not both')

        self.min_scale = min_scale
        self.max_scale = max_scale
        self.min_size = min_size
        self.max_size = max_size
        self.num_branches = num_branches
        self.clip = clip
        self.offset = tuple(offset)
        self.step = step

        self.aspect_ratios = []
        for ar in aspect_ratios:
            assert ar >= 1.0 or not flip
            self.aspect_ratios.append(ar)
            if ar > 1.0 and flip:
                self.aspect_ratios.append(1.0 / ar)

        self.num_ratios = len(self.aspect_ratios)
        if max_scale or max_size:
            self.num_ratios += 1
        self.num_boxes = self.num_ratios * num_branches

    def _branch_sizes(self, img_w: float, img_h: float) -> np.ndarray:
        """``[num_branches + 1, 2]`` array of (w, h) sizes per branch boundary."""
        if self.min_size is not None and self.max_size is not None:
            s = np.linspace(self.min_size, self.max_size, self.num_branches + 1)
            return np.stack([s, s], axis=1)
        scales = np.linspace(self.min_scale, self.max_scale, self.num_branches + 1)
        return np.stack([scales * img_w, scales * img_h], axis=1)

    def __call__(self, img_size, feature_map_size) -> np.ndarray:
        """(img_w, img_h), (layer_w, layer_h) -> ``[H, W, num_boxes, 4]`` float32."""
        img_w, img_h = img_size
        layer_w, layer_h = feature_map_size

        step_w = self.step if self.step is not None else img_w / layer_w
        step_h = self.step if self.step is not None else img_h / layer_h

        sizes = self._branch_sizes(img_w, img_h)
        hws = np.empty((self.num_boxes, 2), dtype=np.float32)
        for j in range(self.num_branches):
            min_size, max_size = sizes[j], sizes[j + 1]
            for i, r in enumerate(self.aspect_ratios):
                hws[j * self.num_ratios + i, 0] = min_size[0] * math.sqrt(r)
                hws[j * self.num_ratios + i, 1] = min_size[1] / math.sqrt(r)
            hws[j * self.num_ratios + len(self.aspect_ratios), 0] = math.sqrt(min_size[0] * max_size[0])
            hws[j * self.num_ratios + len(self.aspect_ratios), 1] = math.sqrt(min_size[1] * max_size[1])

        xs = np.linspace(self.offset[0] * step_w, (self.offset[0] + layer_w - 1) * step_w, layer_w)
        ys = np.linspace(self.offset[1] * step_h, (self.offset[1] + layer_h - 1) * step_h, layer_h)
        x_grid, y_grid = np.meshgrid(xs, ys)  # both [H, W]

        boxes = np.empty((layer_h, layer_w, self.num_boxes, 4), dtype=np.float32)
        boxes[..., 0] = x_grid[..., None]
        boxes[..., 1] = y_grid[..., None]
        boxes[..., 2] = hws[:, 0]
        boxes[..., 3] = hws[:, 1]

        if self.clip:
            boxes[..., 0] = boxes[..., 0].clip(0, img_w - 1)
            boxes[..., 2] = boxes[..., 2].clip(0, img_w - 1)
            boxes[..., 1] = boxes[..., 1].clip(0, img_h - 1)
            boxes[..., 3] = boxes[..., 3].clip(0, img_h - 1)

        return boxes


class RetinaAnchorGenerator:
    """Per-FPN-level RetinaNet anchors (parity: retina_net.py:18-54):
    ``scales_per_level`` sizes ``scale * 2 ** (level + x / scales_per_level)``
    times each aspect ratio, centred on the level's grid."""

    def __init__(self, aspect_ratios, level, scale, scales_per_level=1):
        self.aspect_ratios = list(aspect_ratios)
        self.num_boxes = len(self.aspect_ratios) * scales_per_level
        self.sizes = [scale * (2 ** (level + x / scales_per_level))
                      for x in range(scales_per_level)]

    def __call__(self, img_size, feature_map_size) -> np.ndarray:
        img_w, img_h = img_size
        layer_w, layer_h = feature_map_size
        step_w = img_w / layer_w
        step_h = img_h / layer_h

        hws = np.empty((self.num_boxes, 2), dtype=np.float32)
        for j, size in enumerate(self.sizes):
            for i, ar in enumerate(self.aspect_ratios):
                hws[j * len(self.aspect_ratios) + i, 0] = size * math.sqrt(ar)
                hws[j * len(self.aspect_ratios) + i, 1] = size / math.sqrt(ar)

        xs = np.linspace(0.5 * step_w, (0.5 + layer_w - 1) * step_w, layer_w)
        ys = np.linspace(0.5 * step_h, (0.5 + layer_h - 1) * step_h, layer_h)
        x_grid, y_grid = np.meshgrid(xs, ys)

        boxes = np.empty((layer_h, layer_w, self.num_boxes, 4), dtype=np.float32)
        boxes[..., 0] = x_grid[..., None]
        boxes[..., 1] = y_grid[..., None]
        boxes[..., 2] = hws[:, 0]
        boxes[..., 3] = hws[:, 1]
        return boxes


def build_ssd_anchor_generators(num_scales: int = 6,
                                sizes: Optional[Sequence[float]] = None,
                                min_scale: Optional[float] = None,
                                max_scale: Optional[float] = None,
                                aspect_ratios=None,
                                steps=None,
                                offsets=(0.5, 0.5),
                                num_branches=None,
                                clip: bool = False):
    """Fan out one SsdAnchorGenerator per scale (parity: ssd.py:12-53)."""
    if aspect_ratios is None:
        aspect_ratios = [[1.0, 2.0]] + [[1.0, 2.0, 3.0]] * 3 + [[1.0, 2.0]] * 2
    assert sizes is not None or (min_scale is not None and max_scale is not None)

    if steps is None:
        steps = [None] * num_scales
    assert len(steps) == num_scales
    if num_branches is None:
        num_branches = [1] * num_scales
    assert len(num_branches) == num_scales
    assert len(aspect_ratios) == num_scales

    scales = None
    if min_scale is not None and max_scale is not None:
        scales = np.linspace(min_scale, max_scale, num_scales + 1)

    generators = []
    for i, (ratios, step, branches) in enumerate(zip(aspect_ratios, steps, num_branches)):
        if scales is not None:
            kwargs = {'min_scale': float(scales[i]), 'max_scale': float(scales[i + 1])}
        else:
            kwargs = {'min_size': sizes[i], 'max_size': sizes[i + 1]}
        generators.append(SsdAnchorGenerator(ratios, step=step, num_branches=branches,
                                             offset=offsets, clip=clip, **kwargs))
    return generators


def build_retina_anchor_generators(aspect_ratios, min_level, max_level, scale,
                                   scales_per_level=1):
    """One RetinaAnchorGenerator per pyramid level (parity: retina_net.py:10-16)."""
    return [RetinaAnchorGenerator(aspect_ratios, level, scale, scales_per_level)
            for level in range(min_level, max_level + 1)]


_BUILDERS = {
    'ssd': build_ssd_anchor_generators,
    'retina_net': build_retina_anchor_generators,
}


def build_anchor_generators(type: str = 'ssd', **kwargs):
    """Config-driven anchor generator factory (parity: detector_builder.py:28-29)."""
    from single_shot_detection_tpu_torch.utils.misc import filter_kwargs
    builder = _BUILDERS[type]
    return filter_kwargs(builder)(**kwargs)


def generate_anchors(generators, img_size, feature_map_sizes) -> np.ndarray:
    """Concatenate per-scale anchors into flat ``[A, 4]`` centroid pixel boxes.

    ``img_size``/``feature_map_sizes`` are ``(w, h)`` tuples.  Ordering matches
    the head outputs: scale-major, then (H, W, box).
    Parity: detector.py:82-86 (``generate_anchors``).
    """
    assert len(generators) == len(feature_map_sizes)
    flat = [gen(img_size, fm).reshape(-1, 4)
            for gen, fm in zip(generators, feature_map_sizes)]
    return np.concatenate(flat, axis=0).astype(np.float32)
