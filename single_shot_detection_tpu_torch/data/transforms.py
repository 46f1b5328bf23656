"""On-device augmentation chain and preprocessing, batched over the images of
a batch.

Port of the JAX package's ``data/transforms.py``.  All geometry composes
into one per-image affine view ``[X, Y] = t + D @ [x, y]`` from current-frame
pixels to staged-image coordinates (``D`` a signed permutation: flips and
90-degree rotations change signs and axes, crops and expands translate), and
the whole batch is produced by one bilinear resample with out-of-frame fill
(:func:`sample_view`); the photometric ops and the normalization act on the
staged image around it.  Rejection sampling (50 crop or expand attempts)
becomes 50 parallel candidates with a first-accept argmax.

Every op works on the whole batch at once: the per-image scalars of the JAX
package's vmapped ops are ``[B]`` tensors here, the window state is
``(cur_w [B], cur_h [B], D [B, 2, 2], t [B, 2], valid [B, 4], boxes [B, G, R],
mask [B, G])``.

Draws are explicit.  Each op takes the random numbers it needs as a dict of
``[B, ...]`` tensors (its *draws*), so the same draws give the same result
on any device, and a test can inject the draws the JAX package's keys give.
:meth:`Pipeline.sample_draws` draws them from a ``torch.Generator``,
:meth:`Pipeline.apply` applies given draws, and ``Pipeline.__call__`` does
both.  All draws are float32; the integer ones (``k`` of ``rot90``, ``pick``
of ``OneOf``) hold whole numbers.  As in the JAX package, every branch of a
``OneOf`` sees the same random stream, so branches of one kind share their
draws (the six ``RandomCrop`` branches of the flagship see the same 50
candidates and differ in ``min_iou`` only).  A ``OneOf`` of crops and
identities runs as one crop with each image's picked branch's draws,
``min_iou`` and ``p``; any other ``OneOf`` evaluates every branch and
selects per image.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from single_shot_detection_tpu_torch.data.preprocess import Preprocess

ATTEMPTS = 50

Draws = Dict[str, Any]


# ---------------------------------------------------------------------------
# photometric ops (float32 [B, H, W, 3] images in [0, 255])
# ---------------------------------------------------------------------------

def yuv420_to_rgb(packed: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Packed planar YUV420 ``[B, H*W*3//2]`` uint8 -> RGB uint8 ``[B, H, W,
    3]``: the inverse of the loader's YUV420 staging (``data/native.py``),
    a bilinear chroma upsample (half-pixel centres, the edge clamped: at
    this exact 2x enlargement ``jax.image.resize``'s ``linear`` weights)
    and the BT.601 full-range matrix.  ``size`` is the staging (w, h)."""
    w, h = size
    n = h * w
    q = (h // 2) * (w // 2)
    y = packed[:, :n].reshape(-1, h, w).float()

    def up(plane):
        c = plane.reshape(-1, 1, h // 2, w // 2).float()
        return F.interpolate(c, size=(h, w), mode='bilinear',
                             align_corners=False)[:, 0] - 128.0

    cb = up(packed[:, n:n + q])
    cr = up(packed[:, n + q:])
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8)


def _rgb_to_hsv(rgb):
    """RGB [0,1] -> HSV with h in [0,1)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(dim=-1)
    minc = rgb.amin(dim=-1)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), 0.0)
    safe = torch.clamp(delta, min=1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)  # a floor modulus, as jnp's %
    h = torch.where(delta == 0, 0.0, h)
    return torch.stack([h, s, v], dim=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.int(), 6)

    def pick(opts):
        out = opts[0]
        for k in range(1, 6):
            out = torch.where(i == k, opts[k], out)
        return out
    r = pick([v, q, p, p, t, v])
    g = pick([t, v, v, q, p, p])
    b = pick([p, p, t, v, v, q])
    return torch.stack([r, g, b], dim=-1)


def _per_image(x):
    """``[B]`` -> ``[B, 1, 1, 1]`` to broadcast over ``[B, H, W, 3]``."""
    return x[:, None, None, None]


def adjust_brightness(draws: Draws, img, max_delta, p):
    """img += u(-d, d) * 255 with probability ``p``.  Draws: ``delta`` in
    [-d, d), ``u`` in [0, 1)."""
    delta = draws['delta'] * 255.0
    apply = draws['u'] < p
    return torch.clamp(img + _per_image(torch.where(apply, delta, 0.0)),
                       0.0, 255.0)


def adjust_contrast(draws: Draws, img, delta_range, p):
    """Scale about the image's mean colour.  Draws: ``scale`` in
    ``delta_range``, ``u``."""
    scale = torch.where(draws['u'] < p, draws['scale'], 1.0)
    mean = img.reshape(img.shape[0], -1, 3).mean(dim=1)[:, None, None, :]
    return torch.clamp(mean + _per_image(scale) * (img - mean), 0.0, 255.0)


def adjust_hue_saturation(draws: Draws, img, max_hue_delta,
                          saturation_delta_range, p):
    """HSV hue shift (wrapping) and saturation scale.  Draws: ``hue_delta``
    (with ``max_hue_delta``), ``sat_scale`` (with
    ``saturation_delta_range``), ``u``."""
    hsv = _rgb_to_hsv(torch.clamp(img, 0.0, 255.0) / 255.0)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    if max_hue_delta is not None:
        h = torch.remainder(h + draws['hue_delta'][:, None, None], 1.0)
    if saturation_delta_range is not None:
        s = torch.clamp(s * draws['sat_scale'][:, None, None], 0.0, 1.0)
    out = _hsv_to_rgb(torch.stack([h, s, v], dim=-1)) * 255.0
    return torch.where(_per_image(draws['u'] < p), out, img)


# ---------------------------------------------------------------------------
# geometric ops on the batched (window, boxes, mask) state
# ---------------------------------------------------------------------------
# State: cur_w, cur_h [B] - size of each virtual current image;
#        D [B, 2, 2] signed permutations, t [B, 2] - current-frame pixel
#        (x, y) maps to staged coords [X, Y] = t + D @ [x, y];
#        valid [B, 4] - staged-coords rect (x0, y0, x1, y1, inclusive) still
#        visible: a crop shrinks it, so a later expand pads with fill instead
#        of re-revealing cropped-away content;
#        boxes [B, G, R] in current-frame coords; mask [B, G].

def _mv(D, v):
    """``D @ v`` per image for ``D [B, 2, 2]``, ``v [B, 2]``.  ``D`` is a
    signed permutation, so each output is one exact product plus an exact
    zero."""
    return D[:, :, 0] * v[:, 0:1] + D[:, :, 1] * v[:, 1:2]


def identity_state(src_w, src_h, boxes, mask):
    """Initial state: each current frame IS its staged image."""
    b, dev = boxes.shape[0], boxes.device
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.full((b,), float(src_w), **f32),
            torch.full((b,), float(src_h), **f32),
            torch.eye(2, **f32).expand(b, 2, 2),
            torch.zeros(b, 2, **f32),
            torch.tensor([0.0, 0.0, src_w - 1.0, src_h - 1.0], **f32).expand(b, 4),
            boxes, mask)


def _first_true(x):
    """Index of the first True along the last dim (0 when none is)."""
    return torch.argmax(x.to(torch.uint8), dim=-1)


def _take(x, idx):
    """``x[b, idx[b]]`` for ``x [B, N, ...]``."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def _candidate_sizes(draws: Draws, cur_w, cur_h):
    """Candidate ``(w, h)`` of the 50 attempts: ``floor(sqrt(area * ar))``
    and ``floor(sqrt(area / ar))``, ``area`` scaled by the current size."""
    ar = draws['ar']
    area = draws['area'] * cur_w[:, None] * cur_h[:, None]
    return torch.floor(torch.sqrt(area * ar)), torch.floor(torch.sqrt(area / ar))


def expand_op(draws: Draws, state, aspect_ratio_range, area_range, p):
    """Canvas expansion with mean fill: the first of 50 candidates at least
    as large as the current frame.  Draws: ``ar``, ``area`` ``[B, 50]`` (in
    their ranges), ``off [B, 2]``, ``u``."""
    del aspect_ratio_range, area_range  # in the draws
    cur_w, cur_h, D, t, valid, boxes, mask = state
    new_w, new_h = _candidate_sizes(draws, cur_w, cur_h)
    ok = (new_w >= cur_w[:, None]) & (new_h >= cur_h[:, None])
    idx = _first_true(ok)
    apply = (draws['u'] < p) & ok.any(dim=-1)
    new_w = torch.where(apply, _take(new_w, idx), cur_w)
    new_h = torch.where(apply, _take(new_h, idx), cur_h)
    u = draws['off']
    xmin = torch.where(apply, torch.floor(u[:, 0] * (new_w - cur_w + 1)), 0.0)
    ymin = torch.where(apply, torch.floor(u[:, 1] * (new_h - cur_h + 1)), 0.0)

    shift = torch.stack([xmin, ymin, xmin, ymin], dim=-1)[:, None, :]
    boxes = torch.cat([boxes[..., :4] + shift, boxes[..., 4:]], dim=-1)
    # new-frame pixel x' sees old content at x = x' - xmin
    t = t - _mv(D, torch.stack([xmin, ymin], dim=-1))
    return (new_w, new_h, D, t, valid, boxes, mask)


def _area(x):
    return (torch.clamp(x[..., 2] - x[..., 0], min=0)
            * torch.clamp(x[..., 3] - x[..., 1], min=0))


def _crop_candidate_accept(boxes, mask, region, min_iou, keep_criterion,
                           min_objects_kept):
    """Evaluate crop candidates: ``boxes [..., G, R]``, ``mask [..., G]``,
    ``region [..., 4]`` and ``min_iou [...]`` broadcast over the leading
    dims.  Returns ``(accept [...], keep [..., G], clipped boxes
    [..., G, 4])``."""
    b = boxes[..., :4]
    region = region[..., None, :]
    inter = torch.cat([torch.maximum(b[..., :2], region[..., :2]),
                       torch.minimum(b[..., 2:], region[..., 2:])], dim=-1)
    degenerate = (inter[..., 2:] < inter[..., :2]).any(dim=-1)
    inter = torch.where(degenerate[..., None], 0.0, inter)

    # iou(original, clipped) == |clipped| / |original|
    ia = _area(inter)
    ab = _area(b)
    iou = torch.where(ab > 0, ia / torch.clamp(ab, min=1e-12), 0.0)

    has_boxes = mask.any(dim=-1)
    max_iou = torch.where(mask, iou, -1.0).amax(dim=-1)

    if keep_criterion == 'center_point':
        center = (b[..., :2] + b[..., 2:]) / 2
        keep = ((center > region[..., :2])
                & (center < region[..., 2:])).all(dim=-1)
    elif keep_criterion == 'iou':
        keep = iou > min_iou[..., None]
    else:
        raise ValueError(f'Wrong value for keep_criterion: {keep_criterion}')
    keep = keep & mask

    accept = torch.where(has_boxes,
                         (max_iou > min_iou) & (keep.sum(dim=-1) >= min_objects_kept),
                         True)
    return accept, keep, inter


def crop_op(draws: Draws, state, min_iou=0.5, aspect_ratio_range=(0.5, 2.0),
            area_range=(0.1, 1.0), keep_criterion='center_point',
            min_objects_kept=1, p=0.5):
    """Rejection-sampled crop as 50 parallel candidates, first accept wins.
    Draws: ``ar``, ``area`` ``[B, 50]``, ``off [B, 50, 2]``, ``u``.
    ``min_iou`` and ``p`` are numbers or per-image ``[B]`` tensors."""
    del aspect_ratio_range, area_range  # in the draws
    cur_w, cur_h, D, t, valid, boxes, mask = state
    if not torch.is_tensor(min_iou):
        min_iou = torch.full((boxes.shape[0],), float(min_iou),
                             dtype=torch.float32, device=boxes.device)
    new_w, new_h = _candidate_sizes(draws, cur_w, cur_h)
    cw, ch = cur_w[:, None], cur_h[:, None]
    fits = (new_w <= cw) & (new_h <= ch) & (new_w >= 1) & (new_h >= 1)
    u = draws['off']
    xmin = torch.floor(u[..., 0] * (cw - new_w + 1))
    ymin = torch.floor(u[..., 1] * (ch - new_h + 1))
    regions = torch.stack([xmin, ymin, xmin + new_w - 1, ymin + new_h - 1],
                          dim=-1)                                   # [B, 50, 4]

    accepts, keeps, inters = _crop_candidate_accept(
        boxes[:, None], mask[:, None], regions, min_iou[:, None],
        keep_criterion, min_objects_kept)
    accepts = accepts & fits

    idx = _first_true(accepts)  # first accepted attempt
    apply = accepts.any(dim=-1) & (draws['u'] < p)

    sel_region = _take(regions, idx)
    sel_w, sel_h = _take(new_w, idx), _take(new_h, idx)
    sel_keep = _take(keeps, idx)
    sel_boxes = _take(inters, idx)

    # shift into the crop frame and clip
    x0, y0 = sel_region[:, 0:1], sel_region[:, 1:2]
    hi_w, hi_h = (sel_w - 1)[:, None], (sel_h - 1)[:, None]

    def clip(x, hi):
        return torch.minimum(torch.clamp(x, min=0), hi)
    shifted = torch.stack([clip(sel_boxes[..., 0] - x0, hi_w),
                           clip(sel_boxes[..., 1] - y0, hi_h),
                           clip(sel_boxes[..., 2] - x0, hi_w),
                           clip(sel_boxes[..., 3] - y0, hi_h)], dim=-1)
    new_boxes = torch.where(apply[:, None, None],
                            torch.cat([shifted, boxes[..., 4:]], dim=-1), boxes)
    new_mask = torch.where(apply[:, None], sel_keep, mask)
    out_w = torch.where(apply, sel_w, cur_w)
    out_h = torch.where(apply, sel_h, cur_h)
    # new-frame pixel x' sees old content at x = x' + xmin
    shift = torch.where(apply[:, None], sel_region[:, :2], 0.0)
    t = t + _mv(D, shift)
    # the crop discards everything outside the new frame: intersect the
    # valid rect with the new frame's staged-coords footprint
    p0 = t
    p1 = t + _mv(D, torch.stack([out_w - 1.0, out_h - 1.0], dim=-1))
    lo = torch.minimum(p0, p1)
    hi = torch.maximum(p0, p1)
    new_valid = torch.stack([torch.maximum(valid[:, 0], lo[:, 0]),
                             torch.maximum(valid[:, 1], lo[:, 1]),
                             torch.minimum(valid[:, 2], hi[:, 0]),
                             torch.minimum(valid[:, 3], hi[:, 1])], dim=-1)
    valid = torch.where(apply[:, None], new_valid, valid)
    return (out_w, out_h, D, t, valid, new_boxes, new_mask)


def _flip(draws: Draws, state, p, axis: int):
    """Mirror of the current frame along x (``axis`` 0) or y (1)."""
    cur_w, cur_h, D, t, valid, boxes, mask = state
    flip = draws['u'] < p
    size = (cur_w if axis == 0 else cur_h)[:, None]
    b = boxes
    if axis == 0:
        flipped = [size - 1 - b[..., 2], b[..., 1], size - 1 - b[..., 0], b[..., 3]]
        step = torch.stack([cur_w - 1.0, torch.zeros_like(cur_w)], dim=-1)
        sign = torch.tensor([[-1.0, 1.0], [-1.0, 1.0]], device=D.device)
    else:
        flipped = [b[..., 0], size - 1 - b[..., 3], b[..., 2], size - 1 - b[..., 1]]
        step = torch.stack([torch.zeros_like(cur_h), cur_h - 1.0], dim=-1)
        sign = torch.tensor([[1.0, -1.0], [1.0, -1.0]], device=D.device)
    boxes = torch.where(flip[:, None, None],
                        torch.cat([torch.stack(flipped, dim=-1), b[..., 4:]], dim=-1),
                        boxes)
    t = torch.where(flip[:, None], t + _mv(D, step), t)
    D = torch.where(flip[:, None, None], D * sign, D)
    return (cur_w, cur_h, D, t, valid, boxes, mask)


def hflip_op(draws: Draws, state, p):
    """Horizontal mirror of the current frame.  Draws: ``u``."""
    return _flip(draws, state, p, 0)


def vflip_op(draws: Draws, state, p):
    """Vertical mirror of the current frame.  Draws: ``u``."""
    return _flip(draws, state, p, 1)


def rot90_op(draws: Draws, state):
    """Random 90-degree rotation of the current frame, ``k`` steps.  One
    step maps new-frame (x', y') to old-frame (s-1-y', x'): ``D @= ROT`` and
    ``t += D @ [s-1, 0]``.  A non-square frame is left as it is.  Draws:
    ``k`` in {0, 1, 2, 3}."""
    cur_w, cur_h, D, t, valid, boxes, mask = state
    k = draws['k']
    square = cur_w == cur_h
    s = cur_w[:, None]  # == cur_h wherever the rotation applies

    def rot_boxes_once(b4):
        # frame pixel (x, y) -> (y, s-1-x) under one rotation
        return torch.stack([b4[..., 1], s - 1 - b4[..., 2],
                            b4[..., 3], s - 1 - b4[..., 0]], dim=-1)

    step = torch.stack([cur_w - 1.0, torch.zeros_like(cur_w)], dim=-1)
    d_vars, t_vars, b_vars = [D], [t], [boxes[..., :4]]
    for _ in range(3):
        Dp = d_vars[-1]
        t_vars.append(t_vars[-1] + _mv(Dp, step))
        d_vars.append(torch.stack([Dp[:, :, 1], -Dp[:, :, 0]], dim=-1))  # Dp @ ROT
        b_vars.append(rot_boxes_once(b_vars[-1]))

    sel = [(k == i) & (square | (i == 0)) for i in range(4)]
    sel[0] = sel[0] | ~square

    def select(choices, extra_dims):  # the first true condition wins
        out = torch.zeros_like(choices[0])
        for cond, choice in reversed(list(zip(sel, choices))):
            out = torch.where(cond.reshape(-1, *([1] * extra_dims)), choice, out)
        return out
    b4 = select(b_vars, 2)
    return (cur_w, cur_h, select(d_vars, 2), select(t_vars, 1), valid,
            torch.cat([b4, boxes[..., 4:]], dim=-1), mask)


# ---------------------------------------------------------------------------
# final resample
# ---------------------------------------------------------------------------

def _frame_coords(out: int, cur):
    """``(i + 0.5) * cur / out - 0.5`` for ``i < out`` per image, rounded as
    XLA computes it: the division by the constant ``out`` becomes a product
    with its f32 reciprocal, fused with the subtraction (one rounding: in
    float64 the product of two f32 values is exact).  A coordinate one float
    step off moves a pixel by up to 1e-3 on the 0-255 scale."""
    half = torch.arange(out, dtype=torch.float32, device=cur.device) + 0.5
    scaled = half * cur[:, None]  # rounded in f32, as XLA's
    recip = float(torch.tensor(1.0 / out, dtype=torch.float32))
    return (scaled.double() * recip - 0.5).float()


def sample_view(img, window, out_size, fill):
    """Bilinear resample of each image's affine view ``window = (cur_w,
    cur_h, D, t, valid)`` to ``out_size = (w, h)``: the fusion of
    expand/crop/flip/rotate/resize.

    ``D`` is a signed permutation, so the view is axis-separable: two
    batched products with per-image interpolation matrices,
    ``out = Ry @ img' @ Rx^T + (1 - coverage) * fill``, where
    ``R[i, j] = relu(1 - |src_coord_i - j|)`` are the bilinear weights,
    ``img'`` is the staged image (transposed for odd rotations), weights of
    out-of-frame coordinates or cropped-away pixels are zero, and the
    coverage deficit blends in the fill colour ``fill [B, 3]``.
    ``img [B, S, S, 3]`` -> ``[B, h, w, 3]``.
    """
    out_w, out_h = out_size
    cur_w, cur_h, D, t, valid = window
    if img.shape[1] != img.shape[2]:
        raise ValueError(f'staged images must be square, got {tuple(img.shape)}')
    src = img.shape[1]
    f32 = dict(dtype=torch.float32, device=img.device)

    xs = _frame_coords(out_w, cur_w)  # frame x per output column
    ys = _frame_coords(out_h, cur_h)  # frame y per output row

    # staged X = t0 + D00*x + D01*y ; staged Y = t1 + D10*x + D11*y, one term
    # of each nonzero.  D diagonal: out[r, c] = img[Y(r), X(c)]; anti-diagonal
    # (odd rotation): out[r, c] = imgT[X(r), Y(c)]
    swap = D[:, 0, 1].abs() > 0.5
    row_coords = (torch.where(swap, t[:, 0], t[:, 1])[:, None]
                  + (D[:, 0, 1] + D[:, 1, 1])[:, None] * ys)
    col_coords = (torch.where(swap, t[:, 1], t[:, 0])[:, None]
                  + (D[:, 1, 0] + D[:, 0, 0])[:, None] * xs)

    grid = torch.arange(src, **f32)
    ry = torch.clamp(1.0 - torch.abs(row_coords[..., None] - grid), min=0.0)
    rx = torch.clamp(1.0 - torch.abs(col_coords[..., None] - grid), min=0.0)

    # staged pixels cropped away earlier read as fill
    row_lo = torch.where(swap, valid[:, 0], valid[:, 1])[:, None]
    row_hi = torch.where(swap, valid[:, 2], valid[:, 3])[:, None]
    col_lo = torch.where(swap, valid[:, 1], valid[:, 0])[:, None]
    col_hi = torch.where(swap, valid[:, 3], valid[:, 2])[:, None]
    ry = ry * ((grid >= row_lo) & (grid <= row_hi))[:, None, :]
    rx = rx * ((grid >= col_lo) & (grid <= col_hi))[:, None, :]

    img = torch.where(swap[:, None, None, None], img.transpose(1, 2), img)
    tmp = torch.einsum('byi,bijc->byjc', ry, img)
    out = torch.einsum('byjc,bxj->byxc', tmp, rx)
    coverage = ry.sum(dim=2)[:, :, None] * rx.sum(dim=2)[:, None, :]
    return out + (1.0 - coverage)[..., None] * fill[:, None, None, :]


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------

def _uniform(gen, shape, lo=0.0, hi=1.0):
    return lo + (hi - lo) * torch.rand(shape, generator=gen)


def _randint(gen, high, batch):
    return torch.randint(0, high, (batch,), generator=gen).float()


def sample_stage(kind: str, kw, gen: torch.Generator, batch: int) -> Draws:
    """The draws of one parsed stage ``(kind, kw)`` for ``batch`` images."""
    b = batch
    if kind == 'brightness':
        d = kw['max_delta']
        return {'delta': _uniform(gen, (b,), -d, d), 'u': _uniform(gen, (b,))}
    if kind == 'contrast':
        return {'scale': _uniform(gen, (b,), *kw['delta_range']),
                'u': _uniform(gen, (b,))}
    if kind == 'hue_saturation':
        out = {}
        if kw['max_hue_delta'] is not None:
            d = kw['max_hue_delta']
            out['hue_delta'] = _uniform(gen, (b,), -d, d)
        if kw['saturation_delta_range'] is not None:
            out['sat_scale'] = _uniform(gen, (b,), *kw['saturation_delta_range'])
        out['u'] = _uniform(gen, (b,))
        return out
    if kind in ('expand', 'crop'):
        off = (b, 2) if kind == 'expand' else (b, ATTEMPTS, 2)
        return {'ar': _uniform(gen, (b, ATTEMPTS), *kw['aspect_ratio_range']),
                'area': _uniform(gen, (b, ATTEMPTS), *kw['area_range']),
                'off': _uniform(gen, off), 'u': _uniform(gen, (b,))}
    if kind in ('hflip', 'vflip'):
        return {'u': _uniform(gen, (b,))}
    if kind == 'rot90':
        return {'k': _randint(gen, 4, b)}
    if kind == 'identity':
        return {}
    if kind == 'oneof':
        # every branch sees the same stream, as every branch of a JAX OneOf
        # receives the same key
        seed = int(torch.randint(0, 2 ** 62, (), generator=gen))
        pick = _randint(gen, len(kw), b)
        return {'pick': pick, 'branches': [
            sample_stage(bk, bkw, torch.Generator().manual_seed(seed), b)
            for bk, bkw in kw]}
    raise AssertionError(f'unknown transform kind: {kind}')


def draws_to(draws, device: torch.device):
    """The draws on ``device``, moved in one copy."""
    leaves: List[torch.Tensor] = []

    def collect(node):
        if isinstance(node, torch.Tensor):
            leaves.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                collect(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                collect(v)
    collect(draws)
    if not leaves or all(x.device == device for x in leaves):
        return draws
    flat = torch.cat([x.reshape(-1).float() for x in leaves]).to(device)
    parts = iter(torch.split(flat, [x.numel() for x in leaves]))

    def rebuild(node):
        if isinstance(node, torch.Tensor):
            return next(parts).reshape(node.shape)
        if isinstance(node, dict):
            return {k: rebuild(v) for k, v in node.items()}
        return [rebuild(v) for v in node]
    return rebuild(draws)


# ---------------------------------------------------------------------------
# pipeline assembly from reference-schema config lists
# ---------------------------------------------------------------------------

PHOTOMETRIC_KINDS = ('brightness', 'contrast', 'hue_saturation')
GEOMETRIC_KINDS = ('rot90', 'expand', 'crop', 'hflip', 'vflip')


def _entry_contains(entry, kinds) -> bool:
    """True if a parsed stage entry is (or a nested OneOf branch is) one of
    ``kinds``."""
    kind, kw = entry
    if kind == 'oneof':
        return any(_entry_contains(b, kinds) for b in kw)
    return kind in kinds


def _apply_photo(kind, kw, draws, img):
    if kind == 'brightness':
        return adjust_brightness(draws, img, kw['max_delta'], kw['p'])
    if kind == 'contrast':
        return adjust_contrast(draws, img, kw['delta_range'], kw['p'])
    return adjust_hue_saturation(draws, img, kw['max_hue_delta'],
                                 kw['saturation_delta_range'], kw['p'])


def _select(pick, xs):
    """Per image, the ``pick``-th of the tensors ``xs`` (``[B, ...]``)."""
    if all(x is xs[0] for x in xs):
        return xs[0]
    stacked = torch.stack(xs)
    return stacked[pick.long(), torch.arange(stacked.shape[1], device=stacked.device)]


def _crop_group(branches):
    """``(keep_criterion, min_objects_kept)`` when every branch of a
    ``OneOf`` is a crop with these two, or the identity; else None."""
    crops = [bkw for bk, bkw in branches if bk == 'crop']
    if not crops or any(bk not in ('crop', 'identity') for bk, _ in branches):
        return None
    static = {(c['keep_criterion'], c['min_objects_kept']) for c in crops}
    return static.pop() if len(static) == 1 else None


def _oneof_crop(branches, draws, state, keep_criterion, min_objects_kept):
    """A ``OneOf`` of crops and identities as one crop whose draws,
    ``min_iou`` and ``p`` are each image's picked branch's (an identity
    never applies: ``p`` 0).  Per image the same operations on the same
    values as evaluating every branch and selecting."""
    pick = draws['pick'].long()
    crop_draws = next(d for (bk, _), d in zip(branches, draws['branches'])
                      if bk == 'crop')
    per_branch = [d if bk == 'crop' else crop_draws
                  for (bk, _), d in zip(branches, draws['branches'])]
    rows = torch.arange(pick.shape[0], device=pick.device)
    picked = {name: torch.stack([d[name] for d in per_branch])[pick, rows]
              for name in crop_draws}
    params = torch.tensor([[bkw['min_iou'], bkw['p']] if bk == 'crop'
                           else [0.0, 0.0] for bk, bkw in branches],
                          dtype=torch.float32, device=pick.device)[pick]
    return crop_op(picked, state, min_iou=params[:, 0],
                   keep_criterion=keep_criterion,
                   min_objects_kept=min_objects_kept, p=params[:, 1])


def _apply_stage(kind, kw, draws, img, state):
    """Apply one transform to the ``(staged images, window/box state)``
    pair.  Photometric kinds update the images, geometric kinds the state;
    ``oneof`` runs a group of crops as one crop (:func:`_oneof_crop`), and
    otherwise evaluates every branch and selects one per image.

    ``RandomAdjustContrast`` is not pointwise (its anchor is the image
    mean): placed after a crop or expand, its mean is still taken over the
    full staged image, as in the JAX package.
    """
    if kind in PHOTOMETRIC_KINDS:
        return _apply_photo(kind, kw, draws, img), state
    if kind == 'identity':
        return img, state
    if kind == 'rot90':
        return img, rot90_op(draws, state)
    if kind == 'expand':
        return img, expand_op(draws, state, kw['aspect_ratio_range'],
                              kw['area_range'], kw['p'])
    if kind == 'crop':
        return img, crop_op(draws, state, **kw)
    if kind == 'hflip':
        return img, hflip_op(draws, state, kw['p'])
    if kind == 'vflip':
        return img, vflip_op(draws, state, kw['p'])
    if kind == 'oneof':
        crop_group = _crop_group(kw)
        if crop_group is not None:
            return img, _oneof_crop(kw, draws, state, *crop_group)
        results = [_apply_stage(bk, bkw, bd, img, state)
                   for (bk, bkw), bd in zip(kw, draws['branches'])]
        if len(results) == 1:
            return results[0]
        img_out = _select(draws['pick'], [r[0] for r in results])
        state_out = tuple(_select(draws['pick'], [r[1][i] for r in results])
                          for i in range(len(state)))
        return img_out, state_out
    raise AssertionError(f'unknown transform kind: {kind}')


class Pipeline:
    """Config-driven batched augmentation and preprocessing.

    ``apply(draws, images, boxes, mask)``: uint8 (or float) staged RGB
    ``[B, S, S, 3]``, boxes ``[B, G, R>=4]`` in staged pixels, mask ``[B, G]``
    -> normalized float32 model input ``[B, 3, h, w]``, boxes in output
    pixels, mask.  ``__call__(generator, images, boxes, mask)`` draws from
    ``generator`` (a CPU ``torch.Generator``) and applies.  With
    ``staging_yuv`` (the staging (w, h) of a loader at
    ``staging_colorspace='yuv420'``) images that arrive packed, ``[B,
    S*S*3/2]``, are turned back into RGB first (:func:`yuv420_to_rgb`).
    """

    def __init__(self,
                 augmentations: Sequence[dict] = (),
                 preprocessing: Sequence[dict] = (),
                 input_size: Tuple[int, int] = (300, 300),
                 train: bool = True,
                 staging_yuv: Optional[Tuple[int, int]] = None):
        self.preprocess = Preprocess(preprocessing, input_size)
        self.input_size = self.preprocess.input_size
        self.staging_yuv = tuple(staging_yuv) if staging_yuv else None
        # transforms run in config order: photometric entries update the
        # staged image, geometric ones the window/box state
        self.stages: List[Tuple[str, Any]] = []
        for spec in (list(augmentations) if train else []):
            entry = self._parse_one(spec)
            if entry is not None:
                self.stages.append(entry)
        self._geometric = any(_entry_contains(e, GEOMETRIC_KINDS)
                              for e in self.stages)

        # contrast after a crop or expand anchors at the full staged image's
        # mean, not the view's (flips and rotations keep the mean)
        geo_seen = False
        for entry in self.stages:
            if geo_seen and _entry_contains(entry, ('contrast',)):
                warnings.warn(
                    'RandomAdjustContrast placed after RandomCrop/'
                    'RandomExpand: its mean anchor is the full staged '
                    'image, not the cropped/expanded view the reference '
                    'would use (pixel-level deviation; boxes are '
                    'unaffected). Order photometric transforms before '
                    'geometric ones for exact reference semantics.',
                    stacklevel=2)
                break
            if _entry_contains(entry, ('crop', 'expand')):
                geo_seen = True

    def _parse_one(self, spec):
        """One config transform spec -> (kind, kwargs), or None for no-ops."""
        name = spec['name']
        args = dict(spec.get('args', {}))
        p = args.pop('p', 0.5)
        if name in ('ToFloat', 'ToUint8'):
            return None  # dtype staging is implicit on the device
        if name == 'Identity':
            return ('identity', {})
        if name == 'RandomRotate':
            return ('rot90', {})
        if name == 'RandomAdjustBrightness':
            return ('brightness', {
                'max_delta': args['max_brightness_delta'], 'p': p})
        if name == 'RandomAdjustContrast':
            return ('contrast', {
                'delta_range': tuple(args['contrast_delta_range']), 'p': p})
        if name == 'RandomAdjustHueSaturation':
            return ('hue_saturation', {
                'max_hue_delta': args.get('max_hue_delta'),
                'saturation_delta_range':
                    tuple(args['saturation_delta_range'])
                    if args.get('saturation_delta_range') else None,
                'p': p})
        if name == 'RandomExpand':
            return ('expand', {
                'aspect_ratio_range': tuple(args.get('aspect_ratio_range', (0.5, 2.0))),
                'area_range': tuple(args.get('area_range', (1.0, 16.0))),
                'p': p})
        if name == 'RandomCrop':
            return ('crop', {
                'min_iou': args.get('min_iou', 0.5),
                'aspect_ratio_range': tuple(args.get('aspect_ratio_range', (0.5, 2.0))),
                'area_range': tuple(args.get('area_range', (0.1, 1.0))),
                'keep_criterion': args.get('keep_criterion', 'center_point'),
                'min_objects_kept': args.get('min_objects_kept', 1),
                'p': p})
        if name == 'RandomHorizontalFlip':
            return ('hflip', {'p': p})
        if name == 'RandomVerticalFlip':
            return ('vflip', {'p': p})
        if name == 'OneOf':
            return ('oneof', [self._parse_one(sub) or ('identity', {})
                              for sub in args['transforms']])
        raise NotImplementedError(f'Unsupported augmentation: {name}')

    def sample_draws(self, generator: torch.Generator, batch: int) -> list:
        """One draws dict per stage, for ``batch`` images, on the
        generator's device."""
        return [sample_stage(kind, kw, generator, batch)
                for kind, kw in self.stages]

    def apply(self, draws: list, images: torch.Tensor, boxes: torch.Tensor,
              mask: torch.Tensor):
        """Apply the stages with the given draws (see the class doc)."""
        if self.staging_yuv is not None and images.dim() == 2:
            images = yuv420_to_rgb(images, self.staging_yuv)
        img = images.float()
        src_h, src_w = img.shape[1:3]
        state = identity_state(src_w, src_h, boxes, mask)
        for (kind, kw), d in zip(self.stages, draws):
            img, state = _apply_stage(kind, kw, d, img, state)
        cur_w, cur_h, D, t, valid, boxes, mask = state
        out_w, out_h = self.input_size

        if self._geometric or (src_w, src_h) != (out_w, out_h):
            fill = img.mean(dim=(1, 2))  # the expand fill, after photometrics
            img = sample_view(img, (cur_w, cur_h, D, t, valid), (out_w, out_h),
                              fill)
        # else the view is the identity, exactly

        # boxes to the output frame, clipped
        sx = (out_w / cur_w)[:, None]
        sy = (out_h / cur_h)[:, None]
        resized = torch.stack([
            torch.clamp(boxes[..., 0] * sx, 0, out_w - 1),
            torch.clamp(boxes[..., 1] * sy, 0, out_h - 1),
            torch.clamp(boxes[..., 2] * sx, 0, out_w - 1),
            torch.clamp(boxes[..., 3] * sy, 0, out_h - 1),
        ], dim=-1)
        boxes = torch.cat([resized, boxes[..., 4:]], dim=-1)
        # degenerate boxes are dropped
        degenerate = ((boxes[..., 0] == boxes[..., 2])
                      | (boxes[..., 1] == boxes[..., 3]))
        return self.preprocess.normalize(img), boxes, mask & ~degenerate

    def __call__(self, generator: torch.Generator, images: torch.Tensor,
                 boxes: torch.Tensor, mask: torch.Tensor):
        draws = draws_to(self.sample_draws(generator, images.shape[0]),
                         images.device)
        return self.apply(draws, images, boxes, mask)
