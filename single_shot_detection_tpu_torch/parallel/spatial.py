"""Spatial (height) sharding over the model axis: ``train.spatial_sharding``.

Port of the JAX engine's height-sharded batch (``parallel/mesh.py``'s
``_data_spec`` with ``spatial=True``), where GSPMD inserted the halo
exchanges.  Here every activation is held in a balanced split of its
*global* height over the model group (:func:`split`: rank ``k`` of ``m``
holds ``H // m`` rows, one more for ``k < H % m``; a share may be empty)
and each op with vertical extent works out, from its geometry, the input
rows its own output rows need and fetches only the missing ones from the
ranks that own them (:class:`_Halo`, point-to-point); the backward sends
their gradients back and adds them.  No rank holds a whole activation.

The ops: :func:`conv2d` (kernel, stride, dilation, symmetric padding and
``layers.Conv2d.pad``'s TF-style asymmetric padding, zero rows only at the
global edges), :func:`max_pool2d` (padding of ``-inf``, VGG's 75 -> 37),
:func:`interpolate` to a global size (``nearest`` by the source index the
whole map's resize takes, ``bilinear`` by its two rows and weights),
:func:`mean_hw` (sums and counts all-reduced over the model group), a
GroupNorm's moments (:func:`group_norm`), and :func:`gather_anchors`, the
heads' outputs gathered along the anchor axis in the one-process order.
BN statistics reduce over the model and the data group (the world).

Each op learns its input's global height by an all-gather of the local
heights over the model group, once per detector, op and image height: the
ranks run one sequence of ops, so the heights of the k-th op of a
detector's forward at a given image height are kept (:func:`begin`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from single_shot_detection_tpu_torch.parallel import mesh

# (model, image height, op index) -> global height of the op's input
_HEIGHTS: Dict[tuple, int] = {}
_TRACE = {'key': None, 'op': 0}
# counters a test and the chip smoke read: the most rows any op's window
# held beyond the rank's own share, the largest map a window held whole,
# and the halo rows and bytes received
STATS = {'max_extra_rows': 0, 'largest_whole': 0, 'rows_received': 0,
         'halo_bytes': 0}


def active() -> bool:
    return mesh.model_mode() == 'spatial'


def split(height: int, m: int, k: int) -> Tuple[int, int]:
    """Rank ``k``'s rows ``[lo, hi)`` of a global ``height`` in the
    balanced split over ``m`` ranks."""
    q, r = divmod(int(height), int(m))
    lo = k * q + min(k, r)
    return lo, lo + q + (1 if k < r else 0)


def begin(model: object, image_height: int) -> None:
    """Start a forward of ``model`` (a token of the detector) at
    ``image_height`` rows: the op count restarts."""
    _TRACE['key'] = (model, int(image_height))
    _TRACE['op'] = 0


def global_height(x: torch.Tensor) -> int:
    """The global height of the height-sharded map ``x`` (a collective
    over the model group the first time the op is met at this image
    height)."""
    key = (*_TRACE['key'], _TRACE['op'])
    _TRACE['op'] += 1
    axis = mesh.model_axis()
    h = x.shape[2]
    if key not in _HEIGHTS:
        device = mesh._comm_device()
        heights = torch.cat(mesh.all_gather(
            torch.tensor([h], dtype=torch.int64, device=device), 'model'))
        _HEIGHTS[key] = int(heights.sum())
    height = _HEIGHTS[key]
    lo, hi = split(height, axis.size, axis.index)
    if hi - lo != h:
        raise RuntimeError(f'a height-sharded map of {h} rows on rank '
                           f'{axis.index}; its global height {height} gives '
                           f'{hi - lo}')
    return height


def own_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a whole ``[B, C, H, W]`` map (the image)."""
    axis = mesh.model_axis()
    lo, hi = split(x.shape[2], axis.size, axis.index)
    return x[:, :, lo:hi]


def _overlap(a: Tuple[int, int], b: Tuple[int, int]) -> Tuple[int, int]:
    return max(a[0], b[0]), min(a[1], b[1])


class _Halo(torch.autograd.Function):
    """The input rows ``needs[k]`` of this rank from the local rows of a
    height-sharded map of global height ``height``: its own rows copied,
    the others received from their owners, while this rank sends every
    other rank the rows of its own that that rank needs.  Backward: the
    gradients of the received rows go back to their owners and are added
    to theirs."""

    @staticmethod
    def forward(ctx, x, height: int, needs: Sequence[Tuple[int, int]]):
        axis = mesh.model_axis()
        k, m = axis.index, axis.size
        owns = [split(height, m, j) for j in range(m)]
        ctx.meta = (height, list(needs), owns)
        lo, hi = needs[k]
        window = x.new_empty(x.shape[:2] + (hi - lo,) + x.shape[3:])
        sends, recvs = [], []
        own = owns[k]
        for j in range(m):
            a, b = _overlap(needs[j], own)
            if b <= a:
                continue
            rows = x[:, :, a - own[0]:b - own[0]]
            if j == k:
                window[:, :, a - lo:b - lo] = rows
            else:
                sends.append((mesh.model_rank(j), rows))
        into = []
        for j in range(m):
            a, b = _overlap((lo, hi), owns[j])
            if j != k and b > a:
                buf = x.new_empty(x.shape[:2] + (b - a,) + x.shape[3:])
                recvs.append((mesh.model_rank(j), buf))
                into.append((a, b))
        mesh.exchange(sends, recvs)
        for (_, buf), (a, b) in zip(recvs, into):
            window[:, :, a - lo:b - lo] = buf
        extra = sum(b - a for a, b in into)
        STATS['max_extra_rows'] = max(STATS['max_extra_rows'], extra)
        STATS['rows_received'] += extra
        STATS['halo_bytes'] += sum(buf.numel() * buf.element_size()
                                   for _, buf in recvs)
        if hi - lo == height:
            STATS['largest_whole'] = max(STATS['largest_whole'], height)
        return window

    @staticmethod
    def backward(ctx, grad):
        height, needs, owns = ctx.meta
        axis = mesh.model_axis()
        k, m = axis.index, axis.size
        lo, hi = needs[k]
        own = owns[k]
        grad = grad.contiguous()
        dx = grad.new_zeros(grad.shape[:2] + (own[1] - own[0],)
                            + grad.shape[3:])
        sends, recvs, into = [], [], []
        for j in range(m):
            a, b = _overlap((lo, hi), owns[j])
            if b <= a:
                continue
            rows = grad[:, :, a - lo:b - lo]
            if j == k:
                dx[:, :, a - own[0]:b - own[0]] += rows
            else:
                sends.append((mesh.model_rank(j), rows))
        for j in range(m):
            a, b = _overlap(needs[j], own)
            if j != k and b > a:
                buf = grad.new_empty(grad.shape[:2] + (b - a,)
                                     + grad.shape[3:])
                recvs.append((mesh.model_rank(j), buf))
                into.append((a, b))
        mesh.exchange(sends, recvs)
        for (_, buf), (a, b) in zip(recvs, into):
            dx[:, :, a - own[0]:b - own[0]] += buf
            STATS['halo_bytes'] += buf.numel() * buf.element_size()
        return dx, None, None


def _window(x: torch.Tensor, height: int, needs) -> torch.Tensor:
    return _Halo.apply(x, height, needs)


def _empty_like_out(window: torch.Tensor, shape) -> torch.Tensor:
    """A map of no rows that stays in the graph of ``window`` (so the
    halo's backward runs on every rank)."""
    return window.new_zeros(shape) + window.sum() * 0


def _rows_for(out_height: int, m: int, span) -> List[Tuple[int, int]]:
    """Each rank's input rows for its output rows (``span(lo, hi) ->
    (a, b)``, already clipped), ``(0, 0)`` for an empty share."""
    needs = []
    for j in range(m):
        lo, hi = split(out_height, m, j)
        needs.append(span(lo, hi) if hi > lo else (0, 0))
    return needs


def sliding_plan(height: int, kernel: int, stride: int, dilation: int,
                 top: int, bottom: int, m: int):
    """The rows rule of a sliding op (a conv or a pool) of vertical
    ``kernel``, ``stride`` and ``dilation``, padded by ``top`` and
    ``bottom`` rows, on a map of global ``height`` over ``m`` ranks:
    ``(output height, needs, edges)``, where rank ``j``'s output rows
    (``split(output height, m, j)``) read input rows ``needs[j] = (a,
    b)`` and the padding rows ``edges[j] = (above, below)`` that fall
    outside the map (the global edges only)."""
    reach = dilation * (kernel - 1) + 1
    out_height = (height + top + bottom - reach) // stride + 1
    needs, edges = [], []
    for j in range(m):
        lo, hi = split(out_height, m, j)
        if hi <= lo:
            needs.append((0, 0))
            edges.append((0, 0))
            continue
        a = lo * stride - top
        b = (hi - 1) * stride - top + reach
        needs.append((max(a, 0), min(b, height)))
        edges.append((max(0, -a), max(0, b - height)))
    return out_height, needs, edges


def _sliding(x: torch.Tensor, kernel: int, stride: int, dilation: int,
             top: int, bottom: int, fill: float):
    """This rank's window of a sliding op, padded at the global edges with
    ``fill`` rows, or None when its output is empty; and the window."""
    axis = mesh.model_axis()
    height = global_height(x)
    out_height, needs, edges = sliding_plan(height, kernel, stride, dilation,
                                            top, bottom, axis.size)
    window = _window(x, height, needs)
    lo, hi = split(out_height, axis.size, axis.index)
    if hi <= lo:
        return None, window
    above, below = edges[axis.index]
    padded = window
    if above or below:
        padded = F.pad(window, (0, 0, above, below), value=fill)
    return padded, window


def conv2d(module, x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``module``'s conv (a ``layers.Conv2d``: stride, dilation, padding,
    groups and ``pad``) on a height-sharded ``x``; a height-sharded
    output."""
    pl, pr, pt, pb = module.pad or (0, 0, 0, 0)
    ph, pw = module.padding
    padded, window = _sliding(x, weight.shape[2], module.stride[0],
                              module.dilation[0], ph + pt, ph + pb, 0.0)
    if padded is None:
        kw = weight.shape[3]
        w_out = ((x.shape[3] + pl + pr + 2 * pw
                  - module.dilation[1] * (kw - 1) - 1) // module.stride[1] + 1)
        return _empty_like_out(window, (x.shape[0], weight.shape[0], 0,
                                        w_out))
    if pl or pr:
        padded = F.pad(padded, (pl, pr, 0, 0))
    return F.conv2d(padded, weight, bias, module.stride, (0, pw),
                    module.dilation, module.groups)


def max_pool2d(x: torch.Tensor, kernel: int, stride: int,
               pad: Tuple[int, int, int, int] = (0, 0, 0, 0)) -> torch.Tensor:
    """A square max-pool with ``F.pad``-style ``pad`` of ``-inf`` on a
    height-sharded ``x``."""
    pl, pr, pt, pb = pad
    padded, window = _sliding(x, kernel, stride, 1, pt, pb, -math.inf)
    if padded is None:
        w_out = (x.shape[3] + pl + pr - kernel) // stride + 1
        return _empty_like_out(window, x.shape[:2] + (0, w_out))
    if pl or pr:
        padded = F.pad(padded, (pl, pr, 0, 0), value=-math.inf)
    return F.max_pool2d(padded, kernel, stride)


def resize_plan(height: int, out_height: int, mode: str, m: int):
    """The rows rule of a resize from ``height`` to ``out_height`` rows
    over ``m`` ranks: ``(first, second, weight, needs)``, per output row
    the source rows it reads and the second's weight, and per rank the
    input rows ``needs[j]`` its output rows read.  ``nearest`` takes the
    row the whole map's ``nearest-exact`` resize takes (read from that
    resize of a row index, in f32 as the maps' own); ``bilinear`` is
    torch's half-pixel rule."""
    if mode == 'nearest':
        index = torch.arange(height, dtype=torch.float32).view(1, 1, height, 1)
        first = F.interpolate(index, size=(out_height, 1),
                              mode='nearest-exact').view(-1).long()
        second, weight = first, torch.zeros(out_height)
    else:
        scale = torch.tensor(height / out_height, dtype=torch.float32)
        src = ((torch.arange(out_height, dtype=torch.float32) + 0.5) * scale
               - 0.5).clamp(min=0)
        first = src.floor().long().clamp(max=height - 1)
        second = (first + 1).clamp(max=height - 1)
        weight = src - first
    needs = _rows_for(out_height, m, lambda lo, hi: (
        int(first[lo:hi].min()), int(second[lo:hi].max()) + 1))
    return first, second, weight, needs


def resize_rows(window: torch.Tensor, base: int, first, second, weight,
                size: Tuple[int, int], mode: str) -> torch.Tensor:
    """Output rows of a resize from their source rows in ``window``
    (input rows from ``base``; ``first``, ``second`` and ``weight`` of the
    rows, :func:`resize_plan`'s), then the width resized to ``size[1]``
    with the height kept."""
    rows = len(first)
    y = window.index_select(2, (first - base).to(window.device))
    if mode == 'nearest':
        return F.interpolate(y, size=(rows, size[1]), mode='nearest-exact')
    y1 = window.index_select(2, (second - base).to(window.device))
    w = weight.to(device=window.device, dtype=window.dtype).view(1, 1, -1, 1)
    y = y * (1 - w) + y1 * w
    return F.interpolate(y, size=(rows, size[1]), mode='bilinear',
                         align_corners=False, antialias=False)


def interpolate(x: torch.Tensor, size: Tuple[int, int],
                mode: str) -> torch.Tensor:
    """``features.interpolate`` of a height-sharded ``x`` to the global
    ``size`` (``mode`` ``'nearest'`` or ``'bilinear'``): this rank's
    output rows from the source rows they read."""
    axis = mesh.model_axis()
    height = global_height(x)
    out_h, out_w = int(size[0]), int(size[1])
    first, second, weight, needs = resize_plan(height, out_h, mode,
                                               axis.size)
    window = _window(x, height, needs)
    lo, hi = split(out_h, axis.size, axis.index)
    if hi <= lo:
        return _empty_like_out(window, x.shape[:2] + (0, out_w))
    return resize_rows(window, needs[axis.index][0], first[lo:hi],
                       second[lo:hi], weight[lo:hi], (out_h, out_w), mode)


class _SumModel(torch.autograd.Function):
    """Sum over the model group; backward, the gradients summed too (each
    rank's share of the result's consumers is its own rows')."""

    @staticmethod
    def forward(ctx, x):
        return mesh.all_reduce_(x.clone(), axis='model')

    @staticmethod
    def backward(ctx, grad):
        return mesh.all_reduce_(grad.contiguous().clone(), axis='model')


def sum_model(x: torch.Tensor) -> torch.Tensor:
    return _SumModel.apply(x)


def mean_hw(x: torch.Tensor) -> torch.Tensor:
    """The global spatial mean ``[B, C, 1, 1]`` of a height-sharded map,
    in its dtype: the sums and the count over the model group."""
    height = global_height(x)
    total = sum_model(x.float().sum(dim=(2, 3), keepdim=True))
    return (total / float(height * x.shape[3])).to(x.dtype)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float, num_groups) -> torch.Tensor:
    """``models/norm.py::group_norm`` of a height-sharded map: its two
    passes' sums over the model group."""
    height = global_height(x)
    b, c = x.shape[:2]
    g = num_groups(c, groups)
    xf = x.float().reshape(b, g, c // g, *x.shape[2:])
    axes = tuple(range(2, xf.ndim))
    n = float(c // g * height * x.shape[3])
    mean = sum_model(xf.sum(dim=axes, keepdim=True)) / n
    var = sum_model((xf - mean).square().sum(dim=axes, keepdim=True)) / n
    y = ((xf - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.ndim - 2)
    y = y * weight.float().reshape(shape) + bias.float().reshape(shape)
    return y.to(x.dtype)


class _GatherAnchors(torch.autograd.Function):
    """Every model rank's ``[B, n_j, ...]`` rows concatenated along axis 1
    in rank order (``counts``: every rank's ``n_j``); backward, this
    rank's own part."""

    @staticmethod
    def forward(ctx, x, counts: Sequence[int]):
        axis = mesh.model_axis()
        ctx.part = (sum(counts[:axis.index]), counts[axis.index])
        longest = max(counts)
        padded = x.new_zeros(x.shape[:1] + (longest,) + x.shape[2:])
        padded[:, :x.shape[1]] = x
        parts = mesh.all_gather(padded, 'model')
        return torch.cat([p[:, :n] for p, n in zip(parts, counts)], dim=1)

    @staticmethod
    def backward(ctx, grad):
        start, n = ctx.part
        return grad[:, start:start + n].contiguous(), None


def gather_anchors(head: torch.Tensor, per_cell: int) -> torch.Tensor:
    """A head's height-sharded NCHW output ``[B, per_cell * K, h, W]`` as
    the whole level's ``[B, H * W * per_cell, K]`` in the one-process
    anchor order (row-major over the map, then the cell's boxes)."""
    axis = mesh.model_axis()
    height = global_height(head)
    b, c, h, w = head.shape
    rows = head.permute(0, 2, 3, 1).reshape(b, h * w * per_cell,
                                            c // per_cell)
    counts = [(hi - lo) * w * per_cell
              for lo, hi in (split(height, axis.size, j)
                             for j in range(axis.size))]
    return _GatherAnchors.apply(rows, counts)
