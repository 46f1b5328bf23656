"""GPipe pipeline parallelism over the model axis: ``train.pipeline_sharding``.

Port of the JAX package's ``parallel/pipeline.py`` (``make_pipeline_apply``)
for processes.  The detector splits at its seams (``models/detector.py``
``stage``/``n_stages``: backbone and neck | extras, predictor and heads;
with more than two stages M2Det's TUM chain in segments,
``tum_stage_chunks``).  Rank ``k`` of a model group holds the whole model
but runs only stage ``k``: ``M`` microbatches go forward through the
stages, then backward in reverse (GPipe's schedule).

Each boundary hand-off is one f32 buffer ``[b_micro, L]`` per microbatch
(:func:`pack`/:func:`unpack`, JAX's ``_pack``/``_unpack``: the stage's
leaves flattened and zero-padded to the longest boundary, so bf16 leaves
round-trip losslessly), sent point to point inside the model group by
:class:`_Send` (backward: the gradient received back from the next stage)
and received by :class:`_Receive` (backward: the gradient sent back to
the previous stage).  A single ``loss.backward()`` cannot cross
processes, so :func:`pipeline_apply` returns the outputs with a
``backward()`` that drives each rank's stage explicitly, microbatch by
microbatch in reverse, with ``torch.autograd.backward``.

The outputs reach every rank of the model group (JAX's select-then-psum:
a broadcast from the last stage), so every rank computes the loss; each
parameter's gradient is nonzero only on its stage's rank, and a sum over
the model group, then the data axis (the world), leaves every rank with
the plain forward's gradient.  The state stays replicated.  The forward
runs ``train=False`` (eval-mode BN: the frozen-BN or GroupNorm regime).
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

import torch

from single_shot_detection_tpu_torch.parallel import mesh

# what the hand-offs moved, read by the chip smoke's byte count
STATS = {'sent_bytes': 0, 'boundary_floats': 0}


def flatten(tree) -> List[torch.Tensor]:
    """The tensor leaves of nested tuples and lists, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for item in tree for leaf in flatten(item)]


def unflatten(like, leaves) -> object:
    """``like``'s structure (tuples) with ``leaves`` (an iterator)."""
    if isinstance(like, torch.Tensor):
        return next(leaves)
    return tuple(unflatten(item, leaves) for item in like)


def pack(tree, size: int) -> torch.Tensor:
    """Flatten a tree of ``[Bm, ...]`` tensors into one ``[Bm, size]`` f32
    buffer, zero-padded."""
    leaves = flatten(tree)
    flat = torch.cat([t.reshape(t.shape[0], -1).float() for t in leaves],
                     dim=1)
    if flat.shape[1] < size:
        flat = torch.nn.functional.pad(flat, (0, size - flat.shape[1]))
    return flat


def unpack(buf: torch.Tensor, like) -> object:
    """Inverse of :func:`pack` for the structure, per-row shapes and dtypes
    of ``like`` (a tree of tensors of any batch); the rows are ``buf``'s."""
    out, offset = [], 0
    for t in flatten(like):
        n = math.prod(t.shape[1:])
        out.append(buf[:, offset:offset + n]
                   .reshape((buf.shape[0],) + tuple(t.shape[1:])).to(t.dtype))
        offset += n
    return unflatten(like, iter(out))


def _per_row(tree) -> int:
    return sum(math.prod(t.shape[1:]) for t in flatten(tree))


class _Send(torch.autograd.Function):
    """Send a boundary buffer to the next stage; the output (the same
    buffer) is what this rank's backward starts from.  Backward: the
    buffer's gradient, received from the next stage."""

    @staticmethod
    def forward(ctx, buf, peer: int):
        ctx.peer = peer
        mesh.exchange([(peer, buf)], [])
        STATS['sent_bytes'] += buf.numel() * buf.element_size()
        return buf.view_as(buf)

    @staticmethod
    def backward(ctx, _ignored):
        grad = torch.empty(_ignored.shape, dtype=_ignored.dtype,
                           device=_ignored.device)
        mesh.exchange([], [(ctx.peer, grad)])
        return grad, None


class _Receive(torch.autograd.Function):
    """Receive a boundary buffer from the previous stage (``anchor``, a
    scalar that requires grad, puts it in the graph).  Backward: its
    gradient sent back to the previous stage."""

    @staticmethod
    def forward(ctx, anchor, shape, peer: int):
        ctx.peer = peer
        buf = torch.empty(shape, dtype=torch.float32, device=anchor.device)
        mesh.exchange([], [(peer, buf)])
        return buf

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        mesh.exchange([(ctx.peer, grad)], [])
        STATS['sent_bytes'] += grad.numel() * grad.element_size()
        return None, None, None


def check_stages(model, n_stages: int) -> None:
    """JAX's check: more than two stages need a TUM chain to split."""
    if n_stages > 2 and getattr(model.features, 'num_tums', None) is None:
        raise ValueError(
            f'n_stages={n_stages} pipeline stages need a '
            f'MultilevelFeaturePyramid neck (a TUM chain to split); '
            f'{type(model.features).__name__} supports 2 stages')


def boundary_likes(model, x_row: torch.Tensor, n_stages: int) -> list:
    """Each boundary's tree (``n_stages - 1`` of them) and the outputs',
    from a no-grad run of the stages on one row: their shapes and dtypes
    per row."""
    with torch.no_grad():
        likes = []
        cur = model(x_row, stage=0, n_stages=n_stages)
        likes.append(cur)
        for k in range(1, n_stages):
            cur = model(None, stage=k, stage_state=cur, n_stages=n_stages)
            likes.append(cur)
    return likes


def pipeline_apply(model, x: torch.Tensor, microbatches: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, Callable[[], None]]:
    """The pipelined eval-mode forward of ``model`` (a ``Detector``) on
    this model group's batch ``x``, stage ``k`` on model rank ``k``:
    ``(scores, locs, backward)``.  ``scores`` and ``locs`` are the whole
    batch's outputs on every rank, leaves that require grad; after the
    loss's ``backward()``, ``backward()`` runs the stages' backward (on
    the last stage from their ``.grad``)."""
    axis = mesh.model_axis()
    n_stages, k = axis.size, axis.index
    check_stages(model, n_stages)
    m = int(microbatches)
    if x.shape[0] % m:
        raise ValueError(f'{m} microbatches must divide the batch '
                         f'{x.shape[0]}')
    b_micro = x.shape[0] // m
    key = (tuple(x.shape[1:]), x.dtype, n_stages)
    cache = model.__dict__.setdefault('_pipeline_likes', {})
    if key not in cache:
        cache[key] = boundary_likes(model, x[:1], n_stages)
    likes = cache[key]
    size = max(_per_row(t) for t in likes)
    STATS['boundary_floats'] = size * b_micro
    prev = mesh.model_rank(k - 1) if k > 0 else None
    nxt = mesh.model_rank(k + 1) if k < n_stages - 1 else None
    last = k == n_stages - 1
    micro = x.split(b_micro)
    anchor = torch.zeros((), device=x.device, requires_grad=True)
    starts: List[torch.Tensor] = []  # what each microbatch's backward runs from
    for i in range(m):
        if k == 0:
            out = model(micro[i], stage=0, n_stages=n_stages)
        else:
            recv = _Receive.apply(anchor, (b_micro, size), prev)
            state = unpack(recv, likes[k - 1])
            out = model(None, stage=k, stage_state=state, n_stages=n_stages)
        buf = pack(out, size)
        starts.append(_Send.apply(buf, nxt) if not last else buf)
    # the last stage's outputs, broadcast over the model group
    outs = (torch.cat([s.detach() for s in starts]) if last
            else torch.empty((x.shape[0], size), device=x.device))
    mesh.broadcast_model_(outs, n_stages - 1)
    scores, locs = (t.detach().requires_grad_()
                    for t in unpack(outs, likes[-1]))

    def backward() -> None:
        for i in reversed(range(m)):
            if last:
                rows = slice(i * b_micro, (i + 1) * b_micro)
                grad = pack((scores.grad[rows], locs.grad[rows]), size)
            else:
                grad = torch.zeros_like(starts[i])
            torch.autograd.backward(starts[i], grad)
            starts[i] = None  # frees the microbatch's graph

    return scores, locs, backward
