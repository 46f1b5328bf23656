"""Data parallelism over processes, one process a card.

Port of the JAX package's ``parallel/mesh.py`` for its data axis.  The JAX
engine runs one SPMD program over a ``(data, model)`` mesh, and XLA puts in
the gradient all-reduce and the global-batch BN statistics by itself.  Here
each process drives one card with its own rows of the global batch, in a
``torch.distributed`` process group, and the port does by hand what XLA
did (``train/step.py``, ``models/layers.py``, ``ops/losses.py``): one
bucketed all-reduce of the gradients after the backward, BN statistics and
their gradient sums all-reduced, the loss divided by the global positive
count, QAT's activation maximum all-reduced.

The process group is the default one (``torch.distributed``'s world):
NCCL between cards, gloo when the caller asks for the CPU (the tests).  The
collectives below take device tensors; under gloo a CUDA tensor makes a
round trip through the host, so several ranks can share one card over gloo
(NCCL refuses two ranks on one card).  Without a process group, or in one
of a single rank, every collective is the identity, so the callers make
the same calls in a run of one process as in one of several.

What the JAX module has and this one drops, because one card a process
gives it no meaning: ``create_mesh``, ``batch_sharding(s)``,
``shard_batch``, ``make_global_batch`` (each process feeds its own rows to
its own card), ``host_local_rows`` (a process's rows are its own tensors),
``replicated`` and every ``NamedSharding`` tree (the state is a module on
each card; ZeRO-1's layout is an axis per leaf, :func:`zero_state_sharding`).
The model axis (``tensor_state_sharding``, ``parallel/pipeline.py``) is not
ported yet.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

_OPS = {'sum': 'SUM', 'max': 'MAX'}


def process_device(process_id: int = 0,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The card of process ``process_id``: ``cuda:{process_id % count}``,
    or ``device`` when it names one.  ``'cpu'`` is an explicit request;
    with no GPU and no CPU asked for it raises, as every entry point does."""
    if device is not None:
        device = torch.device(device)
        if device.type == 'cpu':
            return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA is not available; pass device="cpu" to run on the CPU')
    if device is not None and device.index is not None:
        return device
    return torch.device('cuda', int(process_id) % torch.cuda.device_count())


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: Optional[Union[str, torch.device]] = None,
                           backend: Optional[str] = None,
                           timeout: Optional[float] = None) -> torch.device:
    """Join the process group of a multi-process run; returns this
    process's device (:func:`process_device`).

    A no-op for one process.  Otherwise ``torch.distributed.init_process_group``
    over ``tcp://{coordinator_address}`` (``host:port`` of process 0) with
    ``num_processes`` ranks, this one ``process_id``.  The backend is NCCL
    on CUDA and gloo on the CPU unless ``backend`` names one; ``timeout``
    (seconds) bounds every collective, torch's default when None."""
    if num_processes is None or num_processes <= 1:
        return process_device(process_id or 0, device)
    if coordinator_address is None or process_id is None:
        raise ValueError('a multi-process run needs --coordinator-address '
                         'and --process-id besides --num-processes')
    if not 0 <= process_id < num_processes:
        raise ValueError(f'process id {process_id} outside 0..'
                         f'{num_processes - 1}')
    device = process_device(process_id, device)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    backend = backend or ('nccl' if device.type == 'cuda' else 'gloo')
    kwargs = {}
    if timeout is not None:
        kwargs['timeout'] = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(backend, init_method=f'tcp://{coordinator_address}',
                            world_size=int(num_processes), rank=int(process_id),
                            **kwargs)
    return device


def destroy() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The process group's rank count (1 without a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def check_group(count: int, index: int) -> None:
    """Raise ``ValueError`` unless the process group has ``count`` ranks
    and this process is rank ``index`` (a one-process run needs none, and
    may not run inside a group of several: the collectives would reduce
    over its ranks)."""
    if count <= 1:
        if index != 0:
            raise ValueError(f'process_index {index} of a one-process run')
        if world_size() > 1:
            raise ValueError(
                f'process_count=1 inside a process group of {world_size()} '
                'ranks')
        return
    if not dist.is_initialized():
        raise ValueError(
            f'process_count={count} needs a process group: call '
            'parallel.initialize_distributed first (the CLI does it for '
            '--num-processes)')
    if dist.get_world_size() != count or dist.get_rank() != index:
        raise ValueError(
            f'process_count={count}, process_index={index}, but the process '
            f'group has {dist.get_world_size()} ranks and this is rank '
            f'{dist.get_rank()}')


def _through_host(tensor: torch.Tensor) -> bool:
    return tensor.is_cuda and dist.get_backend() == 'gloo'


def _comm_device() -> torch.device:
    """Where host arrays cross between ranks: NCCL moves CUDA tensors only."""
    if dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def all_reduce_(tensor: torch.Tensor, op: str = 'sum') -> torch.Tensor:
    """Reduce a contiguous ``tensor`` over the ranks in place (``'sum'`` or
    ``'max'``); returns it."""
    if world_size() == 1:
        return tensor
    reduce_op = getattr(dist.ReduceOp, _OPS[op])
    if _through_host(tensor):
        host = tensor.cpu()
        dist.all_reduce(host, reduce_op)
        tensor.copy_(host)
    else:
        dist.all_reduce(tensor, reduce_op)
    return tensor


def all_gather(tensor: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's ``tensor`` (one shape on every rank), in rank order, on
    ``tensor``'s device."""
    if world_size() == 1:
        return [tensor]
    src = tensor.contiguous()
    if _through_host(src):
        src = src.cpu()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(out, src)
    return [t.to(tensor.device) for t in out]


def all_gather_rows(tensor: torch.Tensor) -> torch.Tensor:
    """Every rank's ``[b, ...]`` rows concatenated in rank order."""
    return torch.cat(all_gather(tensor), dim=0)


def all_reduce_grads(params: Sequence[torch.nn.Parameter]) -> None:
    """Sum the parameters' gradients over the ranks in one bucket (a
    parameter without a gradient counts as zeros, as every JAX parameter
    has one); each ``.grad`` becomes a view of the reduced bucket."""
    params = list(params)
    if not params or world_size() == 1:
        return
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1) for p in params])
    all_reduce_(flat)
    offset = 0
    for p in params:
        n = p.numel()
        p.grad = flat[offset:offset + n].view_as(p)
        offset += n


def broadcast_object(obj, src: int = 0):
    """Process ``src``'s picklable ``obj`` on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def all_gather_host(tree):
    """All-gather a tree (dict, list or tuple) of per-rank numpy arrays,
    concatenated along axis 0 in rank order.

    The row counts may differ between ranks: each leaf is padded to the
    longest and cut back after the gather."""
    if world_size() == 1:
        return tree
    leaves: List[np.ndarray] = []
    _collect(tree, leaves)
    device = _comm_device()
    counts = torch.tensor([len(x) for x in leaves], dtype=torch.int64,
                          device=device)
    all_counts = torch.stack(all_gather(counts)).cpu().numpy()  # [P, leaves]
    gathered = []
    for i, x in enumerate(leaves):
        longest = int(all_counts[:, i].max())
        padded = np.zeros((longest,) + x.shape[1:], x.dtype)
        padded[:len(x)] = x
        parts = all_gather(torch.from_numpy(padded).to(device))
        gathered.append(np.concatenate(
            [p.cpu().numpy()[:all_counts[r, i]] for r, p in enumerate(parts)]))
    return _rebuild(tree, iter(gathered))


def _collect(tree, out: List[np.ndarray]) -> None:
    if isinstance(tree, dict):
        for v in tree.values():
            _collect(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _collect(v, out)
    else:
        out.append(np.ascontiguousarray(tree))


def _rebuild(tree, leaves):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _largest_divisible_axis(shape, n: int, taken=()) -> Optional[int]:
    """The largest axis of ``shape`` divisible by ``n`` (excluding ``taken``
    indices), or None: the ZeRO-1 axis policy of :func:`zero_state_sharding`."""
    best = None
    for ax, d in enumerate(shape):
        if ax in taken or d <= 1 or d % n:
            continue
        if best is None or d > shape[best]:
            best = ax
    return best


def zero_state_sharding(named: Iterable[Tuple[str, torch.Tensor]], n: int
                        ) -> Dict[str, Optional[int]]:
    """ZeRO-1's layout: for each named leaf (a parameter, whose optimizer
    buffers and EMA shadow share its shape), the axis each of the ``n``
    ranks keeps a slice of, or None for a leaf every rank keeps whole.

    The JAX policy: a leaf of at least ``8 * n`` elements is sliced along
    its largest axis divisible by ``n``; a smaller leaf, or one with no
    such axis, stays whole (its collective would cost more than its
    memory).  Parameters and BN statistics are not sliced: every forward
    needs them whole."""
    out: Dict[str, Optional[int]] = {}
    for name, x in named:
        shape = tuple(x.shape)
        if n <= 1 or int(np.prod(shape or (1,))) < 8 * n:
            out[name] = None
        else:
            out[name] = _largest_divisible_axis(shape, n)
    return out


def zero_slice(tensor: torch.Tensor, axis: Optional[int], n: int,
               index: int) -> torch.Tensor:
    """Rank ``index``'s slice of ``tensor`` along ``axis`` (a view; the
    whole tensor when ``axis`` is None)."""
    if axis is None:
        return tensor
    size = tensor.shape[axis] // n
    return tensor.narrow(axis, index * size, size)


def all_gather_slices(tensor: torch.Tensor, axis: int) -> torch.Tensor:
    """The whole leaf from every rank's slice along ``axis``."""
    return torch.cat(all_gather(tensor), dim=axis)


@dataclasses.dataclass
class ZeroLayout:
    """ZeRO-1 over ``n`` ranks, this one ``index``: ``axes`` maps each
    parameter name to the axis its optimizer buffers and EMA shadow are
    sliced along (None: kept whole), :func:`zero_state_sharding`'s
    layout."""

    axes: Dict[str, Optional[int]]
    n: int
    index: int

    def slice(self, name: str, tensor: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``name``'s leaf ``tensor`` (a view)."""
        return zero_slice(tensor, self.axes.get(name), self.n, self.index)

    def gather_(self, name: str, tensor: torch.Tensor) -> None:
        """Make the whole leaf ``tensor``, whose own slice is current,
        whole on every rank from every rank's slice (a collective for a
        sliced leaf, nothing for a whole one)."""
        axis = self.axes.get(name)
        if axis is not None:
            tensor.copy_(all_gather_slices(
                self.slice(name, tensor).contiguous(), axis))
