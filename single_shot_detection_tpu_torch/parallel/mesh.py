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

The model axis (:func:`set_model_axis`): with ``W`` ranks and a model-axis
size ``m``, rank ``r`` has model index ``r % m`` and data index ``r //
m``, the JAX package's ``create_mesh`` order (``devices.reshape(n_data,
n_model)``).  The ranks of one data index form a *model group*, those of
one model index a *data group*; every rank creates every group, in one
order.  Each collective here names its axis: ``'data'`` (the default: the
data group, the world without a model axis), ``'model'`` or ``'world'``.
The option that owns the model axis (``parallel/tensor.py``,
``parallel/pipeline.py``, ``parallel/spatial.py``) says what its BN
statistics and gradients reduce over; the ranks of one model group load
the same rows, draw the same augmentation and see the same batch.
:func:`tensor_state_sharding` is the tensor option's placement, JAX's rule.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import socket
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
    """Leave the process group (a no-op without one), and drop the model
    axis and its groups, which belonged to it: a process that joins a new
    group (a second run) builds them anew."""
    global _AXIS
    _AXIS = None
    _GROUPS.clear()
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


@dataclasses.dataclass
class ModelAxis:
    """The (data, model) grid of a run with a model axis: the option that
    owns it (``'tensor'``, ``'pipeline'`` or ``'spatial'``), its size
    ``m``, this rank's model and data indices, the global ranks of this
    rank's model group, and the process groups of its model group and
    data group."""

    mode: str
    size: int
    index: int
    data_size: int
    data_index: int
    model_ranks: List[int]
    model_group: object
    data_group: object


_AXIS: Optional[ModelAxis] = None
_GROUPS: Dict[int, tuple] = {}


def model_axis() -> Optional[ModelAxis]:
    """The model axis in force (None without one)."""
    return _AXIS


def model_mode() -> Optional[str]:
    """The option that owns the model axis, or None."""
    return None if _AXIS is None else _AXIS.mode


@contextlib.contextmanager
def model_axis_off():
    """No model axis inside (a whole model's forward: a shape probe)."""
    global _AXIS
    saved, _AXIS = _AXIS, None
    try:
        yield
    finally:
        _AXIS = saved


def _new_groups(m: int) -> tuple:
    """Every model group and every data group of a grid with a model axis
    of ``m`` (collective: every rank creates every group in one order)."""
    if m not in _GROUPS:
        w = dist.get_world_size()
        model = [dist.new_group(list(range(j * m, (j + 1) * m)))
                 for j in range(w // m)]
        data = [dist.new_group(list(range(i, w, m))) for i in range(m)]
        _GROUPS[m] = (model, data)
    return _GROUPS[m]


def check_model_axis(size: int, world: Optional[int] = None) -> None:
    """Raise ``ValueError`` unless ``world`` ranks (the process group's by
    default) make whole model groups of ``size``: processes take the place
    of the JAX engine's devices, so fewer ranks than ``size`` or a count
    that ``size`` does not divide has no grid (the JAX engine shrinks its
    data axis instead)."""
    world = world_size() if world is None else int(world)
    if world < size:
        raise ValueError(f'a model-axis size of {size} needs at least '
                         f'{size} processes, have {world}')
    if world % size:
        raise ValueError(f'a model-axis size of {size} must divide the '
                         f'process count ({world})')


def set_model_axis(mode: Optional[str], size: int = 1) -> Optional[ModelAxis]:
    """Put the model axis of ``size`` owned by ``mode`` in force over the
    process group (``mode`` None or ``size`` 1: none).  Checks the grid
    (:func:`check_model_axis`) and that the ranks of each model group
    share a host (the model axis rides one node's links, as the JAX
    engine's rides ICI): an all-gather of the host names, ``ValueError``
    otherwise."""
    global _AXIS
    if mode is None or size <= 1:
        _AXIS = None
        return None
    check_model_axis(size)
    w, rank = dist.get_world_size(), dist.get_rank()
    hosts = [None] * w
    dist.all_gather_object(hosts, socket.gethostname())
    for j in range(w // size):
        names = set(hosts[j * size:(j + 1) * size])
        if len(names) > 1:
            raise ValueError(
                f'train.{mode}_sharding: the ranks of model group {j} run '
                f'on several hosts ({sorted(names)}); the model axis must '
                "ride one node's links, not the network across hosts")
    model, data = _new_groups(size)
    j, i = rank // size, rank % size
    _AXIS = ModelAxis(mode, size, i, w // size, j,
                      list(range(j * size, (j + 1) * size)), model[j], data[i])
    return _AXIS


def data_count() -> int:
    """Ranks on the data axis: the world without a model axis."""
    return world_size() if _AXIS is None else _AXIS.data_size


def data_index() -> int:
    """This rank's index on the data axis."""
    return process_index() if _AXIS is None else _AXIS.data_index


def _group(axis: str):
    """``(process group or None for the world, rank count)`` of ``axis``."""
    if axis == 'world' or _AXIS is None:
        if axis == 'model':
            return None, 1
        return None, world_size()
    if axis == 'data':
        return _AXIS.data_group, _AXIS.data_size
    if axis == 'model':
        return _AXIS.model_group, _AXIS.size
    raise ValueError(f'unknown axis {axis!r}')


def axis_size(axis: str = 'data') -> int:
    """The rank count of ``axis``."""
    return _group(axis)[1]


def _through_host(tensor: torch.Tensor) -> bool:
    return tensor.is_cuda and dist.get_backend() == 'gloo'


def _comm_device() -> torch.device:
    """Where host arrays cross between ranks: NCCL moves CUDA tensors only."""
    if dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def all_reduce_(tensor: torch.Tensor, op: str = 'sum',
                axis: str = 'data') -> torch.Tensor:
    """Reduce a contiguous ``tensor`` over the ranks of ``axis`` in place
    (``'sum'`` or ``'max'``); returns it."""
    group, size = _group(axis)
    if size == 1:
        return tensor
    reduce_op = getattr(dist.ReduceOp, _OPS[op])
    if _through_host(tensor):
        host = tensor.cpu()
        dist.all_reduce(host, reduce_op, group=group)
        tensor.copy_(host)
    else:
        dist.all_reduce(tensor, reduce_op, group=group)
    return tensor


def all_gather(tensor: torch.Tensor, axis: str = 'data') -> List[torch.Tensor]:
    """Every rank's ``tensor`` of ``axis`` (one shape on every rank), in
    rank order, on ``tensor``'s device."""
    group, size = _group(axis)
    if size == 1:
        return [tensor]
    src = tensor.contiguous()
    if _through_host(src):
        src = src.cpu()
    out = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(out, src, group=group)
    return [t.to(tensor.device) for t in out]


def all_gather_rows(tensor: torch.Tensor, axis: str = 'data') -> torch.Tensor:
    """Every rank's ``[b, ...]`` rows concatenated in rank order."""
    return torch.cat(all_gather(tensor, axis), dim=0)


def all_reduce_grads(params: Sequence[torch.nn.Parameter],
                     axis: str = 'data') -> None:
    """Sum the parameters' gradients over the ranks of ``axis`` in one
    bucket (a parameter without a gradient counts as zeros, as every JAX
    parameter has one); each ``.grad`` becomes a view of the reduced
    bucket."""
    params = list(params)
    if not params or axis_size(axis) == 1:
        return
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1) for p in params])
    all_reduce_(flat, axis=axis)
    offset = 0
    for p in params:
        n = p.numel()
        p.grad = flat[offset:offset + n].view_as(p)
        offset += n


def model_rank(index: int) -> int:
    """The global rank of rank ``index`` of this rank's model group."""
    return index if _AXIS is None else _AXIS.model_ranks[index]


def exchange(sends: Sequence[Tuple[int, torch.Tensor]],
             recvs: Sequence[Tuple[int, torch.Tensor]]) -> None:
    """Point-to-point: send each ``(global rank, tensor)`` of ``sends`` and
    fill each ``(global rank, buffer)`` of ``recvs``, all posted at once
    and waited for (a CUDA tensor crosses through the host under gloo).
    NCCL takes them as one group (``batch_isend_irecv``): two ranks that
    send each other before receiving would otherwise wait on each other."""
    if not sends and not recvs:
        return
    if dist.get_backend() == 'nccl':
        ops = ([dist.P2POp(dist.isend, t.contiguous(), peer)
                for peer, t in sends]
               + [dist.P2POp(dist.irecv, buf, peer) for peer, buf in recvs])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return
    ops, back = [], []
    for peer, t in sends:
        t = t.contiguous()
        ops.append(dist.isend(t.cpu() if _through_host(t) else t, peer))
    for peer, buf in recvs:
        if _through_host(buf):
            host = torch.empty(buf.shape, dtype=buf.dtype)
            back.append((host, buf))
            ops.append(dist.irecv(host, peer))
        else:
            ops.append(dist.irecv(buf, peer))
    for op in ops:
        op.wait()
    for host, buf in back:
        buf.copy_(host)


def broadcast_model_(tensor: torch.Tensor, src: int) -> torch.Tensor:
    """Model rank ``src``'s ``tensor`` on every rank of this rank's model
    group, in place; returns it."""
    group, size = _group('model')
    if size == 1:
        return tensor
    root = model_rank(src)
    if _through_host(tensor):
        host = tensor.cpu()
        dist.broadcast(host, root, group=group)
        tensor.copy_(host)
    else:
        dist.broadcast(tensor, root, group=group)
    return tensor


def broadcast_object(obj, src: int = 0):
    """Process ``src``'s picklable ``obj`` on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def all_gather_host(tree, axis: str = 'data'):
    """All-gather a tree (dict, list or tuple) of per-rank numpy arrays over
    the ranks of ``axis``, concatenated along axis 0 in rank order.

    The row counts may differ between ranks: each leaf is padded to the
    longest and cut back after the gather."""
    if axis_size(axis) == 1:
        return tree
    leaves: List[np.ndarray] = []
    _collect(tree, leaves)
    device = _comm_device()
    counts = torch.tensor([len(x) for x in leaves], dtype=torch.int64,
                          device=device)
    all_counts = torch.stack(all_gather(counts, axis)).cpu().numpy()
    gathered = []
    for i, x in enumerate(leaves):
        longest = int(all_counts[:, i].max())
        padded = np.zeros((longest,) + x.shape[1:], x.dtype)
        padded[:len(x)] = x
        parts = all_gather(torch.from_numpy(padded).to(device), axis)
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


def jax_axes(ndim: int) -> List[int]:
    """The port's axis of each axis of the JAX leaf: a conv weight is
    OIHW here and HWIO there, a vector is the same."""
    return [2, 3, 1, 0] if ndim == 4 else list(range(ndim))


def _jax_pick(shape, n: int, taken=()) -> Optional[int]:
    """:func:`_largest_divisible_axis` over the JAX leaf's axis order (its
    ties go to the first JAX axis), as a port axis."""
    order = jax_axes(len(shape))
    jax_taken = tuple(order.index(a) for a in taken)
    best = _largest_divisible_axis([shape[a] for a in order], n, jax_taken)
    return None if best is None else order[best]


def tensor_state_sharding(named: Iterable[Tuple[str, torch.Tensor]], m: int
                          ) -> Dict[str, Optional[int]]:
    """Tensor (channel) sharding's placement over a model axis of ``m``,
    the JAX package's rule: a leaf whose JAX last axis is above 1 and
    divisible by ``m`` is sliced along it, else kept whole.  That axis is
    ``cout``, the port's axis 0 of a conv weight (dense or depthwise) and
    the only axis of a bias, a BN scale or bias and a running statistic;
    returns ``{name: 0 or None}``."""
    out: Dict[str, Optional[int]] = {}
    for name, x in named:
        shape = tuple(x.shape)
        last = jax_axes(len(shape))[-1] if shape else None
        out[name] = (last if m > 1 and shape and shape[last] > 1
                     and shape[last] % m == 0 else None)
    return out


def zero_state_sharding(named: Iterable[Tuple[str, torch.Tensor]], n: int,
                        taken: Optional[Dict[str, Optional[int]]] = None
                        ) -> Dict[str, Optional[int]]:
    """ZeRO-1's layout: for each named leaf (a parameter, whose optimizer
    buffers and EMA shadow share its shape), the axis each of the ``n``
    ranks of the data axis keeps a slice of, or None for a leaf every rank
    keeps whole.

    The JAX policy: a leaf of at least ``8 * n`` elements (its whole
    shape) is sliced along its largest axis divisible by ``n``, ties to
    the first in the JAX leaf's order; a smaller leaf, or one with no such
    axis, stays whole (its collective would cost more than its memory).
    ``taken`` (tensor sharding's :func:`tensor_state_sharding`) gives each
    leaf's model-axis axis, which ZeRO leaves to it: the largest
    *remaining* axis, as JAX's ``opt_leaf`` picks.  Parameters and BN
    statistics are not sliced: every forward needs them whole."""
    out: Dict[str, Optional[int]] = {}
    for name, x in named:
        shape = tuple(x.shape)
        if n <= 1 or int(np.prod(shape or (1,))) < 8 * n:
            out[name] = None
        else:
            model = (taken or {}).get(name)
            out[name] = _jax_pick(shape, n, () if model is None else (model,))
    return out


def zero_slice(tensor: torch.Tensor, axis: Optional[int], n: int,
               index: int) -> torch.Tensor:
    """Rank ``index``'s slice of ``tensor`` along ``axis`` (a view; the
    whole tensor when ``axis`` is None)."""
    if axis is None:
        return tensor
    size = tensor.shape[axis] // n
    return tensor.narrow(axis, index * size, size)


def all_gather_slices(tensor: torch.Tensor, axis: int,
                      group: str = 'data') -> torch.Tensor:
    """The whole leaf from every ``group`` rank's slice along ``axis``."""
    return torch.cat(all_gather(tensor, group), dim=axis)


@dataclasses.dataclass
class ZeroLayout:
    """ZeRO-1 over ``n`` ranks of the data axis, this one ``index``:
    ``axes`` maps each parameter name to the axis its optimizer buffers
    and EMA shadow are sliced along (None: kept whole),
    :func:`zero_state_sharding`'s layout.  Under tensor sharding the
    leaves are this rank's model slices already, and the axes are their
    remaining ones."""

    axes: Dict[str, Optional[int]]
    n: int
    index: int

    def slice(self, name: str, tensor: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``name``'s leaf ``tensor`` (a view)."""
        return zero_slice(tensor, self.axes.get(name), self.n, self.index)

    def gather_(self, name: str, tensor: torch.Tensor) -> None:
        """Make the whole leaf ``tensor``, whose own slice is current,
        whole on every rank from every rank's slice (a collective over the
        data axis for a sliced leaf, nothing for a whole one)."""
        axis = self.axes.get(name)
        if axis is not None:
            tensor.copy_(all_gather_slices(
                self.slice(name, tensor).contiguous(), axis))
