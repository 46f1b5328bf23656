"""Channel-dependency extraction from a ``torch.export`` ATen graph.

Port of ``single_shot_detection_tpu/train/deps.py``, which walks a jaxpr.
Here the traced program is the export IR of ``torch.export.export(
model.eval(), (zeros [1, 3, H, W],))``, without ``run_decompositions``:
every ATen op the eval forward executes, with the parameters and buffers
as named placeholders (``graph_signature``).  An abstract interpreter over
that graph tracks which tensor axes carry which *channel spaces*.

A **channel space** is an equivalence class of tensor slices that must be
pruned together:

  * ``producer``  — conv weights whose out-channel axis mints the space
  * ``depthwise`` — grouped convs flowing the space through (in == out)
  * ``consumer``  — conv weights reading the space on their in-channel axis
  * ``vector``    — per-channel 1-D tensors combined elementwise with the
                    space (BatchNorm weight, bias and running statistics,
                    conv biases) — discovered from the graph, not from
                    names

Residual adds union the spaces of both operands (union-find); a channel
``cat`` makes multi-segment annotations with per-segment offsets, so a
consumer of concatenated features records where each space lands inside
its weight's in-axis.  Anything the interpreter cannot prove safe (views
that split the channel axis, ops without a rule, data-dependent mixing)
*freezes* the spaces involved; frozen spaces are never materialized, so an
unsupported topology degrades to "not pruned" instead of silent
corruption.

Members name their tensors by the JAX package's variable paths (``('params',
..., 'kernel' | 'scale' | 'bias')``, ``('batch_stats', ..., 'mean' |
'var')``), so a space compares one to one with the JAX analyzer's and
pruning keys read the same; ``utils/weights.py::state_name`` gives the
``state_dict`` name of a path.  Axes are the port's: a conv weight is OIHW, so a producer
or depthwise member slices axis 0 (HWIO axis 3 in JAX) and a consumer axis
1 (HWIO axis 2); :func:`jax_axis` translates.

Rules of the ATen ops that the JAX analyzer spells differently:
an eval-mode ``batch_norm`` is one op that registers its weight, bias,
running mean and running variance as vectors of its input's space (JAX
finds the four in the normalization's arithmetic); a conv's bias is an
argument of ``conv2d``; ``_to_copy``/``to`` keep a weight's
provenance, as ``convert_element_type`` does in JAX;
``_assert_tensor_metadata`` checks and computes nothing.
"""

from __future__ import annotations

import copy
import dataclasses
import operator
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from single_shot_detection_tpu_torch.utils.weights import variable_path

Path = Tuple[str, ...]

# ---------------------------------------------------------------------------
# names: the JAX package's variable paths (``utils/weights.py``)
# ---------------------------------------------------------------------------

def jax_axis(member: 'Member') -> int:
    """The member's axis in the JAX package's layout: a conv kernel is HWIO
    there (out-channel axis 3, in-channel axis 2), OIHW here."""
    if member.path[-1] != 'kernel':
        return member.axis
    return {0: 3, 1: 2}[member.axis]


# ---------------------------------------------------------------------------
# spaces and members
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Member:
    """One sliceable tensor range belonging to a space.

    ``path`` is the variable path INCLUDING the collection (('params', ...)
    or ('batch_stats', ...)); ``axis`` the sliced axis of the port's
    tensor; ``offset`` where the space's channels start along that axis.
    """
    path: Path
    axis: int
    offset: int
    role: str  # 'producer' | 'depthwise' | 'consumer' | 'vector'


class _SpaceSet:
    """Union-find over space ids with per-root members/width/frozen."""

    def __init__(self):
        self.parent: List[int] = []
        self.width: List[int] = []
        self.members: List[List[Member]] = []
        self.frozen: List[bool] = []

    def fresh(self, width: int, frozen: bool = False) -> int:
        sid = len(self.parent)
        self.parent.append(sid)
        self.width.append(width)
        self.members.append([])
        self.frozen.append(frozen)
        return sid

    def find(self, sid: int) -> int:
        while self.parent[sid] != sid:
            self.parent[sid] = self.parent[self.parent[sid]]
            sid = self.parent[sid]
        return sid

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        assert self.width[ra] == self.width[rb], 'cannot union unequal widths'
        self.parent[rb] = ra
        self.members[ra].extend(self.members[rb])
        self.members[rb] = []
        self.frozen[ra] = self.frozen[ra] or self.frozen[rb]

    def add_member(self, sid: int, member: Member):
        self.members[self.find(sid)].append(member)

    def freeze(self, sid: int):
        self.frozen[self.find(sid)] = True


@dataclasses.dataclass
class Space:
    """Final, resolved channel space."""
    width: int
    members: Tuple[Member, ...]
    frozen: bool

    def by_role(self, role: str) -> List[Member]:
        return [m for m in self.members if m.role == role]


# ---------------------------------------------------------------------------
# annotations
# ---------------------------------------------------------------------------

_UNIFORM = 'uniform'  # constant along every axis (scalars, broadcast scalars)


@dataclasses.dataclass(frozen=True)
class ChanAnn:
    """The tensor's ``axis`` is partitioned into space segments."""
    axis: int
    segments: Tuple[Tuple[int, int], ...]  # (space_id, size)


@dataclasses.dataclass(frozen=True)
class VecAnn:
    """A per-channel vector derived solely from 1-D tensors (+ scalars):
    carries the set of variable paths awaiting registration into a
    space."""
    axis: int
    size: int
    paths: frozenset


class _Interp:
    def __init__(self, spaces: _SpaceSet):
        self.spaces = spaces
        self.tainted: set = set()  # vector paths that leaked to unknowns

    def _freeze_ann(self, ann):
        if isinstance(ann, ChanAnn):
            for sid, _ in ann.segments:
                self.spaces.freeze(sid)
        elif isinstance(ann, VecAnn):
            self.tainted |= ann.paths

    def _register_vec(self, vec: VecAnn, chan: ChanAnn):
        off = 0
        for sid, size in chan.segments:
            for path in vec.paths:
                self.spaces.add_member(
                    sid, Member(path=path, axis=0, offset=off, role='vector'))
            off += size

    def _combine(self, a, b, out_shape):
        """Binary elementwise combine of two annotations (broadcasting
        aligns trailing axes; both operands here have the output's rank or
        are scalars, as the graph's ops give them)."""
        for x, y in ((a, b), (b, a)):
            if isinstance(x, ChanAnn):
                if y is None:
                    self._freeze_ann(x)
                    return None
                if y == _UNIFORM:
                    return x
                if isinstance(y, VecAnn):
                    if (y.axis == x.axis
                            and y.size == sum(s for _, s in x.segments)):
                        self._register_vec(y, x)
                        return x
                    self._freeze_ann(x)
                    self.tainted |= y.paths
                    return None
                # ChanAnn + ChanAnn
                if x.axis != y.axis or \
                        [s for _, s in x.segments] != [s for _, s in y.segments]:
                    self._freeze_ann(x)
                    self._freeze_ann(y)
                    return None
                for (sa, _), (sb, _) in zip(x.segments, y.segments):
                    self.spaces.union(sa, sb)
                return x
        for x, y in ((a, b), (b, a)):
            if isinstance(x, VecAnn):
                if y == _UNIFORM:
                    return x
                if isinstance(y, VecAnn):
                    if x.axis == y.axis and x.size == y.size:
                        return VecAnn(x.axis, x.size, x.paths | y.paths)
                    self.tainted |= x.paths | y.paths
                    return None
                self.tainted |= x.paths  # met an unknown tensor
                return None
        if a == _UNIFORM and b == _UNIFORM:
            return _UNIFORM
        return None


# ---------------------------------------------------------------------------
# the interpreter
# ---------------------------------------------------------------------------

# the ops of the zoo's eval graphs, and of their bf16 and configurable
# activations; any other op freezes what it touches
# elementwise ops of one tensor (extra arguments are scalars)
_UNARY = {'relu', 'hardtanh', 'sigmoid', 'tanh', 'gelu', 'silu', 'leaky_relu'}
# copies and dtype casts: a weight keeps its provenance through them
_COPIES = {'_to_copy', 'to', 'clone', 'alias', 'detach', 'contiguous'}
_BINARY = {'add', 'sub', 'mul', 'div', 'maximum', 'minimum'}
# ops that check or create tensors without reading a tracked one
_INERT = {'_assert_tensor_metadata', 'arange', 'full', 'zeros', 'ones',
          'empty'}
# spatial ops that leave the channel axis whole
_SPATIAL = {'max_pool2d_with_indices', 'max_pool2d', 'avg_pool2d',
            'upsample_nearest2d', '_upsample_nearest_exact2d'}
_RESHAPES = {'view', 'reshape', 'unsqueeze', 'squeeze'}
_REDUCTIONS = {'mean', 'sum', 'amax'}


def _op_name(target) -> str:
    if target is operator.getitem:
        return 'getitem'
    return getattr(target, '_opname', getattr(target, '__name__', str(target)))


def _moved_axis(in_shape, out_shape, axis):
    """Where an intact axis lands after a reshape, else None."""
    lead = int(np.prod(in_shape[:axis], dtype=np.int64))
    trail = int(np.prod(in_shape[axis + 1:], dtype=np.int64))
    size = in_shape[axis]
    for b in range(len(out_shape)):
        if (out_shape[b] == size
                and int(np.prod(out_shape[:b], dtype=np.int64)) == lead
                and int(np.prod(out_shape[b + 1:], dtype=np.int64)) == trail):
            return b
    return None


def _norm_dim(dim: int, ndim: int) -> int:
    return dim + ndim if dim < 0 else dim


def _conv2d_args(node) -> list:
    """``aten.conv2d``'s seven arguments, defaults filled in."""
    defaults = [None, None, None, 1, 0, 1, 1]
    names = ['input', 'weight', 'bias', 'stride', 'padding', 'dilation',
             'groups']
    args = list(node.args) + defaults[len(node.args):]
    for i, name in enumerate(names):
        if name in node.kwargs:
            args[i] = node.kwargs[name]
    return args


def analyze_program(program: torch.export.ExportedProgram,
                    model_outputs: Optional[int] = None,
                    prefix: str = '') -> List[Space]:
    """Run the channel interpreter over an exported program's export IR,
    its placeholders named by ``graph_signature`` (``prefix`` taken off the
    names).  The first ``model_outputs`` outputs (default: all) are the
    model's and freeze what reaches them; the rest only keep their
    computation in the graph.  An op without a rule freezes what it
    touches."""
    spaces = _SpaceSet()
    interp = _Interp(spaces)
    sig = program.graph_signature
    named = {node: name[len(prefix):] if name.startswith(prefix) else name
             for mapping in (sig.inputs_to_parameters, sig.inputs_to_buffers)
             for node, name in mapping.items()}

    env: Dict[Any, Any] = {}          # node -> annotation (or a tuple)
    provenance: Dict[Any, Path] = {}  # node -> direct variable path

    def read(arg):
        if isinstance(arg, torch.fx.Node):
            ann = env.get(arg)
            return None if isinstance(ann, tuple) else ann
        if isinstance(arg, (int, float, bool)):
            return _UNIFORM
        return None

    def shape(node) -> Tuple[int, ...]:
        return tuple(node.meta['val'].shape)

    def freeze_all(args):
        flat = []
        torch.fx.node.map_arg(args, flat.append)
        for node in flat:
            ann = env.get(node)
            for a in (ann if isinstance(ann, tuple) else (ann,)):
                if isinstance(a, (ChanAnn, VecAnn)):
                    interp._freeze_ann(a)

    def replace_axis(ann, axis):
        return dataclasses.replace(ann, axis=axis)

    def channel_vector(arg):
        """A 1-D operand that an op applies along the NCHW channel axis."""
        ann = read(arg)
        return replace_axis(ann, 1) if isinstance(ann, VecAnn) else ann

    def conv(node):
        # conv2d(input, weight, bias, stride, padding, dilation, groups)
        lhs, rhs, bias, _, _, _, groups = _conv2d_args(node)
        kernel_path = provenance.get(rhs)
        lhs_ann = read(lhs)
        if kernel_path is None:
            # computed kernel: nothing we can slice
            freeze_all(node.args)
            return None
        cin, cout = shape(lhs)[1], shape(node)[1]
        if isinstance(lhs_ann, ChanAnn) and lhs_ann.axis != 1:
            interp._freeze_ann(lhs_ann)
            lhs_ann = None
        if isinstance(lhs_ann, VecAnn):
            interp.tainted |= lhs_ann.paths
            lhs_ann = None

        if groups == 1:
            if isinstance(lhs_ann, ChanAnn):
                off = 0
                for sid, size in lhs_ann.segments:
                    spaces.add_member(sid, Member(path=kernel_path, axis=1,
                                                  offset=off, role='consumer'))
                    off += size
            sid = spaces.fresh(cout)
            spaces.add_member(sid, Member(path=kernel_path, axis=0, offset=0,
                                          role='producer'))
            out = ChanAnn(1, ((sid, cout),))
        elif groups == cin and cout == cin:
            # depthwise, channel multiplier 1: channels flow through
            if isinstance(lhs_ann, ChanAnn):
                off = 0
                for sid, size in lhs_ann.segments:
                    spaces.add_member(sid, Member(path=kernel_path, axis=0,
                                                  offset=off,
                                                  role='depthwise'))
                    off += size
                out = ChanAnn(1, lhs_ann.segments)
            else:
                # input channels untracked: the kernel still owns a space,
                # but a frozen one
                sid = spaces.fresh(cout, frozen=True)
                spaces.add_member(sid, Member(path=kernel_path, axis=0,
                                              offset=0, role='depthwise'))
                out = ChanAnn(1, ((sid, cout),))
        else:
            # other grouped convs (ResNeXt etc.): pruning would have to
            # keep group sizes equal; freeze for safety
            if isinstance(lhs_ann, ChanAnn):
                interp._freeze_ann(lhs_ann)
            sid = spaces.fresh(cout, frozen=True)
            spaces.add_member(sid, Member(path=kernel_path, axis=0, offset=0,
                                          role='producer'))
            out = ChanAnn(1, ((sid, cout),))
        if bias is not None:
            out = interp._combine(out, channel_vector(bias), shape(node))
        return out

    def concat(node):
        tensors = node.args[0]
        dim = _norm_dim(node.args[1] if len(node.args) > 1 else 0,
                        len(shape(node)))
        anns = [read(a) for a in tensors]
        chan = [a for a in anns if isinstance(a, ChanAnn)]
        if not chan:
            return None
        if chan[0].axis == dim:
            segments: List[Tuple[int, int]] = []
            ok = True
            for a, t in zip(anns, tensors):
                if isinstance(a, ChanAnn) and a.axis == dim:
                    segments.extend(a.segments)
                elif a is None or a == _UNIFORM or isinstance(a, VecAnn):
                    # unknown chunk: an anonymous frozen space keeps the
                    # offsets right
                    size = shape(t)[dim]
                    segments.append((spaces.fresh(size, frozen=True), size))
                    if isinstance(a, VecAnn):
                        interp.tainted |= a.paths
                else:
                    ok = False
            if ok:
                return ChanAnn(dim, tuple(segments))
            for a in anns:
                if isinstance(a, (ChanAnn, VecAnn)):
                    interp._freeze_ann(a)
            return None
        # concat along another axis: all chunks must share the spaces
        out = anns[0]
        for a in anns[1:]:
            out = interp._combine(out, a, shape(node))
        return out

    def reduce(node, ann):
        in_ndim = len(shape(node.args[0]))
        dims = node.args[1] if len(node.args) > 1 else None
        keepdim = (node.args[2] if len(node.args) > 2
                   else node.kwargs.get('keepdim', False))
        if not isinstance(ann, (ChanAnn, VecAnn)):
            return ann if ann == _UNIFORM else None
        if dims is None or (isinstance(dims, (list, tuple)) and not dims):
            interp._freeze_ann(ann)
            return None
        dims = [_norm_dim(d, in_ndim)
                for d in (dims if isinstance(dims, (list, tuple)) else [dims])]
        if ann.axis in dims:
            interp._freeze_ann(ann)
            return None
        if keepdim:
            return ann
        return replace_axis(ann, ann.axis - sum(1 for d in dims if d < ann.axis))

    def index(node, ann):
        indices = node.args[1]
        for ix in indices:
            ix_ann = read(ix) if ix is not None else None
            if isinstance(ix_ann, (ChanAnn, VecAnn)):
                interp._freeze_ann(ix_ann)
        if not isinstance(ann, (ChanAnn, VecAnn)):
            return None
        used = [i for i, ix in enumerate(indices) if ix is not None]
        # spatial gathers after the channel axis, side by side, leave it
        # where it is
        if (used and min(used) > ann.axis
                and used == list(range(used[0], used[-1] + 1))):
            return ann
        interp._freeze_ann(ann)
        return None

    def slice_(node, ann):
        if not isinstance(ann, (ChanAnn, VecAnn)):
            return ann if ann == _UNIFORM else None
        in_shape = shape(node.args[0])
        dim = _norm_dim(node.args[1] if len(node.args) > 1 else 0,
                        len(in_shape))
        if dim != ann.axis:
            return ann
        if tuple(shape(node))[dim] == in_shape[dim] and (
                len(node.args) < 5 or node.args[4] == 1):
            return ann
        interp._freeze_ann(ann)
        return None

    def split(node, ann):
        n = len(node.meta['val'])
        dim = _norm_dim(node.args[2] if len(node.args) > 2
                        else node.kwargs.get('dim', 0), len(shape(node.args[0])))
        if isinstance(ann, (ChanAnn, VecAnn)):
            if ann.axis == dim:
                interp._freeze_ann(ann)
                return (None,) * n
            return (ann,) * n
        return (ann if ann == _UNIFORM else None,) * n

    for node in program.graph.nodes:
        if node.op == 'placeholder':
            env[node] = None
            if node.name in named:
                ndim = len(shape(node))
                path = variable_path(named[node.name], ndim)
                if path is not None:
                    provenance[node] = path
                    if ndim == 1 and shape(node)[0] > 1:
                        env[node] = VecAnn(axis=0, size=shape(node)[0],
                                           paths=frozenset([path]))
                    elif ndim == 0:
                        env[node] = _UNIFORM
                elif ndim == 0:
                    env[node] = _UNIFORM
            continue
        if node.op == 'output':
            # model outputs are user-visible: freeze any space still
            # annotated there
            flat = []
            torch.fx.node.map_arg(node.args, flat.append)
            for out in flat[:model_outputs]:
                if isinstance(env.get(out), ChanAnn):
                    interp._freeze_ann(env[out])
            continue
        if node.op != 'call_function':
            env[node] = None
            freeze_all(node.args)
            continue
        name = _op_name(node.target)
        args = node.args
        first = read(args[0]) if args else None
        if name == 'getitem':
            src = env.get(args[0])
            env[node] = src[args[1]] if isinstance(src, tuple) else None
        elif name == 'conv2d':
            env[node] = conv(node)
        elif name == 'batch_norm' and not args[5]:
            ann = first
            for vec in args[1:5]:
                if vec is not None:
                    ann = interp._combine(ann, channel_vector(vec),
                                          shape(args[0]))
            env[node] = ann
        elif name in _COPIES:
            env[node] = first
            if args and args[0] in provenance:
                provenance[node] = provenance[args[0]]
        elif name in _UNARY or (name == 'clamp' and not any(
                isinstance(bound, torch.fx.Node) for bound in args[1:])):
            env[node] = first
        elif name in _BINARY and len(args) >= 2:
            env[node] = interp._combine(first, read(args[1]), shape(node))
        elif name in _INERT:
            env[node] = None
        elif name == 'pad' and (args[2] if len(args) > 2 else
                                node.kwargs.get('mode', 'constant')) \
                == 'constant':
            ann = first
            if isinstance(ann, ChanAnn):
                pad = args[1]
                ndim = len(shape(args[0]))
                padded = {ndim - 1 - i // 2 for i, p in enumerate(pad) if p}
                if ann.axis in padded:
                    interp._freeze_ann(ann)
                    ann = None
            env[node] = ann
        elif name in _SPATIAL:
            ann = first
            if isinstance(ann, (ChanAnn, VecAnn)) and \
                    ann.axis >= len(shape(args[0])) - 2:
                interp._freeze_ann(ann)
                ann = None
            if isinstance(node.meta['val'], (tuple, list)):
                env[node] = (ann,) + (None,) * (len(node.meta['val']) - 1)
            else:
                env[node] = ann
        elif name in _REDUCTIONS:
            env[node] = reduce(node, first)
        elif name == 'cat':
            env[node] = concat(node)
        elif name == 'permute':
            ann = first
            if isinstance(ann, (ChanAnn, VecAnn)):
                perm = [_norm_dim(d, len(args[1])) for d in args[1]]
                ann = replace_axis(ann, perm.index(ann.axis))
            env[node] = ann
        elif name == 'transpose':
            ann = first
            if isinstance(ann, (ChanAnn, VecAnn)):
                ndim = len(shape(args[0]))
                a, b = _norm_dim(args[1], ndim), _norm_dim(args[2], ndim)
                ann = replace_axis(ann, {a: b, b: a}.get(ann.axis, ann.axis))
            env[node] = ann
        elif name in _RESHAPES:
            ann = first
            if isinstance(ann, (ChanAnn, VecAnn)):
                b = _moved_axis(shape(args[0]), shape(node), ann.axis)
                if b is None:
                    interp._freeze_ann(ann)
                    ann = None
                else:
                    ann = replace_axis(ann, b)
            env[node] = ann
        elif name == 'index':
            env[node] = index(node, first)
        elif name == 'slice':
            env[node] = slice_(node, first)
        elif name in ('split', 'split_with_sizes', 'chunk'):
            env[node] = split(node, first)
        else:
            # no rule: freeze everything it touches
            freeze_all(args)
            freeze_all(node.kwargs)
            val = node.meta.get('val')
            env[node] = ((None,) * len(val) if isinstance(val, (tuple, list))
                         else None)

    # resolve union-find roots into Space objects
    out: List[Space] = []
    for sid in range(len(spaces.parent)):
        if spaces.find(sid) != sid:
            continue
        members = tuple(spaces.members[sid])
        if not members:
            continue
        # vectors that leaked into unknown contexts make the whole space
        # unsafe to slice
        frozen = spaces.frozen[sid] or any(
            m.path in interp.tainted for m in members)
        out.append(Space(width=spaces.width[sid], members=members,
                         frozen=frozen))
    return out


def plain_copy(model: torch.nn.Module) -> torch.nn.Module:
    """A CPU copy of ``model`` in eval mode with its plain float forward:
    no quantization mode on a conv, no GroupNorm on a BatchNorm (the JAX
    package analyzes ``module.apply`` without its interceptors)."""
    from single_shot_detection_tpu_torch.models.layers import BatchNorm, Conv2d
    plain = copy.deepcopy(model).cpu().eval()
    for m in plain.modules():
        if isinstance(m, Conv2d):
            m.quant = None
        elif isinstance(m, BatchNorm):
            m.group_norm = None
    return plain


class _EveryOutput(torch.nn.Module):
    """``model(x)`` followed by every submodule's outputs.  A jaxpr keeps
    computations whose results go unused (a backbone's stages past the
    last tap); ``torch.export`` would drop them, so they are returned here
    too, and only the model's own outputs freeze their spaces."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x):
        seen: List[torch.Tensor] = []

        def keep(module, inputs, output):
            torch.utils._pytree.tree_map_only(torch.Tensor, seen.append,
                                              output)

        hooks = [m.register_forward_hook(keep)
                 for m in self.model.modules() if m is not self.model]
        try:
            out = self.model(x)
        finally:
            for h in hooks:
                h.remove()
        return out, tuple(seen)


def analyze_module(model: torch.nn.Module,
                   input_shape: Sequence[int]) -> List[Space]:
    """Channel spaces of ``model(x)`` in eval mode on f32 zeros of
    ``input_shape`` (NCHW with the batch, e.g. ``(1, 3, 300, 300)``),
    traced on a plain CPU copy (:func:`plain_copy`)."""
    wrapped = _EveryOutput(plain_copy(model))
    with torch.no_grad():
        program = torch.export.export(wrapped,
                                      (torch.zeros(tuple(input_shape)),))
    out_spec = program.module_call_graph[0].signature.out_spec
    model_spec = (out_spec.child(0) if hasattr(out_spec, 'child')
                  else out_spec.children_specs[0])
    return analyze_program(program, model_spec.num_leaves, prefix='model.')
