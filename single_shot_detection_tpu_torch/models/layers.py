"""Reusable conv blocks (NCHW).

Port of ``single_shot_detection_tpu/models/layers.py``.  Child modules carry
the flax submodule names (``conv``/``bn``, ``depthwise_conv``/...), so a JAX
variable tree maps onto the ``state_dict`` by a plain walk
(``utils/weights.py``).

BatchNorm (:class:`BatchNorm`): flax's ``momentum=0.9`` is torch's
``momentum=0.1``, and both use ``eps=1e-5``.  Eval mode normalizes with the
running statistics; train mode follows flax ``nn.BatchNorm`` (batch
statistics, running statistics updated with the *biased* batch variance).

Compute dtype (docs/DESIGN.md §10): parameters and BN statistics are f32; a
convolution runs in its input's dtype (:class:`Conv2d`), and a BatchNorm
computes in f32 and returns its input's dtype, as flax's
``nn.BatchNorm(dtype=...)`` does.  A bf16 detector casts its image once at
its entry (``models/detector.py``) and every layer below follows.

The model axis (``parallel/``): :meth:`Conv2d.conv_with`, every conv's one
path, runs a tensor-sharded conv (``parallel/tensor.py``) or a
height-sharded one (``parallel/spatial.py``) when that option owns the
axis; :func:`max_pool2d`, :func:`spatial_size` and :func:`mean_hw` are
the models' pools, target sizes and global means, height-sharded under
``spatial_sharding``.  A BatchNorm's synced statistics reduce over the
data group, and over the world (model and data) under spatial sharding.

Initializers: :func:`conv2d` builds a :class:`Conv2d` that carries its own
``kernel_init`` (flax's ``lecun_normal`` by default, or a config's
``{'name': ..., 'args': ...}`` through :func:`get_initializer`), drawn from
an explicit ``torch.Generator`` by :func:`reset_conv`.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from single_shot_detection_tpu_torch import parallel
from single_shot_detection_tpu_torch.models import norm
from single_shot_detection_tpu_torch.parallel import spatial, tensor
from single_shot_detection_tpu_torch.ops.bn_fused import fused_bn_train
from single_shot_detection_tpu_torch.ops.ties import SIX


def relu6(x: torch.Tensor) -> torch.Tensor:
    """``min(relu(x), 6)`` with the gradient of JAX's
    ``jnp.minimum(nn.relu(x), 6.0)`` at x = 6."""
    return torch.minimum(F.relu(x), SIX)


ACTIVATIONS = {
    'ReLU': F.relu,
    'ReLU6': relu6,
    'LeakyReLU': lambda x: F.leaky_relu(x, 0.01),  # flax's default slope
    'SiLU': F.silu,
    'GELU': lambda x: F.gelu(x, approximate='tanh'),  # flax's default form
    'Sigmoid': torch.sigmoid,
    'Tanh': torch.tanh,
    'Identity': lambda x: x,
}


def tf_same_pad(kernel_size: int, stride: int) -> Tuple[int, int, int, int]:
    """``F.pad`` widths ``(left, right, top, bottom)`` of the custom
    MobileNets: symmetric ``k // 2`` at stride 1, TF-style asymmetric
    ``(0, 1)`` at stride 2."""
    if stride == 2:
        return (0, 1, 0, 1)
    p = kernel_size // 2
    return (p, p, p, p)


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same ``state_dict`` keys) with flax's train mode.

    Eval mode is ``nn.BatchNorm2d``'s: the running statistics.  Train mode
    normalizes with the batch statistics and updates the running statistics
    in the forward as flax does: ``ra = 0.9 * ra + 0.1 * batch``, with the
    biased batch variance (stock ``nn.BatchNorm2d`` uses the unbiased one).
    ``num_batches_tracked`` is not advanced (flax keeps no such count).

    ``fused`` (the config's ``train.fused_bn``) selects the batch-statistic
    pass: on, ``ops/bn_fused.py::fused_bn_train`` (the four CUDA kernels on
    the card); off, PyTorch's own ``torch.native_batch_norm``, the
    counterpart of flax's XLA-lowered BN.  It is a configuration: neither
    path stands in for the other when one fails.

    ``group_norm`` (the config's ``train.group_norm``, a group count or
    ``None``) makes it a GroupNorm over the same ``weight`` and ``bias``
    in train and eval mode (``models/norm.py``); the running statistics
    are then never written.

    A bf16 input is normalized in f32 and returned in bf16 on every path
    (flax's rule): the kernels' ``out_dtype``, and PyTorch's batch norm,
    which takes bf16 activations with f32 parameters and computes in f32.
    The running statistics are updated from the f32 batch statistics.

    ``sync`` (set for every BatchNorm of a run of several processes,
    ``parallel/mesh.py``) takes the train-mode statistics over the global
    batch, the rows of every rank, as the JAX engine's one SPMD program
    does: :class:`SyncBatchNormFunction`, in plain PyTorch with two
    all-reduces.  It wins over ``fused`` (the JAX engine keeps flax's BN
    under several devices too); eval mode and ``group_norm`` need no sync.
    """

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)
        self.fused = False
        self.sync = False
        self.group_norm: Optional[int] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.group_norm is not None:
            return self._group_norm(x)
        if not self.training:
            return super().forward(x)
        if self.sync:
            z, mean, var = SyncBatchNormFunction.apply(x, self.weight,
                                                       self.bias, self.eps)
        elif self.fused:
            z, mean, var = fused_bn_train(x, self.weight, self.bias, self.eps)
        else:
            z, mean, invstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps)
            mean = mean.detach()
            var = torch.clamp(invstd.detach().pow(-2) - self.eps, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(
                mean * self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(
                var * self.momentum)
        return z

    def _group_norm(self, x: torch.Tensor) -> torch.Tensor:
        """GroupNorm; a group spans channels, so a tensor-sharded map and
        its parameters are gathered and the output cut back to this
        rank's channels, and a height-sharded map's moments are summed
        over the model group."""
        if spatial.active():
            return spatial.group_norm(x, self.weight, self.bias,
                                      self.group_norm, self.eps,
                                      norm.num_groups)
        if tensor.active() and x.shape[1] != self.num_features:
            gather = tensor.gather_channels
            z = norm.group_norm(
                gather(x), gather(self.weight[None])[0],
                gather(self.bias[None])[0], self.group_norm, self.eps)
            return tensor.slice_channels(z)
        return norm.group_norm(x, self.weight, self.bias, self.group_norm,
                               self.eps)


class SyncBatchNormFunction(torch.autograd.Function):
    """Train-mode batch norm over the global batch of all the ranks.

    Forward: each rank's f32 per-channel ``[Σx, Σx², count]`` summed over
    the ranks in one all-reduce, then flax's fast variance ``max(0, E[x²] -
    E[x]²)`` (``nn.BatchNorm``'s ``use_fast_variance``) and ``z = (x -
    mean) * rsqrt(var + eps) * weight + bias`` in f32, returned in ``x``'s
    dtype with the f32 ``mean`` and biased ``var`` (the running statistics'
    update).  Backward: ``[Σdz, Σdz·x̂]`` summed over the ranks in one
    all-reduce, ``dx = weight * rstd / n * (n dz - Σdz - s x̂ Σdz·x̂)`` over
    the global count ``n``, ``s`` being the slope of flax's ``max(0, E[x²]
    - E[x]²)`` in autodiff: 1 above 0, 1/2 at 0 and 0 where rounding made
    the difference negative (``jnp.maximum``'s rule); the weight's and
    bias's gradients are this rank's own sums, which the step's gradient
    all-reduce adds up.

    The ranks are those of :func:`bn_axis`: the data group, or the world
    under spatial sharding (each rank holds some rows of each image)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        xf = x.float()
        c = xf.shape[1]
        dims = [0] + list(range(2, xf.dim()))
        count = torch.full((1,), xf.numel() // c, dtype=torch.float32,
                           device=xf.device)
        ctx.axis = bn_axis()
        sums = parallel.all_reduce_(torch.cat(
            [xf.sum(dims), (xf * xf).sum(dims), count]), axis=ctx.axis)
        n = sums[-1]
        mean = sums[:c] / n
        raw = sums[c:2 * c] / n - mean * mean
        var = torch.clamp(raw, min=0.0)
        rstd = torch.rsqrt(var + eps)
        shape = [1, c] + [1] * (xf.dim() - 2)
        xhat = (xf - mean.view(shape)) * rstd.view(shape)
        z = xhat * weight.view(shape) + bias.view(shape)
        ctx.save_for_backward(xhat, weight, rstd, n, (raw.sign() + 1) / 2)
        ctx.mark_non_differentiable(mean, var)
        ctx.in_dtype = x.dtype
        return z.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dz, _dmean, _dvar):
        xhat, weight, rstd, n, slope = ctx.saved_tensors
        dz = dz.float()
        c = dz.shape[1]
        dims = [0] + list(range(2, dz.dim()))
        local = torch.cat([dz.sum(dims), (dz * xhat).sum(dims)])
        sums = parallel.all_reduce_(local.clone(), axis=ctx.axis)
        sum_dz, sum_dz_xhat = sums[:c], sums[c:]
        shape = [1, c] + [1] * (dz.dim() - 2)
        dx = (weight * rstd / n).view(shape) * (
            n * dz - sum_dz.view(shape)
            - xhat * (slope * sum_dz_xhat).view(shape))
        return dx.to(ctx.in_dtype), local[c:], local[:c], None


def bn_axis() -> str:
    """The ranks a synced BN reduces over: ``'world'`` under spatial
    sharding, else ``'data'`` (a tensor-sharded channel's statistics are
    its owner's, over the model group's whole batch)."""
    return 'world' if spatial.active() else 'data'


def batch_norm(channels: int) -> BatchNorm:
    return BatchNorm(channels)


def set_sync_bn(model: nn.Module, sync: bool) -> int:
    """Set every :class:`BatchNorm`'s ``sync`` flag (the global-batch
    statistics of a run of several processes); returns their count."""
    layers = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in layers:
        m.sync = sync
    return len(layers)


def set_fused_bn(model: nn.Module, fused: bool) -> int:
    """Set every :class:`BatchNorm`'s ``fused`` flag; returns their count."""
    layers = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in layers:
        m.fused = fused
    return len(layers)


def set_group_norm(model: nn.Module, groups: Optional[int]) -> int:
    """Make every :class:`BatchNorm` a GroupNorm of ``groups`` groups
    (``None``: BatchNorm again); returns their count."""
    layers = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in layers:
        m.group_norm = groups
    return len(layers)


Init = Callable[[torch.Tensor, torch.Generator], None]


def _fans(weight: torch.Tensor) -> Tuple[int, int]:
    """``(fan_in, fan_out)`` of a conv weight ``[O, I/groups, kh, kw]``, as
    flax and torch count them."""
    receptive = weight[0, 0].numel()
    return weight.shape[1] * receptive, weight.shape[0] * receptive


def _truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard normal samples truncated to ``[-2, 2]`` (inverse CDF of a
    uniform draw, in f64)."""
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    u = lo + (1 - 2 * lo) * torch.rand(shape, generator=generator,
                                       dtype=torch.float64)
    return math.sqrt(2) * torch.erfinv(2 * u - 1)


def variance_scaling(scale: float, mode: str, distribution: str) -> Init:
    """flax's ``variance_scaling`` initializer: variance ``scale / fan``.
    A ``truncated_normal`` is cut at two standard deviations and widened so
    that the variance holds; ``normal`` is a plain normal and ``uniform``
    a uniform of that variance, both drawn in f32."""
    def init(weight: torch.Tensor, generator: torch.Generator) -> None:
        fan_in, fan_out = _fans(weight)
        fan = {'fan_in': fan_in, 'fan_out': fan_out,
               'fan_avg': (fan_in + fan_out) / 2}[mode]
        std = math.sqrt(scale / fan)
        if distribution == 'truncated_normal':
            # the std of a unit normal truncated to [-2, 2]
            values = (_truncated_normal(weight.shape, generator)
                      * std / 0.87962566103423978)
        elif distribution == 'normal':
            values = torch.randn(weight.shape, generator=generator) * std
        else:
            values = ((torch.rand(weight.shape, generator=generator) * 2 - 1)
                      * (math.sqrt(3.0) * std))
        with torch.no_grad():
            weight.copy_(values)
    return init


def normal(std: float) -> Init:
    def init(weight: torch.Tensor, generator: torch.Generator) -> None:
        with torch.no_grad():
            weight.copy_(torch.randn(weight.shape, generator=generator) * std)
    return init


def constant(value: float) -> Init:
    def init(weight: torch.Tensor, generator: torch.Generator) -> None:
        nn.init.constant_(weight, value)
    return init


# flax's defaults and the named initializers of the JAX package.  One
# deviation: ``xavier_normal`` is a plain normal, as the port has always
# drawn the flagship's extras (seeded runs keep their weights),
# where flax's ``glorot_normal`` truncates at two standard deviations; the
# variance is the same.
lecun_normal = variance_scaling(1.0, 'fan_in', 'truncated_normal')
xavier_normal = variance_scaling(1.0, 'fan_avg', 'normal')
xavier_uniform = variance_scaling(1.0, 'fan_avg', 'uniform')
_NAMED = {
    'xavier_normal_': xavier_normal,
    'xavier_uniform_': xavier_uniform,
    # torch's defaults (leaky_relu, a=0): gain sqrt(2), He init
    'kaiming_normal_': variance_scaling(2.0, 'fan_in', 'truncated_normal'),
    'kaiming_uniform_': variance_scaling(2.0, 'fan_in', 'uniform'),
    'zeros_': constant(0.0),
    'ones_': constant(1.0),
}


def get_initializer(params: Optional[Mapping],
                    default: Optional[Init] = None) -> Optional[Init]:
    """A config's ``{'name': <torch nn.init name>, 'args': {...}}`` as an
    ``init(weight, generator)`` function (port of the JAX package's
    ``get_initializer``); ``default`` without one."""
    if params is None:
        return default
    name = params['name']
    args = dict(params.get('args', {}))
    if name == 'normal_':
        if args.pop('mean', 0) != 0:
            raise ValueError('normal_ initializer: only mean=0 is supported')
        return normal(args.pop('std', 1.0))
    if name == 'constant_':
        return constant(args.pop('val'))
    if name not in _NAMED:
        raise ValueError(f'Unsupported initializer {name!r} '
                         f'(supported: normal_, constant_, {", ".join(_NAMED)})')
    if args:
        raise ValueError(f'{name}: unsupported args {sorted(args)}')
    return _NAMED[name]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype: an f32 weight and bias are cast
    to a bf16 input's dtype at use, as flax's ``nn.Conv(dtype=...)`` casts
    its f32 parameters, so the gradients still reach f32 parameters.

    ``pad`` (``F.pad`` widths ``(left, right, top, bottom)``, or None) is
    the zero padding of a conv that flax pads asymmetrically (the custom
    MobileNets' TF-style stride 2), applied ahead of the conv's own
    symmetric ``padding``; the conv still sees the unpadded input, as the
    flax conv does.  ``quant`` (None: the float conv) is the quantization
    mode that ``export/quantize.py`` switches on: a callable ``(conv, x) ->
    y`` run in place of :meth:`float_forward` (int8 serving, QAT's fake
    quantization, calibration)."""

    pad: Optional[Tuple[int, int, int, int]] = None
    quant: Optional[Callable[['Conv2d', torch.Tensor], torch.Tensor]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant is not None:
            return self.quant(self, x)
        return self.float_forward(x)

    def float_forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self.conv_with(x, self.weight.to(x.dtype), bias)

    def conv_with(self, x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor]) -> torch.Tensor:
        """This conv's geometry (``pad``, stride, padding, groups) on
        ``x`` with another ``weight`` and ``bias``: height-sharded under
        ``spatial_sharding``, on this rank's channels under
        ``tensor_sharding``."""
        mode = parallel.model_mode()
        if mode == 'spatial':
            return spatial.conv2d(self, x, weight, bias)
        if self.pad is not None:
            x = F.pad(x, self.pad)
        if mode == 'tensor':
            return tensor.conv(self, x, weight, bias)
        return self._conv_forward(x, weight, bias)


def max_pool2d(x: torch.Tensor, kernel: int, stride: int, padding: int = 0,
               pad: Optional[Tuple[int, int, int, int]] = None
               ) -> torch.Tensor:
    """``F.max_pool2d`` (symmetric ``padding``, then ``F.pad``-style
    ``pad`` widths of ``-inf``), height-sharded under
    ``spatial_sharding``."""
    widths = tuple(p + padding for p in (pad or (0, 0, 0, 0)))
    if spatial.active():
        return spatial.max_pool2d(x, kernel, stride, widths)
    if pad is not None:
        x = F.pad(x, pad, value=float('-inf'))
    return F.max_pool2d(x, kernel, stride, padding=padding)


def spatial_size(x: torch.Tensor) -> Tuple[int, int]:
    """``(H, W)`` of a map: its global height under ``spatial_sharding``."""
    if spatial.active():
        return spatial.global_height(x), x.shape[3]
    return tuple(x.shape[2:])


def mean_hw(x: torch.Tensor) -> torch.Tensor:
    """The spatial mean ``[B, C, 1, 1]``, over the global map under
    ``spatial_sharding``."""
    if spatial.active():
        return spatial.mean_hw(x)
    return x.mean(dim=(2, 3), keepdim=True)


def conv2d(in_channels: int, out_channels: int, kernel_size: int,
           stride: int = 1, padding: int = 0, groups: int = 1,
           bias: bool = False, kernel_init: Optional[Init] = None,
           bias_init: float = 0.0,
           pad: Optional[Tuple[int, int, int, int]] = None) -> Conv2d:
    """:class:`Conv2d` that carries its own initializer: ``kernel_init``
    (default: flax's ``lecun_normal``) and a constant ``bias_init``, which
    ``reset_conv`` applies; ``pad`` as :class:`Conv2d` takes it."""
    conv = Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                  padding=padding, groups=groups, bias=bias)
    conv.kernel_init = kernel_init or lecun_normal
    conv.bias_init = bias_init
    conv.pad = pad
    return conv


def reset_conv(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """Draw ``conv``'s weight with its own ``kernel_init``; its bias is
    ``bias_init``."""
    if not hasattr(conv, 'kernel_init'):
        raise TypeError(f'{conv} carries no initializer: build it with '
                        'layers.conv2d')
    conv.kernel_init(conv.weight, generator)
    if conv.bias is not None:
        nn.init.constant_(conv.bias, conv.bias_init)


def _act(activation: Optional[str]):
    return ACTIVATIONS['Identity' if activation is None else activation]


class ConvBn(nn.Module):
    """conv [+ BN] [+ activation]; ``padding`` is symmetric.
    ``kernel_init`` None is flax's default, ``lecun_normal``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 0,
                 groups: int = 1, use_bias: bool = False, use_bn: bool = True,
                 activation: Optional[str] = 'ReLU',
                 kernel_init: Optional[Init] = None):
        super().__init__()
        self.conv = conv2d(in_channels, out_channels, kernel_size,
                           stride=stride, padding=padding, groups=groups,
                           bias=use_bias, kernel_init=kernel_init)
        self.bn = batch_norm(out_channels) if use_bn else None
        self.activation = activation

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return _act(self.activation)(x)


class DepthwiseConvBn(nn.Module):
    """depthwise conv [+ BN] [+ activation], then pointwise conv [+ BN]
    [+ activation].  ``padding`` is symmetric (the SSD extras pad their
    stride-2 depthwise conv by 1 on every side, unlike the backbone);
    ``kernel_init`` applies to both convs."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 0,
                 use_bias: bool = False, use_bn: bool = True,
                 activation: Optional[str] = 'ReLU',
                 kernel_init: Optional[Init] = None):
        super().__init__()
        self.depthwise_conv = conv2d(in_channels, in_channels, kernel_size,
                                     stride=stride, padding=padding,
                                     groups=in_channels, bias=use_bias,
                                     kernel_init=kernel_init)
        self.depthwise_bn = batch_norm(in_channels) if use_bn else None
        self.pointwise_conv = conv2d(in_channels, out_channels, 1,
                                     bias=use_bias, kernel_init=kernel_init)
        self.pointwise_bn = batch_norm(out_channels) if use_bn else None
        self.activation = activation

    def forward(self, x):
        act = _act(self.activation)
        x = self.depthwise_conv(x)
        if self.depthwise_bn is not None:
            x = self.depthwise_bn(x)
        x = self.pointwise_conv(act(x))
        if self.pointwise_bn is not None:
            x = self.pointwise_bn(x)
        return act(x)
