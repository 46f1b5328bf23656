"""Train-mode BatchNorm on the four hand-written CUDA kernels
(``kernels/bn.cu``), with their plain PyTorch versions.

Port of the four Pallas kernels of ``single_shot_detection_tpu/ops/
bn_pallas.py`` (K1 ``_stats_kernel``, K2 ``_apply_kernel``, K3
``_grad_sums_kernel``, K4 ``_dx_kernel``).  Activations are NCHW
``[B, C, *spatial]``, contiguous, f32 or bf16; each channel reduces over
every axis but 1.  Statistics, sums and coefficients are f32.

Each wrapper takes its plain version for a CPU tensor and launches its
kernel for a CUDA tensor; on CUDA there is no fallback: a failed build,
an input the kernel does not take or a failed launch raises.  Each wrapper
counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from single_shot_detection_tpu_torch.kernels import _build

# dtype codes of kernels/bn.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

Tensor = torch.Tensor


# ------------------------------------------------------- plain versions

def _dims(x: Tensor):
    return [0] + list(range(2, x.dim()))


def _per_channel(v: Tensor, x: Tensor) -> Tensor:
    return v.view(1, -1, *([1] * (x.dim() - 2)))


def _count(x: Tensor) -> int:
    return x.numel() // x.shape[1]


def bn_stats_plain(x: Tensor, eps: float) -> Tuple[Tensor, Tensor, Tensor]:
    """K1: ``(mean, var, rstd)`` per channel in f32, flax's fast variance
    ``max(0, E[x^2] - E[x]^2)`` and ``rstd = rsqrt(var + eps)``."""
    xf = x.float()
    n = _count(x)
    mean = xf.sum(_dims(x)) / n
    var = torch.clamp((xf * xf).sum(_dims(x)) / n - mean * mean, min=0.0)
    return mean, var, torch.rsqrt(var + eps)


def bn_apply_plain(x: Tensor, mean: Tensor, rstd: Tensor, scale: Tensor,
                   bias: Tensor, out_dtype: torch.dtype) -> Tensor:
    """K2: ``z = (x - mean) * rstd * scale + bias`` in f32, cast."""
    c = functools.partial(_per_channel, x=x)
    z = (x.float() - c(mean)) * c(rstd) * c(scale) + c(bias)
    return z.to(out_dtype)


def bn_grad_sums_plain(dz: Tensor, x: Tensor, mean: Tensor, rstd: Tensor,
                       scale: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """K3: ``(d_gamma, d_beta, coef)``; ``d_beta = sum dz``,
    ``d_gamma = sum dz * xhat`` and K4's coefficients
    ``coef = [rstd * scale, d_beta / n, d_gamma / n]`` (``[3, C]``)."""
    c = functools.partial(_per_channel, x=x)
    g = dz.float()
    xhat = (x.float() - c(mean)) * c(rstd)
    d_beta = g.sum(_dims(x))
    d_gamma = (g * xhat).sum(_dims(x))
    n = _count(x)
    coef = torch.stack([rstd * scale, d_beta / n, d_gamma / n])
    return d_gamma, d_beta, coef


def bn_dx_plain(dz: Tensor, x: Tensor, mean: Tensor, rstd: Tensor,
                coef: Tensor) -> Tensor:
    """K4: ``dx = coef0 * (dz - coef1 - xhat * coef2)`` in x's dtype."""
    c = functools.partial(_per_channel, x=x)
    xhat = (x.float() - c(mean)) * c(rstd)
    dx = c(coef[0]) * ((dz.float() - c(coef[1])) - xhat * c(coef[2]))
    return dx.to(x.dtype)


# ------------------------------------------------------------- kernels

@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load('bn')
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.bn_stats_launch.argtypes = [p, i, p, p, p, ll, ll, ll, f, i, p]
    lib.bn_apply_launch.argtypes = [p, i, p, p, p, p, p, i, ll, ll, ll, i, p]
    lib.bn_grad_sums_launch.argtypes = [p, i, p, i, p, p, p, p, p, p,
                                        ll, ll, ll, i, p]
    lib.bn_dx_launch.argtypes = [p, i, p, i, p, p, p, p, ll, ll, ll, i, p]
    lib.bn_reduce_launch.argtypes = [i, i, i, p, i, p, i, p, p, p, p, p, p,
                                     ll, ll, ll, f, i, p]
    lib.bn_reduce_plan.argtypes = [i, i, p, i, p, i, ll, ll, ll, i, p]
    lib.bn_elementwise_launch.argtypes = [i, i, i, p, i, p, i, p, p, p, p, p,
                                          i, ll, ll, ll, i, p]
    lib.bn_elementwise_plan.argtypes = [i, i, p, i, p, i, p, i, ll, ll, ll,
                                        i, p]
    for fn in (lib.bn_stats_launch, lib.bn_apply_launch,
               lib.bn_grad_sums_launch, lib.bn_dx_launch,
               lib.bn_reduce_launch, lib.bn_reduce_plan,
               lib.bn_elementwise_launch, lib.bn_elementwise_plan):
        fn.restype = i
    lib.bn_error_string.argtypes = [i]
    lib.bn_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build and load the kernels now (otherwise at first launch)."""
    _library()


def _check_activation(name: str, t: Tensor, like: Optional[Tensor] = None):
    if t.dtype not in _DTYPES:
        raise TypeError(f'{name} must be float32 or bfloat16, got {t.dtype}')
    if t.dim() < 2:
        raise ValueError(f'{name} must be [B, C, ...], got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')
    if t.numel() == 0:
        raise ValueError(f'{name} is empty')
    if like is not None and (t.shape != like.shape or t.device != like.device):
        raise ValueError(f'{name} {tuple(t.shape)} on {t.device} does not '
                         f'match x {tuple(like.shape)} on {like.device}')


def _check_channel(name: str, t: Tensor, x: Tensor, rows: int = 1):
    want = (x.shape[1],) if rows == 1 else (rows, x.shape[1])
    if t.dtype != torch.float32 or tuple(t.shape) != want:
        raise ValueError(f'{name} must be float32 {want}, got {t.dtype} '
                         f'{tuple(t.shape)}')
    if t.device != x.device or not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous on {x.device}')


def _on_cuda(x: Tensor) -> bool:
    if x.device.type == 'cpu':
        return False
    if x.device.type != 'cuda':
        raise ValueError(f'no BatchNorm kernel for device {x.device}')
    return True


def _geometry(x: Tensor):
    return x.shape[0], x.shape[1], math.prod(x.shape[2:])


def _launch(fn, *args, device: torch.device) -> None:
    err = fn(*args, device.index, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f'BatchNorm kernel launch failed: '
                           f'{_library().bn_error_string(err).decode()} ({err})')


def _empty_f32(shape, device) -> Tensor:
    return torch.empty(shape, dtype=torch.float32, device=device)


def bn_stats(x: Tensor, eps: float) -> Tuple[Tensor, Tensor, Tensor]:
    """K1: per-channel ``(mean, var, rstd)`` of ``x`` ``[B, C, ...]``."""
    if not _on_cuda(x):
        return bn_stats_plain(x, eps)
    _check_activation('x', x)
    b, c, s = _geometry(x)
    mean, var, rstd = (_empty_f32(c, x.device) for _ in range(3))
    _launch(_library().bn_stats_launch, x.data_ptr(), _DTYPES[x.dtype],
            mean.data_ptr(), var.data_ptr(), rstd.data_ptr(), b, c, s, eps,
            device=x.device)
    bn_stats.launches += 1
    return mean, var, rstd


def bn_apply(x: Tensor, mean: Tensor, rstd: Tensor, scale: Tensor,
             bias: Tensor, out_dtype: Optional[torch.dtype] = None) -> Tensor:
    """K2: ``z = (x - mean) * rstd * scale + bias`` in ``out_dtype``
    (default: x's)."""
    out_dtype = out_dtype or x.dtype
    if not _on_cuda(x):
        return bn_apply_plain(x, mean, rstd, scale, bias, out_dtype)
    _check_activation('x', x)
    for name, t in (('mean', mean), ('rstd', rstd), ('scale', scale),
                    ('bias', bias)):
        _check_channel(name, t, x)
    if out_dtype not in _DTYPES:
        raise TypeError(f'out_dtype must be float32 or bfloat16, got {out_dtype}')
    z = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    b, c, s = _geometry(x)
    _launch(_library().bn_apply_launch, x.data_ptr(), _DTYPES[x.dtype],
            mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), z.data_ptr(), _DTYPES[out_dtype], b, c, s,
            device=x.device)
    bn_apply.launches += 1
    return z


def bn_grad_sums(dz: Tensor, x: Tensor, mean: Tensor, rstd: Tensor,
                 scale: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """K3: ``(d_gamma, d_beta, coef [3, C])`` from ``dz`` and ``x``."""
    if not _on_cuda(x):
        return bn_grad_sums_plain(dz, x, mean, rstd, scale)
    _check_activation('x', x)
    _check_activation('dz', dz, like=x)
    for name, t in (('mean', mean), ('rstd', rstd), ('scale', scale)):
        _check_channel(name, t, x)
    b, c, s = _geometry(x)
    d_gamma, d_beta = _empty_f32(c, x.device), _empty_f32(c, x.device)
    coef = _empty_f32((3, c), x.device)
    _launch(_library().bn_grad_sums_launch, dz.data_ptr(), _DTYPES[dz.dtype],
            x.data_ptr(), _DTYPES[x.dtype], mean.data_ptr(), rstd.data_ptr(),
            scale.data_ptr(), d_gamma.data_ptr(), d_beta.data_ptr(),
            coef.data_ptr(), b, c, s, device=x.device)
    bn_grad_sums.launches += 1
    return d_gamma, d_beta, coef


def bn_dx(dz: Tensor, x: Tensor, mean: Tensor, rstd: Tensor,
          coef: Tensor) -> Tensor:
    """K4: ``dx = coef0 * (dz - coef1 - xhat * coef2)`` in x's dtype."""
    if not _on_cuda(x):
        return bn_dx_plain(dz, x, mean, rstd, coef)
    _check_activation('x', x)
    _check_activation('dz', dz, like=x)
    for name, t in (('mean', mean), ('rstd', rstd)):
        _check_channel(name, t, x)
    _check_channel('coef', coef, x, rows=3)
    dx = torch.empty_like(x)
    b, c, s = _geometry(x)
    _launch(_library().bn_dx_launch, dz.data_ptr(), _DTYPES[dz.dtype],
            x.data_ptr(), _DTYPES[x.dtype], mean.data_ptr(), rstd.data_ptr(),
            coef.data_ptr(), dx.data_ptr(), b, c, s, device=x.device)
    bn_dx.launches += 1
    return dx


# Kernel launches since each count was last set to 0.
KERNELS = (bn_stats, bn_apply, bn_grad_sums, bn_dx)


# ------------------------------------------------ the reductions' grids

# K1's and K3's paths and how a channel's blocks combine (codes of
# kernels/bn.cu): 'auto' is the shape's own path
REDUCE_PATHS = {'auto': -1, 'vector': 0, 'split': 1, 'scalar': 2,
                'narrow': 3}
_COMBINES = ('one block', 'cluster', 'ticket')
_REDUCE_KERNELS = {'bn_stats': 0, 'bn_grad_sums': 1}


def reduce_plan(kernel: str, x: Tensor, dz: Optional[Tensor] = None,
                path: str = 'auto') -> dict:
    """The grid that K1 (``kernel='bn_stats'``) or K3 (``'bn_grad_sums'``,
    with ``dz``) launches on these CUDA tensors on ``path``: the path, the
    threads per block, the blocks per channel and how they combine, the
    blocks and the channels per block."""
    b, c, s = _geometry(x)
    out = (ctypes.c_int * 6)()
    err = _library().bn_reduce_plan(
        _REDUCE_KERNELS[kernel], REDUCE_PATHS[path],
        dz.data_ptr() if dz is not None else None,
        _DTYPES[dz.dtype] if dz is not None else 0, x.data_ptr(),
        _DTYPES[x.dtype], b, c, s, x.device.index, out)
    if err:
        raise ValueError(f'{kernel} takes no path {path!r} on {tuple(x.shape)}')
    names = {v: k for k, v in REDUCE_PATHS.items()}
    return {'path': names[out[0]], 'threads': out[1],
            'blocks_per_channel': out[2], 'combine': _COMBINES[out[5]],
            'blocks': out[3], 'channels_per_block': out[4]}


def reduce_launcher(kernel: str, x: Tensor, dz: Optional[Tensor] = None,
                    mean: Optional[Tensor] = None, rstd: Optional[Tensor] = None,
                    scale: Optional[Tensor] = None, path: str = 'auto',
                    floor: bool = False, eps: float = 1e-5):
    """A call that launches K1 (``kernel='bn_stats'``) or K3
    (``'bn_grad_sums'``, with ``dz``, ``mean``, ``rstd`` and ``scale``) on
    ``path`` into outputs allocated once, or with ``floor`` an empty kernel
    on the same grid, block and cluster (the launch floor); the wrappers'
    launch counts are untouched.  For timing."""
    b, c, s = _geometry(x)
    outs = [_empty_f32(c, x.device), _empty_f32(c, x.device),
            _empty_f32((3, c) if kernel == 'bn_grad_sums' else c, x.device)]
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    args = (_REDUCE_KERNELS[kernel], REDUCE_PATHS[path], int(floor), ptr(dz),
            _DTYPES[dz.dtype] if dz is not None else 0, x.data_ptr(),
            _DTYPES[x.dtype], ptr(mean), ptr(rstd), ptr(scale),
            *(t.data_ptr() for t in outs), b, c, s, eps)

    def launch():
        _launch(_library().bn_reduce_launch, *args, device=x.device)
        return outs
    return launch


# ------------------------------------------------ the elementwise launches

# K2's and K4's paths (codes of kernels/bn.cu): 16-byte vectors whose lanes
# take one channel or two, 16-byte vectors with a channel per lane (planes
# shorter than a vector), one element per load (inputs and output at
# different phases); 'auto' is the inputs' own
ELEMENTWISE_PATHS = {'auto': -1, 'vector': 0, 'lanes': 1, 'scalar': 2}
_ELEMENTWISE_KERNELS = {'bn_apply': 0, 'bn_dx': 1}


def elementwise_plan(kernel: str, x: Tensor, dz: Optional[Tensor] = None,
                     out_dtype: Optional[torch.dtype] = None,
                     path: str = 'auto', out: Optional[Tensor] = None) -> dict:
    """The launch K2 (``kernel='bn_apply'``, z in ``out_dtype``) or K4
    (``'bn_dx'``, with ``dz``; dx in x's dtype) makes on these CUDA tensors
    into ``out`` (default: a fresh allocation, as the wrappers make) on
    ``path``: the path, the elements per 16-byte vector, the loads each
    thread keeps in flight, the threads per block, the blocks, the vectors
    per block and the elements before the first vector and after the last
    (one at a time)."""
    out_dtype = (out.dtype if out is not None
                 else x.dtype if kernel == 'bn_dx' else out_dtype or x.dtype)
    b, c, s = _geometry(x)
    result = (ctypes.c_int * 8)()
    err = _library().bn_elementwise_plan(
        _ELEMENTWISE_KERNELS[kernel], ELEMENTWISE_PATHS[path],
        dz.data_ptr() if dz is not None else None,
        _DTYPES[dz.dtype] if dz is not None else 0, x.data_ptr(),
        _DTYPES[x.dtype], out.data_ptr() if out is not None else None,
        _DTYPES[out_dtype], b, c, s, x.device.index, result)
    if err:
        raise ValueError(f'{kernel} takes no path {path!r} on {tuple(x.shape)}')
    names = {v: k for k, v in ELEMENTWISE_PATHS.items()}
    return {'path': names[result[0]], 'vector': result[1],
            'unroll': result[2], 'threads': result[3], 'blocks': result[4],
            'vectors_per_block': result[5], 'head': result[6],
            'tail': result[7]}


def elementwise_launcher(kernel: str, x: Tensor, mean: Tensor, rstd: Tensor,
                         scale: Optional[Tensor] = None,
                         bias: Optional[Tensor] = None,
                         dz: Optional[Tensor] = None,
                         coef: Optional[Tensor] = None,
                         out_dtype: Optional[torch.dtype] = None,
                         path: str = 'auto', floor: bool = False,
                         out: Optional[Tensor] = None):
    """A call that launches K2 (``kernel='bn_apply'``, with ``scale`` and
    ``bias``) or K4 (``'bn_dx'``, with ``dz`` and ``coef``) on ``path`` into
    ``out`` (default: allocated once, z in ``out_dtype``, dx in x's dtype; a
    given ``out`` must be contiguous, of x's shape), or with ``floor`` an
    empty kernel on the same grid (the launch floor); the wrappers' launch
    counts are untouched.  For timing, and for holding each path against
    the plain version."""
    if out is None:
        out = torch.empty(x.shape, device=x.device, dtype=(
            x.dtype if kernel == 'bn_dx' else out_dtype or x.dtype))
    _check_activation('out', out, like=x)
    b, c, s = _geometry(x)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    p0, p1 = (scale, bias) if kernel == 'bn_apply' else (coef, None)
    args = (_ELEMENTWISE_KERNELS[kernel], ELEMENTWISE_PATHS[path], int(floor),
            ptr(dz), _DTYPES[dz.dtype] if dz is not None else 0, x.data_ptr(),
            _DTYPES[x.dtype], mean.data_ptr(), rstd.data_ptr(), ptr(p0),
            ptr(p1), out.data_ptr(), _DTYPES[out.dtype], b, c, s)

    def launch():
        _launch(_library().bn_elementwise_launch, *args, device=x.device)
        return out
    return launch


for _fn in KERNELS:
    _fn.launches = 0
