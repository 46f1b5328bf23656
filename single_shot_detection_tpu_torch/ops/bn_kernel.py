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
    lib.bn_partial_floats.argtypes = [ll, ll, ll]
    lib.bn_partial_floats.restype = ll
    lib.bn_stats_launch.argtypes = [p, i, p, p, p, p, ll, ll, ll, f, i, p]
    lib.bn_apply_launch.argtypes = [p, i, p, p, p, p, p, i, ll, ll, ll, i, p]
    lib.bn_grad_sums_launch.argtypes = [p, i, p, i, p, p, p, p, p, p, p,
                                        ll, ll, ll, i, p]
    lib.bn_dx_launch.argtypes = [p, i, p, i, p, p, p, p, ll, ll, ll, i, p]
    for fn in (lib.bn_stats_launch, lib.bn_apply_launch,
               lib.bn_grad_sums_launch, lib.bn_dx_launch):
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
    lib = _library()
    b, c, s = _geometry(x)
    partial = _empty_f32(lib.bn_partial_floats(b, c, s), x.device)
    mean, var, rstd = (_empty_f32(c, x.device) for _ in range(3))
    _launch(lib.bn_stats_launch, x.data_ptr(), _DTYPES[x.dtype],
            partial.data_ptr(), mean.data_ptr(), var.data_ptr(),
            rstd.data_ptr(), b, c, s, eps, device=x.device)
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
    lib = _library()
    b, c, s = _geometry(x)
    partial = _empty_f32(lib.bn_partial_floats(b, c, s), x.device)
    d_gamma, d_beta = _empty_f32(c, x.device), _empty_f32(c, x.device)
    coef = _empty_f32((3, c), x.device)
    _launch(lib.bn_grad_sums_launch, dz.data_ptr(), _DTYPES[dz.dtype],
            x.data_ptr(), _DTYPES[x.dtype], mean.data_ptr(), rstd.data_ptr(),
            scale.data_ptr(), partial.data_ptr(), d_gamma.data_ptr(),
            d_beta.data_ptr(), coef.data_ptr(), b, c, s, device=x.device)
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
for _fn in KERNELS:
    _fn.launches = 0
