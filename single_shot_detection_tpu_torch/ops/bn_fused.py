"""Fused train-mode BatchNorm: forward ``(z, mean, var)`` and its VJP.

Port of ``single_shot_detection_tpu/ops/bn_pallas.py::fused_bn_train``
(a ``jax.custom_vjp``) as a ``torch.autograd.Function``.  Semantics are
flax ``nn.BatchNorm(use_running_average=False)``'s: f32 statistics, the
fast variance ``max(0, E[x^2] - E[x]^2)``, ``z = (x - mean) * rsqrt(var +
eps) * scale + bias`` computed in f32 and then cast.  The backward is the
two-pass three-term VJP of the JAX package: K3 sums ``dz`` and ``dz * xhat``,
K4 forms ``dx``; the statistics' cotangents are ignored as there (nothing
differentiates through the running-statistic update).

The passes go through ``ops/bn_kernel.py``: on a CUDA tensor the four
kernels of ``kernels/bn.cu``, on a CPU tensor their plain versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from single_shot_detection_tpu_torch.ops import bn_kernel


class FusedBatchNormTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, eps, out_dtype):
        mean, var, rstd = bn_kernel.bn_stats(x, eps)
        z = bn_kernel.bn_apply(x, mean, rstd, scale, bias, out_dtype)
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.mark_non_differentiable(mean, var)
        return z, mean, var

    @staticmethod
    def backward(ctx, dz, _dmean, _dvar):
        x, scale, mean, rstd = ctx.saved_tensors
        dz = dz.contiguous()
        d_gamma, d_beta, coef = bn_kernel.bn_grad_sums(dz, x, mean, rstd, scale)
        dx = bn_kernel.bn_dx(dz, x, mean, rstd, coef)
        return dx, d_gamma, d_beta, None, None


def fused_bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5, out_dtype: Optional[torch.dtype] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode BN of NCHW ``x``: ``(z, mean, var)``, statistics in f32.

    ``scale`` and ``bias`` are f32 ``[C]``; ``z`` is in ``out_dtype``
    (default: x's).  Differentiable in ``x``, ``scale`` and ``bias``.
    """
    return FusedBatchNormTrain.apply(x.contiguous(), scale, bias, eps,
                                     out_dtype or x.dtype)
