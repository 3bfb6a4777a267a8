"""RMSNorm ops (port of ``repro.kernels.rmsnorm.ops``): the kernel
forward plus the training-time autograd op.

``rmsnorm_train``'s forward is the kernel wrapper (the CUDA kernel on a
CUDA tensor, the plain version on a CPU tensor); its backward is the
closed-form RMSNorm gradient of the JAX package's ``_rms_bwd``, plain
PyTorch on either device.  With ``r = rsqrt(mean(x^2) + eps)`` and scale
``s``:

    dx = g * s * r - x * (r^3 / d) * sum_j(g_j * s_j * x_j)
    ds = sum_rows g * x * r
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.kernel import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def rmsnorm_op(x: torch.Tensor, scale: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """The kernel on a contiguous copy of ``x`` (a ``[:, -1:]`` slice of
    a batch is a strided view)."""
    return rmsnorm(x.contiguous(), scale, eps)


def _rms_bwd(eps: float, x: torch.Tensor, scale: torch.Tensor,
             g: torch.Tensor):
    x32 = x.to(torch.float32)
    g32 = g.to(torch.float32)
    s32 = scale.to(torch.float32)
    d = x.shape[-1]
    r = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    gs = g32 * s32                                      # [..., d]
    inner = (gs * x32).sum(-1, keepdim=True)            # sum_j g_j s_j x_j
    dx = gs * r - x32 * (r ** 3 / d) * inner
    ds = (g32 * x32 * r).reshape(-1, d).sum(0)
    return dx.to(x.dtype), ds.to(scale.dtype)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_op(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, ds = _rms_bwd(ctx.eps, x, scale, g)
        return dx, ds, None


def rmsnorm_train(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Differentiable RMSNorm: kernel forward, closed-form backward.
    Without gradients it is :func:`rmsnorm_op`."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps)
    return rmsnorm_op(x, scale, eps)


__all__ = ["rmsnorm", "rmsnorm_ref", "rmsnorm_op", "rmsnorm_train"]
