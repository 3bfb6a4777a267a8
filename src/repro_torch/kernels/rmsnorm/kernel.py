"""Wrapper of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``), replacing
the Pallas ``repro.kernels.rmsnorm.kernel.rmsnorm``.

On a CUDA tensor it launches the kernel or raises; on a CPU tensor it
runs :func:`~repro_torch.kernels.rmsnorm.ref.rmsnorm_ref`.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x [..., d] -> rmsnorm(x) * scale, in x's dtype."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    from repro_torch.kernels import _lib
    d = x.shape[-1]
    if scale.shape != (d,) or scale.device != x.device:
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} on "
                         f"{scale.device} does not fit x {tuple(x.shape)} "
                         f"on {x.device}")
    if scale.dtype != torch.float32:
        raise TypeError(f"rmsnorm: scale must be float32, got {scale.dtype}")
    if not x.is_contiguous() or not scale.is_contiguous():
        raise ValueError("rmsnorm: x and scale must be contiguous")
    code = _lib.dtype_code(x, "rmsnorm")
    out = torch.empty_like(x)
    rc = _lib.lib().repro_rmsnorm(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), x.numel() // d, d,
        float(eps), code, _lib.stream_ptr(x.device))
    _lib.check(rc, "rmsnorm")
    kernels.LAUNCHES["rmsnorm"] += 1
    return out
