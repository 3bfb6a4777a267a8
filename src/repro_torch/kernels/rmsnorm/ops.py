"""RMSNorm op on the serving path (forward only in this slice; the
closed-form backward of ``repro.kernels.rmsnorm.ops._rms_bwd`` comes
with the training slice)."""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.kernel import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def rmsnorm_op(x: torch.Tensor, scale: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """The kernel on a contiguous copy of ``x`` (a ``[:, -1:]`` slice of
    a batch is a strided view)."""
    return rmsnorm(x.contiguous(), scale, eps)


__all__ = ["rmsnorm", "rmsnorm_ref", "rmsnorm_op"]
