"""Wrapper of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``), replacing
the Pallas ``repro.kernels.rmsnorm.kernel.rmsnorm``.

On a CUDA tensor it launches the kernel or raises; on a CPU tensor it
runs :func:`~repro_torch.kernels.rmsnorm.ref.rmsnorm_ref`; on a meta
tensor it takes the meta route of :mod:`repro_torch.kernels` (the CUDA
route's checks and output, :func:`rmsnorm_work` counted; the plain
version's f32 intermediates are not the kernel's memory).  Which of the
kernel's two paths a call takes is :func:`_plan`'s choice, by width, dtype
and alignment alone.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch import kernels
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

MAX_VECTORS = 8     # 16-byte vectors a lane on the register path
ROW_WARPS = (4, 8)  # warps a row (a block) on the register path


class Plan(NamedTuple):
    """The kernel's path for one call: the register path with ``vectors``
    16-byte vectors a lane and ``warps`` warps a row, or the general path
    (both 0)."""
    vectors: int
    warps: int

    @property
    def path(self) -> str:
        return "registers" if self.vectors else "general"


@functools.lru_cache(maxsize=None)
def _plan(d: int, dtype: torch.dtype, aligned: bool) -> Plan:
    """The register path where x and scale start 16-byte aligned and ``d``
    is a whole number of 16-byte vectors (8 bf16, 4 f32), at most 8 warps
    of ``MAX_VECTORS`` vectors a lane: 4 warps a row, 8 where 4 would
    need more than ``MAX_VECTORS`` vectors a lane.  Otherwise the general
    path.  Rows do not enter: a row's summation order never depends on
    the other rows of the call."""
    per = 16 // dtype.itemsize
    if aligned and d > 0 and d % per == 0:
        units = d // per
        for w in ROW_WARPS:
            if units <= 32 * w * MAX_VECTORS:
                return Plan(-(-units // (32 * w)), w)
    return Plan(0, 0)


def plan_for(x: torch.Tensor, scale: torch.Tensor) -> Plan:
    """:func:`_plan` of a call ``rmsnorm(x, scale)``."""
    aligned = x.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0
    return _plan(x.shape[-1], x.dtype, aligned)


def rmsnorm_work(x: torch.Tensor) -> tuple[float, float]:
    """(operations, bytes): 4 f32 operations an element, x read and the
    output written once, the scale read once."""
    return 4.0 * x.numel(), 2.0 * x.numel() * x.element_size() + \
        x.shape[-1] * 4


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x [..., d] -> rmsnorm(x) * scale, in x's dtype."""
    where = kernels.route(x, "rmsnorm")
    if where == "cpu":
        return rmsnorm_ref(x, scale, eps)
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
    plan = plan_for(x, scale)
    out = torch.empty_like(x)
    if where == "meta":
        kernels.meta_call("rmsnorm", *rmsnorm_work(x))
        return out
    rc = _lib.lib().repro_rmsnorm(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), x.numel() // d, d,
        float(eps), code, plan.vectors, plan.warps,
        _lib.stream_ptr(x.device))
    _lib.check(rc, "rmsnorm")
    kernels.LAUNCHES["rmsnorm"] += 1
    return out
