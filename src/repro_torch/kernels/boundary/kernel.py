"""Wrapper of the CUDA blockwise int8 round trip (``csrc/qdq.cu``),
replacing the Pallas ``qdq`` / ``qdq_flat`` of
``repro.kernels.boundary.kernel``.

On a CUDA tensor it launches the kernel or raises; on a CPU tensor it
runs the plain version (``repro_torch.compression.quant8._roundtrip``,
the same codes).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import kernels


def qdq_flat(x: torch.Tensor, block: int,
             codes: Optional[torch.Tensor] = None,
             scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flat-blocked round trip of any-shaped ``x`` (tail block padded
    with zeros, which never raises an absmax).  ``codes`` (int8, one per
    element) and ``scales`` (f32, one per block) optionally receive the
    quantized payload — the comparison harness reads them; the wire path
    does not."""
    if x.device.type == "cpu":
        if codes is not None or scales is not None:
            raise ValueError("qdq_flat: codes/scales are kernel outputs; "
                             "on the CPU use quant8.blockwise_quantize")
        from repro_torch.compression.quant8 import _roundtrip
        return _roundtrip(x, block)
    if x.device.type != "cuda":
        raise ValueError(f"qdq_flat: unsupported device {x.device}")
    from repro_torch.kernels import _lib
    if block % 32 or not 32 <= block <= 128:
        raise ValueError(f"qdq_flat: block {block} must be 32, 64, 96 or "
                         "128")
    if not x.is_contiguous():
        raise ValueError("qdq_flat: x must be contiguous")
    code = _lib.dtype_code(x, "qdq_flat")
    n = x.numel()
    n_blocks = -(-n // block)
    for t, dt, size, name in ((codes, torch.int8, n, "codes"),
                              (scales, torch.float32, n_blocks, "scales")):
        if t is not None and (t.dtype != dt or t.numel() != size
                              or t.device != x.device
                              or not t.is_contiguous()):
            raise ValueError(f"qdq_flat: {name} must be a contiguous "
                             f"{dt} tensor of {size} elements on "
                             f"{x.device}")
    out = torch.empty_like(x)
    rc = _lib.lib().repro_qdq_flat(
        x.data_ptr(), out.data_ptr(),
        None if codes is None else codes.data_ptr(),
        None if scales is None else scales.data_ptr(),
        n, block, code, _lib.stream_ptr(x.device))
    _lib.check(rc, "qdq_flat")
    kernels.LAUNCHES["qdq_flat"] += 1
    return out


def qdq(x: torch.Tensor, qb: int) -> torch.Tensor:
    """Row-blocked round trip over the trailing dim: with
    ``x.shape[-1] % qb == 0`` the row blocks are the flat blocks."""
    if x.shape[-1] % qb:
        raise ValueError(f"qdq: trailing dim {x.shape[-1]} not a multiple "
                         f"of {qb}")
    return qdq_flat(x, qb)
