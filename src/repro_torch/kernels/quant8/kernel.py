"""Wrappers of the CUDA blockwise int8 pair (``csrc/quant8.cu``),
replacing the Pallas kernels ``quantize`` and ``dequantize`` of
``repro.kernels.quant8.kernel``.

Both take every block >= 1 and any start of their input: the rule
``repro_torch.kernels.boundary.kernel.flat_block_path`` picks the kernel
of ``csrc/blockq.cuh`` (16-byte vectors on lane groups, vectors or
scalars on thread groups).  On a CUDA tensor each launches its kernel or
raises; on a CPU tensor it runs the plain version of :mod:`.ref`.
``repro_torch.kernels.LAUNCHES`` counts one per kernel launch.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels.boundary.kernel import FLAT_PATHS, flat_block_path
from repro_torch.kernels.quant8 import ref as R


def quantize(x: torch.Tensor, block: int = 64):
    """Flat ``x`` [n], n % block == 0 -> (codes int8 [n // block, block],
    scales f32 [n // block, 1])."""
    if block < 1:
        raise ValueError(f"quant8.quantize: block {block} must be at "
                         "least 1")
    if x.dim() != 1 or x.shape[0] % block:
        raise ValueError(f"quant8.quantize: x must be flat with a length "
                         f"divisible by {block}, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return R.quantize_ref(x, block)
    if x.device.type != "cuda":
        raise ValueError(f"quant8.quantize: unsupported device {x.device}")
    from repro_torch.kernels import _lib
    code = _lib.dtype_code(x, "quant8.quantize")
    x = x.contiguous()
    nb = x.shape[0] // block
    q = torch.empty((nb, block), dtype=torch.int8, device=x.device)
    s = torch.empty((nb, 1), dtype=torch.float32, device=x.device)
    path = flat_block_path(block, x.dtype, x, q)
    rc = _lib.lib().repro_quant8_quantize(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), nb, block, code,
        FLAT_PATHS[path], _lib.stream_ptr(x.device))
    _lib.check(rc, "quant8.quantize")
    kernels.LAUNCHES["quant8_quantize"] += 1
    return q, s


def dequantize(q: torch.Tensor, s: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    """codes [nb, block] int8 + scales [nb, 1] f32 -> [nb, block] in
    ``dtype``."""
    if q.dim() != 2 or q.dtype != torch.int8 or \
            tuple(s.shape) != (q.shape[0], 1) or s.dtype != torch.float32:
        raise ValueError(f"quant8.dequantize: want int8 codes [nb, block] "
                         f"and f32 scales [nb, 1], got {q.dtype} "
                         f"{tuple(q.shape)} and {s.dtype} {tuple(s.shape)}")
    if q.device.type == "cpu":
        return R.dequantize_ref(q, s, dtype)
    if q.device.type != "cuda" or s.device != q.device:
        raise ValueError(f"quant8.dequantize: codes on {q.device} and "
                         f"scales on {s.device}")
    from repro_torch.kernels import _lib
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    code = _lib.dtype_code(out, "quant8.dequantize")
    q, s = q.contiguous(), s.contiguous()
    path = flat_block_path(q.shape[1], dtype, q, out)
    rc = _lib.lib().repro_quant8_dequantize(
        q.data_ptr(), s.data_ptr(), out.data_ptr(), q.shape[0], q.shape[1],
        code, FLAT_PATHS[path], _lib.stream_ptr(q.device))
    _lib.check(rc, "quant8.dequantize")
    kernels.LAUNCHES["quant8_dequantize"] += 1
    return out
