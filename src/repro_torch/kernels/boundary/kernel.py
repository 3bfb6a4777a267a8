"""Wrappers of the CUDA boundary kernels, replacing the Pallas kernels
of ``repro.kernels.boundary.kernel``:

* ``qdq_flat`` / ``qdq`` — the blockwise int8 round trip (``csrc/qdq.cu``);
* ``encode`` / ``decode`` — the learned codecs' two sides, with the wire
  QDQ fused into ``encode`` (``csrc/codec.cu``).

On a CUDA tensor each launches its kernel or raises; on a CPU tensor it
runs the plain version (``repro_torch.compression.quant8._roundtrip``,
:mod:`.ref`).  ``repro_torch.kernels.LAUNCHES`` counts one per call that
launches the kernels (``encode`` and ``decode`` are each up to three
CUDA launches, see ``csrc/codec.cu``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels.boundary import ref as R


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


# ----------------------------------------------------------- learned codecs
def _codec_args(t: torch.Tensor, w: Optional[torch.Tensor], name: str):
    """Validate a codec call on the card; returns the dtype code."""
    from repro_torch.kernels import _lib
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    code = _lib.dtype_code(t, name)
    if w is not None:
        if w.device != t.device or w.dtype != torch.float32 or w.dim() != 2:
            raise ValueError(f"{name}: w must be a 2-d float32 tensor on "
                             f"{t.device}, got {tuple(w.shape)} "
                             f"{w.dtype} on {w.device}")
    return code


def _ln_rows(x2: torch.Tensor, k: int, qb: int, code: int) -> torch.Tensor:
    from repro_torch.kernels import _lib
    rows, width = x2.shape
    out = torch.empty((rows, width // k), dtype=x2.dtype, device=x2.device)
    rc = _lib.lib().repro_codec_ln_rows(
        x2.data_ptr(), out.data_ptr(), rows, width, k, qb, code,
        _lib.stream_ptr(x2.device))
    _lib.check(rc, "codec ln_rows")
    return out


def _gemm(a2: torch.Tensor, w: torch.Tensor, code: int) -> torch.Tensor:
    from repro_torch.kernels import _lib
    n, kdim = a2.shape
    if w.shape[0] != kdim:
        raise ValueError(f"codec gemm: w {tuple(w.shape)} does not fit "
                         f"rows of width {kdim}")
    w = w.contiguous()           # held until the launch is queued
    out = torch.empty((n, w.shape[1]), dtype=a2.dtype, device=a2.device)
    rc = _lib.lib().repro_codec_gemm(
        a2.data_ptr(), w.data_ptr(), out.data_ptr(), n, kdim, w.shape[1],
        code, _lib.stream_ptr(a2.device))
    _lib.check(rc, "codec gemm")
    return out


def encode(x: torch.Tensor, w: Optional[torch.Tensor], mode: str, k: int,
           qb: int, quantize: bool) -> torch.Tensor:
    """Fused codec encode (+ optional row-blocked QDQ of block ``qb``):
    [..., d] -> the [..., c] wire tensor in x's dtype.  ``w`` is ``w_c``
    [d, c] (f32) for the bottleneck, None for maxout (pool width ``k``)."""
    if mode not in ("bottleneck", "maxout"):
        raise ValueError(f"not a learned codec: {mode!r}")
    if x.device.type == "cpu":
        z = R.encode_ref(x, w, mode, k)
        return R.qdq_ref(z, qb) if quantize else z
    d = x.shape[-1]
    c = w.shape[1] if mode == "bottleneck" else d // k
    if mode == "maxout" and d % k:
        raise ValueError(f"encode: maxout k={k} does not divide d={d}")
    if quantize and c % qb:
        raise ValueError(f"encode: qb={qb} does not divide c={c}")
    code = _codec_args(x, w if mode == "bottleneck" else None, "encode")
    x2 = x.reshape(-1, d).contiguous()
    q = qb if quantize else 0
    if mode == "bottleneck":
        out = _ln_rows(_gemm(_ln_rows(x2, 1, 0, code), w, code), 1, q, code)
    else:
        out = _ln_rows(x2, k, q, code)
    kernels.LAUNCHES["encode"] += 1
    return out.reshape(*x.shape[:-1], c)


def decode(z: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """Fused codec decode: [..., c] wire -> [..., d] (maxout applies the
    LayerNorm first), in z's dtype.  ``w`` is ``w_d`` [c, d] (f32)."""
    if mode not in ("bottleneck", "maxout"):
        raise ValueError(f"not a learned codec: {mode!r}")
    if z.device.type == "cpu":
        return R.decode_ref(z, w, mode)
    code = _codec_args(z, w, "decode")
    c = z.shape[-1]
    z2 = z.reshape(-1, c).contiguous()
    if mode == "maxout":
        z2 = _ln_rows(z2, 1, 0, code)
    out = _gemm(z2, w, code)
    kernels.LAUNCHES["decode"] += 1
    return out.reshape(*z.shape[:-1], w.shape[1])
