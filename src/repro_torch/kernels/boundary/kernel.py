"""Wrappers of the CUDA boundary kernels, replacing the Pallas kernels
of ``repro.kernels.boundary.kernel``:

* ``qdq_flat`` / ``qdq`` — the blockwise int8 round trip (``csrc/qdq.cu``);
* ``encode`` / ``decode`` — the learned codecs' two sides, with the wire
  QDQ fused into ``encode`` (``csrc/codec.cu``);
* ``encode_quantize`` / ``dequantize_decode`` — the same two sides with
  the true wire format between them, int8 codes + f32 row-block scales
  (``csrc/codec.cu``).

On a CUDA tensor each launches its kernel or raises; on a CPU tensor it
runs the plain version (``repro_torch.compression.quant8._roundtrip``,
:mod:`.ref`).  ``repro_torch.kernels.LAUNCHES`` counts one per call that
launches the kernels (``encode`` and ``decode`` are each up to three
CUDA launches, see ``csrc/codec.cu``; so are ``encode_quantize`` and
``dequantize_decode``).
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
    """``a2 @ round(w)`` by the codec GEMM: bf16 on the tensor cores (k and
    m multiples of 8, 16-byte-aligned operands; a scratch tensor takes the
    weight rounded to bf16 and any split-K partials), f32 on the SIMT
    kernel."""
    from repro_torch.kernels import _lib
    n, kdim = a2.shape
    if w.shape[0] != kdim:
        raise ValueError(f"codec gemm: w {tuple(w.shape)} does not fit "
                         f"rows of width {kdim}")
    w = w.contiguous()           # held until the launch is queued
    m = w.shape[1]
    lib = _lib.lib()
    scratch = None
    if a2.dtype == torch.bfloat16:
        if kdim % 8 or m % 8:
            raise ValueError(f"codec gemm: bf16 needs k and m multiples of "
                             f"8, got k={kdim} m={m}")
        if a2.data_ptr() % 16 or w.data_ptr() % 16:
            raise ValueError("codec gemm: bf16 needs 16-byte-aligned a and "
                             "w")
        scratch = torch.empty(lib.repro_codec_gemm_scratch(n, kdim, m, code),
                              dtype=torch.uint8, device=a2.device)
    out = torch.empty((n, m), dtype=a2.dtype, device=a2.device)
    rc = lib.repro_codec_gemm(
        a2.data_ptr(), w.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), n, kdim, m, code,
        _lib.stream_ptr(a2.device))
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


# ----------------------------------------------- true wire (codes) format
def encode_quantize(x: torch.Tensor, w: Optional[torch.Tensor], mode: str,
                    k: int, qb: int):
    """Encode [..., d] straight to the wire payload: (int8 codes [..., c],
    f32 scales [..., c // qb]), the codes of the encode output rounded to
    x's dtype.  ``w`` is ``w_c`` [d, c] (f32) for the bottleneck, None for
    maxout (pool width ``k``)."""
    if mode not in ("bottleneck", "maxout"):
        raise ValueError(f"not a learned codec: {mode!r}")
    if x.device.type == "cpu":
        return R.encode_quantize_ref(x, w, mode, k, qb)
    from repro_torch.kernels import _lib
    d = x.shape[-1]
    c = w.shape[1] if mode == "bottleneck" else d // k
    if mode == "maxout" and d % k:
        raise ValueError(f"encode_quantize: maxout k={k} does not divide "
                         f"d={d}")
    if qb <= 0 or c % qb:
        raise ValueError(f"encode_quantize: qb={qb} does not divide c={c}")
    code = _codec_args(x, w if mode == "bottleneck" else None,
                       "encode_quantize")
    x2 = x.reshape(-1, d).contiguous()
    if mode == "bottleneck":
        src, kk = _gemm(_ln_rows(x2, 1, 0, code), w, code), 1
    else:
        src, kk = x2, k
    rows = x2.shape[0]
    q = torch.empty((rows, c), dtype=torch.int8, device=x.device)
    s = torch.empty((rows, c // qb), dtype=torch.float32, device=x.device)
    rc = _lib.lib().repro_codec_ln_rows_codes(
        src.data_ptr(), q.data_ptr(), s.data_ptr(), rows, src.shape[1], kk,
        qb, code, _lib.stream_ptr(x.device))
    _lib.check(rc, "codec ln_rows_codes")
    kernels.LAUNCHES["encode_quantize"] += 1
    return (q.reshape(*x.shape[:-1], c),
            s.reshape(*x.shape[:-1], c // qb))


def dequantize_decode(q: torch.Tensor, s: torch.Tensor, w: torch.Tensor,
                      mode: str, qb: int,
                      dtype=torch.float32) -> torch.Tensor:
    """Mirror of :func:`encode_quantize`: codes [..., c] + scales
    [..., c // qb] -> the decoded [..., d] in ``dtype`` (dequantized and
    rounded to ``dtype``, maxout's LayerNorm, the product in ``dtype``).
    ``w`` is ``w_d`` [c, d] (f32)."""
    if mode not in ("bottleneck", "maxout"):
        raise ValueError(f"not a learned codec: {mode!r}")
    c = q.shape[-1]
    if q.dtype != torch.int8 or s.dtype != torch.float32 or qb <= 0 or \
            c % qb or tuple(s.shape) != (*q.shape[:-1], c // qb):
        raise ValueError(f"dequantize_decode: want int8 codes [..., c] and "
                         f"f32 scales [..., c // {qb}], got {q.dtype} "
                         f"{tuple(q.shape)} and {s.dtype} {tuple(s.shape)}")
    if q.device.type == "cpu":
        return R.dequantize_decode_ref(q, s, w, mode, qb, dtype)
    from repro_torch.kernels import _lib
    if s.device != q.device:
        raise ValueError(f"dequantize_decode: codes on {q.device}, scales "
                         f"on {s.device}")
    z = torch.empty((*q.shape[:-1], c), dtype=dtype, device=q.device)
    code = _codec_args(z, w, "dequantize_decode")
    q2 = q.reshape(-1, c).contiguous()
    s2 = s.reshape(-1, c // qb).contiguous()
    z2 = z.reshape(-1, c)
    rc = _lib.lib().repro_codec_dequant_rows(
        q2.data_ptr(), s2.data_ptr(), z2.data_ptr(), q2.shape[0], c, qb,
        int(mode == "maxout"), code, _lib.stream_ptr(q.device))
    _lib.check(rc, "codec dequant_rows")
    out = _gemm(z2, w, code)
    kernels.LAUNCHES["dequantize_decode"] += 1
    return out.reshape(*q.shape[:-1], w.shape[1])
