"""Wrappers of the CUDA boundary kernels, replacing the Pallas kernels
of ``repro.kernels.boundary.kernel``:

* ``qdq_flat`` / ``qdq`` — the blockwise int8 round trip (``csrc/qdq.cu``);
* ``encode`` / ``decode`` — the learned codecs' two sides, with the wire
  QDQ fused into ``encode`` (``csrc/codec.cu``);
* ``encode_quantize`` / ``dequantize_decode`` — the same two sides with
  the true wire format between them, int8 codes + f32 row-block scales
  (``csrc/codec.cu``).

``qdq_flat`` takes every block and any start: :func:`flat_block_path`
picks its kernel (16-byte vectors on lane groups, vectors or scalars on
thread groups).  The codec kernels read and write 16-byte vectors: on
the card each of their wrappers refuses, with a ``ValueError`` naming
the value, what :func:`vector_layout_problem` rules out (it never takes
another path).
On a CUDA tensor each launches its kernel or raises; on a CPU tensor it
runs the plain version (``repro_torch.compression.quant8._roundtrip``,
:mod:`.ref`); on a meta tensor it takes the meta route of
:mod:`repro_torch.kernels`: the CUDA route's checks and every tensor it
allocates (each pass's output, the GEMM's scratch: the bf16 weight copy
and the split-K partials, sized by :func:`gemm_scratch_bytes`) on meta,
no launch, the call's work counted (:func:`codec_work` and the flat
reckonings beside the wrappers).  The plain versions are not that
account: they upcast whole tensors to f32 where the kernels hold rows in
registers.  ``repro_torch.kernels.LAUNCHES`` counts one per call that
launches the kernels (``encode`` and ``decode`` are each up to three
CUDA launches, see ``csrc/codec.cu``; so are ``encode_quantize`` and
``dequantize_decode``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels.boundary import ref as R

ROW_WIDTH_MAX = 32768        # elements of a row the row passes hold
POOLS = (1, 2, 4, 8)         # maxout widths whose windows tile a unit of 8
FLAT_PATHS = {"scalar": 0, "units": 1, "lanes": 2}   # csrc/blockq.cuh
GEMM_TILE_N = 128            # csrc/codec.cu namespace tc: BN


def gemm_splits(kdim: int, m: int) -> int:
    """The bf16 codec GEMM's split-K count (``tc::gemm_splits``)."""
    col_tiles = -(-m // GEMM_TILE_N)
    return max(min(kdim // 1024, 32 // col_tiles), 1)


def gemm_scratch_bytes(n: int, kdim: int, m: int,
                       dtype: torch.dtype) -> int:
    """Bytes of scratch the codec GEMM takes at ``[n, kdim] x [kdim, m]``
    (``repro_codec_gemm_scratch``): bf16 only, the weight rounded to bf16
    (256-byte aligned), then the f32 split-K partials where it splits."""
    if dtype != torch.bfloat16:
        return 0
    splits = gemm_splits(kdim, m)
    return -(-kdim * m * 2 // 256) * 256 + (splits * n * m * 4
                                            if splits > 1 else 0)


def codec_work(call: str, mode: str, N: int, d: int, c: int, es: int,
               quantize: bool = False, qb: int = 0
               ) -> tuple[float, float]:
    """(operations, bytes) of one codec call on ``N`` rows between width
    ``d`` and wire width ``c`` (``es``: the activations' element size),
    the kernel table's bound: inputs read once (the f32 weight, 4 bytes
    an element), outputs written once, 8 operations an element a
    LayerNorm pass, 2 a product's multiply-add, 5 a QDQ'd or coded
    element, 3 a dequantized one."""
    bott = mode == "bottleneck"
    if call == "encode":
        ops = 8.0 * N * d + (2.0 * N * d * c + 8.0 * N * c if bott
                             else 0.0) + (5.0 * N * c if quantize else 0.0)
        return ops, (N * d + N * c) * es + (d * c * 4 if bott else 0)
    if call == "decode":
        ops = 2.0 * N * c * d + (0.0 if bott else 8.0 * N * c)
        return ops, (N * c + N * d) * es + c * d * 4
    if call == "encode_quantize":
        ops = 8.0 * N * d + 5.0 * N * c + (2.0 * N * d * c + 8.0 * N * c
                                           if bott else 0.0)
        return ops, N * d * es + N * c + N * (c // qb) * 4 + (
            d * c * 4 if bott else 0)
    if call == "dequantize_decode":
        ops = 2.0 * N * c * d + 3.0 * N * c + (0.0 if bott else 8.0 * N * c)
        return ops, N * c + N * (c // qb) * 4 + c * d * 4 + N * d * es
    raise ValueError(f"not a codec call: {call!r}")


def flat_block_path(block: int, dtype: torch.dtype, *tensors) -> str:
    """Which kernel of ``csrc/blockq.cuh`` takes a flat blockwise int8
    call (``qdq_flat``, the quant8 pair) of blocks of ``block`` elements
    whose float side is ``dtype``; ``tensors`` are the call's inputs and
    outputs (None skipped).  Every block >= 1 has one:

    * ``"lanes"``: every tensor starts 16-byte aligned and the block is a
      power of two of 1 to 32 16-byte vectors (bf16 8 ... 256, f32
      4 ... 128): a lane a vector, a block an aligned lane group;
    * ``"units"``: aligned, and the block a whole number of vectors
      otherwise (48, 96, 512, 4096): a thread group a block, looping in
      vectors;
    * ``"scalar"``: anything else (blocks 1, 3, 100, an unaligned view):
      the same groups, one element at a time."""
    if block < 1:
        raise ValueError(f"block {block}: blocks hold at least one element")
    vec = 16 // dtype.itemsize
    if block % vec or any(t.data_ptr() % 16 for t in tensors
                          if t is not None):
        return "scalar"
    lanes = block // vec
    return "lanes" if lanes <= 32 and not lanes & (lanes - 1) else "units"


def vector_layout_problem(t: torch.Tensor, width: Optional[int] = None,
                          k: int = 1, qb: int = 0) -> Optional[str]:
    """Why the codec's 16-byte vector kernels cannot take ``t``, or None.

    The codec's row passes need ``t`` to start 16-byte aligned.  Given
    ``width`` (rows of ``width`` elements, a maxout pool of ``k``, blocks
    of ``qb`` when ``qb > 0``), they hold a row as units of 8 elements,
    so they also need a width that is a multiple of 8 and at most
    :data:`ROW_WIDTH_MAX`, ``k`` in :data:`POOLS` (a unit pools into
    whole windows), and ``qb`` a multiple of 8 (a block is whole
    units)."""
    if t.data_ptr() % 16:
        return (f"starts {t.data_ptr() % 16} bytes past a 16-byte "
                f"boundary")
    if width is None:
        return None
    if width % 8 or not 0 < width <= ROW_WIDTH_MAX:
        return (f"has rows of width {width}; the row passes take "
                f"multiples of 8 up to {ROW_WIDTH_MAX}")
    if k not in POOLS:
        return f"has maxout k={k}; the row passes pool k in {POOLS}"
    if qb and qb % 8:
        return f"has qb={qb}, not a multiple of 8"
    return None


def _require_layout(name: str, t: torch.Tensor, width: Optional[int] = None,
                    k: int = 1, qb: int = 0) -> None:
    problem = vector_layout_problem(t, width, k, qb)
    if problem:
        raise ValueError(f"{name}: {t.dtype} input {problem}")


def qdq_flat(x: torch.Tensor, block: int,
             codes: Optional[torch.Tensor] = None,
             scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flat-blocked round trip of any-shaped ``x`` (tail block padded
    with zeros, which never raises an absmax), any block >= 1.
    ``codes`` (int8, one per element) and ``scales`` (f32, one per
    block) optionally receive the quantized payload — the comparison
    harness reads them; the wire path does not."""
    if block < 1:
        raise ValueError(f"qdq_flat: block {block} must be at least 1")
    where = kernels.route(x, "qdq_flat")
    if where == "cpu":
        if codes is not None or scales is not None:
            raise ValueError("qdq_flat: codes/scales are kernel outputs; "
                             "on the CPU use quant8.blockwise_quantize")
        from repro_torch.compression.quant8 import _roundtrip
        return _roundtrip(x, block)
    from repro_torch.kernels import _lib
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
    if (codes is None) != (scales is None):
        raise ValueError("qdq_flat: codes and scales come together")
    out = torch.empty_like(x)
    path = flat_block_path(block, x.dtype, x, out, codes)
    if where == "meta":
        kernels.meta_call("qdq_flat", 5.0 * n, 2.0 * n * x.element_size())
        return out
    rc = _lib.lib().repro_qdq_flat(
        x.data_ptr(), out.data_ptr(),
        None if codes is None else codes.data_ptr(),
        None if scales is None else scales.data_ptr(),
        n, block, code, FLAT_PATHS[path], _lib.stream_ptr(x.device))
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
def _codec_args(t: torch.Tensor, w: Optional[torch.Tensor], name: str,
                dtype: Optional[torch.dtype] = None):
    """Validate a codec call on the card (or its meta route); returns the
    code of ``dtype`` (default: ``t``'s)."""
    from repro_torch.kernels import _lib
    dtype = t.dtype if dtype is None else dtype
    if dtype not in _lib.DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} not supported (float32 "
                        f"or bfloat16)")
    code = _lib.DTYPE_CODES[dtype]
    if w is not None:
        if w.device != t.device or w.dtype != torch.float32 or w.dim() != 2:
            raise ValueError(f"{name}: w must be a 2-d float32 tensor on "
                             f"{t.device}, got {tuple(w.shape)} "
                             f"{w.dtype} on {w.device}")
    return code


def _ln_rows(x2: torch.Tensor, k: int, qb: int, code: int,
            name: str = "codec ln_rows") -> torch.Tensor:
    from repro_torch.kernels import _lib
    rows, width = x2.shape
    _require_layout(name, x2, width, k, qb)
    out = torch.empty((rows, width // k), dtype=x2.dtype, device=x2.device)
    if x2.device.type == "meta":
        return out
    rc = _lib.lib().repro_codec_ln_rows(
        x2.data_ptr(), out.data_ptr(), rows, width, k, qb, code,
        _lib.stream_ptr(x2.device))
    _lib.check(rc, "codec ln_rows")
    return out


def _ln_rows_codes(x2: torch.Tensor, k: int, qb: int, code: int,
                  name: str = "codec ln_rows_codes"):
    """The codes pass: int8 codes [rows, width // k] and f32 scales
    [rows, width // k // qb] of pool_k(round(LN(x2)))."""
    from repro_torch.kernels import _lib
    rows, width = x2.shape
    if qb <= 0:
        raise ValueError(f"{name}: qb={qb}; the codes pass needs blocks")
    _require_layout(name, x2, width, k, qb)
    c = width // k
    q = torch.empty((rows, c), dtype=torch.int8, device=x2.device)
    s = torch.empty((rows, c // qb), dtype=torch.float32, device=x2.device)
    if x2.device.type == "meta":
        return q, s
    rc = _lib.lib().repro_codec_ln_rows_codes(
        x2.data_ptr(), q.data_ptr(), s.data_ptr(), rows, width, k, qb, code,
        _lib.stream_ptr(x2.device))
    _lib.check(rc, "codec ln_rows_codes")
    return q, s


def _dequant_rows(q2: torch.Tensor, s2: torch.Tensor, qb: int, ln: bool,
                  dtype: torch.dtype, name: str = "codec dequant_rows"):
    """The dequant pass: round(q2 * s2 / 127) to ``dtype`` [rows, c],
    then round(LN(.)) when ``ln``."""
    from repro_torch.kernels import _lib
    rows, c = q2.shape
    _require_layout(name, q2, c, 1, qb)
    z = torch.empty((rows, c), dtype=dtype, device=q2.device)
    if q2.device.type == "meta":
        return z
    rc = _lib.lib().repro_codec_dequant_rows(
        q2.data_ptr(), s2.data_ptr(), z.data_ptr(), rows, c, qb, int(ln),
        _lib.DTYPE_CODES[dtype], _lib.stream_ptr(q2.device))
    _lib.check(rc, "codec dequant_rows")
    return z


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
    meta = a2.device.type == "meta"
    lib = None if meta else _lib.lib()
    scratch = None
    if a2.dtype == torch.bfloat16:
        if kdim % 8 or m % 8:
            raise ValueError(f"codec gemm: bf16 needs k and m multiples of "
                             f"8, got k={kdim} m={m}")
        if a2.data_ptr() % 16 or w.data_ptr() % 16:
            raise ValueError("codec gemm: bf16 needs 16-byte-aligned a and "
                             "w")
        size = (gemm_scratch_bytes(n, kdim, m, a2.dtype) if meta
                else lib.repro_codec_gemm_scratch(n, kdim, m, code))
        scratch = torch.empty(size, dtype=torch.uint8, device=a2.device)
    out = torch.empty((n, m), dtype=a2.dtype, device=a2.device)
    if meta:
        return out
    rc = lib.repro_codec_gemm(
        a2.data_ptr(), w.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), n, kdim, m, code,
        _lib.stream_ptr(a2.device))
    _lib.check(rc, "codec gemm")
    return out


def _count(t: torch.Tensor, name: str, work: tuple[float, float]) -> None:
    """One call of a codec wrapper: a launch on the card, a meta call
    (with its work) on meta."""
    if t.device.type == "meta":
        kernels.meta_call(name, *work)
    else:
        kernels.LAUNCHES[name] += 1


def encode(x: torch.Tensor, w: Optional[torch.Tensor], mode: str, k: int,
           qb: int, quantize: bool) -> torch.Tensor:
    """Fused codec encode (+ optional row-blocked QDQ of block ``qb``):
    [..., d] -> the [..., c] wire tensor in x's dtype.  ``w`` is ``w_c``
    [d, c] (f32) for the bottleneck, None for maxout (pool width ``k``)."""
    if mode not in ("bottleneck", "maxout"):
        raise ValueError(f"not a learned codec: {mode!r}")
    if kernels.route(x, "encode") == "cpu":
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
        _require_layout("encode", x2, c, 1, q)    # the second pass's width
        out = _ln_rows(_gemm(_ln_rows(x2, 1, 0, code, "encode"), w, code),
                       1, q, code, "encode")
    else:
        out = _ln_rows(x2, k, q, code, "encode")
    _count(x2, "encode", codec_work("encode", mode, x2.shape[0], d, c,
                                    x.element_size(), quantize, qb))
    return out.reshape(*x.shape[:-1], c)


def decode(z: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """Fused codec decode: [..., c] wire -> [..., d] (maxout applies the
    LayerNorm first), in z's dtype.  ``w`` is ``w_d`` [c, d] (f32)."""
    if mode not in ("bottleneck", "maxout"):
        raise ValueError(f"not a learned codec: {mode!r}")
    if kernels.route(z, "decode") == "cpu":
        return R.decode_ref(z, w, mode)
    code = _codec_args(z, w, "decode")
    c = z.shape[-1]
    z2 = z.reshape(-1, c).contiguous()
    if mode == "maxout":
        z2 = _ln_rows(z2, 1, 0, code, "decode")
    out = _gemm(z2, w, code)
    _count(z2, "decode", codec_work("decode", mode, z2.shape[0], w.shape[1],
                                    c, z.element_size()))
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
    if kernels.route(x, "encode_quantize") == "cpu":
        return R.encode_quantize_ref(x, w, mode, k, qb)
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
        _require_layout("encode_quantize", x2, c, 1, qb)
        src, kk = _gemm(_ln_rows(x2, 1, 0, code, "encode_quantize"), w,
                        code), 1
    else:
        src, kk = x2, k
    q, s = _ln_rows_codes(src, kk, qb, code, "encode_quantize")
    _count(x2, "encode_quantize", codec_work(
        "encode_quantize", mode, x2.shape[0], d, c, x.element_size(), qb=qb))
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
    if kernels.route(q, "dequantize_decode") == "cpu":
        return R.dequantize_decode_ref(q, s, w, mode, qb, dtype)
    if s.device != q.device:
        raise ValueError(f"dequantize_decode: codes on {q.device}, scales "
                         f"on {s.device}")
    code = _codec_args(q, w, "dequantize_decode", dtype)
    z2 = _dequant_rows(q.reshape(-1, c).contiguous(),
                       s.reshape(-1, c // qb).contiguous(), qb,
                       mode == "maxout", dtype, "dequantize_decode")
    out = _gemm(z2, w, code)
    _count(z2, "dequantize_decode", codec_work(
        "dequantize_decode", mode, z2.shape[0], w.shape[1], c,
        out.element_size(), qb=qb))
    return out.reshape(*q.shape[:-1], w.shape[1])
