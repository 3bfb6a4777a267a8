"""Plain PyTorch versions of the boundary crossing (port of
``repro.kernels.boundary.ref``): the row-blocked int8 round trip, the
learned codecs' two sides, ``encode_ref`` and ``decode_ref``, and their
true-wire-format pair ``encode_quantize_ref`` / ``dequantize_decode_ref``
(int8 codes + f32 scales on the wire).

They define what the CUDA kernels of ``csrc/codec.cu`` compute and are
the recompute target of the autograd ops in :mod:`.ops`: the backward of
a crossing always differentiates THESE functions, on the CPU and on the
card alike, as the JAX package's custom VJPs do.

Dtype discipline, as ``repro.kernels.boundary.kernel._encode32``: the
LayerNorm core runs in f32 (statistics summed in f64 and rounded once,
see :func:`repro_torch.compression.bottleneck.ln_core`), its output is
rounded to the activation dtype before the product, the weights are
rounded to the activation dtype, the product accumulates in f32 and is
rounded to the activation dtype before the second LayerNorm.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.compression.bottleneck import _ln
from repro_torch.compression.quant8 import div127

QBLOCK = 64          # default quantization granularity (paper-faithful)


def wire_qblock(width: int, block: int = QBLOCK) -> int:
    """Largest block <= ``block`` that divides the wire width."""
    if width % block == 0:
        return block
    return math.gcd(width, block)


def qdq_ref(x: torch.Tensor, qb: int) -> torch.Tensor:
    """Row-blocked int8 quantize-dequantize along the trailing dim
    (``x.shape[-1] % qb == 0``); absmax scaling, clip to [-127, 127]."""
    shape, dtype = x.shape, x.dtype
    blocks = x.to(torch.float32).reshape(*shape[:-1], shape[-1] // qb, qb)
    scale = blocks.abs().amax(dim=-1, keepdim=True)
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)
                                * 127.0), -127, 127)
    return div127(q * scale).reshape(shape).to(dtype)


def encode_ref(x: torch.Tensor, w: Optional[torch.Tensor], mode: str,
               k: int) -> torch.Tensor:
    """Sending side: [..., d] -> [..., c] (bottleneck: ln -> @w_c -> ln;
    maxout: ln -> max-pool over windows of ``k``)."""
    if mode == "bottleneck":
        return _ln(_ln(x) @ w.to(x.dtype))
    if mode == "maxout":
        z = _ln(x)
        m = z.shape[-1]
        return z.reshape(*z.shape[:-1], m // k, k).amax(-1)
    raise ValueError(f"not a learned codec: {mode!r}")


def decode_ref(z: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """Receiving side: [..., c] -> [..., d]."""
    if mode == "bottleneck":
        return z @ w.to(z.dtype)
    if mode == "maxout":
        return _ln(z) @ w.to(z.dtype)
    raise ValueError(f"not a learned codec: {mode!r}")


# ----------------------------------------------- true wire (codes) format
def encode_quantize_ref(x: torch.Tensor, w: Optional[torch.Tensor],
                        mode: str, k: int, qb: int):
    """Encode + quantize to the actual wire payload: (int8 codes
    [..., c], f32 scales [..., c // qb]) of the encode output rounded to
    x's dtype."""
    return quantize_rows(encode_ref(x, w, mode, k), qb)


def quantize_rows(z: torch.Tensor, qb: int):
    """Row-blocked int8 codes [..., c] and f32 scales [..., c // qb] of
    ``z`` upcast to f32 (``qdq_ref`` without the dequantize)."""
    z = z.to(torch.float32)
    blocks = z.reshape(*z.shape[:-1], z.shape[-1] // qb, qb)
    scale = blocks.abs().amax(dim=-1, keepdim=True)
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)
                                * 127.0), -127, 127).to(torch.int8)
    return q.reshape(z.shape), scale[..., 0]


def dequantize_decode_ref(q: torch.Tensor, s: torch.Tensor,
                          w: torch.Tensor, mode: str, qb: int,
                          dtype=torch.float32) -> torch.Tensor:
    """Mirror of :func:`encode_quantize_ref`: ``q * s / 127`` in f32,
    cast to ``dtype``, then decoded to [..., d] in ``dtype``."""
    blocks = q.to(torch.float32).reshape(*q.shape[:-1], q.shape[-1] // qb,
                                         qb)
    z = div127(blocks * s[..., None]).reshape(q.shape).to(dtype)
    return decode_ref(z, w, mode)
