"""Autograd ops of the boundary crossing (port of
``repro.kernels.boundary.ops``).

Each op pairs a forward through the kernel wrappers of :mod:`.kernel`
(the CUDA kernel on a CUDA tensor, the plain version on a CPU tensor)
with ONE backward that pulls cotangents through the plain versions of
:mod:`.ref` by recompute, as the JAX package's custom VJPs do — so CPU
and card gradients agree by construction.

Wire-quantization semantics mirror ``quant8.compress_boundary``: the
QDQ is straight-through (rounding contributes no gradient), and under
``quantized=True`` the *cotangent* is QDQ'd too — that is what crosses
the wire in SWARM both directions (§4.3).  The backward QDQ lives on the
sending side's :func:`encode_wire` only, so a crossing split across two
peers quantizes each direction exactly once.

:func:`encode_quantize` and :func:`dequantize_decode` put the true wire
format (int8 codes + f32 scales) between the two sides, forward only, as
the JAX package's ops of the same names do.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.boundary import kernel as K
from repro_torch.kernels.boundary import ref as R

QBLOCK = R.QBLOCK
wire_qblock = R.wire_qblock


# ------------------------------------------------------------ int8 wire
class _Int8RoundTrip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, block, grad_block):
        ctx.grad_block = grad_block
        return K.qdq_flat(x.contiguous(), block)

    @staticmethod
    def backward(ctx, g):
        return K.qdq_flat(g.contiguous(), ctx.grad_block), None, None


def int8_roundtrip(x: torch.Tensor, block: int = QBLOCK,
                   grad_block: int = QBLOCK) -> torch.Tensor:
    """Single-launch ``quant8.compress_boundary``: flat blockwise int8
    QDQ forward, QDQ'd cotangent (block ``grad_block``) backward (STE).
    Integer tensors pass through."""
    if not x.is_floating_point():
        return x
    return _Int8RoundTrip.apply(x, block, grad_block)


# ---------------------------------------------------------- learned wire
class _EncodeWire(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, mode, k, qb, quantized):
        ctx.save_for_backward(x, w)
        ctx.codec = (mode, k, qb, quantized)
        return K.encode(x, w, mode, k, qb, quantized)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        mode, k, qb, quantized = ctx.codec
        if quantized:                 # the backward wire is quantized too
            g = K.qdq(g.contiguous(), qb)
        with torch.enable_grad():
            xs = x.detach().requires_grad_()
            ws = None if w is None else w.detach().requires_grad_()
            z = R.encode_ref(xs, ws, mode, k)
            grads = torch.autograd.grad(
                z, [xs] if ws is None else [xs, ws], g)
        return (grads[0], None if ws is None else grads[1], None, None,
                None, None)


def encode_wire(x: torch.Tensor, w: Optional[torch.Tensor], mode: str,
                k: int, qb: int, quantized: bool) -> torch.Tensor:
    """Sending side of a boundary crossing: codec encode [..., d] ->
    [..., c] with the wire QDQ fused in when ``quantized``.  ``w`` is
    ``w_c`` for the bottleneck, ``None`` for maxout."""
    return _EncodeWire.apply(x, w, mode, k, qb, quantized)


class _DecodeWire(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, w, mode):
        ctx.save_for_backward(z, w)
        ctx.mode = mode
        return K.decode(z, w, mode)

    @staticmethod
    def backward(ctx, g):
        z, w = ctx.saved_tensors
        with torch.enable_grad():
            zs = z.detach().requires_grad_()
            ws = w.detach().requires_grad_()
            gz, gw = torch.autograd.grad(R.decode_ref(zs, ws, ctx.mode),
                                         [zs, ws], g)
        return gz, gw, None


def decode_wire(z: torch.Tensor, w: torch.Tensor,
                mode: str) -> torch.Tensor:
    """Receiving side: [..., c] wire -> [..., d].  No QDQ here — the
    backward-direction wire quantization happens exactly once, at the
    sender's :func:`encode_wire` backward."""
    return _DecodeWire.apply(z, w, mode)


# ----------------------------------------------- true wire (codes) format
def encode_quantize(x: torch.Tensor, w: Optional[torch.Tensor], mode: str,
                    k: int, qb: int):
    """Fused encode + quantize to the actual payload (int8 codes + f32
    scales): what a real transport would put on the wire."""
    return K.encode_quantize(x, w, mode, k, qb)


def dequantize_decode(q: torch.Tensor, s: torch.Tensor, w: torch.Tensor,
                      mode: str, qb: int, dtype=None) -> torch.Tensor:
    """Mirror dequantize + decode from wire codes + scales (``dtype``
    defaults to f32, as in the JAX package)."""
    return K.dequantize_decode(q, s, w, mode, qb,
                               torch.float32 if dtype is None else dtype)
