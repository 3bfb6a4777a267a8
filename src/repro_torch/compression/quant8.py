"""Blockwise dynamic 8-bit quantization (Dettmers et al., 2021), port of
``repro.compression.quant8``: the compression SWARM applies at
pipeline-stage boundaries (§4.3).

Tensors are flattened into blocks of ``block_size``; each block is scaled
by its absmax and rounded (half to even, as ``jnp.round``) to int8.
This module is the plain PyTorch version of the boundary round trip;
the CUDA kernel of ``repro_torch.kernels.boundary`` computes the same
codes.  The straight-through ``compress_boundary`` comes with the
training slice.
"""
from __future__ import annotations

import torch

BLOCK = 64  # paper-faithful default (Dettmers 2021 blockwise state)


def _pad_to_block(flat: torch.Tensor, block: int):
    n = flat.shape[0]
    pad = (-n) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat, pad


def blockwise_quantize(x: torch.Tensor, block: int = BLOCK):
    """x (any shape) -> (int8 codes [n_blocks, block], f32 scales
    [n_blocks, 1], meta)."""
    shape, dtype = tuple(x.shape), x.dtype
    flat, pad = _pad_to_block(x.reshape(-1).to(torch.float32), block)
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True)            # [nb, 1]
    q = torch.round(blocks / torch.clamp(scale, min=1e-12) * 127.0)
    q = torch.clamp(q, -127, 127).to(torch.int8)
    return q, scale, (shape, dtype, pad)


def div127(a: torch.Tensor) -> torch.Tensor:
    """``a / 127`` as an IEEE division on every device: on CUDA, PyTorch
    divides by a Python scalar as a multiply by its reciprocal, which
    can differ from the quotient in the last bit."""
    return a / a.new_full((), 127.0)


def blockwise_dequantize(q: torch.Tensor, scale: torch.Tensor,
                         meta) -> torch.Tensor:
    shape, dtype, pad = meta
    flat = div127(q.to(torch.float32) * scale).reshape(-1)
    if pad:
        flat = flat[:flat.shape[0] - pad]
    return flat.reshape(shape).to(dtype)


def _roundtrip(x: torch.Tensor, block: int) -> torch.Tensor:
    if not x.is_floating_point():
        return x
    q, s, meta = blockwise_quantize(x, block)
    return blockwise_dequantize(q, s, meta)


def compressed_nbytes(n: int, block: int = BLOCK) -> int:
    """Wire size of an ``n``-element tensor after 8-bit compression: one
    int8 code per element + one f32 scale per (ceil-divided) block."""
    nb = -(-n // block)
    return n + 4 * nb
