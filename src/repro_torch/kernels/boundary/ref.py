"""Plain PyTorch versions for the int8 boundary wire (port of the QDQ
part of ``repro.kernels.boundary.ref``; the learned-codec oracles come
with the learned-codec slice)."""
from __future__ import annotations

import math

import torch

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
