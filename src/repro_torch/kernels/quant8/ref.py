"""Plain PyTorch versions of the blockwise int8 quantization pair (port
of ``repro.kernels.quant8.ref``): what ``csrc/quant8.cu`` computes, bit
for bit, and what a wrapper runs on a CPU tensor."""
from __future__ import annotations

import torch

from repro_torch.compression.quant8 import div127


def quantize_ref(x: torch.Tensor, block: int = 64):
    """x [n] (flat, n % block == 0) -> (codes int8 [n // block, block],
    scales f32 [n // block, 1])."""
    blocks = x.reshape(-1, block).to(torch.float32)
    scale = blocks.abs().amax(dim=1, keepdim=True)
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)
                                * 127.0), -127, 127).to(torch.int8)
    return q, scale


def dequantize_ref(q: torch.Tensor, scale: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    """``q * scale / 127`` in f32 (IEEE division), cast to ``dtype``."""
    return div127(q.to(torch.float32) * scale).to(dtype)


def roundtrip_ref(x: torch.Tensor, block: int = 64) -> torch.Tensor:
    q, s = quantize_ref(x, block)
    return dequantize_ref(q, s, x.dtype).reshape(x.shape)
