"""Any-shape blockwise int8 round trip over the quant8 pair (port of
``repro.kernels.quant8.ops``): the flat tensor is zero-padded to a whole
number of blocks (zeros never raise an absmax), quantized, and the
padding dropped again on the way back.  Routing follows the tensor's
device (:mod:`.kernel`)."""
from __future__ import annotations

import torch

from repro_torch.kernels.quant8 import kernel as K


def quantize(x: torch.Tensor, block: int = 64):
    """Any-shape x -> (codes [nb, block] int8, scales [nb, 1] f32, meta)."""
    shape, dtype = tuple(x.shape), x.dtype
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    q, s = K.quantize(flat, block)
    return q, s, (shape, dtype, pad)


def dequantize(q: torch.Tensor, s: torch.Tensor, meta) -> torch.Tensor:
    shape, dtype, pad = meta
    flat = K.dequantize(q, s, dtype).reshape(-1)
    if pad:
        flat = flat[:flat.shape[0] - pad]
    return flat.reshape(shape)


def roundtrip(x: torch.Tensor, block: int = 64) -> torch.Tensor:
    q, s, meta = quantize(x, block)
    return dequantize(q, s, meta)
