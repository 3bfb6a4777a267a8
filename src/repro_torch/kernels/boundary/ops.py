"""Boundary-crossing ops on the serving path: the forward of the int8
wire round trip (port of ``repro.kernels.boundary.ops.int8_roundtrip``;
its straight-through backward comes with the training slice)."""
from __future__ import annotations

import torch

from repro_torch.kernels.boundary import kernel as K
from repro_torch.kernels.boundary import ref as R

QBLOCK = R.QBLOCK
wire_qblock = R.wire_qblock


def int8_roundtrip(x: torch.Tensor, block: int = QBLOCK,
                   use_kernel: bool = True) -> torch.Tensor:
    """Flat blockwise int8 QDQ; integer tensors pass through."""
    if not x.is_floating_point():
        return x
    if use_kernel:
        return K.qdq_flat(x.contiguous(), block)
    from repro_torch.compression.quant8 import _roundtrip
    return _roundtrip(x, block)
