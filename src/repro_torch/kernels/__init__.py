"""Hand-written CUDA kernels for the Hopper port, each beside its plain
PyTorch version.

A wrapper given a CUDA tensor launches its kernel (built on first use by
:mod:`repro_torch.kernels._lib`) or raises; given a CPU tensor it runs
the plain version.  It never falls back from the card to the plain
version.  ``LAUNCHES`` counts the kernel launches of each wrapper; it
moves only where a kernel is launched.
"""
from __future__ import annotations

LAUNCHES: dict[str, int] = {"flash_attention_fwd": 0, "rmsnorm": 0,
                            "qdq_flat": 0, "encode": 0, "decode": 0,
                            "encode_quantize": 0, "dequantize_decode": 0,
                            "quant8_quantize": 0, "quant8_dequantize": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
