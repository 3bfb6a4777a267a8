"""Boundary-codec dispatch (port of ``repro.compression.codecs``) for the
parameter-free modes: ``none`` (raw activations, 2-byte wire elements)
and ``int8`` (blockwise 8-bit round trip, :mod:`repro_torch.compression
.quant8`).  The learned codecs (``bottleneck``, ``maxout``) and their
params come with the learned-codec slice; the mode names, the width
helpers and the FLOP accounting already know them so the cost model is
the JAX package's.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import ArchConfig

MODES = ("none", "int8", "bottleneck", "maxout")
LEARNED = ("bottleneck", "maxout")


def resolve_mode(cfg: ArchConfig, compress: Optional[str] = None) -> str:
    """``compress`` overrides ``cfg.boundary_compression``; validate."""
    mode = cfg.boundary_compression if compress is None else compress
    if mode not in MODES:
        raise ValueError(f"unknown boundary compression {mode!r}; "
                         f"expected one of {MODES}")
    return mode


def maxout_k(cfg: ArchConfig) -> int:
    """Maxout pool width ``k``: explicit ``cfg.maxout_k``, else derived from
    ``cfg.bottleneck_dim``, else the paper's default 2x."""
    if cfg.maxout_k:
        k = cfg.maxout_k
    elif cfg.bottleneck_dim:
        k = max(1, cfg.d_model // cfg.bottleneck_dim)
    else:
        k = 2
    if cfg.d_model % k:
        raise ValueError(f"maxout k={k} must divide d_model={cfg.d_model}")
    return k


def wire_dim(cfg: ArchConfig, compress: Optional[str] = None) -> int:
    """Feature width of the tensor that actually crosses the wire."""
    mode = resolve_mode(cfg, compress)
    if mode == "bottleneck":
        c = cfg.bottleneck_dim or cfg.d_model // 2
        if not 0 < c <= cfg.d_model:
            raise ValueError(f"bottleneck_dim={c} outside (0, d_model="
                             f"{cfg.d_model}]")
        return c
    if mode == "maxout":
        return cfg.d_model // maxout_k(cfg)
    return cfg.d_model


def wire_qblock(cfg: ArchConfig, compress: Optional[str] = None) -> int:
    """Quantization block for the wire tensor under ``cfg.wire_quant``."""
    from repro_torch.kernels.boundary import ref as bref
    return bref.wire_qblock(wire_dim(cfg, compress))


def int8_boundary(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """The ``int8`` boundary mode, routed by ``cfg.kernels``: the plain
    quantize/dequantize pair, or the CUDA single-launch round trip
    (same codes)."""
    from repro_torch.compression import quant8
    from repro_torch.kernels.boundary.ops import int8_roundtrip
    return int8_roundtrip(x, quant8.BLOCK,
                          use_kernel=cfg.kernels == "pallas")


def codec_flops_per_token(cfg: ArchConfig, mode: str, *, sender: bool,
                          receiver: bool) -> float:
    """Forward matmul FLOPs the codec adds to one stage, per token."""
    if mode not in LEARNED:
        return 0.0
    c = wire_dim(cfg, mode)
    f = 0.0
    if sender and mode == "bottleneck":
        f += 2.0 * cfg.d_model * c           # x @ w_c
    if receiver:
        f += 2.0 * c * cfg.d_model           # z @ w_d
    return f
