"""Maxout compression layer (paper App. J.1, Goodfellow et al. 2013;
port of ``repro.compression.maxout``).

``Maxout_k`` reduces the hidden dim by k by taking the max over
non-overlapping windows of k features; a decompression matrix ``w_d`` on
the receiving stage restores ``m``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.compression.bottleneck import _ln
from repro_torch.models.params import ParamSpec

Tree = Any


def maxout_specs(d_model: int, k: int, dtype=torch.float32) -> Tree:
    assert d_model % k == 0
    return {
        "w_d": ParamSpec((d_model // k, d_model), dtype,
                         axes=("bottleneck", "embed")),
    }


def compress(x: torch.Tensor, k: int) -> torch.Tensor:
    """[.., m] -> [.., m/k]: maxout_k(LayerNorm(x)) (crosses the wire)."""
    x = _ln(x)
    m = x.shape[-1]
    return x.reshape(*x.shape[:-1], m // k, k).amax(-1)


def decompress(p: Tree, z: torch.Tensor) -> torch.Tensor:
    return _ln(z) @ p["w_d"].to(z.dtype)


def apply_maxout(p: Tree, x: torch.Tensor, k: int) -> torch.Tensor:
    return decompress(p, compress(x, k))
