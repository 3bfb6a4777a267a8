"""Linear bottleneck compression layer (paper App. J.1; port of
``repro.compression.bottleneck``).

``Bottleneck(x) = LayerNorm(LayerNorm(MLP(x)) @ w_c) @ w_d`` — ``w_c``
lives on the sending stage, ``w_d`` on the receiving stage; the wire
carries the ``c``-dim tensor, an ``m/c``x reduction.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.params import ParamSpec

Tree = Any


def ln_core(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without affine, eps 1e-6, in f32: ``(x - mu) *
    rsqrt(var + 1e-6)`` with ``var = mean((x - mu)^2)``, as the JAX
    package computes it.  Both means are summed in f64 and rounded once
    to f32, so they are the correctly rounded f32 means whatever order
    the sum runs in; the CUDA codec kernel sums the same way, and the
    two agree to the bit."""
    x32 = x.to(torch.float32)
    mu = x32.to(torch.float64).mean(-1, keepdim=True).to(torch.float32)
    d = x32 - mu
    var = (d * d).to(torch.float64).mean(-1, keepdim=True).to(torch.float32)
    return d * torch.rsqrt(var + 1e-6)


def _ln(x: torch.Tensor) -> torch.Tensor:
    return ln_core(x).to(x.dtype)


def bottleneck_specs(d_model: int, d_compress: int,
                     dtype=torch.float32) -> Tree:
    return {
        "w_c": ParamSpec((d_model, d_compress), dtype,
                         axes=("embed", "bottleneck")),
        "w_d": ParamSpec((d_compress, d_model), dtype,
                         axes=("bottleneck", "embed")),
    }


def compress(p: Tree, x: torch.Tensor) -> torch.Tensor:
    """Sending stage: [.., m] -> [.., c] (this is what crosses the wire)."""
    return _ln(_ln(x) @ p["w_c"].to(x.dtype))


def decompress(p: Tree, z: torch.Tensor) -> torch.Tensor:
    """Receiving stage: [.., c] -> [.., m]."""
    return z @ p["w_d"].to(z.dtype)


def apply_bottleneck(p: Tree, x: torch.Tensor) -> torch.Tensor:
    return decompress(p, compress(p, x))


def wire_ratio(d_model: int, d_compress: int) -> float:
    return d_compress / d_model
