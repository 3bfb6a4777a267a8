"""Boundary-codec dispatch (port of ``repro.compression.codecs``): what
crosses a SWARM stage boundary under each ``cfg.boundary_compression``
mode (paper App. J).

* ``none``        — raw activations (2-byte wire elements);
* ``int8``        — blockwise 8-bit round trip (:mod:`.quant8`),
                    parameter-free;
* ``bottleneck``  — learned linear bottleneck: the sending stage owns
                    ``w_c`` ([m, c]), the receiving stage ``w_d`` ([c, m]);
* ``maxout``      — maxout_k pooling (parameter-free) + a learned ``w_d``
                    ([m/k, m]) on the receiving stage.

The crossings always go through the ops of
:mod:`repro_torch.kernels.boundary.ops`: their wrappers launch the CUDA
kernels on a CUDA tensor and run the plain versions on a CPU tensor,
whatever ``cfg.kernels`` says (it is kept for parity with the JAX
configs).  ``pipeline_boundary_specs`` gives the GSPMD pipeline's
stage-stacked codec specs, which the parameter counts of
``models.flops`` read and which the shifting-buffer pipeline
(``dist/pipeline.py::make_pipeline_train_step``) trains with the
model.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.params import ParamSpec

Tree = Any

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


# ------------------------------------------------------------ ParamSpecs
def sender_specs(cfg: ArchConfig, compress: Optional[str] = None) -> Tree:
    """Codec params owned by a SENDING stage (compress side)."""
    mode = resolve_mode(cfg, compress)
    if mode == "bottleneck":
        return {"w_c": ParamSpec((cfg.d_model, wire_dim(cfg, mode)),
                                 cfg.param_jdtype,
                                 axes=("embed", "bottleneck"))}
    return {}                                # maxout compress is param-free


def receiver_specs(cfg: ArchConfig, compress: Optional[str] = None) -> Tree:
    """Codec params owned by a RECEIVING stage (decompress side)."""
    mode = resolve_mode(cfg, compress)
    if mode in LEARNED:
        return {"w_d": ParamSpec((wire_dim(cfg, mode), cfg.d_model),
                                 cfg.param_jdtype,
                                 axes=("bottleneck", "embed"))}
    return {}


def pipeline_boundary_specs(cfg: ArchConfig) -> Optional[Tree]:
    """Stage-stacked codec specs of the GSPMD pipeline: leading dim is
    the boundary index ``b`` in ``0..pipeline_stages-2``.  ``None``
    unless the config declares a learned codec AND a pipeline depth."""
    mode = cfg.boundary_compression
    if mode not in LEARNED or cfg.pipeline_stages <= 1:
        return None
    nb = cfg.pipeline_stages - 1
    d, c = cfg.d_model, wire_dim(cfg, mode)
    specs: Tree = {"w_d": ParamSpec((nb, c, d), cfg.param_jdtype,
                                    axes=("stage", "bottleneck", "embed"))}
    if mode == "bottleneck":
        specs["w_c"] = ParamSpec((nb, d, c), cfg.param_jdtype,
                                 axes=("stage", "embed", "bottleneck"))
    return specs


# ------------------------------------------------------------ apply
def wire_qblock(cfg: ArchConfig, compress: Optional[str] = None) -> int:
    """Quantization block for the wire tensor under ``cfg.wire_quant`` —
    the paper's 64, gcd-aligned down so it divides the wire width."""
    from repro_torch.kernels.boundary import ref as bref
    return bref.wire_qblock(wire_dim(cfg, compress))


# ------------------------------------------------------------ apply
def compress(cfg: ArchConfig, mode: str, p: Tree, x: torch.Tensor
             ) -> torch.Tensor:
    """[.., d_model] -> [.., wire_dim]: what the sending stage emits, in
    plain PyTorch (:mod:`.bottleneck`, :mod:`.maxout`; the crossings of
    the execution paths go through :func:`encode_wire`)."""
    from repro_torch.compression import bottleneck, maxout
    if mode == "bottleneck":
        return bottleneck.compress(p, x)
    if mode == "maxout":
        return maxout.compress(x, maxout_k(cfg))
    return x


def decompress(cfg: ArchConfig, mode: str, p: Tree, z: torch.Tensor
               ) -> torch.Tensor:
    """[.., wire_dim] -> [.., d_model]: what the receiving stage
    restores, in plain PyTorch."""
    from repro_torch.compression import bottleneck, maxout
    if mode == "bottleneck":
        return bottleneck.decompress(p, z)
    if mode == "maxout":
        return maxout.decompress(p, z)
    return z


def encode_wire(cfg: ArchConfig, mode: str, p: Tree,
                x: torch.Tensor, quant: Optional[bool] = None
                ) -> torch.Tensor:
    """Sending side of a boundary crossing: codec encode (+ the blockwise
    int8 wire QDQ under ``quant``, default ``cfg.wire_quant``) through
    the autograd op of :mod:`repro_torch.kernels.boundary.ops` — the
    ``encode`` kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    if mode not in LEARNED:
        return x
    from repro_torch.kernels.boundary import ops as bops
    w = (p or {}).get("w_c") if mode == "bottleneck" else None
    k = maxout_k(cfg) if mode == "maxout" else 1
    return bops.encode_wire(x, w, mode, k, wire_qblock(cfg, mode),
                            cfg.wire_quant if quant is None else quant)


def decode_wire(cfg: ArchConfig, mode: str, p: Tree,
                z: torch.Tensor) -> torch.Tensor:
    """Receiving side of a boundary crossing (mirror of
    :func:`encode_wire`; the wire QDQ lives on the sending side only, so
    each direction quantizes exactly once)."""
    if mode not in LEARNED:
        return z
    from repro_torch.kernels.boundary import ops as bops
    return bops.decode_wire(z, p["w_d"], mode)


def int8_boundary(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """The parameter-free ``int8`` boundary mode: the single-launch round
    trip (the CUDA kernel on a CUDA tensor, the plain quantize/dequantize
    pair on a CPU tensor; same codes) with its straight-through
    backward."""
    from repro_torch.compression import quant8
    from repro_torch.kernels.boundary.ops import int8_roundtrip
    del cfg
    return int8_roundtrip(x, quant8.BLOCK, quant8.BLOCK)


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
