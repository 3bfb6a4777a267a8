"""Norms, FFNs and dense attention (port of ``repro.models.layers``;
MoE comes with its slice).

Weights are stored in ``cfg.param_dtype`` and cast to the activation's
dtype at each matmul, as the JAX package does.  The projections and the
FFN stay ``torch.matmul``/``einsum``: the JAX package leaves them to XLA
outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.params import ParamSpec
from repro_torch.models import attention as attn_lib
from repro_torch.models import flash as flash_lib
from repro_torch.models import rope as rope_lib

Tree = Any


# ---------------------------------------------------------------- norms
def norm_specs(cfg: ArchConfig, d: Optional[int] = None) -> Tree:
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": ParamSpec((d,), cfg.param_jdtype, "ones", ("embed",)),
                "bias": ParamSpec((d,), cfg.param_jdtype, "zeros", ("embed",))}
    return {"scale": ParamSpec((d,), cfg.param_jdtype, "ones", ("embed",))}


def apply_norm(cfg: ArchConfig, p: Tree, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    if cfg.norm == "layernorm":
        x = x.to(torch.float32)
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + 1e-6)
        return (y * p["scale"].to(torch.float32)
                + p["bias"].to(torch.float32)).to(dt)
    if cfg.kernels == "pallas":
        from repro_torch.kernels.rmsnorm.ops import rmsnorm_op
        return rmsnorm_op(x, p["scale"])
    x = x.to(torch.float32)
    var = (x * x).mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + 1e-6)
    return (y * p["scale"].to(torch.float32)).to(dt)


# ---------------------------------------------------------------- FFN
def ffn_specs(cfg: ArchConfig, d_ff: Optional[int] = None) -> Tree:
    d, f, pd = cfg.d_model, d_ff or cfg.d_ff, cfg.param_jdtype
    if cfg.act in ("swiglu", "geglu"):
        return {
            "wi_gate": ParamSpec((d, f), pd, axes=("embed", "mlp")),
            "wi_up": ParamSpec((d, f), pd, axes=("embed", "mlp")),
            "wo": ParamSpec((f, d), pd, axes=("mlp", "embed")),
        }
    return {
        "wi": ParamSpec((d, f), pd, axes=("embed", "mlp")),
        "wo": ParamSpec((f, d), pd, axes=("mlp", "embed")),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")       # jax.nn.gelu's default


def apply_ffn(cfg: ArchConfig, p: Tree, x: torch.Tensor) -> torch.Tensor:
    cd = x.dtype
    if cfg.act in ("swiglu", "geglu"):
        g = x @ p["wi_gate"].to(cd)
        u = x @ p["wi_up"].to(cd)
        act = F.silu(g) if cfg.act == "swiglu" else _gelu(g)
        return (act * u) @ p["wo"].to(cd)
    h = _gelu(x @ p["wi"].to(cd))
    return h @ p["wo"].to(cd)


# ---------------------------------------------------------------- attention
def attn_specs(cfg: ArchConfig) -> Tree:
    d, H, KV, hd, pd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                        cfg.param_jdtype)
    s = {
        "wq": ParamSpec((d, H, hd), pd, axes=("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, KV, hd), pd, axes=("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, KV, hd), pd, axes=("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, hd, d), pd, axes=("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((H, hd), pd, "zeros", ("heads", "head_dim"))
        s["bk"] = ParamSpec((KV, hd), pd, "zeros", ("kv_heads", "head_dim"))
        s["bv"] = ParamSpec((KV, hd), pd, "zeros", ("kv_heads", "head_dim"))
    return s


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _project_qkv(cfg: ArchConfig, p: Tree, x: torch.Tensor):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        cd = x.dtype
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    return q, k, v


def _pos_embed(cfg: ArchConfig, q, k, positions):
    if cfg.rope == "rope":
        q = rope_lib.apply_rope(q, positions, cfg.rope_theta)
        k = rope_lib.apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope == "mrope":
        raise NotImplementedError("mrope comes with the VLM slice")
    return q, k


def _out_proj(out: torch.Tensor, wo: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul over the flattened heads."""
    h, k, d = wo.shape
    return out.flatten(-2) @ wo.to(dtype).reshape(h * k, d)


def apply_attn(cfg: ArchConfig, p: Tree, x: torch.Tensor,
               positions: torch.Tensor, *, causal: Optional[bool] = None,
               window: Optional[int] = None, chunk_q: int = 512,
               chunk_k: int = 1024, return_kv: bool = False):
    """Full-sequence (prefill) attention. x [B, S, d]."""
    q, k, v = _project_qkv(cfg, p, x)
    q, k = _pos_embed(cfg, q, k, positions)
    out = flash_lib.flash_attention(
        q, k, v,
        causal=cfg.causal if causal is None else causal,
        window=cfg.sliding_window if window is None else window,
        softcap=cfg.attn_logit_softcap,
        chunk_q=chunk_q, chunk_k=chunk_k, impl=cfg.kernels)
    y = _out_proj(out, p["wo"], x.dtype)
    if return_kv:
        return y, (k, v)
    return y


def ring_place(x_seq: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Place the last ``cache_len`` sequence entries of ``x_seq`` [B,S,...]
    into ring-buffer slots ``t % cache_len`` (prefill -> decode handoff)."""
    S = x_seq.shape[1]
    W = min(cache_len, S)
    slots = torch.arange(S - W, S, device=x_seq.device) % cache_len
    out = x_seq.new_zeros((x_seq.shape[0], cache_len) + x_seq.shape[2:])
    out[:, slots] = x_seq[:, S - W:]
    return out


def apply_attn_decode(cfg: ArchConfig, p: Tree, x: torch.Tensor,
                      cache: Tree, pos: int, positions: torch.Tensor,
                      *, window: Optional[int] = None):
    """One-token decode. x [B, 1, d]; cache {'k','v'} [B, S_c, KV, hd].

    The new key/value row is written into the cache IN PLACE (the JAX
    version returns an updated copy): a serving session owns its caches
    exclusively, so the old contents are dead the moment the row lands,
    and the stacked per-layer caches need no restacking.  Sliding-window
    archs use a ring buffer of exactly ``window`` slots.
    """
    window = cfg.sliding_window if window is None else window
    S_c = cache["k"].shape[1]
    ring = window > 0 and S_c == window
    slot = pos % S_c if ring else pos
    q, k, v = _project_qkv(cfg, p, x)
    q, k = _pos_embed(cfg, q, k, positions)
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    out = attn_lib.decode_attention(
        q, cache["k"], cache["v"], pos,
        window=0 if ring else window,   # ring geometry enforces the window
        softcap=cfg.attn_logit_softcap)
    y = _out_proj(out, p["wo"], x.dtype)
    return y, cache


def attn_cache_specs(cfg: ArchConfig, batch: int, seq: int) -> Tree:
    hd = cfg.hd
    dt = cfg.compute_jdtype
    return {
        "k": ParamSpec((batch, seq, cfg.n_kv_heads, hd), dt, "zeros",
                       ("batch", "kv_seq", "kv_heads", "head_dim")),
        "v": ParamSpec((batch, seq, cfg.n_kv_heads, hd), dt, "zeros",
                       ("batch", "kv_seq", "kv_heads", "head_dim")),
    }
