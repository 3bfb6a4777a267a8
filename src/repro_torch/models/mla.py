"""DeepSeek-V2 Multi-head Latent Attention (port of ``repro.models.mla``).

Prefill: expand the compressed latent into per-head K/V and run flash
attention with distinct qk and v head dims: ``[q_nope, q_rope]`` against
``[k_nope, k_rope]`` (192 dims for DeepSeek-V2) with 128-dim values, at
the scale of the concatenated dims.  The flash forward routes by the
tensor's device, so on the card this is the CUDA kernel's ``(192, 128)``
instantiation.

Decode: the **absorbed** form, plain PyTorch as in the JAX package:
W_uk is folded into the query and W_uv into the output, so attention
runs directly against the cached latent ``c_kv [B, S, r]`` and the
shared rope key ``k_rope [B, S, dr]``.  The new latent row is written
into the cache in place (as the attention caches are,
:func:`repro_torch.models.layers.apply_attn_decode`).

Over a data shard's model shards (``dist.tensor_parallel``) the heads
split and the down-projections (``w_dq``, ``w_dkv``, ``w_krope``)
replicate, as the JAX package's sharding rules lay them out:
:func:`mla_part` is model shard ``j``'s f32 partial of
:func:`apply_mla`, computed from the shard's copy of the stream, and
``apply_mla_decode(..., partial=True)`` that of the absorbed decode.
The latent cache replicates over ``model`` (``kv_lora`` maps to no mesh
axis): every shard computes its copy's rows from its copy of the stream
(:func:`latent_rows`), bit for bit the same rows.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.params import ParamSpec
from repro_torch.models import attention as attn_lib
from repro_torch.models import flash as flash_lib
from repro_torch.models import layers as L
from repro_torch.models import rope as rope_lib

Tree = Any


def mla_specs(cfg: ArchConfig) -> Tree:
    a = cfg.mla
    d, H, pd = cfg.d_model, cfg.n_heads, cfg.param_jdtype
    qd = a.qk_nope_dim + a.qk_rope_dim
    s: Tree = {
        "w_dkv": ParamSpec((d, a.kv_lora_rank), pd, axes=("embed", "kv_lora")),
        "w_krope": ParamSpec((d, a.qk_rope_dim), pd,
                             axes=("embed", "head_dim")),
        "w_uk": ParamSpec((a.kv_lora_rank, H, a.qk_nope_dim), pd,
                          axes=("kv_lora", "heads", "head_dim")),
        "w_uv": ParamSpec((a.kv_lora_rank, H, a.v_head_dim), pd,
                          axes=("kv_lora", "heads", "head_dim")),
        "wo": ParamSpec((H, a.v_head_dim, d), pd,
                        axes=("heads", "head_dim", "embed")),
    }
    if a.q_lora_rank:
        s["w_dq"] = ParamSpec((d, a.q_lora_rank), pd,
                              axes=("embed", "q_lora"))
        s["w_uq"] = ParamSpec((a.q_lora_rank, H, qd), pd,
                              axes=("q_lora", "heads", "head_dim"))
    else:
        s["wq"] = ParamSpec((d, H, qd), pd,
                            axes=("embed", "heads", "head_dim"))
    return s


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsr,rhk->bshk") as one matmul over the flattened heads."""
    r, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(r, h * k)).unflatten(-1, (h, k))


def _queries(cfg: ArchConfig, p: Tree, x: torch.Tensor):
    a = cfg.mla
    if a.q_lora_rank:
        q = _proj(x @ p["w_dq"].to(x.dtype), p["w_uq"])
    else:
        q = _proj(x, p["wq"])
    return q[..., :a.qk_nope_dim], q[..., a.qk_nope_dim:]   # nope, rope


def _scale(cfg: ArchConfig) -> float:
    return (cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim) ** -0.5


def _rope_key(cfg: ArchConfig, p: Tree, x: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """The rope key shared by all heads, rotated: [B, S, 1, dr]."""
    return rope_lib.apply_rope((x @ p["w_krope"].to(x.dtype))[:, :, None, :],
                               positions, cfg.rope_theta)


def apply_mla(cfg: ArchConfig, p: Tree, x: torch.Tensor,
              positions: torch.Tensor, *, chunk_q: int = 512,
              chunk_k: int = 1024, return_cache: bool = False,
              partial: bool = False):
    """Full-sequence (prefill / training) MLA. x [B, S, d]; with
    ``return_cache`` also the decode cache rows ``(c_kv [B, S, r],
    k_rope [B, S, dr])``.  The heads are those ``p`` holds;
    ``partial``: the output a row-parallel partial in f32
    (``layers._RowPartial``)."""
    a, cd = cfg.mla, x.dtype
    B, S, _ = x.shape
    H = p["wo"].shape[0]
    q_nope, q_rope = _queries(cfg, p, x)
    q_rope = rope_lib.apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = x @ p["w_dkv"].to(cd)                             # [B, S, r]
    k_rope = _rope_key(cfg, p, x, positions)                 # [B, S, 1, dr]
    k_nope = _proj(c_kv, p["w_uk"])
    v = _proj(c_kv, p["w_uv"])
    # the rope dims concatenated, so one flash pass takes both products
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, a.qk_rope_dim)], dim=-1)
    out = flash_lib.flash_attention(
        q, k, v, causal=cfg.causal, softcap=cfg.attn_logit_softcap,
        chunk_q=chunk_q, chunk_k=chunk_k, scale=_scale(cfg))
    y = L._out_proj(out, p["wo"], cd, partial)
    if return_cache:
        return y, (c_kv, k_rope[:, :, 0, :])
    return y


def mla_part(cfg: ArchConfig, p: Tree, x: torch.Tensor,
             positions: torch.Tensor, return_cache: bool = False):
    """Model shard ``j``'s partial of :func:`apply_mla` (``x`` already
    normed), in f32: the down-projections whole, on the shard's copy of
    the stream (they replicate over ``model``, as in GSPMD's program),
    its block of the heads' up-projections (``w_uq`` or ``wq``,
    ``w_uk``, ``w_uv``), the flash kernel over those heads at the
    config's scale, and its rows of ``wo``; the shards' partials sum to
    the attention's output.  ``return_cache``: also the shard's copy of
    the latent cache rows (the latents replicate over ``model``)."""
    return apply_mla(cfg, p, x, positions, partial=True,
                     return_cache=return_cache)


def latent_rows(cfg: ArchConfig, p: Tree, x: torch.Tensor,
                positions: torch.Tensor):
    """The latent cache rows ``(c_kv [B, S, r], k_rope [B, S, dr])`` of
    ``x`` (already normed), computed as :func:`apply_mla` and
    :func:`apply_mla_decode` compute them: a model shard's copy of the
    replicated latent cache, bit for bit the copy the shards that attend
    write."""
    return x @ p["w_dkv"].to(x.dtype), \
        _rope_key(cfg, p, x, positions)[:, :, 0, :]


def write_latent_row(cfg: ArchConfig, p: Tree, x: torch.Tensor,
                     cache: Tree, pos: int, positions: torch.Tensor
                     ) -> Tree:
    """The decode latent row of ``x`` written into ``cache`` at ``pos``
    in place."""
    c_new, kr_new = latent_rows(cfg, p, x, positions)
    cache["c_kv"][:, pos] = c_new[:, 0].to(cache["c_kv"].dtype)
    cache["k_rope"][:, pos] = kr_new[:, 0].to(cache["k_rope"].dtype)
    return cache


def mla_heads_split(cfg: ArchConfig, p: Tree) -> bool:
    """Does this shard hold a block of MLA's heads?"""
    return p["wo"].shape[0] < cfg.n_heads


def mla_cache_specs(cfg: ArchConfig, batch: int, seq: int) -> Tree:
    a, dt = cfg.mla, cfg.compute_jdtype
    return {
        "c_kv": ParamSpec((batch, seq, a.kv_lora_rank), dt, "zeros",
                          ("batch", "kv_seq", "kv_lora")),
        "k_rope": ParamSpec((batch, seq, a.qk_rope_dim), dt, "zeros",
                            ("batch", "kv_seq", "head_dim")),
    }


def apply_mla_decode(cfg: ArchConfig, p: Tree, x: torch.Tensor,
                     cache: Tree, pos: int, positions: torch.Tensor,
                     partial: bool = False):
    """Absorbed one-token decode. x [B, 1, d]; cache ``c_kv`` [B, S, r],
    ``k_rope`` [B, S, dr], written at ``pos`` in place.  Scores are f32
    (the JAX package's ``preferred_element_type``); P is rounded to the
    compute dtype for the latent-space sum.  The heads are those ``p``
    holds; ``partial``: the output a row-parallel partial in f32 (a
    model shard's, its latent row written into its copy of the
    cache)."""
    cd = x.dtype
    q_nope, q_rope = _queries(cfg, p, x)                     # [B,1,H,*]
    q_rope = rope_lib.apply_rope(q_rope, positions, cfg.rope_theta)
    write_latent_row(cfg, p, x, cache, pos, positions)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]

    # absorb W_uk into q: q_abs [B, H, r]
    q_abs = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], p["w_uk"].to(cd))
    f32 = torch.float32
    s_nope = torch.einsum("bhr,bsr->bhs", q_abs.to(f32), c_kv.to(f32))
    s_rope = torch.einsum("bhk,bsk->bhs", q_rope[:, 0].to(f32),
                          k_rope.to(f32))
    s = (s_nope + s_rope) * _scale(cfg)
    ok = torch.arange(c_kv.shape[1], device=x.device) <= pos
    s = torch.where(ok[None, None, :], s, attn_lib.NEG_INF)
    pattn = torch.softmax(s, dim=-1)
    # attend in latent space, then absorb W_uv
    out_c = torch.einsum("bhs,bsr->bhr", pattn.to(cd), c_kv.to(cd))
    out = torch.einsum("bhr,rhk->bhk", out_c, p["w_uv"].to(cd))
    if partial:
        h, k, d = p["wo"].shape
        y = L._product(out.reshape(-1, h * k),
                       p["wo"].to(cd).reshape(h * k, d), True)
        return y[:, None], cache
    y = torch.einsum("bhk,hkd->bd", out, p["wo"].to(cd))[:, None]
    return y, cache
