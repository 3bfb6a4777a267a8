"""Block registry (port of ``repro.models.blocks``): one (specs, apply,
decode, cache_specs, prefill) tuple per kind.  The serving slice brings
the dense ``attn`` kind (self-attention + dense FFN); the other kinds
come with their slices."""
from __future__ import annotations

from typing import Any

from repro_torch.models import layers as L

Tree = Any


def _residual_ffn(cfg, p, x):
    return x + L.apply_ffn(cfg, p["mlp"], L.apply_norm(cfg, p["ln2"], x))


# ---------------------------------------------------------------- attn
def attn_specs(cfg):
    return {"ln1": L.norm_specs(cfg), "attn": L.attn_specs(cfg),
            "ln2": L.norm_specs(cfg), "mlp": L.ffn_specs(cfg)}


def attn_apply(cfg, p, x, positions):
    x = x + L.apply_attn(cfg, p["attn"], L.apply_norm(cfg, p["ln1"], x),
                         positions)
    return _residual_ffn(cfg, p, x), 0.0


def attn_decode(cfg, p, x, cache, pos, positions):
    h, cache = L.apply_attn_decode(
        cfg, p["attn"], L.apply_norm(cfg, p["ln1"], x), cache, pos, positions)
    x = x + h
    return _residual_ffn(cfg, p, x), cache


def attn_cache(cfg, batch, seq):
    # ring buffer for sliding-window archs: never cache beyond the window
    if cfg.sliding_window:
        seq = min(seq, cfg.sliding_window)
    return L.attn_cache_specs(cfg, batch, seq)


# ---------------------------------------------------------------- prefill
# Each prefill runs the full-sequence path AND emits the decode cache so a
# serving stack can hand off prefill -> decode (SWA caches land in ring
# layout via L.ring_place).
def _pad_kv(cfg, k, v, cache_len):
    if cfg.sliding_window:
        cache_len = min(cache_len, cfg.sliding_window)
    return {"k": L.ring_place(k.to(cfg.compute_jdtype), cache_len),
            "v": L.ring_place(v.to(cfg.compute_jdtype), cache_len)}


def _attn_kv_prefill(cfg, p, x, positions, cache_len):
    y, (k, v) = L.apply_attn(cfg, p["attn"], L.apply_norm(cfg, p["ln1"], x),
                             positions, return_kv=True)
    return y, _pad_kv(cfg, k, v, cache_len)


def attn_prefill(cfg, p, x, positions, cache_len):
    y, cache = _attn_kv_prefill(cfg, p, x, positions, cache_len)
    x = x + y
    return _residual_ffn(cfg, p, x), 0.0, cache


REGISTRY = {
    "attn": (attn_specs, attn_apply, attn_decode, attn_cache, attn_prefill),
}
