"""Attention decode path and test oracle (port of
``repro.models.attention``).

``decode_attention`` is plain PyTorch: the JAX decode path has no Pallas
kernel either.  Scores and the PV sum are f32 (``preferred_element_type``
in the JAX version), P is rounded to the cache dtype first.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *, window: int = 0,
                     softcap: float = 0.0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention over a KV cache; q [B,1,H,Dq], caches
    [B,S,KV,D*], ``pos`` the number of valid slots minus one.  Returns
    [B,1,H,Dv]."""
    B, _, H, Dq = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = scale if scale is not None else Dq ** -0.5
    qg = q.reshape(B, KV, G, Dq).to(torch.float32)
    s = torch.einsum("bkgd,bskd->bkgs", qg,
                     k_cache.to(torch.float32)) * scale
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    kpos = torch.arange(S, device=q.device)
    ok = kpos <= pos                  # attend to cache + current token
    if window > 0:
        ok = ok & (kpos > (pos - window))
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd",
                       p.to(v_cache.dtype).to(torch.float32),
                       v_cache.to(torch.float32))
    return out.reshape(B, 1, H, v_cache.shape[-1]).to(v_cache.dtype)


def naive_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    q_offset=0, scale=None):
    """O(S^2)-memory oracle used in tests only."""
    B, Sq, H, Dq = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else Dq ** -0.5
    qg = q.reshape(B, Sq, KV, G, Dq).to(torch.float32)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(torch.float32)) * scale
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (qpos[:, None] >= kpos[None, :])
    if window > 0:
        ok = ok & ((qpos[:, None] - kpos[None, :]) < window)
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.reshape(B, Sq, H, v.shape[-1]).to(v.dtype)
