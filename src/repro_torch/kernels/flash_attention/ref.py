"""Plain PyTorch version of the flash-attention forward: a chunked
online-softmax mirror of ``repro.models.flash._flash_fwd_impl`` (plus the
logit soft-cap of ``repro.models.attention.chunked_attention``).

Scores are f32 (q and k upcast — bf16 products are exact in f32), P is
rounded to v's dtype for the PV product and summed in f32, exactly the
dtype discipline of the JAX oracle and of the CUDA kernel.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _pad_seq(x: torch.Tensor, mult: int) -> torch.Tensor:
    pad = (-x.shape[1]) % mult
    if pad:
        x = torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])],
                      dim=1)
    return x


def _ok_mask(qpos, kpos, causal: bool, window: int, kv_len: int):
    ok = (kpos[None, :] < kv_len).expand(qpos.shape[0], kpos.shape[0])
    if causal:
        ok = ok & (qpos[:, None] >= kpos[None, :])
    if window > 0:
        ok = ok & ((qpos[:, None] - kpos[None, :]) < window)
    return ok


def flash_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0, q_offset: int = 0,
                  cq: int = 512, ck: int = 1024, scale: float = None,
                  softcap: float = 0.0):
    """q [B,Sq,H,Dq], k [B,Sk,KV,Dq], v [B,Sk,KV,Dv] ->
    (out [B,Sq,H,Dv] in v's dtype, lse [B,KV,G,Sq] f32)."""
    B, Sq, H, Dq = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KV
    scale = Dq ** -0.5 if scale is None else scale
    cq, ck = min(cq, Sq), min(ck, Sk)
    nq, nk = -(-Sq // cq), -(-Sk // ck)
    dev = q.device
    qc = _pad_seq(q, cq).reshape(B, nq, cq, KV, G, Dq)
    kc = _pad_seq(k, ck).reshape(B, nk, ck, KV, Dq)
    vc = _pad_seq(v, ck).reshape(B, nk, ck, KV, Dv)
    outs, lses = [], []
    for qi in range(nq):
        qblk = qc[:, qi].to(torch.float32)           # [B, cq, KV, G, Dq]
        qpos = q_offset + qi * cq + torch.arange(cq, device=dev)
        m = torch.full((B, KV, G, cq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, cq, Dv), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            kpos = ki * ck + torch.arange(ck, device=dev)
            s = torch.einsum("bqkgd,bckd->bkgqc", qblk,
                             kc[:, ki].to(torch.float32)) * scale
            if softcap > 0.0:
                s = torch.tanh(s / softcap) * softcap
            s = torch.where(_ok_mask(qpos, kpos, causal, window, Sk),
                            s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqc,bckd->bkgqd", p.to(v.dtype).to(torch.float32),
                vc[:, ki].to(torch.float32))
            m = m_new
        den = torch.clamp(l, min=1e-30)
        outs.append((acc / den[..., None]).permute(0, 3, 1, 2, 4))
        lses.append(m + torch.log(den))
    out = torch.cat(outs, dim=1).reshape(B, nq * cq, H, Dv)[:, :Sq]
    lse = torch.cat(lses, dim=-1)[..., :Sq]
    return out.to(v.dtype), lse


def attention_ref(q, k, v, *, causal=True, window=0, scale=None):
    """Unchunked oracle (port of ``repro.kernels.flash_attention.ref``):
    query offset ``Sk - Sq``, softmax over the full key axis."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Sq, KV, G, D).to(torch.float32)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(torch.float32)) * scale
    qpos = (Sk - Sq) + torch.arange(Sq, device=q.device)
    ok = _ok_mask(qpos, torch.arange(Sk, device=q.device), causal, window,
                  Sk)
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(torch.float32))
    return out.reshape(B, Sq, H, v.shape[-1]).to(v.dtype)
