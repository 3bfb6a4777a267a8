"""Flash attention with a recompute backward (port of
``repro.models.flash``).

The forward of a call the kernel computes without a soft-cap is the
CUDA kernel of :mod:`repro_torch.kernels.flash_attention` on a CUDA
tensor and its plain version on a CPU tensor, whatever ``impl`` says
(``impl`` is accepted for the JAX signature; the tensor's device
decides).  The kernel fixes the query offset at ``Sk - Sq``, so it takes
a call at that offset, and a bidirectional call without a window at any
offset (no mask reads the offset there: whisper's cross-attention, Sq
decoder tokens against Sk encoder frames at offset 0).  Every other call
runs the chunked plain forward.

Under autograd the forward is a :class:`torch.autograd.Function` whose
residuals are ``(q, k, v, out, lse)`` (the kernel's optional ``lse``
output); its backward is :func:`_flash_bwd`, a port of the JAX
package's chunked FlashAttention-2 recompute backward, which is plain
jnp there and plain PyTorch here — on the CPU and on the card alike, so
their gradients agree by construction:

    Dsum_i = rowsum(do_i * o_i)
    p_ij  = exp(q_i k_j^T * scale + bias - lse_i)
    dv_j += p_ij^T do_i
    ds_ij = p_ij * (do_i v_j^T - Dsum_i) * scale
    dq_i += ds_ij k_j ;  dk_j += ds_ij^T q_i
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ref import _ok_mask, _pad_seq, \
    flash_fwd_ref

NEG_INF = -1e30


def _kernel_takes(causal, window, q_offset, Sq, Sk) -> bool:
    """Whether the kernel, whose query offset is ``Sk - Sq``, computes the
    call: at that offset, or where no mask reads the offset (neither
    causal nor windowed)."""
    return q_offset == Sk - Sq or (not causal and window == 0)


def _flash_fwd(q, k, v, causal, window, q_offset, cq, ck, scale):
    """(out, lse [B,KV,G,Sq]): the kernel wrapper where the kernel takes
    the call (the CUDA kernel on a CUDA tensor), the plain version
    otherwise."""
    Sq, Sk = q.shape[1], k.shape[1]
    if _kernel_takes(causal, window, q_offset, Sq, Sk):
        from repro_torch.kernels.flash_attention.kernel import \
            flash_attention_fwd
        return flash_attention_fwd(q, k, v, causal, window, scale, cq, ck,
                                   with_lse=True)
    return flash_fwd_ref(q, k, v, causal, window, q_offset, cq, ck, scale)


def _flash_bwd(causal, window, q_offset, cq, ck, scale, res, do):
    """Chunked recompute backward, chunk for chunk the JAX
    ``_flash_bwd``; all products in f32, gradients in the inputs'
    dtypes."""
    q, k, v, out, lse = res
    B, Sq, H, Dq = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KV
    nq, nk = -(-Sq // cq), -(-Sk // ck)
    dev, f32 = q.device, torch.float32
    qc = _pad_seq(q, cq).reshape(B, nq, cq, KV, G, Dq).to(f32)
    kc = _pad_seq(k, ck).reshape(B, nk, ck, KV, Dq).to(f32)
    vc = _pad_seq(v, ck).reshape(B, nk, ck, KV, Dv).to(f32)
    dop = _pad_seq(do, cq).to(f32)
    outp = _pad_seq(out, cq).to(f32)
    doc = dop.reshape(B, nq, cq, KV, G, Dv)
    # Dsum_i = rowsum(do * o): [B, nq, KV, G, cq]
    dsum = (dop * outp).sum(-1).reshape(B, nq, cq, KV, G).permute(
        0, 1, 3, 4, 2)
    lsep = torch.nn.functional.pad(lse.to(f32), (0, nq * cq - Sq))
    lsec = lsep.reshape(B, KV, G, nq, cq)
    dq = torch.zeros((B, nq, cq, KV, G, Dq), dtype=f32, device=dev)
    dks, dvs = [], []
    for ki in range(nk):
        kblk, vblk = kc[:, ki], vc[:, ki]
        kpos = ki * ck + torch.arange(ck, device=dev)
        dk = torch.zeros((B, ck, KV, Dq), dtype=f32, device=dev)
        dv = torch.zeros((B, ck, KV, Dv), dtype=f32, device=dev)
        for qi in range(nq):
            qblk, doblk = qc[:, qi], doc[:, qi]
            qpos = q_offset + qi * cq + torch.arange(cq, device=dev)
            s = torch.einsum("bqkgd,bckd->bkgqc", qblk, kblk) * scale
            s = torch.where(_ok_mask(qpos, kpos, causal, window, Sk), s,
                            NEG_INF)
            p = torch.exp(s - lsec[:, :, :, qi, :, None])  # [B,KV,G,cq,ck]
            dv = dv + torch.einsum("bkgqc,bqkgd->bckd", p, doblk)
            dp = torch.einsum("bqkgd,bckd->bkgqc", doblk, vblk)
            ds = p * (dp - dsum[:, qi, ..., None]) * scale
            dk = dk + torch.einsum("bkgqc,bqkgd->bckd", ds, qblk)
            dq[:, qi] += torch.einsum("bkgqc,bckd->bqkgd", ds, kblk)
        dks.append(dk)
        dvs.append(dv)
    dq = dq.reshape(B, nq * cq, H, Dq)[:, :Sq]
    dk = torch.cat(dks, dim=1)[:, :Sk]
    dv = torch.cat(dvs, dim=1)[:, :Sk]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, cq, ck, scale):
        out, lse = _flash_fwd(q, k, v, causal, window, q_offset, cq, ck,
                              scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, q_offset, cq, ck, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = _flash_bwd(*ctx.args, ctx.saved_tensors, do)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    q_offset=0, chunk_q=512, chunk_k=1024,
                    scale: Optional[float] = None, impl: str = "jnp"):
    """q [B,Sq,H,Dq], k [B,Sk,KV,Dq], v [B,Sk,KV,Dv] -> [B,Sq,H,Dv].

    A soft-capped call runs the plain chunked forward (autograd through
    it, as the JAX package's ``chunked_attention`` fallback).  Without
    gradients the forward runs alone (no ``lse`` residual)."""
    del impl
    from repro_torch.models.probe import probe_enabled
    Sq, Dq = q.shape[1], q.shape[3]
    Sk = k.shape[1]
    scale = scale if scale is not None else Dq ** -0.5
    if probe_enabled():            # the FLOP probe: one block
        chunk_q, chunk_k = Sq, Sk
    cq, ck = min(chunk_q, Sq), min(chunk_k, Sk)
    if softcap > 0.0:
        out, _ = flash_fwd_ref(q, k, v, causal, window, q_offset, cq, ck,
                               scale, softcap)
        return out
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Flash.apply(q, k, v, causal, window, q_offset, cq, ck,
                            scale)
    if _kernel_takes(causal, window, q_offset, Sq, Sk):
        from repro_torch.kernels.flash_attention.kernel import \
            flash_attention_fwd
        return flash_attention_fwd(q, k, v, causal, window, scale, cq, ck)
    out, _ = flash_fwd_ref(q, k, v, causal, window, q_offset, cq, ck, scale)
    return out
