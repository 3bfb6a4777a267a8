"""Flash attention router, forward only (port of ``repro.models.flash``).

``impl="pallas"`` (``cfg.kernels``) sends the call to the CUDA kernel of
:mod:`repro_torch.kernels.flash_attention` under the JAX routing rule:
only when ``q_offset == Sk - Sq`` (the kernel's fixed alignment) and
there is no soft-cap.  Every other call, and ``impl="jnp"``, runs the
chunked online-softmax plain version.  The custom backward
(``_flash_bwd``) comes with the training slice.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.flash_attention.ref import flash_fwd_ref


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    q_offset=0, chunk_q=512, chunk_k=1024,
                    scale: Optional[float] = None, impl: str = "jnp"):
    """q [B,Sq,H,Dq], k [B,Sk,KV,Dq], v [B,Sk,KV,Dv] -> [B,Sq,H,Dv]."""
    Sq, Dq = q.shape[1], q.shape[3]
    Sk = k.shape[1]
    scale = scale if scale is not None else Dq ** -0.5
    cq, ck = min(chunk_q, Sq), min(chunk_k, Sk)
    if impl == "pallas" and q_offset == Sk - Sq and softcap == 0.0:
        from repro_torch.kernels.flash_attention.kernel import \
            flash_attention_fwd
        return flash_attention_fwd(q, k, v, causal, window, scale, cq, ck)
    out, _ = flash_fwd_ref(q, k, v, causal, window, q_offset, cq, ck, scale,
                           softcap)
    return out
