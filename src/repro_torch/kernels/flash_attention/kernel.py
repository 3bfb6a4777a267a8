"""Wrapper of the CUDA flash-attention forward
(``csrc/flash_attention.cu``), replacing the Pallas
``repro.kernels.flash_attention.kernel.flash_attention_fwd`` (and its
``with_lse`` variant).

On a CUDA tensor it launches the kernel or raises; on a CPU tensor it
runs :func:`~repro_torch.kernels.flash_attention.ref.flash_fwd_ref` at
the kernel's fixed query offset ``Sk - Sq``.  The kernel tiles queries
and keys by 64 itself; ``block_q``/``block_k`` set the chunks of the
plain version only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels.flash_attention.ref import flash_fwd_ref

DEFAULT_BQ = 256
DEFAULT_BK = 512
HEAD_DIMS = (64, 128)


def flash_attention_fwd(q, k, v, causal=True, window=0, scale=None,
                        block_q: int = DEFAULT_BQ,
                        block_k: int = DEFAULT_BK, with_lse: bool = False):
    """q [B,Sq,H,D], k/v [B,Sk,KV,D] -> out [B,Sq,H,D] (and, with
    ``with_lse``, the f32 log-sum-exp ``[B, KV, G, Sq]``)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = D ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        out, lse = flash_fwd_ref(q, k, v, causal, window, Sk - Sq,
                                 block_q, block_k, scale)
        return (out, lse) if with_lse else out
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device "
                         f"{q.device}")
    from repro_torch.kernels import _lib
    if not (k.device == v.device == q.device):
        raise ValueError("flash_attention_fwd: q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention_fwd: dtypes differ "
                        f"({q.dtype}, {k.dtype}, {v.dtype})")
    if D not in HEAD_DIMS or k.shape[-1] != D or v.shape[-1] != D:
        raise ValueError(f"flash_attention_fwd: head dims q {D}, k "
                         f"{k.shape[-1]}, v {v.shape[-1]}; the kernel "
                         f"takes equal head dims in {HEAD_DIMS}")
    if (k.shape[0] != B or v.shape[:3] != k.shape[:3] or KV == 0
            or H % KV or Sk == 0):
        raise ValueError(f"flash_attention_fwd: shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention_fwd: head dim must be contiguous")
    code = _lib.dtype_code(q, "flash_attention_fwd")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
    rc = _lib.lib().repro_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, H, KV, Sq, Sk, D,
        ctypes.cast(strides, ctypes.c_void_p), scale, int(bool(causal)),
        int(window), code, _lib.stream_ptr(q.device))
    _lib.check(rc, "flash_attention_fwd")
    kernels.LAUNCHES["flash_attention_fwd"] += 1
    if with_lse:
        return out, lse.reshape(B, KV, H // KV, Sq)
    return out
