"""Wrapper of the CUDA flash-attention forward
(``csrc/flash_attention.cu``), replacing the Pallas
``repro.kernels.flash_attention.kernel.flash_attention_fwd`` (and its
``with_lse`` variant).

On a CUDA tensor it launches the kernel or raises; on a CPU tensor it
runs :func:`~repro_torch.kernels.flash_attention.ref.flash_fwd_ref` at
the kernel's fixed query offset ``Sk - Sq``; on a meta tensor it takes
the meta route of :mod:`repro_torch.kernels` (the CUDA route's checks and
its ``out`` / ``lse`` on meta, :func:`flash_work` counted).  The meta
route is not the plain version: that one materialises f32 score blocks
``[B, KV, G, cq, ck]`` which the kernel keeps in registers and never
writes to memory, so it would reckon memory the kernel never takes.  The kernel tiles queries
and keys by 64 itself; ``block_q``/``block_k`` set the chunks of the
plain version only.  bf16 runs on the tensor cores with 16-byte copies,
so its q, k and v must meet :func:`bf16_layout_problem`'s rule; f32 runs
the SIMT kernel, which takes any strides.  Both take the head-dim pairs
``(Dqk, Dv)`` of :data:`HEAD_DIMS` (the served models' own); on the card
any other pair raises, where the plain version takes any.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.kernels.flash_attention.ref import flash_fwd_ref

DEFAULT_BQ = 256
DEFAULT_BK = 512
# (q/k head dim, v head dim): 64 and 128 (yi-6b, swarm-1b, qwen), 120
# (h2o-danube-3), 192/128 (DeepSeek-V2's MLA prefill), 256 (gemma)
HEAD_DIMS = ((64, 64), (120, 120), (128, 128), (192, 128), (256, 256))


def bf16_layout_problem(t: torch.Tensor):
    """Why the bf16 kernel cannot read ``t`` [B, S, heads, D] with 16-byte
    copies, or None: it needs a 16-byte-aligned start (a storage offset
    that is a multiple of 8 elements) and batch, seq and head strides that
    are multiples of 8 elements (a dim of size 1 is never stepped over)."""
    if t.storage_offset() % 8 or t.data_ptr() % 16:
        return (f"starts at element offset {t.storage_offset()}, not "
                f"16-byte aligned")
    bad = [(i, s) for i, (n, s) in enumerate(zip(t.shape[:3],
                                                  t.stride()[:3]))
           if n > 1 and s % 8]
    if bad:
        return (f"has strides {tuple(t.stride()[:3])} (batch, seq, head); "
                f"they must be multiples of 8 elements")
    return None


def attended_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the kernel computes at query offset ``Sk -
    Sq``: every pair the causal and window masks keep."""
    p = np.arange(Sq, dtype=np.int64) + (Sk - Sq)
    lo = np.maximum(p - window + 1, 0) if window > 0 else np.zeros_like(p)
    hi = np.minimum(p, Sk - 1) if causal else np.full_like(p, Sk - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_work(q, k, v, causal: bool, window: int) -> tuple[float, float]:
    """(operations, bytes) of one forward: ``2 (Dqk + Dv)`` a pair and
    head, q, k, v read once and ``out`` written once (the kernel table's
    bound)."""
    B, Sq, H, D = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    flops = 2.0 * (D + Dv) * attended_pairs(Sq, Sk, causal, window) * B * H
    nbytes = (q.numel() + k.numel() + v.numel() + B * Sq * H * Dv) * \
        q.element_size()
    return flops, nbytes


def flash_attention_fwd(q, k, v, causal=True, window=0, scale=None,
                        block_q: int = DEFAULT_BQ,
                        block_k: int = DEFAULT_BK, with_lse: bool = False):
    """q [B,Sq,H,D], k [B,Sk,KV,D], v [B,Sk,KV,Dv] -> out [B,Sq,H,Dv]
    (and, with ``with_lse``, the f32 log-sum-exp ``[B, KV, G, Sq]``)."""
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    scale = D ** -0.5 if scale is None else float(scale)
    where = kernels.route(q, "flash_attention_fwd")
    if where == "cpu":
        out, lse = flash_fwd_ref(q, k, v, causal, window, Sk - Sq,
                                 block_q, block_k, scale)
        return (out, lse) if with_lse else out
    from repro_torch.kernels import _lib
    if not (k.device == v.device == q.device):
        raise ValueError("flash_attention_fwd: q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention_fwd: dtypes differ "
                        f"({q.dtype}, {k.dtype}, {v.dtype})")
    if (D, Dv) not in HEAD_DIMS or k.shape[-1] != D:
        raise ValueError(f"flash_attention_fwd: head dims q {D}, k "
                         f"{k.shape[-1]}, v {Dv}; the kernel takes q = k "
                         f"and (q, v) in {HEAD_DIMS}")
    if (k.shape[0] != B or v.shape[:3] != k.shape[:3] or KV == 0
            or H % KV or Sk == 0):
        raise ValueError(f"flash_attention_fwd: shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention_fwd: head dim must be contiguous")
    code = _lib.dtype_code(q, "flash_attention_fwd")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            problem = bf16_layout_problem(t)
            if problem:
                raise ValueError(f"flash_attention_fwd: bf16 {name} "
                                 f"{problem}")
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if where == "meta":
        kernels.meta_call("flash_attention_fwd",
                          *flash_work(q, k, v, causal, window))
    else:
        _launch(q, k, v, out, lse, scale, causal, window, code)
    if with_lse:
        return out, lse.reshape(B, KV, H // KV, Sq)
    return out


def _launch(q, k, v, out, lse, scale, causal, window, code) -> None:
    from repro_torch.kernels import _lib
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
    rc = _lib.lib().repro_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, H, KV, Sq, Sk, D, Dv,
        ctypes.cast(strides, ctypes.c_void_p), scale, int(bool(causal)),
        int(window), code, _lib.stream_ptr(q.device))
    _lib.check(rc, "flash_attention_fwd")
    kernels.LAUNCHES["flash_attention_fwd"] += 1
