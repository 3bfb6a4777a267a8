"""Norms, FFNs, dense attention and capacity-bounded MoE (port of
``repro.models.layers``).  RMSNorm and flash attention go through the
kernel wrappers: the CUDA kernels on a CUDA tensor, their plain versions
on a CPU tensor.

Weights are stored in ``cfg.param_dtype`` and cast to the activation's
dtype at each matmul, as the JAX package does.  The projections, the
FFN and the MoE's routing, scatter, expert products and gather stay
plain PyTorch: the JAX package leaves them to XLA outside any Pallas
kernel.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable, Optional

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
    # the kernel on a CUDA tensor, its plain version on a CPU tensor;
    # closed-form backward under autograd.  The kernel takes an f32 scale:
    # a bf16 tree's (llama4-scout, deepseek-v2) is widened exactly, as the
    # JAX package's jnp path widens it
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_train
    return rmsnorm_train(x, p["scale"].to(torch.float32))


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


class _RowPartial(torch.autograd.Function):
    """``x @ w`` (``x [..., k]``, ``w [k, n]``) with the product left in
    f32: a row-parallel partial, rounded to the compute dtype only once
    the shards' partials are summed (``dist.tensor_parallel.all_reduce``).
    Products of bf16 operands are exact in f32 and a bf16 GEMM
    accumulates in f32, so, as on one device, the product is rounded
    once.  The backward runs in the operands' dtype, as the one-device
    product's does."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        if x.dtype == torch.float32:
            out = x2 @ w
        elif x.device.type == "cpu":
            out = x2.float() @ w.float()
        else:                                   # cuBLAS, f32 output
            out = torch.mm(x2, w, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return g @ w.T, gw


def _product(x: torch.Tensor, w: torch.Tensor, partial: bool
             ) -> torch.Tensor:
    return _RowPartial.apply(x, w) if partial else x @ w


def apply_ffn(cfg: ArchConfig, p: Tree, x: torch.Tensor,
              partial: bool = False) -> torch.Tensor:
    """The FFN; ``partial``: a model shard's block of its columns, the
    output a row-parallel partial in f32 (:class:`_RowPartial`)."""
    cd = x.dtype
    if cfg.act in ("swiglu", "geglu"):
        g = x @ p["wi_gate"].to(cd)
        u = x @ p["wi_up"].to(cd)
        act = F.silu(g) if cfg.act == "swiglu" else _gelu(g)
        return _product(act * u, p["wo"].to(cd), partial)
    h = _gelu(x @ p["wi"].to(cd))
    return _product(h, p["wo"].to(cd), partial)


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


def _project_kv(cfg: ArchConfig, p: Tree, x: torch.Tensor):
    k, v = _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return k, v


def _project_qkv(cfg: ArchConfig, p: Tree, x: torch.Tensor):
    q = _proj(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    return (q, *_project_kv(cfg, p, x))


def _rope(cfg: ArchConfig, t: torch.Tensor, positions) -> torch.Tensor:
    if cfg.rope == "rope":
        return rope_lib.apply_rope(t, positions, cfg.rope_theta)
    if cfg.rope == "mrope":
        return rope_lib.apply_mrope(t, positions, cfg.rope_theta)
    return t


def _pos_embed(cfg: ArchConfig, q, k, positions):
    return _rope(cfg, q, positions), _rope(cfg, k, positions)


def kv_rows(cfg: ArchConfig, p: Tree, x: torch.Tensor,
            positions: torch.Tensor):
    """The keys (rotated) and values of ``x`` (already normed) for every
    kv head ``p`` holds, computed as :func:`apply_attn` computes them: a
    model shard's copy of a replicated cache, bit for bit the copy the
    shard that attends writes."""
    k, v = _project_kv(cfg, p, x)
    return _rope(cfg, k, positions), v


def _out_proj(out: torch.Tensor, wo: torch.Tensor,
              dtype: torch.dtype, partial: bool = False) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul over the flattened heads
    (``partial``: a row-parallel partial in f32)."""
    h, k, d = wo.shape
    return _product(out.flatten(-2), wo.to(dtype).reshape(h * k, d),
                    partial)


def apply_attn(cfg: ArchConfig, p: Tree, x: torch.Tensor,
               positions: torch.Tensor, *, causal: Optional[bool] = None,
               window: Optional[int] = None, chunk_q: int = 512,
               chunk_k: int = 1024, return_kv: bool = False,
               partial: bool = False, shard: Optional[int] = None):
    """Full-sequence (prefill) attention. x [B, S, d].  ``partial``: a
    model shard's block of the heads, the output a row-parallel partial
    in f32 (:class:`_RowPartial`).  ``shard``: the model shard ``j``
    whose q heads ``p`` holds, reading their kv heads of every kv head
    ``p`` holds (:func:`read_kv`); ``return_kv`` then returns every one
    of those, the shard's block or copy of the cache."""
    q, k, v = _project_qkv(cfg, p, x)
    q, k = _pos_embed(cfg, q, k, positions)
    kr, vr = (k, v) if shard is None else read_kv(cfg, k, v, shard,
                                                  q.shape[-2])
    out = flash_lib.flash_attention(
        q, kr, vr,
        causal=cfg.causal if causal is None else causal,
        window=cfg.sliding_window if window is None else window,
        softcap=cfg.attn_logit_softcap,
        chunk_q=chunk_q, chunk_k=chunk_k)
    y = _out_proj(out, p["wo"], x.dtype, partial)
    if return_kv:
        return y, (k, v)
    return y


# ------------------------------------------- over a data shard's model shards
def kv_heads_of(n_heads: int, n_kv: int, j: int, h_j: int) -> list[int]:
    """The kv head each of model shard ``j``'s ``h_j`` q heads (heads
    ``j * h_j`` on) reads under GQA, counted globally."""
    g = n_heads // n_kv
    return [(j * h_j + t) // g for t in range(h_j)]


def kv_index(n_heads: int, n_kv: int, j: int, h_j: int):
    """The kv heads model shard ``j``'s ``h_j`` q heads read, as an index
    of a kv-heads dim: a slice where each kv head serves an equal run of
    them (``H_j % KV_j == 0``, the flash kernel's GQA), else a tensor of
    one kv head a q head."""
    idx = kv_heads_of(n_heads, n_kv, j, h_j)
    uniq = sorted(set(idx))
    even = len(idx) % len(uniq) == 0 and idx == [
        u for u in uniq for _ in range(len(idx) // len(uniq))]
    return slice(uniq[0], uniq[-1] + 1) if even else torch.tensor(idx)


def read_kv(cfg: ArchConfig, k: torch.Tensor, v: torch.Tensor, j: int,
            h_j: int):
    """The kv heads of ``k`` / ``v`` ``[B, S, KV_p, D]`` that model shard
    ``j``'s ``h_j`` q heads read: those heads of a whole (replicated)
    set, else every one (a split ``wk`` / ``wv`` holds exactly the kv
    heads its q heads read; whole heads read them all)."""
    if k.shape[-2] != cfg.n_kv_heads or h_j == cfg.n_heads:
        return k, v
    sel = kv_index(cfg.n_heads, cfg.n_kv_heads, j, h_j)
    return k[:, :, sel], v[:, :, sel]


def _kv_block(p: Tree, sel) -> Tree:
    """``p``'s ``wk`` / ``wv`` (and biases) narrowed to the kv heads
    ``sel`` (:func:`kv_index`) a shard's q heads read."""
    out = dict(p)
    for key in ("wk", "wv"):
        out[key] = p[key][:, sel]
    for key in ("bk", "bv"):
        if key in p:
            out[key] = p[key][sel]
    return out


def attn_part(cfg: ArchConfig, p: Tree, x: torch.Tensor,
              positions: torch.Tensor, j: int) -> torch.Tensor:
    """Model shard ``j``'s partial of :func:`apply_attn` (``x`` already
    normed), in f32: its q heads (its block of a head-split ``wq`` /
    ``bq``), the kv heads they read (its block of a split ``wk`` /
    ``wv``, or those heads of a replicated one), and its rows of
    ``wo``; the shards' partials sum to the attention's output."""
    h_j, kv_j = p["wq"].shape[-2], p["wk"].shape[-2]
    if kv_j == cfg.n_kv_heads and h_j < cfg.n_heads:
        p = _kv_block(p, kv_index(cfg.n_heads, cfg.n_kv_heads, j, h_j))
    return apply_attn(cfg, p, x, positions, partial=True)


def heads_split(cfg: ArchConfig, p: Tree) -> bool:
    """Does this shard hold a block of the attention's heads?"""
    return p["wq"].shape[-2] < cfg.n_heads


def ffn_split(p: Tree, d_ff: int) -> bool:
    """Does this shard hold a block of the FFN's columns?"""
    return p["wo"].shape[-2] < d_ff


def ring_place(x_seq: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Place the last ``cache_len`` sequence entries of ``x_seq`` [B,S,...]
    into ring-buffer slots ``t % cache_len`` (prefill -> decode handoff)."""
    S = x_seq.shape[1]
    W = min(cache_len, S)
    slots = torch.arange(S - W, S, device=x_seq.device) % cache_len
    out = x_seq.new_zeros((x_seq.shape[0], cache_len) + x_seq.shape[2:])
    out[:, slots] = x_seq[:, S - W:]
    return out


def _decode_slot(cfg: ArchConfig, cache: Tree, pos: int,
                 window: Optional[int]):
    """``(slot, ring, window)``: the cache slot decode position ``pos``
    writes, and whether the cache is a ring of exactly ``window``
    slots."""
    window = cfg.sliding_window if window is None else window
    S_c = cache["k"].shape[1]
    ring = window > 0 and S_c == window
    return (pos % S_c if ring else pos), ring, window


def _write_row(cache: Tree, slot: int, k: torch.Tensor, v: torch.Tensor
               ) -> None:
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)


def apply_attn_decode(cfg: ArchConfig, p: Tree, x: torch.Tensor,
                      cache: Tree, pos: int, positions: torch.Tensor,
                      *, window: Optional[int] = None,
                      partial: bool = False, shard: Optional[int] = None):
    """One-token decode. x [B, 1, d]; cache {'k','v'} [B, S_c, KV, hd].

    The new key/value row is written into the cache IN PLACE (the JAX
    version returns an updated copy): a serving session owns its caches
    exclusively, so the old contents are dead the moment the row lands,
    and the stacked per-layer caches need no restacking.  Sliding-window
    archs use a ring buffer of exactly ``window`` slots.

    ``partial`` / ``shard``: model shard ``j``'s partial, as
    :func:`apply_attn` takes them: its q heads attend over their kv
    heads of the cache it holds, into which it writes the row of every
    kv head ``p`` holds (its block, or the whole row of its copy).
    """
    slot, ring, window = _decode_slot(cfg, cache, pos, window)
    q, k, v = _project_qkv(cfg, p, x)
    q, k = _pos_embed(cfg, q, k, positions)
    _write_row(cache, slot, k, v)
    kc, vc = cache["k"], cache["v"]
    if shard is not None:
        kc, vc = read_kv(cfg, kc, vc, shard, q.shape[-2])
    out = attn_lib.decode_attention(
        q, kc, vc, pos,
        window=0 if ring else window,   # ring geometry enforces the window
        softcap=cfg.attn_logit_softcap)
    y = _out_proj(out, p["wo"], x.dtype, partial)
    return y, cache


def write_kv_row(cfg: ArchConfig, p: Tree, x: torch.Tensor, cache: Tree,
                 pos: int, positions: torch.Tensor) -> Tree:
    """The decode row of ``x`` (already normed) written into ``cache`` in
    place, as :func:`apply_attn_decode` writes it: a model shard's copy
    of a replicated cache, where another shard attends."""
    slot, _, _ = _decode_slot(cfg, cache, pos, None)
    _write_row(cache, slot, *kv_rows(cfg, p, x, positions))
    return cache


def attn_cache_specs(cfg: ArchConfig, batch: int, seq: int) -> Tree:
    hd = cfg.hd
    dt = cfg.compute_jdtype
    return {
        "k": ParamSpec((batch, seq, cfg.n_kv_heads, hd), dt, "zeros",
                       ("batch", "kv_seq", "kv_heads", "head_dim")),
        "v": ParamSpec((batch, seq, cfg.n_kv_heads, hd), dt, "zeros",
                       ("batch", "kv_seq", "kv_heads", "head_dim")),
    }


# ---------------------------------------------------------------- MoE
def moe_specs(cfg: ArchConfig) -> Tree:
    """Routed experts stacked ``[E, ...]``, an f32 router whatever
    ``param_dtype`` is, and the shared experts as one dense FFN."""
    m = cfg.moe
    d, f, pd = cfg.d_model, m.d_ff_expert, cfg.param_jdtype
    s = {
        "router": ParamSpec((d, m.num_experts), torch.float32,
                            axes=("embed", "experts")),
        "wi_gate": ParamSpec((m.num_experts, d, f), pd,
                             axes=("experts", "embed", "expert_mlp")),
        "wi_up": ParamSpec((m.num_experts, d, f), pd,
                           axes=("experts", "embed", "expert_mlp")),
        "wo": ParamSpec((m.num_experts, f, d), pd,
                        axes=("experts", "expert_mlp", "embed")),
    }
    if m.num_shared:
        s["shared"] = ffn_specs(cfg, d_ff=m.num_shared * m.d_ff_expert)
    return s


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, equal values
    in index order (a stable descending sort; ``torch.topk`` promises no
    order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@dataclasses.dataclass
class MoESplit:
    """What one data shard of a split microbatch needs to route its rows
    as the whole microbatch routes them: ``tokens`` the microbatch's
    token count (a host integer: it sets the capacity C), ``offsets``
    this shard's first slot in each expert (``[E]`` int, the earlier
    shards' route counts summed: JAX's token-major order is row order),
    ``counts`` the microbatch's route counts (``[E]`` int, for the
    balance loss's ``f_e``)."""
    tokens: int
    offsets: torch.Tensor
    counts: torch.Tensor


def moe_route(cfg: ArchConfig, p: Tree, x: torch.Tensor):
    """The router of :func:`apply_moe` over ``x [B, S, d]``: ``(probs [T,
    E] f32, weights [T, k] renormalised, sel [T, k], onehot [T * k, E]
    int)``; the route counts are ``onehot.sum(0)`` (``torch.bincount``
    sizes its output on the host)."""
    m = cfg.moe
    xt = x.reshape(-1, x.shape[-1])
    logits = xt.to(torch.float32) @ p["router"].to(torch.float32)  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    weights, sel = _top_k(probs, m.top_k)                        # [T, k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True),
                                    min=1e-9)
    return probs, weights, sel, F.one_hot(sel.reshape(-1), m.num_experts)


def split_contexts(counts: list, tokens: list) -> list:
    """The :class:`MoESplit` of every data shard of one microbatch, in
    row order, from each shard's route counts and token count.  Counts
    cross to each shard's device as int tensors; nothing is read on the
    host."""
    total = sum(tokens)
    out = []
    for j, c in enumerate(counts):
        dev = c.device
        whole = sum(o.to(dev) for o in counts)
        before = (sum(o.to(dev) for o in counts[:j]) if j
                  else torch.zeros_like(c))
        out.append(MoESplit(total, before, whole))
    return out


def apply_moe_shards(cfg: ArchConfig, ps: list, xs: list, scope=None):
    """:func:`apply_moe` over the data shards of one microbatch (row
    order; ``ps`` / ``xs`` per shard, on its device), each routed as
    the whole microbatch routes it: every shard's router first, then
    every shard's experts under its :class:`MoESplit`.  Returns ``(ys,
    auxs)`` per shard; the aux shares add up to the microbatch's balance
    loss.  ``scope(j)`` is a context shard ``j``'s ops run in."""
    scope = scope or (lambda j: contextlib.nullcontext())
    routes = []
    for j, (p, x) in enumerate(zip(ps, xs)):
        with scope(j):
            routes.append(moe_route(cfg, p, x))
    splits = split_contexts([r[3].sum(0) for r in routes],
                            [x.shape[0] * x.shape[1] for x in xs])
    ys, auxs = [], []
    for j, (p, x) in enumerate(zip(ps, xs)):
        with scope(j), moe_split(lambda tokens, counts, _s=splits[j]: _s):
            y, aux = apply_moe(cfg, p, x, route=routes[j])
        ys.append(y)
        auxs.append(aux)
    return ys, auxs


# apply_moe's split context: None where x is the whole microbatch, else
# a function (tokens, counts) -> MoESplit of the call's own token count
# and route counts
_SPLIT: contextvars.ContextVar = contextvars.ContextVar("moe_split",
                                                       default=None)


@contextlib.contextmanager
def moe_split(provider: Callable):
    """Every :func:`apply_moe` call inside routes its ``x`` as one data
    shard of a larger microbatch, under the :class:`MoESplit` that
    ``provider(tokens, counts)`` gives from the call's own token count
    and route counts (``[E]`` int).  :func:`apply_moe_shards` sets each
    shard's; a caller that computes one shard for several sets its own
    rule."""
    tok = _SPLIT.set(provider)
    try:
        yield
    finally:
        _SPLIT.reset(tok)


def split_provider() -> Optional[Callable]:
    """The provider :func:`moe_split` set here (None: no split)."""
    return _SPLIT.get()


def _moe_plan(cfg: ArchConfig, route, T: int):
    """:func:`apply_moe`'s routing past the router, under the
    :func:`moe_split` context where one is set: ``(e_flat [T * k], pos
    [T * k] the pair's rank in its expert, keep [T * k], Cb the buffer's
    slots an expert, aux share)``."""
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    probs, _, sel, onehot = route
    e_flat = sel.reshape(T * k)                                  # [T*k]
    counts = onehot.sum(0)                                       # [E]
    provider = _SPLIT.get()
    split = None if provider is None else provider(T, counts)
    pos_in_e = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1  # [T*k]
    if split is None:
        dispatch_frac = counts.to(torch.float32) / (T * k)
        aux = E * torch.sum(dispatch_frac * probs.mean(0))
        C = Cb = max(1, int(m.capacity_factor * T * k / E))
        keep = pos_in_e < C
    else:
        Tg = split.tokens
        dispatch_frac = split.counts.to(torch.float32) / (Tg * k)
        aux = E * torch.sum(dispatch_frac * (probs.sum(0) / Tg))
        C = max(1, int(m.capacity_factor * Tg * k / E))
        Cb = min(C, T * k)
        keep = split.offsets[e_flat] + pos_in_e < C
    return e_flat, pos_in_e, keep, Cb, aux


def expert_outputs(p: Tree, xt: torch.Tensor, e_flat: torch.Tensor,
                   pos_in_e: torch.Tensor, keep: torch.Tensor, Cb: int,
                   k: int, lo: Optional[int] = None) -> torch.Tensor:
    """The experts ``p`` holds over the kept pairs routed to them:
    ``[E_p, Cb, d]``, ``p``'s stacks ``[E_p, ...]`` every expert (``lo``
    None) or a model shard's block, experts ``lo`` to ``lo + E_p``.
    Each such pair's row of ``xt`` goes to its own slot of the ``[E_p *
    Cb, d]`` buffer, every other pair to one spare row past them (never
    read): no host sync for a count."""
    Ep, d, cd = p["wi_gate"].shape[0], xt.shape[-1], xt.dtype
    if lo is None:
        local, mine = e_flat, keep
    else:
        local = e_flat - lo
        mine = keep & (local >= 0) & (local < Ep)
    rows = torch.where(mine, local * Cb + pos_in_e, Ep * Cb)
    buf = xt.new_zeros((Ep * Cb + 1, d))
    buf[rows] = xt.repeat_interleave(k, dim=0)
    buf = buf[:Ep * Cb].view(Ep, Cb, d)
    g = torch.bmm(buf, p["wi_gate"].to(cd))
    u = torch.bmm(buf, p["wi_up"].to(cd))
    return torch.bmm(F.silu(g) * u, p["wo"].to(cd))              # [E_p, Cb, d]


def _combine(weights: torch.Tensor, keep: torch.Tensor,
             rows: torch.Tensor, T: int, k: int) -> torch.Tensor:
    """Each pair's expert row ``rows [T * k, d]`` weighted by its
    renormalised gate (0 where dropped), summed over a token's k
    choices: ``[T, d]``."""
    cd, d = rows.dtype, rows.shape[-1]
    w = weights.reshape(T * k, 1).to(cd) * keep[:, None].to(cd)
    return (rows * w).reshape(T, k, d).sum(1)


def apply_moe(cfg: ArchConfig, p: Tree, x: torch.Tensor, route=None):
    """Capacity-bounded top-k MoE, the JAX package's routing exactly.
    x [B, S, d] -> (y [B, S, d], aux loss).

    The router runs in f32; each token's k choices are renormalised;
    the Switch load-balance loss is ``E * sum_e f_e * P_e``.  Each
    expert takes ``C = max(1, int(capacity_factor * T * k / E))`` rows:
    a (token, choice) pair's slot is its rank among the pairs routed to
    that expert in token-major order, and pairs ranked C or later are
    dropped.  Every slot holds at most one kept row, so the buffers
    ``[E, C, d]`` are written with a plain index put (no accumulation:
    no kept row's value depends on the order rows land in), the experts
    run as batched matmuls, and each kept pair gathers its expert's row
    back, weighted.  Capacity couples the rows of a batch: the same
    token can be kept in one batch and dropped in another.

    Under :func:`moe_split` ``x`` is one data shard of a larger
    microbatch, routed by its :class:`MoESplit`: T in C is the
    microbatch's, a pair's slot is the shard's offset plus its local
    rank, and the aux is this shard's share ``E * sum_e f_e * (sum_{t
    in shard} p_te) / T`` with the microbatch's ``f_e`` — the shards'
    shares add up to the microbatch's loss.  The shard's buffer holds its kept rows at their
    local ranks, ``[E, min(C, T_shard * k), d]``.  ``route`` is
    :func:`moe_route`'s output where the caller has it."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    route = route or moe_route(cfg, p, x)
    e_flat, pos_in_e, keep, Cb, aux = _moe_plan(cfg, route, T)
    eo = expert_outputs(p, xt, e_flat, pos_in_e, keep, Cb, m.top_k)
    y = _combine(route[1], keep, eo[e_flat, torch.clamp(pos_in_e,
                                                       max=Cb - 1)],
                 T, m.top_k)
    if m.num_shared:
        y = y + apply_ffn(cfg, p["shared"], xt)
    return y.reshape(B, S, d), aux * m.aux_loss_coef


# ------------------------------------- MoE over a data shard's model shards
def experts_split(cfg: ArchConfig, p: Tree) -> bool:
    """Does this shard hold a block of the routed experts?"""
    return p["wi_gate"].shape[0] < cfg.moe.num_experts


def moe_route_tp(cfg: ArchConfig, ps: list, x: torch.Tensor, group):
    """:func:`moe_route` over a data shard's model shards (``ps[j]``
    shard ``j``'s block of the MoE tree, ``x`` the normed stream at
    home): the router's column blocks gathered whole at home
    (``ALL_REDUCES["router"]``) and the route taken there, as one
    device takes it.  Top-k is discontinuous: a column-split product
    may round otherwise and flip a route."""
    from repro_torch.dist import tensor_parallel as tp
    routers = [p["router"] for p in ps]
    router = (tp.gather_home(routers, group, "router")
              if routers[0].shape[-1] < cfg.moe.num_experts else routers[0])
    with group.scope(0):
        return moe_route(cfg, {"router": router}, x)


def apply_moe_tp(cfg: ArchConfig, ps: list, x: torch.Tensor, group,
                 route=None):
    """:func:`apply_moe` over a data shard's model shards
    (``dist.tensor_parallel``): ``ps[j]`` shard ``j``'s block of the MoE
    tree, ``x [B, S, d]`` the normed stream at home; under
    :func:`moe_split` as :func:`apply_moe` is.  Where the experts split
    over ``model`` (expert parallelism):

    * home routes (:func:`moe_route_tp`, then the capacity, slots and
      aux of :func:`apply_moe`); only the integer route (each pair's
      expert, slot and kept flag) goes to the shards, beside their copy
      of the stream;
    * shard ``j`` runs its experts over the pairs routed to them
      (:func:`expert_outputs`) and reads back each of its pairs' rows,
      unweighted, zeros for the pairs it does not own;
    * home takes each pair's row from its expert's owner by selection
      (``ALL_REDUCES["expert_rows"]``), then weights and sums as
      :func:`apply_moe` does: the routed output is the one-device one
      wherever each expert's products are.

    No coordinate holds an ``[E, Cb, .]`` tensor.  The shared expert runs
    column- then row-parallel where its width splits
    (``ALL_REDUCES["shared_expert"]``), else whole at home, and is added
    at home in the stream's dtype.  Experts that do not split run
    :func:`apply_moe` whole at home."""
    from repro_torch.dist import tensor_parallel as tp
    m = cfg.moe
    route = route or moe_route_tp(cfg, ps, x, group)
    if not experts_split(cfg, ps[0]):
        with group.scope(0):
            return apply_moe(cfg, ps[0], x, route=route)
    B, S, d = x.shape
    T, k, Ep = B * S, m.top_k, ps[0]["wi_gate"].shape[0]
    with group.scope(0):
        xt = x.reshape(T, d)
        e_flat, pos, keep, Cb, aux = _moe_plan(cfg, route, T)
        owner = e_flat // Ep
    xs = tp.fanout(xt, group)

    def rows(j, p, xj, e, pj, kj):
        local = e - j * Ep
        eo = expert_outputs(p, xj, e, pj, kj, Cb, k, lo=j * Ep)
        r = eo[local.clamp(0, Ep - 1), pj.clamp(max=Cb - 1)]
        return torch.where(((local >= 0) & (local < Ep))[:, None], r, 0.0)
    got = tp.select_home(group.per_shard(
        rows, ps, xs, *(tp.on_shards(t, group) for t in (e_flat, pos, keep))),
        owner, group, "expert_rows")
    with group.scope(0):
        y = _combine(route[1], keep, got, T, k)
    if m.num_shared:
        if ffn_split(ps[0]["shared"], m.num_shared * m.d_ff_expert):
            shared = tp.all_reduce(group.per_shard(
                lambda j, p, xj: apply_ffn(cfg, p["shared"], xj,
                                           partial=True), ps, xs),
                group, "shared_expert", dtype=xt.dtype)
        else:
            with group.scope(0):
                shared = apply_ffn(cfg, ps[0]["shared"], xt)
        with group.scope(0):
            y = y + shared
    return y.reshape(B, S, d), aux * m.aux_loss_coef


def apply_moe_shards_tp(cfg: ArchConfig, pss: list, xs: list,
                        groups: list):
    """:func:`apply_moe_shards` over the data shards' model shards
    (``pss[i]`` / ``xs[i]`` / ``groups[i]`` data shard ``i``'s, row
    order): every shard's route at its home first, then every shard's
    :func:`apply_moe_tp` under its :class:`MoESplit`.  Returns ``(ys,
    auxs)``; the aux shares add up to the microbatch's balance loss."""
    routes = [moe_route_tp(cfg, ps, x, g) for ps, x, g in zip(pss, xs,
                                                              groups)]
    splits = split_contexts([r[3].sum(0) for r in routes],
                            [x.shape[0] * x.shape[1] for x in xs])
    ys, auxs = [], []
    for ps, x, g, r, s in zip(pss, xs, groups, routes, splits):
        with moe_split(lambda tokens, counts, _s=s: _s):
            y, aux = apply_moe_tp(cfg, ps, x, g, route=r)
        ys.append(y)
        auxs.append(aux)
    return ys, auxs
