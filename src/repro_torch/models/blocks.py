"""Block registry (port of ``repro.models.blocks``): one (specs, apply,
decode, cache_specs, prefill) tuple per kind.

Kinds:
  attn      — self-attention + dense FFN            (dense LMs, VLM backbone)
  moe       — self-attention + MoE FFN              (llama4-scout)
  mla       — multi-head latent attention + FFN     (deepseek dense layer)
  mla_moe   — MLA + MoE FFN                         (deepseek-v2)
  mlstm     — xLSTM matrix-memory block             (xlstm-125m)
  slstm     — xLSTM scalar-memory block             (xlstm-125m)
  hymba     — parallel attention ∥ mamba heads + FFN (hymba-1.5b)
  mamba     — pure selective-SSM block

The recurrent kinds' caches are their decode states (``models.ssm``),
advanced in place by their decode steps as the attention kinds write
their KV rows; hymba's is ``{"kv": ring-windowed attention cache,
"ssm": mamba state}``."""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional

from repro_torch.models import layers as L
from repro_torch.models import mla as mla_lib
from repro_torch.models import ssm as ssm_lib

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


# ---------------------------------------------------------------- moe
def moe_specs(cfg):
    return {"ln1": L.norm_specs(cfg), "attn": L.attn_specs(cfg),
            "ln2": L.norm_specs(cfg), "moe": L.moe_specs(cfg)}


def _residual_moe(cfg, p, x):
    y, aux = L.apply_moe(cfg, p["moe"], L.apply_norm(cfg, p["ln2"], x))
    return x + y, aux


def moe_pre(cfg, p, x, positions):
    """The block up to its MoE: ``x + attn(ln1(x))``."""
    return x + L.apply_attn(cfg, p["attn"], L.apply_norm(cfg, p["ln1"], x),
                            positions)


def moe_apply(cfg, p, x, positions):
    return _residual_moe(cfg, p, moe_pre(cfg, p, x, positions))


def moe_decode(cfg, p, x, cache, pos, positions):
    h, cache = L.apply_attn_decode(
        cfg, p["attn"], L.apply_norm(cfg, p["ln1"], x), cache, pos, positions)
    x = x + h
    return _residual_moe(cfg, p, x)[0], cache


# ---------------------------------------------------------------- mla
def mla_specs(cfg):
    return {"ln1": L.norm_specs(cfg), "mla": mla_lib.mla_specs(cfg),
            "ln2": L.norm_specs(cfg), "mlp": L.ffn_specs(cfg)}


def mla_apply(cfg, p, x, positions):
    x = x + mla_lib.apply_mla(cfg, p["mla"], L.apply_norm(cfg, p["ln1"], x),
                              positions)
    return _residual_ffn(cfg, p, x), 0.0


def _mla_decode_attn(cfg, p, x, cache, pos, positions):
    h, cache = mla_lib.apply_mla_decode(
        cfg, p["mla"], L.apply_norm(cfg, p["ln1"], x), cache, pos, positions)
    return x + h, cache


def mla_decode(cfg, p, x, cache, pos, positions):
    x, cache = _mla_decode_attn(cfg, p, x, cache, pos, positions)
    return _residual_ffn(cfg, p, x), cache


def mla_cache(cfg, batch, seq):
    return mla_lib.mla_cache_specs(cfg, batch, seq)


# ---------------------------------------------------------------- mla_moe
def mla_moe_specs(cfg):
    return {"ln1": L.norm_specs(cfg), "mla": mla_lib.mla_specs(cfg),
            "ln2": L.norm_specs(cfg), "moe": L.moe_specs(cfg)}


def mla_moe_pre(cfg, p, x, positions):
    """The block up to its MoE: ``x + mla(ln1(x))``."""
    return x + mla_lib.apply_mla(cfg, p["mla"],
                                 L.apply_norm(cfg, p["ln1"], x), positions)


def mla_moe_apply(cfg, p, x, positions):
    return _residual_moe(cfg, p, mla_moe_pre(cfg, p, x, positions))


def mla_moe_decode(cfg, p, x, cache, pos, positions):
    x, cache = _mla_decode_attn(cfg, p, x, cache, pos, positions)
    return _residual_moe(cfg, p, x)[0], cache


# ---------------------------------------------------------------- xLSTM
def _cell_specs(cell_specs):
    return lambda cfg: {"ln1": L.norm_specs(cfg), "cell": cell_specs(cfg)}


def _cell_apply(apply_fn):
    def block_apply(cfg, p, x, positions):
        del positions
        y = apply_fn(cfg, p["cell"], L.apply_norm(cfg, p["ln1"], x))
        return x + y, 0.0
    return block_apply


def _cell_decode(decode_fn):
    def block_decode(cfg, p, x, cache, pos, positions):
        del pos, positions
        y, cache = decode_fn(cfg, p["cell"], L.apply_norm(cfg, p["ln1"], x),
                             cache)
        return x + y, cache
    return block_decode


def _cell_cache(cache_specs):
    def block_cache(cfg, batch, seq):
        del seq
        return cache_specs(cfg, batch)
    return block_cache


def _cell_prefill(apply_fn):
    def block_prefill(cfg, p, x, positions, cache_len):
        del positions, cache_len
        y, st = apply_fn(cfg, p["cell"], L.apply_norm(cfg, p["ln1"], x),
                         return_state=True)
        return x + y, 0.0, st
    return block_prefill


mlstm_specs = _cell_specs(ssm_lib.mlstm_specs)
mlstm_apply = _cell_apply(ssm_lib.apply_mlstm)
mlstm_decode = _cell_decode(ssm_lib.apply_mlstm_decode)
mlstm_cache = _cell_cache(ssm_lib.mlstm_cache_specs)
mlstm_prefill = _cell_prefill(ssm_lib.apply_mlstm)

slstm_specs = _cell_specs(ssm_lib.slstm_specs)
slstm_apply = _cell_apply(ssm_lib.apply_slstm)
slstm_decode = _cell_decode(ssm_lib.apply_slstm_decode)
slstm_cache = _cell_cache(ssm_lib.slstm_cache_specs)
slstm_prefill = _cell_prefill(ssm_lib.apply_slstm)

# ---------------------------------------------------------------- mamba
mamba_specs = _cell_specs(ssm_lib.mamba_specs)
mamba_apply = _cell_apply(ssm_lib.apply_mamba)
mamba_decode = _cell_decode(ssm_lib.apply_mamba_decode)
mamba_cache = _cell_cache(ssm_lib.mamba_cache_specs)
mamba_prefill = _cell_prefill(ssm_lib.apply_mamba)


# ---------------------------------------------------------------- hymba
def hymba_specs(cfg):
    return {"ln1": L.norm_specs(cfg), "attn": L.attn_specs(cfg),
            "mamba": ssm_lib.mamba_specs(cfg),
            "ln2": L.norm_specs(cfg), "mlp": L.ffn_specs(cfg)}


def hymba_apply(cfg, p, x, positions):
    h = L.apply_norm(cfg, p["ln1"], x)
    ya = L.apply_attn(cfg, p["attn"], h, positions)
    ys = ssm_lib.apply_mamba(cfg, p["mamba"], h)
    x = x + 0.5 * (ya + ys)
    return _residual_ffn(cfg, p, x), 0.0


def hymba_decode(cfg, p, x, cache, pos, positions):
    h = L.apply_norm(cfg, p["ln1"], x)
    ya, kv = L.apply_attn_decode(cfg, p["attn"], h, cache["kv"], pos,
                                 positions)
    ys, st = ssm_lib.apply_mamba_decode(cfg, p["mamba"], h, cache["ssm"])
    x = x + 0.5 * (ya + ys)
    return _residual_ffn(cfg, p, x), {"kv": kv, "ssm": st}


def hymba_cache(cfg, batch, seq):
    return {"kv": attn_cache(cfg, batch, seq),
            "ssm": ssm_lib.mamba_cache_specs(cfg, batch)}


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


def moe_prefill(cfg, p, x, positions, cache_len):
    y, cache = _attn_kv_prefill(cfg, p, x, positions, cache_len)
    x, aux = _residual_moe(cfg, p, x + y)
    return x, aux, cache


def _latent_cache(cfg, c_kv, k_rope, cache_len):
    return {"c_kv": L.ring_place(c_kv.to(cfg.compute_jdtype), cache_len),
            "k_rope": L.ring_place(k_rope.to(cfg.compute_jdtype),
                                   cache_len)}


def _mla_prefill_inner(cfg, p, x, positions, cache_len):
    """MLA over the sequence, and its latent decode caches placed in ring
    layout at ``cache_len`` slots (as the attention caches are)."""
    y, (c_kv, k_rope) = mla_lib.apply_mla(
        cfg, p["mla"], L.apply_norm(cfg, p["ln1"], x), positions,
        return_cache=True)
    return y, _latent_cache(cfg, c_kv, k_rope, cache_len)


def mla_prefill(cfg, p, x, positions, cache_len):
    y, cache = _mla_prefill_inner(cfg, p, x, positions, cache_len)
    x = x + y
    return _residual_ffn(cfg, p, x), 0.0, cache


def mla_moe_prefill(cfg, p, x, positions, cache_len):
    y, cache = _mla_prefill_inner(cfg, p, x, positions, cache_len)
    x, aux = _residual_moe(cfg, p, x + y)
    return x, aux, cache


def hymba_prefill(cfg, p, x, positions, cache_len):
    h = L.apply_norm(cfg, p["ln1"], x)
    ya, (k, v) = L.apply_attn(cfg, p["attn"], h, positions, return_kv=True)
    ys, st = ssm_lib.apply_mamba(cfg, p["mamba"], h, return_state=True)
    x = x + 0.5 * (ya + ys)
    cache = {"kv": _pad_kv(cfg, k, v, cache_len), "ssm": st}
    return _residual_ffn(cfg, p, x), 0.0, cache


REGISTRY = {
    "attn": (attn_specs, attn_apply, attn_decode, attn_cache, attn_prefill),
    "moe": (moe_specs, moe_apply, moe_decode, attn_cache, moe_prefill),
    "mla": (mla_specs, mla_apply, mla_decode, mla_cache, mla_prefill),
    "mla_moe": (mla_moe_specs, mla_moe_apply, mla_moe_decode, mla_cache,
                mla_moe_prefill),
    "mlstm": (mlstm_specs, mlstm_apply, mlstm_decode, mlstm_cache,
              mlstm_prefill),
    "slstm": (slstm_specs, slstm_apply, slstm_decode, slstm_cache,
              slstm_prefill),
    "hymba": (hymba_specs, hymba_apply, hymba_decode, hymba_cache,
              hymba_prefill),
    "mamba": (mamba_specs, mamba_apply, mamba_decode, mamba_cache,
              mamba_prefill),
}


# ------------------------------------------- over a data shard's model shards
def _mixer_half_tp(cfg, ps: list, x, positions, group, key: str,
                   split: Callable, part: Callable, whole: Callable):
    """``x + mixer(ln1(x))`` over a data shard's model shards, the mixer
    ``p[key]``: where ``split`` says its heads split, each shard norms
    its copy of ``x`` and computes its heads' partial ``part(cfg, p, x,
    positions, j)``, all-reduced at home; else ``whole`` runs at home."""
    from repro_torch.dist import tensor_parallel as tp
    p0 = ps[0]
    if split(cfg, p0[key]):
        xs = tp.fanout(x, group)
        pos = tp.on_shards(positions, group)
        y = tp.all_reduce(group.per_shard(
            lambda j, p, xj, pj: part(
                cfg, p[key], L.apply_norm(cfg, p["ln1"], xj), pj, j),
            ps, xs, pos), group, dtype=x.dtype)
    else:
        with group.scope(0):
            y = whole(cfg, p0[key], L.apply_norm(cfg, p0["ln1"], x),
                      positions)
    return x + y


def _attn_half_tp(cfg, ps: list, x, positions, group):
    """``x + attn(ln1(x))`` over a data shard's model shards."""
    return _mixer_half_tp(cfg, ps, x, positions, group, "attn",
                          L.heads_split, L.attn_part, L.apply_attn)


def _mla_half_tp(cfg, ps: list, x, positions, group):
    """``x + mla(ln1(x))`` over a data shard's model shards: the heads
    split, the down-projections replicate
    (:func:`~repro_torch.models.mla.mla_part`)."""
    return _mixer_half_tp(
        cfg, ps, x, positions, group, "mla", mla_lib.mla_heads_split,
        lambda cfg, p, x, pos, j: mla_lib.mla_part(cfg, p, x, pos),
        mla_lib.apply_mla)


def _ffn_half_tp(cfg, ps: list, x, group):
    """``x + ffn(ln2(x))`` over a data shard's model shards: where the
    FFN's columns split, each shard norms its copy of ``x`` and computes
    its columns' partial, all-reduced at home; else it runs whole at
    home."""
    from repro_torch.dist import tensor_parallel as tp
    if L.ffn_split(ps[0]["mlp"], cfg.d_ff):
        xs = tp.fanout(x, group)
        y = tp.all_reduce(group.per_shard(
            lambda j, p, xj: L.apply_ffn(cfg, p["mlp"],
                                         L.apply_norm(cfg, p["ln2"], xj),
                                         partial=True),
            ps, xs), group, dtype=x.dtype)
        return x + y, 0.0
    with group.scope(0):
        return _residual_ffn(cfg, ps[0], x), 0.0


def attn_apply_tp(cfg, ps: list, x, positions, group):
    """One ``attn`` layer over a data shard's model shards
    (``dist.tensor_parallel``): ``ps[j]`` shard ``j``'s block of the
    layer, ``x`` the residual stream at home.  Each half (attention,
    FFN) whose weights split over ``model`` runs on every shard from its
    copy of ``x`` (norm, its heads or columns, its rows of ``wo``) and
    the f32 partials are all-reduced, rounded once to the stream's
    dtype, before the residual add; a half whose weights replicate runs
    whole at home."""
    return _ffn_half_tp(cfg, ps, _attn_half_tp(cfg, ps, x, positions,
                                               group), group)


def mla_apply_tp(cfg, ps: list, x, positions, group):
    """One ``mla`` layer over a data shard's model shards: the MLA half
    (:func:`_mla_half_tp`), then the FFN half as :func:`attn_apply_tp`
    runs it."""
    return _ffn_half_tp(cfg, ps, _mla_half_tp(cfg, ps, x, positions,
                                              group), group)


def _moe_norm(cfg, ps: list, h, group):
    """``ln2(h)`` at home: the MoE's router input and its experts'."""
    with group.scope(0):
        return L.apply_norm(cfg, ps[0]["ln2"], h)


def _a2a(cfg, mps: list) -> bool:
    """Do the routed experts of ``mps`` (a model shard's MoE trees) split
    over ``model`` and hold a data slice, so that their slots are
    computed once per microbatch
    (:func:`~repro_torch.models.layers.apply_moe_a2a`)?"""
    return L.experts_split(cfg, mps[0]) and L.expert_slices(cfg, mps[0]) > 1


def _moe_half_tp(cfg, ps: list, h, group):
    """``h + moe(ln2(h))``: the MoE expert-parallel
    (:func:`~repro_torch.models.layers.apply_moe_tp`) on ``ln2`` of the
    stream, normed at home.  Where the experts hold a data slice, this
    data shard stands for the microbatch's
    (:func:`~repro_torch.models.layers.moe_data_groups`, the dry run)
    and the layer computes each expert's slots once per microbatch."""
    mps = [p["moe"] for p in ps]
    x = _moe_norm(cfg, ps, h, group)
    if _a2a(cfg, mps):
        groups = L.data_groups()
        if not groups or groups[0].coords != group.coords:
            raise ValueError("expert stacks holding a data slice need the "
                             "microbatch's data shards (moe_data_groups)")
        ys, auxs = L.apply_moe_a2a(cfg, [mps], [x], groups)
        y, aux = ys[0], auxs[0]
    else:
        y, aux = L.apply_moe_tp(cfg, mps, x, group)
    with group.scope(0):
        return h + y, aux


def moe_apply_tp(cfg, ps: list, x, positions, group):
    """One ``moe`` layer over a data shard's model shards: the attention
    half as :func:`attn_apply_tp`'s, then the MoE half."""
    return _moe_half_tp(cfg, ps, _attn_half_tp(cfg, ps, x, positions,
                                               group), group)


def mla_moe_apply_tp(cfg, ps: list, x, positions, group):
    """One ``mla_moe`` layer over a data shard's model shards: the MLA
    half, then the MoE half as :func:`moe_apply_tp` runs it."""
    return _moe_half_tp(cfg, ps, _mla_half_tp(cfg, ps, x, positions,
                                              group), group)


TP_APPLY = {"attn": attn_apply_tp, "moe": moe_apply_tp,
            "mla": mla_apply_tp, "mla_moe": mla_moe_apply_tp}


# ------------------------------------------------ data shards in lockstep
# the kinds whose apply routes over the whole microbatch (capacity, slots
# and the balance loss), each with its block up to the MoE
MOE_PRE = {"moe": moe_pre, "mla_moe": mla_moe_pre}


def per_shard(scope: Optional[Callable], f: Callable, *cols) -> list:
    """``f`` over the data shards' entries of ``cols`` (lists a shard),
    shard ``j``'s call run in ``scope(j)`` (None: no scope)."""
    out = []
    for j, args in enumerate(zip(*cols)):
        with scope(j) if scope else contextlib.nullcontext():
            out.append(f(*args))
    return out


def apply_lockstep(cfg, kind: str, ps: list, xs: list, positions: list,
                   scope: Optional[Callable] = None):
    """One layer of ``kind`` over the data shards of one microbatch (row
    order): ``ps`` / ``xs`` / ``positions`` per shard, each on its
    shard's device.  Returns ``(ys, auxs)`` per shard.  A MoE kind runs
    every shard up to its MoE, then the MoE over all shards
    (:func:`~repro_torch.models.layers.apply_moe_shards`), so the shards
    route as the microbatch would and their aux shares add up to its
    balance loss; any other kind, or one shard, applies shard by shard.
    ``scope(j)`` is a context each of shard ``j``'s ops run in (the
    pipeline's ``dist.mesh.at``)."""
    pre = MOE_PRE.get(kind)
    if pre is None or len(xs) == 1:
        apply_fn = REGISTRY[kind][1]
        outs = per_shard(scope, lambda p, x, pos: apply_fn(cfg, p, x, pos),
                         ps, xs, positions)
        return [y for y, _ in outs], [a for _, a in outs]
    hs = per_shard(scope, lambda p, x, pos: pre(cfg, p, x, pos), ps, xs,
                   positions)
    ns = per_shard(scope, lambda p, h: L.apply_norm(cfg, p["ln2"], h), ps,
                   hs)
    ys, auxs = L.apply_moe_shards(cfg, [p["moe"] for p in ps], ns, scope)
    return per_shard(scope, lambda h, y: h + y, hs, ys), auxs


# the tensor-parallel kinds that route over the whole microbatch, each
# with its block up to the MoE over a data shard's model shards
MOE_PRE_TP = {"moe": _attn_half_tp, "mla_moe": _mla_half_tp}


def apply_lockstep_tp(cfg, kind: str, pss: list, xs: list, positions: list,
                      groups: list):
    """:func:`apply_lockstep` over each data shard's model shards:
    ``pss[i]`` data shard ``i``'s list of model shard blocks of the
    layer, ``xs[i]`` its residual stream at its home, ``groups[i]`` its
    :class:`~repro_torch.dist.tensor_parallel.Group`.  A MoE kind runs
    every data shard's block up to its MoE, then every shard's route at
    its home, the split contexts, and every shard's expert-parallel MoE
    under its own (:func:`~repro_torch.models.layers.apply_moe_shards_tp`):
    the shards route as the microbatch would and their aux shares add up
    to its balance loss.  Any other kind, or one data shard, applies
    shard by shard (``TP_APPLY``)."""
    pre = MOE_PRE_TP.get(kind)
    if pre is None or len(xs) == 1:
        outs = [TP_APPLY[kind](cfg, ps, x, pos, g)
                for ps, x, pos, g in zip(pss, xs, positions, groups)]
        return [y for y, _ in outs], [a for _, a in outs]
    hs = [pre(cfg, ps, x, pos, g)
          for ps, x, pos, g in zip(pss, xs, positions, groups)]
    return _moe_lockstep_tp(cfg, pss, hs, groups)


def _moe_lockstep_tp(cfg, pss: list, hs: list, groups: list):
    """``h + moe(ln2(h))`` over the data shards of one batch (row order),
    ``hs[i]`` data shard ``i``'s stream up to its MoE at its home: every
    shard's route at its home first, then, where the experts hold a data
    slice, each expert's slots computed once for the batch
    (:func:`~repro_torch.models.layers.apply_moe_a2a`), else every
    shard's expert-parallel MoE under its split context
    (:func:`~repro_torch.models.layers.apply_moe_shards_tp`).  Returns
    ``(ys, auxs)``."""
    ns = [_moe_norm(cfg, ps, h, g) for ps, h, g in zip(pss, hs, groups)]
    mpss = [[p["moe"] for p in ps] for ps in pss]
    moe = L.apply_moe_a2a if _a2a(cfg, mpss[0]) else L.apply_moe_shards_tp
    ys, auxs = moe(cfg, mpss, ns, groups)
    out = []
    for h, y, g in zip(hs, ys, groups):
        with g.scope(0):
            out.append(h + y)
    return out, auxs


# ------------------------------------------ serving over the model shards
# Prefill and decode over a data shard's model shards.  Each decode cache
# is held by every model shard as its block of JAX's layout (the ``kv_heads``
# rule: split over ``model`` where the kv heads divide it, else a copy a
# shard; MLA's latent cache is a copy a shard).  Every shard writes its
# own block or copy from its copy of the stream: ``ln1`` on the copy,
# then the projections of every kv head it holds (or the latents), the
# same ops on the same bits as the shard that attends, so the copies are
# equal to the bit and nothing crosses a shard for them.  Where the heads
# split, each shard's q heads attend over their kv heads of its block or
# copy and its partial is all-reduced; else the mixer runs whole at home,
# as one device runs it, and the other shards only write their copies.
def _serve_mixer_tp(cfg, ps: list, x, group, key: str, sp: bool,
                    attend: Callable, copy_rows: Callable):
    """``(x + mixer(ln1(x)), caches)``, ``caches[j]`` model shard ``j``'s
    block or copy: each shard norms its copy of ``x``; ``attend(j, p,
    h)`` gives ``(output, cache)`` (a partial where the heads of
    ``p[key]`` split, ``sp``, all-reduced at home; else home's whole
    output), ``copy_rows(j, p, h)`` a shard's cache where home attends
    alone."""
    from repro_torch.dist import tensor_parallel as tp
    xs = tp.fanout(x, group)

    def one(j, p, xj):
        h = L.apply_norm(cfg, p["ln1"], xj)
        if sp or j == 0:
            return attend(j, p[key], h)
        return None, copy_rows(j, p[key], h)
    outs = group.per_shard(one, ps, xs)
    y = tp.all_reduce([o[0] for o in outs], group, dtype=x.dtype) if sp \
        else outs[0][0]
    with group.scope(0):
        return x + y, [o[1] for o in outs]


def _attn_prefill_half_tp(cfg, ps: list, x, positions, cache_len, group):
    """``x + attn(ln1(x))`` and every shard's cache: the prefill
    counterpart of :func:`_attn_half_tp`."""
    from repro_torch.dist import tensor_parallel as tp
    pos = tp.on_shards(positions, group)
    sp = L.heads_split(cfg, ps[0]["attn"])

    def attend(j, p, h):
        y, (k, v) = L.apply_attn(cfg, p, h, pos[j], return_kv=True,
                                 partial=sp, shard=j if sp else None)
        return y, _pad_kv(cfg, k, v, cache_len)
    return _serve_mixer_tp(
        cfg, ps, x, group, "attn", sp, attend,
        lambda j, p, h: _pad_kv(cfg, *L.kv_rows(cfg, p, h, pos[j]),
                                cache_len))


def _attn_decode_half_tp(cfg, ps: list, x, caches: list, pos: int,
                         positions, group):
    """``x + attn(ln1(x))`` for one token, each shard's row written into
    its block or copy of the cache in place."""
    from repro_torch.dist import tensor_parallel as tp
    ppos = tp.on_shards(positions, group)
    sp = L.heads_split(cfg, ps[0]["attn"])
    return _serve_mixer_tp(
        cfg, ps, x, group, "attn", sp,
        lambda j, p, h: L.apply_attn_decode(
            cfg, p, h, caches[j], pos, ppos[j], partial=sp,
            shard=j if sp else None),
        lambda j, p, h: L.write_kv_row(cfg, p, h, caches[j], pos, ppos[j]))


def _mla_prefill_half_tp(cfg, ps: list, x, positions, cache_len, group):
    """``x + mla(ln1(x))`` and every shard's copy of the latent cache:
    the prefill counterpart of :func:`_mla_half_tp`."""
    from repro_torch.dist import tensor_parallel as tp
    pos = tp.on_shards(positions, group)
    sp = mla_lib.mla_heads_split(cfg, ps[0]["mla"])

    def attend(j, p, h):
        y, rows = (mla_lib.mla_part(cfg, p, h, pos[j], return_cache=True)
                   if sp else mla_lib.apply_mla(cfg, p, h, pos[j],
                                                return_cache=True))
        return y, _latent_cache(cfg, *rows, cache_len)
    return _serve_mixer_tp(
        cfg, ps, x, group, "mla", sp, attend,
        lambda j, p, h: _latent_cache(
            cfg, *mla_lib.latent_rows(cfg, p, h, pos[j]), cache_len))


def _mla_decode_half_tp(cfg, ps: list, x, caches: list, pos: int,
                        positions, group):
    """The absorbed MLA decode over a data shard's model shards, each
    shard's latent row written into its copy in place."""
    from repro_torch.dist import tensor_parallel as tp
    ppos = tp.on_shards(positions, group)
    sp = mla_lib.mla_heads_split(cfg, ps[0]["mla"])
    return _serve_mixer_tp(
        cfg, ps, x, group, "mla", sp,
        lambda j, p, h: mla_lib.apply_mla_decode(
            cfg, p, h, caches[j], pos, ppos[j], partial=sp),
        lambda j, p, h: mla_lib.write_latent_row(cfg, p, h, caches[j], pos,
                                                 ppos[j]))


# each kind's (prefill, decode) mixer half over the model shards
SERVE_MIXERS_TP = {
    "attn": (_attn_prefill_half_tp, _attn_decode_half_tp),
    "moe": (_attn_prefill_half_tp, _attn_decode_half_tp),
    "mla": (_mla_prefill_half_tp, _mla_decode_half_tp),
    "mla_moe": (_mla_prefill_half_tp, _mla_decode_half_tp)}


def _tp_prefill(kind: str):
    mix = SERVE_MIXERS_TP[kind][0]
    rest = _moe_half_tp if kind in MOE_PRE_TP else _ffn_half_tp

    def prefill(cfg, ps: list, x, positions, cache_len: int, group):
        h, caches = mix(cfg, ps, x, positions, cache_len, group)
        y, aux = rest(cfg, ps, h, group)
        return y, aux, caches
    return prefill


def _tp_decode(kind: str):
    mix = SERVE_MIXERS_TP[kind][1]
    rest = _moe_half_tp if kind in MOE_PRE_TP else _ffn_half_tp

    def decode(cfg, ps: list, x, caches: list, pos: int, positions, group):
        h, caches = mix(cfg, ps, x, caches, pos, positions, group)
        return rest(cfg, ps, h, group)[0], caches
    return decode


# one layer over a data shard's model shards, as REGISTRY's prefill and
# decode: ``(x, aux, caches)`` and ``(x, caches)``, ``caches[j]`` model
# shard ``j``'s block or copy of the layer's cache
TP_PREFILL = {k: _tp_prefill(k) for k in SERVE_MIXERS_TP}
TP_DECODE = {k: _tp_decode(k) for k in SERVE_MIXERS_TP}


def prefill_lockstep_tp(cfg, kind: str, pss: list, xs: list,
                        positions: list, cache_len: int, groups: list):
    """:data:`TP_PREFILL` over the data shards of one batch (row order;
    ``pss[i]`` / ``xs[i]`` / ``positions[i]`` / ``groups[i]`` data shard
    ``i``'s, as :func:`apply_lockstep_tp` takes them): ``(ys, auxs,
    caches)``, ``caches[i][j]`` the layer's cache held by data shard
    ``i``'s model shard ``j``.  A MoE kind over several data shards runs
    every shard up to its MoE, then the MoE in lockstep
    (:func:`_moe_lockstep_tp`): the shards route as the whole batch
    would."""
    if kind not in MOE_PRE_TP or len(xs) == 1:
        outs = [TP_PREFILL[kind](cfg, ps, x, pos, cache_len, g)
                for ps, x, pos, g in zip(pss, xs, positions, groups)]
        return ([o[0] for o in outs], [o[1] for o in outs],
                [o[2] for o in outs])
    mix = SERVE_MIXERS_TP[kind][0]
    out = [mix(cfg, ps, x, pos, cache_len, g)
           for ps, x, pos, g in zip(pss, xs, positions, groups)]
    ys, auxs = _moe_lockstep_tp(cfg, pss, [h for h, _ in out], groups)
    return ys, auxs, [c for _, c in out]


def decode_lockstep_tp(cfg, kind: str, pss: list, xs: list, caches: list,
                       pos: int, positions: list, groups: list) -> list:
    """:data:`TP_DECODE` over the data shards of one batch, ``caches[i]
    [j]`` data shard ``i``'s model shard ``j``'s block or copy of the
    layer's cache, written in place: the new streams (a MoE kind's data
    shards in lockstep)."""
    if kind not in MOE_PRE_TP or len(xs) == 1:
        return [TP_DECODE[kind](cfg, ps, x, c, pos, pp, g)[0]
                for ps, x, c, pp, g in zip(pss, xs, caches, positions,
                                           groups)]
    mix = SERVE_MIXERS_TP[kind][1]
    hs = [mix(cfg, ps, x, c, pos, pp, g)[0]
          for ps, x, c, pp, g in zip(pss, xs, caches, positions, groups)]
    return _moe_lockstep_tp(cfg, pss, hs, groups)[0]
