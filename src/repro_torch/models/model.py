"""Decoder-LM assembly: embed -> per-run layer walk -> head (port of
``repro.models.model``).

Layer patterns are grouped into runs of identical block kinds, each run
one stacked ``[n, ...]`` parameter tree, exactly the JAX tree layout.
Where JAX scans over the stack, the port loops over layers and indexes
the stack (``a[i]`` is a view, no copy).  The GSPMD sharding hints
(``dist.constrain``) have no effect on one device and are left out.

:func:`lm_apply` is the training forward.  Its ``remat`` selects the
activation checkpointing of JAX's ``jax.checkpoint`` / ``remat_scan``
(non-reentrant ``torch.utils.checkpoint``): ``"none"``, ``"block"``
(one checkpoint per layer application) or ``"2level"`` (``sqrt(n)``
checkpointed groups of checkpointed layers).  Serving's ``lm_prefill``
computes no gradient and ignores its ``remat``.

ALBERT-style layer sharing (the paper's 1B model, §4.3) stores
``share_groups`` parameter groups and re-applies each ``reps = n_layers
/ share_groups`` times.  Decode caches stay one per application,
stacked group-major as the JAX package stacks them: application ``r``
of group ``g`` is cache row ``g * reps + r``.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ArchConfig
from repro_torch.models.params import ParamSpec
from repro_torch.models import layers as L
from repro_torch.models import rope as rope_lib
from repro_torch.models.blocks import REGISTRY
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like

Tree = Any


def segments(pattern: tuple[str, ...]) -> list[tuple[str, int]]:
    runs: list[tuple[str, int]] = []
    for k in pattern:
        if runs and runs[-1][0] == k:
            runs[-1] = (k, runs[-1][1] + 1)
        else:
            runs.append((k, 1))
    return runs


def stack_specs(tree: Tree, n: int) -> Tree:
    def s(p: ParamSpec) -> ParamSpec:
        return ParamSpec((n,) + p.shape, p.dtype, p.init,
                         ("layers",) + p.axes, p.scale)
    return tree_map(s, tree, is_leaf=lambda x: isinstance(x, ParamSpec))


def _shared_kind(cfg: ArchConfig) -> str:
    """The single block kind of an ALBERT-shared stack."""
    kinds = set(cfg.block_kinds)
    if len(kinds) > 1:
        raise ValueError(
            f"{cfg.name}: share_groups={cfg.share_groups} requires "
            f"a homogeneous stack, got block kinds {sorted(kinds)}")
    return cfg.block_kinds[0]


def _shared_runs(cfg: ArchConfig) -> list[tuple[str, int]]:
    return [(_shared_kind(cfg), cfg.share_groups)]


def model_runs(cfg: ArchConfig) -> tuple[list[tuple[str, int]], int]:
    """The whole model's ``(runs, reps)``: one run of ``share_groups``
    groups applied ``reps`` times each for a shared stack, else the
    pattern's runs applied once."""
    if cfg.share_groups:
        return _shared_runs(cfg), cfg.n_layers // cfg.share_groups
    return segments(cfg.block_kinds), 1


# leaves read in f32 whatever the activation dtype: the norms' scales
# (apply_norm; the rmsnorm kernel takes an f32 scale), the MoE router
# (apply_moe routes in f32) and Mamba's f32 ``a_log`` / ``d_skip`` (used
# uncast by models.ssm, as the JAX package uses them); every other block
# weight is cast to the activation dtype at its matmul, so casting it
# once up front computes the same
_F32_KEYS = frozenset({"ln1", "ln2", "router", "a_log", "d_skip"})


def _cast_tree(tree: Tree, dtype: torch.dtype) -> Tree:
    if isinstance(tree, dict):
        return {key: sub if key in _F32_KEYS else _cast_tree(sub, dtype)
                for key, sub in tree.items()}
    return tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a,
                    tree)


def compute_cast(tree: Tree, dtype: torch.dtype) -> Tree:
    """A block's params with every floating leaf but the f32 ones
    (norms, the MoE router, Mamba's ``a_log`` / ``d_skip``) cast to
    ``dtype`` (a no-op, no copy, where it already has that dtype),
    outside autograd: what each of a shared layer's applications would
    cast at its matmuls, cast once."""
    with torch.no_grad():
        return _cast_tree(tree, dtype)


class SharedCast(torch.autograd.Function):
    """One application's view of a weight already cast to the compute
    dtype: the forward returns a view of the shared low-precision copy
    (no new memory, and what the application's matmuls save for their
    backward is that one copy), the backward hands the f32 weight its
    cotangent in f32.  Each application is its own node, so the
    ``reps`` cotangents add in f32 at the weight, as the JAX package's
    per-use casts do; one shared cast node would add them in bf16."""

    @staticmethod
    def forward(ctx, w, w_low):
        ctx.dtype = w.dtype
        return w_low.view_as(w_low)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


def shared_application(p32: Tree, p_low: Tree) -> Tree:
    """One application's params: the shared cast copies, each behind its
    own :class:`SharedCast` node when gradients flow to the f32
    weights."""
    def one(w, w_low):
        if w_low is w or not (torch.is_grad_enabled() and w.requires_grad):
            return w_low
        return SharedCast.apply(w, w_low)
    return tree_map(one, p32, p_low)


def lm_specs(cfg: ArchConfig) -> Tree:
    """The full model's parameter specs (an ALBERT-shared stack holds
    ``share_groups`` stacked layers)."""
    d, V, pd = cfg.d_model, cfg.vocab_size, cfg.param_jdtype
    specs: Tree = {
        "embed": ParamSpec((V, d), pd, "embed", ("vocab", "embed")),
        "final_norm": L.norm_specs(cfg),
    }
    if cfg.share_groups:
        if cfg.n_layers % cfg.share_groups:
            raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} not "
                             f"divisible by share_groups="
                             f"{cfg.share_groups}")
        specs["blocks"] = [stack_specs(REGISTRY[_shared_kind(cfg)][0](cfg),
                                       cfg.share_groups)]
    else:
        specs["blocks"] = [stack_specs(REGISTRY[k][0](cfg), n)
                           for k, n in segments(cfg.block_kinds)]
    if not cfg.tie_embeddings:
        specs["head"] = ParamSpec((d, V), pd, "normal", ("embed", "vocab"))
    return specs


def embed(cfg: ArchConfig, params: Tree, tokens: torch.Tensor
          ) -> torch.Tensor:
    x = params["embed"][tokens.long()].to(cfg.compute_jdtype)
    if cfg.scale_embed:
        x = x * (cfg.d_model ** 0.5)
    return x


def head(cfg: ArchConfig, params: Tree, x: torch.Tensor) -> torch.Tensor:
    x = L.apply_norm(cfg, params["final_norm"], x)
    w = (params["embed"].T if cfg.tie_embeddings else params["head"])
    return x @ w.to(x.dtype)


def default_positions(cfg: ArchConfig, batch: int, seq: int, offset=0,
                      device=None) -> torch.Tensor:
    """Prefill positions: ``[S]``, or M-RoPE's text-only ``[3, B, S]``."""
    if cfg.rope == "mrope":
        return rope_lib.default_mrope_positions(batch, seq, offset, device)
    return torch.arange(seq, device=device) + offset


def layer(tree: Tree, i: int) -> Tree:
    """Layer ``i`` of a stacked ``[n, ...]`` tree (views, no copies)."""
    return tree_map(lambda a: a[i], tree)


def n_stacked(tree: Tree) -> int:
    return tree_leaves(tree)[0].shape[0]


def layers(tree: Tree) -> list[Tree]:
    """Every layer of a stacked ``[n, ...]`` tree, as views: one
    ``unbind`` a leaf, whose backward stacks the layers' gradients once.
    (Under autograd ``a[i]`` gives each layer's gradient the size of the
    whole stack, zeros but its own row, and adds ``n`` of them.)"""
    leaves = tree_leaves(tree)
    cols = [a.unbind(0) for a in leaves]
    return [tree_unflatten_like(tree, [c[i] for c in cols])
            for i in range(len(cols[0]))]


def _applied(seg_params: Tree, i: int, reps: int, dtype) -> Tree:
    """Layer ``i``'s params as its applications use them: a layer
    applied ``reps`` > 1 times is cast to the activation dtype once, not
    once per application (the same numbers)."""
    p = layer(seg_params, i)
    return compute_cast(p, dtype) if reps > 1 else p


def remat_mode(remat: bool | str) -> str:
    """``remat`` as JAX's ``lm_apply`` reads it: a mode name, or a bool
    (``True`` -> ``"block"``)."""
    if isinstance(remat, str):
        if remat not in ("none", "block", "2level"):
            raise ValueError(f"remat {remat!r}: want none, block or 2level")
        return remat
    return "block" if remat else "none"


def checkpointed(fn):
    """``fn`` under one non-reentrant activation checkpoint, as
    ``jax.checkpoint`` (nothing saveable): only its tensor arguments are
    kept, and its forward runs again when backward reaches it.  A call
    without autograd runs ``fn`` as it is.  The blocks draw no random
    numbers, so no RNG state is stashed."""
    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return run


def _sqrt_divisor(n: int) -> int:
    n1 = max(1, int(n ** 0.5))
    while n % n1:
        n1 -= 1
    return n1


def remat_scan(steps: list, x, aux, mode: str):
    """Walk ``steps``, one callable ``(x, aux) -> (x, aux)`` a layer
    application, each already checkpointed where ``mode`` asks.
    ``2level`` over at least 4 steps nests them in ``sqrt(n)``
    checkpointed groups (``_sqrt_divisor``): backward then keeps one
    carry a group and recomputes a group's carries from it, each layer
    once more from its own (JAX's ``remat_scan``)."""
    n = len(steps)
    if mode != "2level" or n < 4:
        for step in steps:
            x, aux = step(x, aux)
        return x, aux
    per = n // _sqrt_divisor(n)
    for g in range(0, n, per):
        def group(x, aux, _steps=steps[g:g + per]):
            for step in _steps:
                x, aux = step(x, aux)
            return x, aux
        x, aux = checkpointed(group)(x, aux)
    return x, aux


def _step(cfg: ArchConfig, apply_fn, p: Tree, positions: torch.Tensor,
          p_low: Optional[Tree] = None):
    """One layer application ``(x, aux) -> (x, aux + a)``; ``p_low`` is
    a shared layer's compute-dtype copy, reached through
    :func:`shared_application` (one cast a call, the reps' cotangents
    added in f32)."""
    def step(x, aux):
        w = p if p_low is None else shared_application(p, p_low)
        y, a = apply_fn(cfg, w, x, positions)
        return y, aux + a
    return step


def lm_apply(cfg: ArchConfig, params: Tree, tokens: torch.Tensor,
             positions: Optional[torch.Tensor] = None,
             *, remat: bool | str = True):
    """Training / prefill forward.  tokens [B, S] -> (logits [B, S, V] in
    the compute dtype, aux f32 scalar: the MoE balance loss summed over
    applications).  ``remat``: see the module docstring; a shared
    stack checkpoints each application (``2level`` reads as ``block``
    there, as JAX scans its groups without ``remat_scan``)."""
    mode = remat_mode(remat)
    B, S = tokens.shape
    if positions is None:
        positions = default_positions(cfg, B, S, device=tokens.device)
    x = embed(cfg, params, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    runs, reps = model_runs(cfg)
    for (kind, _), seg in zip(runs, params["blocks"]):
        apply_fn = REGISTRY[kind][1]
        steps = []
        for p in layers(seg):
            p_low = compute_cast(p, x.dtype) if reps > 1 else None
            step = _step(cfg, apply_fn, p, positions, p_low)
            if mode != "none":
                step = checkpointed(step)
            steps += [step] * reps
        x, aux = remat_scan(steps, x, aux, "block" if reps > 1 else mode)
    return head(cfg, params, x), aux


# ------------------------------------------- over a data shard's model shards
def vocab_split(cfg: ArchConfig, table: torch.Tensor, dim: int) -> bool:
    """Does this shard hold a block of the vocabulary (``table``'s
    ``dim``)?"""
    return table.shape[dim] < cfg.vocab_size


def embed_tp(cfg: ArchConfig, ps: list, tokens: torch.Tensor, group
             ) -> torch.Tensor:
    """:func:`embed` over a data shard's model shards (``ps[j]`` shard
    ``j``'s tree): vocab-parallel where the table splits
    (``dist.tensor_parallel.vocab_parallel_embed``, then
    ``scale_embed`` on the sum), else the one-device lookup at home."""
    from repro_torch.dist import tensor_parallel as tp
    if not vocab_split(cfg, ps[0]["embed"], 0):
        with group.scope(0):
            return embed(cfg, ps[0], tokens)
    x = tp.vocab_parallel_embed([p["embed"] for p in ps], tokens, group)
    x = x.to(cfg.compute_jdtype)
    if cfg.scale_embed:
        x = x * (cfg.d_model ** 0.5)
    return x


def head_weight(cfg: ArchConfig, params: Tree) -> torch.Tensor:
    """The LM head ``[d, V]``: the tied embedding's transpose where the
    tree has no head of its own."""
    if cfg.tie_embeddings and "head" not in params:
        return params["embed"].T
    return params["head"]


def head_tp(cfg: ArchConfig, ps: list, x: torch.Tensor, group):
    """:func:`head` over a data shard's model shards: ``[B, S, V / m]``
    logits on each shard (final norm on the shard's copy of ``x``, its
    block of the head or of the tied table), or None where the vocab
    does not split (the caller runs the one-device head at home)."""
    from repro_torch.dist import tensor_parallel as tp
    if not vocab_split(cfg, head_weight(cfg, ps[0]), 1):
        return None
    xs = tp.fanout(x, group)
    return group.per_shard(
        lambda j, p, xj: L.apply_norm(cfg, p["final_norm"], xj)
        @ head_weight(cfg, p).to(xj.dtype), ps, xs)


def lm_apply_tp(cfg: ArchConfig, ps: list, group, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                *, remat: bool | str = True):
    """:func:`lm_apply` over a data shard's model shards, up to the
    final hidden state (the head and loss are vocab-parallel:
    :func:`head_tp`): ``(x [B, S, d] at home, aux)``.  Every layer kind
    must be in ``models.blocks.TP_APPLY``; ``remat`` checkpoints as
    :func:`lm_apply` does, each checkpoint spanning the layer's work on
    every shard."""
    from repro_torch.models.blocks import TP_APPLY
    mode = remat_mode(remat)
    B, S = tokens.shape
    if positions is None:
        positions = default_positions(cfg, B, S, device=tokens.device)
    x = embed_tp(cfg, ps, tokens, group)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    runs, reps = model_runs(cfg)
    for r, (kind, _) in enumerate(runs):
        apply_fn = TP_APPLY[kind]
        steps = []
        for lp in zip(*(layers(p["blocks"][r]) for p in ps)):
            lows = [compute_cast(p, x.dtype) if reps > 1 else None
                    for p in lp]

            def step(x, aux, _lp=lp, _lows=lows):
                w = [p if low is None else shared_application(p, low)
                     for p, low in zip(_lp, _lows)]
                y, a = apply_fn(cfg, w, x, positions, group)
                return y, aux + a
            if mode != "none":
                step = checkpointed(step)
            steps += [step] * reps
        x, aux = remat_scan(steps, x, aux, "block" if reps > 1 else mode)
    return x, aux


def prefill_runs(cfg: ArchConfig, runs, blocks: list, x: torch.Tensor,
                 positions: torch.Tensor, cache_len: int, reps: int = 1):
    """Walk ``runs`` of stacked blocks over ``x`` (each layer applied
    ``reps`` times), emitting each run's decode caches stacked
    ``[n * reps, ...]`` group-major — shared by ``lm_prefill`` and the
    staged session programs."""
    caches = []
    for (kind, _), seg_params in zip(runs, blocks):
        prefill_fn = REGISTRY[kind][4]
        cs = []
        for i in range(n_stacked(seg_params)):
            p = _applied(seg_params, i, reps, x.dtype)
            for _ in range(reps):
                x, _, c = prefill_fn(cfg, p, x, positions, cache_len)
                cs.append(c)
        caches.append(tree_map(lambda *a: torch.stack(a), cs[0], *cs[1:]))
    return x, caches


def lm_cache_specs(cfg: ArchConfig, batch: int, seq: int) -> Tree:
    """Decode-cache specs, one stacked tree a run (an ALBERT-shared stack:
    one cache per application, ``n_layers`` rows)."""
    if cfg.share_groups:
        kind = _shared_kind(cfg)
        return [stack_specs(REGISTRY[kind][3](cfg, batch, seq),
                            cfg.n_layers)]
    return [stack_specs(REGISTRY[k][3](cfg, batch, seq), n)
            for k, n in segments(cfg.block_kinds)]


def decode_runs(cfg: ArchConfig, runs, blocks: list, caches: list,
                x: torch.Tensor, pos: int, positions: torch.Tensor,
                reps: int = 1):
    """One-token walk of ``runs``; each application writes its cache row
    (``i * reps + r``) in place through a view of the stacked cache, so
    the stacked caches are returned as they came."""
    for (kind, _), seg_params, seg_cache in zip(runs, blocks, caches):
        decode_fn = REGISTRY[kind][2]
        for i in range(n_stacked(seg_params)):
            p = _applied(seg_params, i, reps, x.dtype)
            for r in range(reps):
                x, _ = decode_fn(cfg, p, x, layer(seg_cache, i * reps + r),
                                 pos, positions)
    return x, caches


def lm_prefill(cfg: ArchConfig, params: Tree, tokens: torch.Tensor,
               positions: Optional[torch.Tensor] = None,
               *, cache_len: Optional[int] = None, remat: bool = True,
               last_only: bool = True):
    """Prefill: forward pass + decode-cache emission.  Returns (logits
    [B,S|1,V], caches); caches hand off to ``lm_decode_step`` at
    ``pos = S``."""
    del remat
    B, S = tokens.shape
    cache_len = cache_len or S
    if positions is None:
        positions = default_positions(cfg, B, S, device=tokens.device)
    x = embed(cfg, params, tokens)
    runs, reps = model_runs(cfg)
    x, caches = prefill_runs(cfg, runs, params["blocks"], x, positions,
                             cache_len, reps)
    if last_only:
        x = x[:, -1:]
    return head(cfg, params, x), caches


def decode_positions(cfg: ArchConfig, batch: int, pos: int,
                     device) -> torch.Tensor:
    """One decode step's positions: ``[B, 1]``, or ``[3, B, 1]``
    (M-RoPE)."""
    shape = (3, batch, 1) if cfg.rope == "mrope" else (batch, 1)
    return torch.full(shape, pos, dtype=torch.int64, device=device)


def lm_decode_step(cfg: ArchConfig, params: Tree, token: torch.Tensor,
                   caches: Tree, pos: int,
                   positions: Optional[torch.Tensor] = None):
    """One-token decode. token [B,1] -> (logits [B,1,V], caches updated
    in place)."""
    B = token.shape[0]
    if positions is None:
        positions = decode_positions(cfg, B, pos, token.device)
    x = embed(cfg, params, token)
    runs, reps = model_runs(cfg)
    x, caches = decode_runs(cfg, runs, params["blocks"], caches, x, pos,
                            positions, reps)
    return head(cfg, params, x), caches


def head_blocks_tp(cfg: ArchConfig, ps: list, x: torch.Tensor, group
                   ) -> list:
    """The logits of ``x`` as its vocab blocks, one a model shard
    (:func:`head_tp`), or ``[logits]`` at home where the vocab does not
    split."""
    parts = head_tp(cfg, ps, x, group)
    if parts is None:
        with group.scope(0):
            parts = [head(cfg, ps[0], x)]
    return parts


def _into(stack: Optional[Tree], c: Tree, k: int, rows: int) -> Tree:
    """Layer cache ``c`` written into row ``k`` of ``stack`` (``[rows,
    ...]``, allocated at the first row): a run's caches stacked as its
    layers emit them, without holding every layer's beside the stack."""
    if stack is None:
        stack = tree_map(lambda a: a.new_empty((rows,) + tuple(a.shape)),
                         c)
    tree_map(lambda s, a: s[k].copy_(a), stack, c)
    return stack


def _run_layers(pss: list, groups: list, r: int, reps: int, dtype):
    """Run ``r``'s layers over every data shard's model shards, one at a
    time: ``[i][j]`` the layer's params as data shard ``i``'s model
    shard ``j`` applies them (cast once where applied ``reps`` > 1
    times, as :func:`_applied`)."""
    per = [[layers(p["blocks"][r]) for p in ps] for ps in pss]
    for l in range(len(per[0][0])):
        yield [g.per_shard(
            lambda j, ls: compute_cast(ls[l], dtype) if reps > 1 else ls[l],
            row) for g, row in zip(groups, per)]


def lm_prefill_tp(cfg: ArchConfig, pss: list, groups: list, tokens: list,
                  positions: Optional[list] = None, *,
                  cache_len: Optional[int] = None, last_only: bool = True):
    """:func:`lm_prefill` over the data shards of one batch (row order),
    each over its model shards (``dist.tensor_parallel``): ``pss[i][j]``
    data shard ``i``'s model shard ``j``'s tree, ``groups[i]`` its
    group, ``tokens[i]`` / ``positions[i]`` its rows at its home.
    Returns ``(logits, caches)``: ``logits[i]`` data shard ``i``'s
    logits of its last position (``last_only``, cut before the head) or
    of every position, as :func:`head_blocks_tp`'s blocks;
    ``caches[i][j]`` one stacked tree a run, model shard ``j``'s block
    or copy of each layer's cache (``models.blocks``' serving halves).
    A MoE layer's data shards route as the whole batch would.  Every
    layer kind must be in ``models.blocks.TP_PREFILL``."""
    from repro_torch.models.blocks import prefill_lockstep_tp
    S = tokens[0].shape[1]
    cache_len = cache_len or S
    positions = [default_positions(cfg, t.shape[0], S, device=t.device)
                 if p is None else p
                 for t, p in zip(tokens, positions or [None] * len(tokens))]
    xs = [embed_tp(cfg, ps, t, g) for ps, t, g in zip(pss, tokens, groups)]
    runs, reps = model_runs(cfg)
    caches = [[[] for _ in g.devs] for g in groups]
    for r, (kind, n) in enumerate(runs):
        stacks = [[None] * g.m for g in groups]
        k = 0
        for lp in _run_layers(pss, groups, r, reps, xs[0].dtype):
            for _ in range(reps):
                xs, _, c = prefill_lockstep_tp(cfg, kind, lp, xs, positions,
                                               cache_len, groups)
                for i, g in enumerate(groups):
                    stacks[i] = g.per_shard(
                        lambda j, st, cj: _into(st, cj, k, n * reps),
                        stacks[i], c[i])
                del c
                k += 1
        for i, row in enumerate(stacks):
            for j, st in enumerate(row):
                caches[i][j].append(st)
    out = []
    for ps, x, g in zip(pss, xs, groups):
        if last_only:
            with g.scope(0):
                x = x[:, -1:]
        out.append(head_blocks_tp(cfg, ps, x, g))
    return out, caches


def lm_decode_step_tp(cfg: ArchConfig, pss: list, groups: list,
                      tokens: list, caches: list, pos: int,
                      positions: Optional[list] = None):
    """:func:`lm_decode_step` over the data shards of one batch, each
    over its model shards, as :func:`lm_prefill_tp` takes them:
    ``caches[i][j]`` data shard ``i``'s model shard ``j``'s caches (its
    blocks or copies), written in place.  Returns ``(logits, caches)``,
    ``logits[i]`` as :func:`head_blocks_tp`'s blocks."""
    from repro_torch.models.blocks import decode_lockstep_tp
    positions = [decode_positions(cfg, t.shape[0], pos, t.device)
                 if p is None else p
                 for t, p in zip(tokens, positions or [None] * len(tokens))]
    xs = [embed_tp(cfg, ps, t, g) for ps, t, g in zip(pss, tokens, groups)]
    runs, reps = model_runs(cfg)
    for r, (kind, _) in enumerate(runs):
        for l, lp in enumerate(_run_layers(pss, groups, r, reps,
                                           xs[0].dtype)):
            for rr in range(reps):
                cl = [[layer(c[r], l * reps + rr) for c in row]
                      for row in caches]
                xs = decode_lockstep_tp(cfg, kind, lp, xs, cl, pos,
                                        positions, groups)
    return [head_blocks_tp(cfg, ps, x, g)
            for ps, x, g in zip(pss, xs, groups)], caches
