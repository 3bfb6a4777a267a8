"""Partition an ArchConfig into SWARM pipeline stages: the stage
programs (port of ``repro.runtime.stage_model``).

Stage 0 owns the embedding, the last stage the final norm + LM head +
loss (the paper's §4.3 placement).  Backward runs by activation
checkpointing: a stage's ``bwd`` recomputes its forward from the
boundary input it is handed, under autograd, so backward can be
re-routed to *any* peer of the stage after a failure (App. A).

Under a learned boundary codec (``"bottleneck"`` / ``"maxout"``, paper
App. J) each stage program *includes* its side of the codec: a sending
stage encodes its output (owning ``w_c`` for the bottleneck), a
receiving stage decodes its input (owning ``w_d``) — so the tensor a
trainer carries between peers IS the c-dim wire tensor, and codec
gradients arrive through the ordinary per-stage ``bwd``.  ``"int8"``
stays outside the programs (the executor round-trips the wire tensor).

The per-stage layer math is :func:`make_block_core` (the stage core of
``repro.dist.pipeline.make_block_core``): ``reps > 1`` re-applies each
layer (ALBERT-style sharing), with the layer's weights cast to the
compute dtype once per stage call, outside the ``reps`` loop — under
autograd a cast inside it would save one copy per application.

Every program takes the data shards of one microbatch as lists, a shard
an entry (``fwd_shards`` / ``bwd_shards``; ``fwd`` / ``bwd`` are the
one-shard call, the microbatch whole).  The shards run layer by layer
in lockstep, so a MoE layer routes over the whole microbatch as JAX's
jitted program does with the batch sharded over ``data`` (its capacity,
slots and route counts: ``models.layers.MoESplit``); such a program has
``routes_whole`` set, and a caller hands it all of a microbatch's shards
in one call.  Any other program's shards are independent, and a caller
hands it one at a time.

:func:`build_span_program` fuses a contiguous span ``[lo, hi)`` of
stages into one program (the
:class:`repro_torch.runtime.pipeline.PipelineExecutor` backend): the
covered stages' forwards chain on the device, so an intra-span boundary
never crosses the host, while a learned codec's encode/decode pair still
runs inside it and every covered stage computes what its single-stage
program computes.  Serving runs the session programs of
:mod:`repro_torch.serve.programs` over the per-stage trees cut by
:func:`split_lm_params`.

An encoder-decoder config (whisper) plans stage 0 as the encoder pod and
splits the decoder over the other stages; its boundaries are trees
(``{"audio", "tok"}`` into stage 0, ``{"enc", "tok"}`` out of it,
``{"x", "enc", "tok"}`` between decoder stages) whose integer token ids
ride along and never take a gradient, so ``bwd``'s ``gx`` is the tree of
the floating inputs' cotangents.  Learned codecs are refused there, as
the JAX package refuses them; :func:`split_whisper_params` cuts a full
whisper tree into stage trees.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.compression import codecs
from repro_torch.models.config import ArchConfig
from repro_torch.models.stage_plan import get_stage_plan
from repro_torch.models import params as P
from repro_torch.models import layers as L
from repro_torch.models import model as model_lib
from repro_torch.models.blocks import MOE_PRE, REGISTRY, TP_APPLY, \
    apply_lockstep, apply_lockstep_tp
from repro_torch.dist.tensor_parallel import ModelShards
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like

Tree = Any


class _OneShard:
    """``fwd`` / ``bwd``: a program's call on one data shard."""

    def fwd(self, params, inp, labels=None):
        return self.fwd_shards([params], [inp], [labels])[0]

    def bwd(self, params, inp, dy_or_labels):
        return next(self.bwd_shards([params], [inp], [dy_or_labels]))


@dataclasses.dataclass
class StageProgram(_OneShard):
    """``fwd_shards(ps, inps, labels=None)`` runs under
    ``torch.no_grad()`` and returns each shard's output (the token-sum
    loss on the last stage); ``bwd_shards(ps, inps, dys_or_labels)``
    recomputes the shards under autograd and yields each shard's ``(gx,
    gp)`` in row order (``(loss, gx, gp)`` on the last stage), dropping
    its entries of ``ps`` once they are used."""
    stage: int
    n_stages: int
    specs: Tree
    fwd_shards: Callable          # no_grad forward
    bwd_shards: Callable          # recompute + autograd backward
    fwd_flops_per_token: float
    bwd_flops_per_token: float    # includes checkpoint recompute
    routes_whole: bool = False    # MoE: a microbatch's shards in one call


@dataclasses.dataclass
class SpanProgram(_OneShard):
    """A contiguous span ``[lo, hi)`` of stages fused into one program.

    A shard's params are a tuple of per-stage param trees (ordered
    ``lo..hi-1``, each shaped like that stage's :class:`StageProgram`
    specs), so a span peer's state stays per-stage-keyed: checkpoint
    cuts, downloads and span split/merge hand-offs move single-stage
    snapshots.  ``bwd_shards`` yields the per-stage gradients as a
    tuple in the same order; otherwise the calls are
    :class:`StageProgram`'s."""
    span: tuple[int, int]
    n_stages: int
    specs: dict[int, Tree]        # per covered stage, keyed by global id
    fwd_shards: Callable          # no_grad forward
    bwd_shards: Callable          # recompute + autograd backward
    fwd_flops_per_token: float    # whole-span totals
    bwd_flops_per_token: float
    routes_whole: bool = False    # as StageProgram's

    @property
    def stages(self) -> range:
        return range(*self.span)


def _stage_runs(cfg: ArchConfig, s: int, n_stages: int):
    """(kinds, [per-run (kind, count)], reps) for one stage, read off the
    canonical :class:`~repro_torch.models.stage_plan.StagePlan`."""
    spec = get_stage_plan(cfg, n_stages).stages[s]
    return spec.kinds, list(spec.runs), spec.reps


def _stage_specs(cfg: ArchConfig, s: int, n_stages: int,
                 comp: str = "none", learned: bool = False) -> Tree:
    """One stage's ParamSpec tree: blocks + edge extras (embed / head) +
    its side(s) of the learned boundary codec."""
    _, runs, _ = _stage_runs(cfg, s, n_stages)
    specs: Tree = {"blocks": [
        model_lib.stack_specs(REGISTRY[k][0](cfg), n) for k, n in runs]}
    if s == 0:
        specs["embed"] = P.ParamSpec(
            (cfg.vocab_size, cfg.d_model), cfg.param_jdtype, "embed",
            ("vocab", "embed"))
    if s == n_stages - 1:
        specs["final_norm"] = L.norm_specs(cfg)
        if not cfg.tie_embeddings or s != 0:
            specs["head"] = P.ParamSpec(
                (cfg.d_model, cfg.vocab_size), cfg.param_jdtype,
                "normal", ("embed", "vocab"))
    if learned:
        # receiving side (w_d) for s > 0, sending side (w_c) for
        # s < S-1; maxout's compress is param-free so its stage-0
        # "boundary" tree is empty and omitted
        bnd: Tree = {}
        if s > 0:
            bnd.update(codecs.receiver_specs(cfg, comp))
        if s < n_stages - 1:
            bnd.update(codecs.sender_specs(cfg, comp))
        if bnd:
            specs["boundary"] = bnd
    return specs


def make_block_core(cfg: ArchConfig, runs: list[tuple[str, int]],
                    reps: int = 1) -> Callable:
    """The stage core: walk ``runs`` of stacked layer params over the data
    shards of one microbatch, ``(blocks, xs, positions) -> xs`` (lists a
    shard, row order; one entry where the microbatch runs whole).  A
    shard's ``blocks`` is one stage's ``[tree-per-run]`` list (leaves
    stacked ``[count, ...]``).  The shards go layer by layer in lockstep
    (:func:`repro_torch.models.blocks.apply_lockstep`: a MoE layer
    routes over all of them).  ``reps > 1`` re-applies each layer
    (ALBERT-style sharing, paper §4.3).  Each layer's weights are cast
    to the compute dtype once, outside the ``reps`` loop: under autograd
    one cast copy per application would be saved for backward (16 x 537
    MB per swarm-1b stage); the applications share one copy and add
    their weight cotangents in f32
    (:class:`repro_torch.models.model.SharedCast`, as ``lm_apply``
    does)."""
    def block_fn(blocks: list, xs: list, positions: list) -> list:
        for r, (kind, _) in enumerate(runs):
            for ps in zip(*(model_lib.layers(b[r]) for b in blocks)):
                lows = [model_lib.compute_cast(p32, x.dtype)
                        for p32, x in zip(ps, xs)]
                for _ in range(reps):
                    xs, _auxs = apply_lockstep(
                        cfg, kind, [model_lib.shared_application(p32, low)
                                    for p32, low in zip(ps, lows)],
                        xs, positions)
        return xs

    return block_fn


def make_block_core_tp(cfg: ArchConfig, runs: list[tuple[str, int]],
                       reps: int = 1) -> Callable:
    """:func:`make_block_core` over the model shards of a microbatch's
    data shards, ``(blocks, xs, positions, groups) -> xs``:
    ``blocks[i][j]`` data shard ``i``'s model shard ``j``'s
    ``[tree-per-run]`` list, ``xs[i]`` its residual stream at home,
    ``groups[i]`` its group.  The data shards go layer by layer in
    lockstep (:func:`repro_torch.models.blocks.apply_lockstep_tp`: a MoE
    layer routes over all of them).  Each shard casts its block of a
    layer once a call, outside the ``reps`` loop, as
    :func:`make_block_core` does."""
    def block_fn(blocks: list, xs: list, positions: list,
                 groups: list) -> list:
        for r, (kind, _) in enumerate(runs):
            per_data = [list(zip(*(model_lib.layers(b[r]) for b in bs)))
                        for bs in blocks]
            for lps in zip(*per_data):
                lows = [g.per_shard(
                    lambda j, p, _dt=x.dtype: model_lib.compute_cast(p, _dt),
                    ps) for ps, g, x in zip(lps, groups, xs)]
                for _ in range(reps):
                    xs, _auxs = apply_lockstep_tp(
                        cfg, kind, [[model_lib.shared_application(p32, low)
                                     for p32, low in zip(ps, lw)]
                                    for ps, lw in zip(lps, lows)],
                        xs, positions, groups)
        return xs

    return block_fn


def _routes_whole(cfg: ArchConfig, n_stages: int, stages) -> bool:
    """Does one of these stages route over the whole microbatch (MoE)?"""
    return any(k in MOE_PRE for s in stages
               for k in _stage_runs(cfg, s, n_stages)[0])


def _make_stage_fwd(cfg: ArchConfig, s: int, n_stages: int, comp: str,
                    learned: bool) -> Callable:
    """Stage ``s``'s wire-to-wire forward over the data shards of one
    microbatch, ``(ps, inps) -> ys`` (lists a shard): decode each
    inbound wire tensor (embed for stage 0), run the stage's layers
    through the block core, emit the outbound wire tensors (hidden for
    the last stage — the head/loss is applied by the caller)."""
    _, runs, reps = _stage_runs(cfg, s, n_stages)
    core = make_block_core(cfg, runs, reps)
    is_first, is_last = s == 0, s == n_stages - 1

    def enter(params: Tree, inp: torch.Tensor, ms=None) -> torch.Tensor:
        if cfg.rope == "mrope":
            raise NotImplementedError(
                f"{cfg.name}: M-RoPE stage programs are refused.  The JAX "
                "package's stage programs pass 1-D positions (arange) to "
                "apply_mrope, which needs [3, B, S] and raises, so the "
                "reference trains no M-RoPE config through SWARM stages "
                "(ROADMAP queue 3); serve it through ServeRunner instead")
        if is_first:
            if ms is not None:
                return model_lib.embed_tp(cfg, ms.trees, inp, ms.group)
            return model_lib.embed(cfg, params, inp)
        x = inp.to(cfg.compute_jdtype)
        if learned:          # wire tensor arrives c-dim: restore
            x = codecs.decode_wire(cfg, comp, params.get("boundary"), x)
        return x

    def leave(params: Tree, x: torch.Tensor) -> torch.Tensor:
        if learned and not is_last:    # emit the c-dim wire tensor
            x = codecs.encode_wire(cfg, comp, params.get("boundary"), x)
        return x

    core_tp = make_block_core_tp(cfg, runs, reps) if \
        set(k for k, _ in runs) <= set(TP_APPLY) else None

    def tp_fwd(mss: list, inps: list) -> list:
        """The data shards over their model shards: the learned codec at
        each home, on its whole weights."""
        xs = []
        for ms, inp in zip(mss, inps):
            with ms.group.scope(0):
                xs.append(enter(ms.trees[0], inp, ms))
        xs = core_tp([[t["blocks"] for t in ms.trees] for ms in mss], xs,
                     [torch.arange(x.shape[1], device=x.device) for x in xs],
                     [ms.group for ms in mss])
        out = []
        for ms, x in zip(mss, xs):
            with ms.group.scope(0):
                out.append(leave(ms.trees[0], x))
        return out

    def stage_fwd(ps: list, inps: list) -> list:
        if isinstance(ps[0], ModelShards):
            return tp_fwd(ps, inps)
        xs = [enter(p, i) for p, i in zip(ps, inps)]
        pos = [torch.arange(x.shape[1], device=x.device) for x in xs]
        xs = core([p["blocks"] for p in ps], xs, pos)
        return [leave(p, x) for p, x in zip(ps, xs)]

    return stage_fwd


def _head_logits(cfg: ArchConfig, params: Tree, x: torch.Tensor
                 ) -> torch.Tensor:
    """Final norm + LM head, f32 logits — the last stage's extra
    ownership, shared by the training loss and the serving session
    programs."""
    x = L.apply_norm(cfg, params["final_norm"], x)
    w = (params["embed"].T if cfg.tie_embeddings and "head" not in
         params else params["head"])
    return (x @ w.to(x.dtype)).to(torch.float32)


def _head_loss(cfg: ArchConfig, params: Tree, x: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """Logits + token-sum CE (so microbatch gradients add exactly,
    App. E); over a data shard's model shards (:class:`ModelShards`)
    vocab-parallel where the head splits, else the one-device head at
    home."""
    if isinstance(params, ModelShards):
        from repro_torch.dist import tensor_parallel as tp
        parts = model_lib.head_tp(cfg, params.trees, x, params.group)
        if parts is not None:
            return tp.vocab_parallel_nll(parts, labels, params.group).sum()
        with params.group.scope(0):
            return _head_loss(cfg, params.trees[0], x, labels)
    logits = _head_logits(cfg, params, x)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (lse - gold).sum()


def _stage_fwd_flops(cfg: ArchConfig, s: int, n_stages: int, seq_len: int,
                     comp: str, learned: bool) -> float:
    is_first, is_last = s == 0, s == n_stages - 1
    codec_f = codecs.codec_flops_per_token(
        cfg, comp, sender=learned and not is_last,
        receiver=learned and not is_first)
    return get_stage_plan(cfg, n_stages).stage_flops(s, seq_len) + codec_f


def _tree_of(params) -> Tree:
    """A param tree; a :class:`ModelShards`' list of shard trees."""
    return params.trees if isinstance(params, ModelShards) else params


def _grad_leaves(params: Tree) -> list[torch.Tensor]:
    """The floating leaves of ``params`` as fresh autograd leaves
    (detached views: no copy)."""
    return [a.detach().requires_grad_() for a in tree_leaves(
        _tree_of(params))]


def _fresh_params(params, leaves: list):
    """``params`` rebuilt over its fresh ``leaves``."""
    tree = tree_unflatten_like(_tree_of(params), leaves)
    if isinstance(params, ModelShards):
        return ModelShards(tree, params.group)
    return tree


def _grads_like(params: Tree, leaves: list, grads) -> Tree:
    """Rebuild the gradient tree; a leaf the loss does not reach gets
    zeros (JAX's vjp returns zeros there too).  Over model shards: the
    list of each shard's gradient tree, on its own device."""
    return tree_unflatten_like(_tree_of(params), [
        torch.zeros_like(a) if g is None else g
        for a, g in zip(leaves, grads)])


def _per_stage(ps, n: int):
    """A span shard's per-stage params: its tuple, or over model shards
    one :class:`ModelShards` a stage."""
    if isinstance(ps, ModelShards):
        return [ps.sub(i) for i in range(n)]
    return ps


# --------------------------------------------------- encoder-decoder stages
# whisper boundary payloads are trees; these keys are integer leaves
# (token ids) that ride the wire but never take gradients — the stage
# programs split them out, so every autograd.grad runs over floating
# inputs only
_INT_KEYS = ("tok",)


def _split_payload(inp: Tree) -> tuple[Tree, Tree]:
    floats = {k: v for k, v in inp.items() if k not in _INT_KEYS}
    ints = {k: v for k, v in inp.items() if k in _INT_KEYS}
    return floats, ints


def _cast_like(dy: Tree, y: Tree) -> Tree:
    """A boundary cotangent tree cast leaf by leaf to the forward
    output's dtypes."""
    return {k: dy[k].to(y[k].dtype) for k in y}


def _stage_specs_encdec(cfg: ArchConfig, s: int, n_stages: int) -> Tree:
    """Whisper stage specs: stage 0 is the encoder pod, stages
    ``1..n_stages-1`` split the decoder; stage 1 owns the token embed,
    the last stage the final norm + head (plan ownership)."""
    from repro_torch.models import whisper as W
    if s == 0:
        return {"enc_blocks": model_lib.stack_specs(
                    W.enc_block_specs(cfg), cfg.encoder_layers),
                "enc_norm": L.norm_specs(cfg)}
    per = cfg.n_layers // (n_stages - 1)
    specs: Tree = {"dec_blocks": model_lib.stack_specs(
        W.dec_block_specs(cfg), per)}
    if s == 1:
        specs["embed"] = P.ParamSpec(
            (cfg.vocab_size, cfg.d_model), cfg.param_jdtype, "embed",
            ("vocab", "embed"))
    if s == n_stages - 1:
        specs["final_norm"] = L.norm_specs(cfg)
        specs["head"] = P.ParamSpec(
            (cfg.d_model, cfg.vocab_size), cfg.param_jdtype, "normal",
            ("embed", "vocab"))
    return specs


def _make_stage_core_encdec(cfg: ArchConfig, s: int, n_stages: int
                            ) -> Callable:
    """Stage ``s``'s float-to-float core: ``(params, floats, ints) ->
    out_floats``.  Integer token ids ride the boundary tree untouched,
    so cross-attention gradients flow stage to stage through purely
    floating cotangent trees: boundary 0 ships ``{"enc"}``, interior
    boundaries ``{"x", "enc"}`` — the encoder pod hand-off sits exactly
    at the cross-attention boundary.  A decoder stage returns ``enc``
    beside ``x``: its cotangent is the pass-through plus the
    cross-attention's contribution in every later decoder stage."""
    from repro_torch.models import whisper as W
    is_enc, first_dec = s == 0, s == 1
    is_last = s == n_stages - 1

    def core(params: Tree, floats: Tree, ints: Tree) -> Tree:
        if is_enc:
            return {"enc": W.encode(cfg, params, floats["audio"],
                                    remat=False)}
        enc = floats["enc"].to(cfg.compute_jdtype)
        if first_dec:
            x = W.embed_tokens(cfg, params["embed"], ints["tok"])
        else:
            x = floats["x"].to(cfg.compute_jdtype)
        x = W.dec_scan(cfg, params["dec_blocks"], x, enc,
                       torch.arange(x.shape[1], device=x.device),
                       remat=False)
        return {"x": x} if is_last else {"x": x, "enc": enc}

    return core


def _fresh(floats: Tree) -> Tree:
    """Floating boundary leaves as fresh autograd leaves (detached views:
    no copy)."""
    return {k: v.detach().requires_grad_() for k, v in floats.items()}


def _encdec_grads(out, seed, leaves: list, fin: Optional[Tree], params):
    """One stage's ``torch.autograd.grad``: ``out`` a loss (``seed``
    None) or an output tree seeded leaf by leaf by ``seed`` (cast to
    the output's dtypes); gradients for the param ``leaves`` and the
    floating inputs ``fin`` (None on the encoder pod, whose audio takes
    none).  Returns (gx tree or None, gp tree)."""
    if seed is None:
        outs, seeds = [out], None
    else:
        keys = sorted(out)
        cast = _cast_like(seed, out)
        outs, seeds = [out[k] for k in keys], [cast[k] for k in keys]
    fkeys = [] if fin is None else sorted(fin)
    grads = torch.autograd.grad(outs, leaves + [fin[k] for k in fkeys],
                                seeds, allow_unused=True)
    gp = _grads_like(params, leaves, grads[:len(leaves)])
    if fin is None:
        return None, gp
    gx = {k: torch.zeros_like(fin[k]) if g is None else g
          for k, g in zip(fkeys, grads[len(leaves):])}
    return gx, gp


def _build_stage_programs_encdec(cfg: ArchConfig, n_stages: int,
                                 seq_len: int) -> list[StageProgram]:
    """The encoder-decoder stage programs, framed as the LM ones: ``fwd``
    under ``torch.no_grad()`` returns the outbound tree with the token
    ids riding along (the token-sum loss on the last stage); ``bwd``
    recomputes the stage under autograd and returns ``(gx, gp)``
    (``(loss, gx, gp)`` on the last stage), ``gx`` the floating inputs'
    cotangent tree, None on the encoder pod."""
    programs = []
    for s in range(n_stages):
        specs = _stage_specs_encdec(cfg, s, n_stages)
        core = _make_stage_core_encdec(cfg, s, n_stages)
        is_enc, is_last = s == 0, s == n_stages - 1

        def fwd(params, inp, labels=None, _c=core, _last=is_last):
            floats, ints = _split_payload(inp)
            with torch.no_grad():
                y = _c(params, floats, ints)
                if _last:
                    return _head_loss(cfg, params, y["x"], labels)
                return {**y, **ints}

        def bwd(params, inp, dy_or_labels, _c=core, _enc=is_enc,
                _last=is_last):
            floats, ints = _split_payload(inp)
            leaves = _grad_leaves(params)
            fin = None if _enc else _fresh(floats)
            with torch.enable_grad():
                p = tree_unflatten_like(params, leaves)
                y = _c(p, floats if _enc else fin, ints)
                if _last:
                    out, seed = _head_loss(cfg, p, y["x"], dy_or_labels), None
                else:
                    out, seed = y, _split_payload(dy_or_labels)[0]
                gx, gp = _encdec_grads(out, seed, leaves, fin, params)
            if _last:
                return out.detach(), gx, gp
            return gx, gp

        fwd_f = _stage_fwd_flops(cfg, s, n_stages, seq_len, "none", False)
        programs.append(StageProgram(
            s, n_stages, specs, *_shard_by_shard(fwd, bwd),
            fwd_flops_per_token=fwd_f, bwd_flops_per_token=3.0 * fwd_f))
    return programs


def _shard_by_shard(fwd: Callable, bwd: Callable) -> tuple:
    """``(fwd_shards, bwd_shards)`` of a program whose shards are
    independent (no MoE), from its one-shard ``fwd`` / ``bwd``."""
    def fwd_shards(ps, inps, labels=None):
        labels = labels or [None] * len(inps)
        return [fwd(p, x, lab) for p, x, lab in zip(ps, inps, labels)]

    def bwd_shards(ps, inps, dys_or_labels):
        for j, (x, d) in enumerate(zip(inps, dys_or_labels)):
            p, ps[j] = ps[j], None
            yield bwd(p, x, d)
    return fwd_shards, bwd_shards


def _build_span_encdec(cfg: ArchConfig, n_stages: int, seq_len: int,
                       span: tuple[int, int]) -> SpanProgram:
    """The encoder-decoder span program: the covered stages' cores
    chained on the device, the token ids riding along; ``bwd`` keeps
    the LM span's contract — one ``torch.autograd.grad`` per covered
    stage over detached intra-span boundary trees, bit-equal to the
    chain of single-stage programs on one device."""
    lo, hi = span
    stages = range(lo, hi)
    covers_last = hi == n_stages
    specs = {s: _stage_specs_encdec(cfg, s, n_stages) for s in stages}
    cores = [_make_stage_core_encdec(cfg, s, n_stages) for s in stages]

    def fwd(ps, inp, labels=None):
        cur, ints = _split_payload(inp)
        with torch.no_grad():
            for core, p in zip(cores, ps):
                cur = core(p, cur, ints)
            if covers_last:
                return _head_loss(cfg, ps[-1], cur["x"], labels)
            return {**cur, **ints}

    def bwd(ps, inp, dy_or_labels):
        cur, ints = _split_payload(inp)
        leaves = [_grad_leaves(p) for p in ps]
        trees = [tree_unflatten_like(p, lv) for p, lv in zip(ps, leaves)]
        ins, outs = [], []
        gps: list = [None] * len(ps)
        loss = None
        with torch.enable_grad():
            for s, core, p in zip(stages, cores, trees):
                fin = None if s == 0 else _fresh(cur)
                ins.append(fin)
                cur = core(p, cur if fin is None else fin, ints)
                outs.append(cur)
            if covers_last:
                loss = _head_loss(cfg, trees[-1], outs[-1]["x"],
                                  dy_or_labels)
            gx = None if covers_last else _split_payload(dy_or_labels)[0]
            for i in reversed(range(len(ps))):
                if covers_last and i == len(ps) - 1:
                    out, seed = loss, None
                else:
                    out, seed = outs[i], gx
                gx, gps[i] = _encdec_grads(out, seed, leaves[i], ins[i],
                                           ps[i])
        if covers_last:
            return loss.detach(), gx, tuple(gps)
        return gx, tuple(gps)

    fwd_f = sum(_stage_fwd_flops(cfg, s, n_stages, seq_len, "none", False)
                for s in stages)
    return SpanProgram((lo, hi), n_stages, specs,
                       *_shard_by_shard(fwd, bwd),
                       fwd_flops_per_token=fwd_f,
                       bwd_flops_per_token=3.0 * fwd_f)


def build_stage_programs(cfg: ArchConfig, n_stages: int, seq_len: int,
                         compress: Optional[str] = None
                         ) -> list[StageProgram]:
    """Per-stage programs for the elastic path.  ``fwd`` runs under
    ``torch.no_grad()`` (the last stage's returns the token-sum loss);
    ``bwd`` recomputes the stage from its boundary input under autograd
    and returns ``(gx, gp)`` as ``jax.vjp`` does (``(loss, gx, gp)`` on
    the last stage; ``gx`` is None on stage 0); ``fwd_shards`` /
    ``bwd_shards`` do the same over a microbatch's data shards."""
    get_stage_plan(cfg, n_stages)      # validates the split (ValueError)
    comp = codecs.resolve_mode(cfg, compress)
    learned = comp in codecs.LEARNED and n_stages > 1
    if cfg.encoder_layers:
        if learned:
            raise NotImplementedError(
                "learned boundary codecs are unsupported for "
                "encoder-decoder stage programs (tree-valued boundaries)")
        return _build_stage_programs_encdec(cfg, n_stages, seq_len)
    programs = []
    for s in range(n_stages):
        specs = _stage_specs(cfg, s, n_stages, comp, learned)
        stage_fwd = _make_stage_fwd(cfg, s, n_stages, comp, learned)
        is_first, is_last = s == 0, s == n_stages - 1

        def fwd_shards(ps, inps, labels=None, _sf=stage_fwd,
                       _last=is_last):
            with torch.no_grad():
                ys = _sf(ps, inps)
                if _last:
                    return [_head_loss(cfg, p, y, lab)
                            for p, y, lab in zip(ps, ys, labels)]
                return ys

        def bwd_shards(ps, inps, dys_or_labels, _sf=stage_fwd,
                       _first=is_first, _last=is_last):
            leaves = [_grad_leaves(p) for p in ps]
            trees = [_fresh_params(p, lv) for p, lv in zip(ps, leaves)]
            with torch.enable_grad():
                xs = [i if _first else i.detach().requires_grad_()
                      for i in inps]
                ys = _sf(trees, xs)
            for idx in _backward_sets(ps):
                with torch.enable_grad():
                    outs = _stage_grads(
                        cfg, [ps[j] for j in idx], [trees[j] for j in idx],
                        [leaves[j] for j in idx], [xs[j] for j in idx],
                        [ys[j] for j in idx],
                        [dys_or_labels[j] for j in idx], _first, _last)
                # the shards' recompute and params go before their
                # consumer folds the results
                for j in idx:
                    ps[j] = ys[j] = xs[j] = trees[j] = leaves[j] = None
                while outs:
                    yield outs.pop(0)

        fwd_f = _stage_fwd_flops(cfg, s, n_stages, seq_len, comp, learned)
        programs.append(StageProgram(
            stage=s, n_stages=n_stages, specs=specs, fwd_shards=fwd_shards,
            bwd_shards=bwd_shards, fwd_flops_per_token=fwd_f,
            bwd_flops_per_token=3.0 * fwd_f,   # recompute + 2x backward
            routes_whole=_routes_whole(cfg, n_stages, [s])))
    return programs


def _backward_sets(ps: list) -> list:
    """The data shards whose backward is one pass: all of them where
    their params hold the routed expert stacks' data slices (a layer
    exchanges their activations, ``models.layers.apply_moe_a2a``), else
    one shard at a time."""
    if any(getattr(p, "data", None) is not None for p in ps):
        return [list(range(len(ps)))]
    return [[j] for j in range(len(ps))]


def _split_grads(grads: tuple, leaves: list, with_x: bool) -> list:
    """One ``torch.autograd.grad`` result over several shards' inputs
    (each shard's ``leaves[j]``, then its input where ``with_x``) as
    ``(leaf grads, input grad)`` a shard."""
    out, k = [], 0
    for lv in leaves:
        g = grads[k:k + len(lv)]
        k += len(lv)
        gx = None
        if with_x:
            gx, k = grads[k], k + 1
        out.append((g, gx))
    return out


def _stage_grads(cfg: ArchConfig, params: list, p: list, leaves: list,
                 x: list, y: list, dy_or_labels: list, first: bool,
                 last: bool) -> list:
    """One stage's backward over data shards (lists a shard) from their
    recomputed outputs ``y`` (``p[j]`` the tree over the fresh
    ``leaves[j]``, ``x[j]`` the input leaf), one
    ``torch.autograd.grad`` for them all: per shard ``(gx, gp)``,
    ``(loss, gx, gp)`` on the last stage, ``gx`` None on stage 0."""
    if last:
        outs = [_head_loss(cfg, pj, yj, lab)
                for pj, yj, lab in zip(p, y, dy_or_labels)]
        seeds = [None] * len(outs)
    else:
        outs, seeds = y, [d.to(yj.dtype) for d, yj in zip(dy_or_labels, y)]
    ins = [t for lv, xj in zip(leaves, x)
           for t in (lv if first else lv + [xj])]
    grads = torch.autograd.grad(outs, ins, seeds, allow_unused=True)
    res = []
    for j, (g, gx) in enumerate(_split_grads(grads, leaves, not first)):
        gp = _grads_like(params[j], leaves[j], g)
        res.append((outs[j].detach(), gx, gp) if last else (gx, gp))
    return res


def build_span_program(cfg: ArchConfig, n_stages: int, seq_len: int,
                       span: tuple[int, int],
                       compress: Optional[str] = None) -> SpanProgram:
    """Fuse stages ``[lo, hi)`` into one ``fwd``/``bwd``.

    ``fwd`` chains the covered stages' forwards under ``torch.no_grad()``
    (the token-sum loss when the span covers the last stage).  ``bwd``
    recomputes the whole span from its inbound tensor under autograd,
    then walks the stages backward: each stage's gradients come from its
    own ``torch.autograd.grad`` over its own inputs, seeded as a
    single-stage ``bwd`` seeds it (the next stage's input gradient, cast
    to the stage output's dtype).  The intra-span boundaries are
    detached leaves of that recompute, so every covered stage gets the
    gradient the chain of single-stage programs gives it, bit for bit on
    one device.  ``bwd`` returns ``(gx, gps)``, ``(loss, gx, gps)`` when
    the span covers the last stage, with ``gx`` None when ``lo == 0``
    and ``gps`` one tree per covered stage in span order.
    ``fwd_shards`` / ``bwd_shards`` do the same over a microbatch's data
    shards, the covered layers in lockstep."""
    lo, hi = span
    if not (0 <= lo < hi <= n_stages):
        raise ValueError(f"span [{lo}, {hi}) outside [0, {n_stages})")
    get_stage_plan(cfg, n_stages)      # validates the split (ValueError)
    comp = codecs.resolve_mode(cfg, compress)
    learned = comp in codecs.LEARNED and n_stages > 1
    if cfg.encoder_layers:
        if learned:
            raise NotImplementedError(
                "learned boundary codecs are unsupported for "
                "encoder-decoder span programs (tree-valued boundaries)")
        return _build_span_encdec(cfg, n_stages, seq_len, span)
    stages = range(lo, hi)
    specs = {s: _stage_specs(cfg, s, n_stages, comp, learned)
             for s in stages}
    fwds = [_make_stage_fwd(cfg, s, n_stages, comp, learned)
            for s in stages]
    covers_last = hi == n_stages

    def fwd_shards(pss, inps, labels=None):
        pss = [_per_stage(ps, len(stages)) for ps in pss]
        with torch.no_grad():
            xs = inps
            for i, f in enumerate(fwds):
                xs = f([ps[i] for ps in pss], xs)
            if covers_last:
                return [_head_loss(cfg, ps[-1], x, lab)
                        for ps, x, lab in zip(pss, xs, labels)]
            return xs

    def walk_back(ps, leaves, trees, ins, outs, dys_or_labels):
        """The walk of a set of shards (lists a shard, as
        :func:`_backward_sets` groups them): each covered stage's own
        ``torch.autograd.grad`` over them, last to first, from the
        recomputed chain's inputs ``ins`` and outputs ``outs``."""
        n, ns = len(ps), len(stages)
        losses = None
        if covers_last:
            losses = [_head_loss(cfg, t[-1], o[-1], lab)
                      for t, o, lab in zip(trees, outs, dys_or_labels)]
        gps = [[None] * ns for _ in range(n)]
        gxs = [None] * n if covers_last else list(dys_or_labels)
        for i in reversed(range(ns)):
            if covers_last and i == ns - 1:
                out, seed = losses, [None] * n
            else:
                out = [o[i] for o in outs]
                seed = [g.to(o[i].dtype) for g, o in zip(gxs, outs)]
            first = stages[i] == 0
            wrt = [t for lv, x in zip(leaves, ins)
                   for t in (lv[i] if first else lv[i] + [x[i]])]
            grads = torch.autograd.grad(out, wrt, seed, allow_unused=True)
            for j, (g, gx) in enumerate(_split_grads(
                    grads, [lv[i] for lv in leaves], not first)):
                gps[j][i] = _grads_like(ps[j][i], leaves[j][i], g)
                gxs[j] = gx
        if covers_last:
            return [(loss.detach(), gx, tuple(gp))
                    for loss, gx, gp in zip(losses, gxs, gps)]
        return [(gx, tuple(gp)) for gx, gp in zip(gxs, gps)]

    def bwd_shards(pss, inps, dys_or_labels):
        n = len(pss)
        sets = _backward_sets(pss)
        pss[:] = [_per_stage(ps, len(stages)) for ps in pss]
        leaves = [[_grad_leaves(p) for p in ps] for ps in pss]
        trees = [[_fresh_params(p, lv) for p, lv in zip(ps, lvs)]
                 for ps, lvs in zip(pss, leaves)]
        ins = [[] for _ in range(n)]
        outs = [[] for _ in range(n)]
        with torch.enable_grad():
            xs = list(inps)
            for i, (s, f) in enumerate(zip(stages, fwds)):
                if s > 0:          # the boundary input: a fresh leaf
                    xs = [x.detach().requires_grad_() for x in xs]
                for j in range(n):
                    ins[j].append(xs[j])
                xs = f([trees[j][i] for j in range(n)], xs)
                for j in range(n):
                    outs[j].append(xs[j])
        del xs
        for idx in sets:
            with torch.enable_grad():
                res = walk_back(*([col[j] for j in idx] for col in (
                    pss, leaves, trees, ins, outs, dys_or_labels)))
            for j in idx:
                pss[j] = leaves[j] = trees[j] = ins[j] = outs[j] = None
            while res:
                yield res.pop(0)

    fwd_f = sum(_stage_fwd_flops(cfg, s, n_stages, seq_len, comp, learned)
                for s in stages)
    return SpanProgram(span=(lo, hi), n_stages=n_stages, specs=specs,
                       fwd_shards=fwd_shards, bwd_shards=bwd_shards,
                       fwd_flops_per_token=fwd_f,
                       bwd_flops_per_token=3.0 * fwd_f,
                       routes_whole=_routes_whole(cfg, n_stages, stages))


def init_stage_params(programs: list[StageProgram], seed: int,
                      device="cuda") -> list[Tree]:
    """Random stage params from ``seed`` (stage ``s`` draws from its own
    generator, seeded ``(seed << 16) + s``)."""
    return [P.init((int(seed) << 16) + i, p.specs, device)
            for i, p in enumerate(programs)]


def split_whisper_params(cfg: ArchConfig, n_stages: int,
                         params: Tree) -> list[Tree]:
    """Slice a full whisper tree (``models.whisper.whisper_specs``
    layout) into per-stage trees shaped like the encoder-decoder stage
    programs: the encoder pod, then ``n_layers / (n_stages - 1)``
    decoder layers a stage, stage 1 with the embedding and the last
    with the final norm and head.  Every leaf is a view of the full
    tree, so the staged pipeline computes ``whisper_apply``'s
    numbers."""
    per = cfg.n_layers // (n_stages - 1)
    out: list[Tree] = [{"enc_blocks": params["enc_blocks"],
                        "enc_norm": params["enc_norm"]}]
    for s in range(1, n_stages):
        lo = (s - 1) * per
        st: Tree = {"dec_blocks": tree_map(
            lambda a, _lo=lo: a[_lo:_lo + per], params["dec_blocks"])}
        if s == 1:
            st["embed"] = params["embed"]
        if s == n_stages - 1:
            st["final_norm"] = params["final_norm"]
            st["head"] = params["head"]
        out.append(st)
    return out


def split_lm_params(cfg: ArchConfig, n_stages: int, params: Tree,
                    compress: Optional[str] = None) -> list[Tree]:
    """Slice a full-model tree (``model.lm_specs`` layout) into per-stage
    trees shaped like :func:`_stage_specs`.

    Every leaf is a VIEW of the full tree: a stage's run of layers lies
    inside one model segment, so its stacked params are ``seg[a:b]``
    slices (the JAX version ``jnp.stack``s per-layer copies).  A staged
    yi-6b swarm therefore costs no parameter memory beyond the full
    tree, and staged prefill/decode see exactly the full model's
    numbers.  An ALBERT-shared stack splits by groups: stage ``s`` takes
    its ``share_groups / n_stages`` groups as one ``[g:g+n]`` view (one
    group per stage, ``[s:s+1]``, as in the JAX package, for swarm-1b).

    Learned boundary codecs are refused, as the JAX package refuses
    them: the single-process tree carries no per-stage ``w_c``/``w_d``
    split (serve them through :func:`init_stage_params` and the session
    programs).
    """
    comp = codecs.resolve_mode(cfg, compress)
    if comp in codecs.LEARNED and n_stages > 1:
        raise NotImplementedError(
            "split_lm_params cannot split learned boundary-codec params; "
            "init per-stage codec weights via init_stage_params instead")
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} not "
                         f"divisible by n_stages={n_stages}")
    if cfg.share_groups:
        get_stage_plan(cfg, n_stages)   # groups must split evenly
        per_groups = cfg.share_groups // n_stages
        return [_stage_extras(cfg, n_stages, s, params, [tree_map(
                    lambda a, _g=s * per_groups: a[_g:_g + per_groups],
                    params["blocks"][0])])
                for s in range(n_stages)]
    per = cfg.n_layers // n_stages
    # (segment index, offset within it) of every layer
    where = [(i, j) for i, (_, n) in
             enumerate(model_lib.segments(cfg.block_kinds))
             for j in range(n)]
    out: list[Tree] = []
    for s in range(n_stages):
        blocks, idx = [], s * per
        for _kind, n in model_lib.segments(
                cfg.block_kinds[s * per:(s + 1) * per]):
            seg, off = where[idx]
            blocks.append(tree_map(
                lambda a, _o=off, _n=n: a[_o:_o + _n],
                params["blocks"][seg]))
            idx += n
        out.append(_stage_extras(cfg, n_stages, s, params, blocks))
    return out


def _stage_extras(cfg: ArchConfig, n_stages: int, s: int, params: Tree,
                  blocks: list) -> Tree:
    """Stage ``s``'s tree: its ``blocks`` plus the edge params it owns
    (embed on stage 0; final norm and head on the last), as views of
    the full tree."""
    st: Tree = {"blocks": blocks}
    if s == 0:
        st["embed"] = params["embed"]
    if s == n_stages - 1:
        st["final_norm"] = params["final_norm"]
        if not cfg.tie_embeddings:
            st["head"] = params["head"]
        elif s != 0:
            st["head"] = params["embed"].T          # view of the table
    return st
