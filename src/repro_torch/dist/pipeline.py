"""The shifting-buffer SWARM pipeline over the ``pod`` mesh axis (port of
``repro.dist.pipeline``).

The elastic layer (``repro_torch.core``) simulates SWARM's stochastic
wiring; this module is the compiled counterpart for one static layout:
every stage of the model in one train step, stage ``s``'s stacked blocks
on the mesh's ``pod`` coordinate of stage ``s``, and microbatch
activations moving between stages through a shifting buffer.

Schedule: with ``S`` stages and ``M`` microbatches the step runs ``T = M
+ S - 1`` ticks.  At tick ``t`` slot ``s`` holds microbatch ``t - s``:
slot 0 embeds microbatch ``t``, slot ``S - 1`` feeds the head and the
loss, and every other slot's output moves to slot ``s + 1`` for the next
tick — a copy from slot ``s``'s device to slot ``s + 1``'s
(``dist.mesh.send``: a ``collective-permute`` under a collective
recorder; each slot runs as its mesh coordinate, ``dist.mesh.at``).  JAX runs
every slot each tick (one vmapped program over the stage dim) and lets
the slots outside ``[0, M)`` compute garbage that the loss never reads;
here each slot is its own call, so a dead slot is not run at all: no
output of it exists, so none reaches the loss and no cotangent flows
back from it.  Within a stage the microbatch splits over ``data`` when
it divides (else it runs whole, as ``resolve_spec`` replicates it), and
the data shards' cross-entropies are averaged (they are equal-sized
means).  A MoE stage's data shards run in lockstep, layer by layer, so
each MoE layer routes over the whole microbatch as JAX's program does
(its capacity, slots and route counts: ``models.layers.MoESplit``), and
the shards' balance-loss shares add up to the microbatch's.  Autograd
through the tick loop gives the reverse schedule; ``remat`` runs each
tick under one non-reentrant checkpoint, so backward recomputes a tick
from its inbound buffer.

Parameters: the step places the state's params by
``state_shardings(cfg, mesh, pipeline=True)`` at its start (the stacked
``layers`` dim on ``pod``, FSDP over ``data``, storage over ``model``),
and every use gathers what it needs on its slot's device.  The state
itself stays where the caller keeps it: on a mesh that lists the
state's device (a virtual mesh) the shards are views of it, on other
devices copies, and autograd carries each use's gradient back to it.  A
weight used on two ``pod`` coordinates (tied embeddings: slot 0 embeds,
slot ``S - 1`` projects) therefore gets the sum of both gradients.

All four boundary modes run (paper §4.3, App. J): ``int8`` round-trips
every live crossing in both directions (activations forward, cotangents
backward); ``bottleneck`` / ``maxout`` carry the ``c``-dim code on the
wire, encoded by sending stage ``b`` with ``w_c[b]`` and decoded by stage
``b + 1`` with ``w_d[b]`` (``params["boundary"]``, attached by
``train.steps.model_specs`` when ``cfg.pipeline_stages == S``), both
trained with the model.

:func:`make_reference_loss_fn` is the sequential one-device twin (the
same staged computation, the same boundary crossings, no buffer): the
oracle the pipeline is held to, and the math the elastic path runs peer
by peer.  The JAX package's ``_restack`` and ``JAX_PIN_CEILING`` are
XLA-compiler and version-pin workarounds with no counterpart here.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.utils.checkpoint

from repro_torch.compression import codecs
from repro_torch.dist.constrain import current_mesh, resolve_spec
from repro_torch.dist.mesh import Mesh, at, gather, gather_tree, \
    place_as, send
from repro_torch.models import model as model_lib
from repro_torch.models.blocks import MOE_PRE, apply_lockstep, per_shard
from repro_torch.models.config import ArchConfig
from repro_torch.models.stage_plan import get_stage_plan
from repro_torch.optim.adamw import Optimizer
from repro_torch.tree import tree_leaves, tree_map

Tree = Any
Tensor = torch.Tensor


def stage_periodic(cfg: ArchConfig, n_stages: int) -> bool:
    """Can this layer stack split into ``n_stages`` identical stages?
    Encoder-decoder stacks never; ALBERT-shared stacks iff the groups
    split evenly; otherwise the block-kind pattern must tile."""
    if n_stages < 1:
        return False
    if cfg.family == "audio" or cfg.encoder_layers:
        return False
    try:
        return get_stage_plan(cfg, n_stages).periodic
    except ValueError:       # stack cannot split at this stage count
        return False


def _period_runs(cfg: ArchConfig, n_stages: int) -> list[tuple[str, int]]:
    """(kind, count) runs of one stage's slice of the layer pattern."""
    return list(get_stage_plan(cfg, n_stages).stages[0].runs)


def _global_runs(cfg: ArchConfig) -> list[tuple[str, int]]:
    """The runs ``params["blocks"]`` stacks: one run of ``share_groups``
    groups for a shared stack, the pattern's segments otherwise."""
    runs, _ = model_lib.model_runs(cfg)
    return runs


def _run_rows(cfg: ArchConfig, runs, start: int
              ) -> list[tuple[int, int, int]]:
    """``(global run, lo, hi)`` per run of a stage whose first layer (or
    group) is global index ``start``: a contiguous same-kind range sits
    inside one global run, so it is a row slice of that run's stack."""
    g_runs = _global_runs(cfg)
    starts = [0]
    for _, c in g_runs:
        starts.append(starts[-1] + c)
    out = []
    for _, c in runs:
        ri = max(i for i in range(len(g_runs)) if starts[i] <= start)
        lo = start - starts[ri]
        out.append((ri, lo, lo + c))
        start += c
    return out


def _stage_rows(cfg: ArchConfig, n_stages: int
                ) -> list[list[tuple[int, int, int]]]:
    """Every stage's ``(global run, lo, hi)`` slices of
    ``params["blocks"]``, read off the stage plan."""
    plan = get_stage_plan(cfg, n_stages)
    if cfg.share_groups:
        per = cfg.share_groups // n_stages
    else:
        per = cfg.n_layers // n_stages
    return [_run_rows(cfg, spec.runs, s * per)
            for s, spec in enumerate(plan.stages)]


def make_block_core(cfg: ArchConfig, runs: list[tuple[str, int]],
                    reps: int = 1) -> Callable:
    """The stage core: walk ``runs`` of stacked layer params over the data
    shards of one microbatch, ``(blocks, xs, auxs, positions, scope=None)
    -> (xs, auxs)`` (lists a shard, row order; one entry where the
    microbatch runs whole).  A shard's ``blocks`` is one stage's
    ``[tree-per-run]`` list (leaves stacked ``[count, ...]``).  The
    shards go layer by layer in lockstep
    (:func:`repro_torch.models.blocks.apply_lockstep`): each MoE layer
    routes over all of them and adds each shard's share of its balance
    loss to that shard's aux.  ``reps > 1`` re-applies each layer (ALBERT
    sharing) with its weights cast to the activation dtype once
    (``lm_apply``'s rule).  ``scope(j)`` is a context shard ``j``'s ops
    run in."""
    def block_fn(blocks: list, xs: list, auxs: list, positions: list,
                 scope: Optional[Callable] = None):
        for r, (kind, _) in enumerate(runs):
            segs = per_shard(scope, lambda b: model_lib.layers(b[r]),
                             blocks)
            for ps in zip(*segs):
                lows = per_shard(scope, lambda p, x: model_lib.compute_cast(
                    p, x.dtype) if reps > 1 else None, ps, xs)
                for _ in range(reps):
                    ws = per_shard(scope, lambda p, low: p if low is None
                                   else model_lib.shared_application(p, low),
                                   ps, lows)
                    xs, shares = apply_lockstep(cfg, kind, ws, xs,
                                                positions, scope)
                    auxs = per_shard(scope, lambda a, sh: a + sh, auxs,
                                     shares)
        return xs, auxs

    return block_fn


def _make_stage_fn(cfg: ArchConfig, n_stages: int):
    """One (periodic) stage's core."""
    spec = get_stage_plan(cfg, n_stages).stages[0]
    return make_block_core(cfg, list(spec.runs), spec.reps)


def _resolve_codec(cfg: ArchConfig, n_stages: int,
                   compress: Optional[str]) -> str:
    """The validated boundary mode of an ``n_stages`` pipeline."""
    comp = codecs.resolve_mode(cfg, compress)
    if n_stages == 1:
        return "none"                    # no boundaries to compress
    if comp in codecs.LEARNED and cfg.pipeline_stages != n_stages:
        raise ValueError(
            f"{cfg.name}: compress={comp!r} needs one learned codec pair "
            f"per boundary — set cfg.pipeline_stages={n_stages} (got "
            f"{cfg.pipeline_stages}) so model_specs attaches "
            "params['boundary']")
    return comp


def _boundary_params(params: Tree, comp: str, n_stages: int) -> Tree:
    bparams = params.get("boundary")
    if bparams is None:
        raise ValueError(
            f"compress={comp!r} but params carry no 'boundary' codec tree "
            "— build the state from repro_torch.train.steps.model_specs "
            "with cfg.pipeline_stages set")
    nb = tree_leaves(bparams)[0].shape[0]
    if nb != n_stages - 1:
        raise ValueError(f"params['boundary'] holds {nb} codec pairs, "
                         f"need {n_stages - 1} (one per boundary)")
    return bparams


def _encode(cfg: ArchConfig, comp: str, pb: Optional[Tree],
            x: torch.Tensor) -> torch.Tensor:
    """The sending side of a crossing: what goes on the wire."""
    if comp == "int8":
        return codecs.int8_boundary(cfg, x)
    if comp in codecs.LEARNED:
        return codecs.encode_wire(cfg, comp, pb, x)
    return x


def _decode(cfg: ArchConfig, comp: str, pb: Optional[Tree],
            z: torch.Tensor) -> torch.Tensor:
    """The receiving side: the stage input from the wire."""
    if comp in codecs.LEARNED:
        return codecs.decode_wire(cfg, comp, pb, z)
    return z


def boundary_crossing(cfg: ArchConfig, comp: str, bparams: Optional[Tree],
                      b: int, x: torch.Tensor) -> torch.Tensor:
    """What boundary ``b`` (stage b -> b+1) does to the activation, given
    the stacked codec tree (leading dim: the boundary): the int8 round
    trip, or the learned codec's encode then decode (the kernels on a
    CUDA tensor, their plain versions on a CPU tensor)."""
    pb = None
    if comp in codecs.LEARNED:
        pb = tree_map(lambda a: a[b], bparams)
    return _decode(cfg, comp, pb, _encode(cfg, comp, pb, x))


def _mrope_rows(batch: Tree, M: int, mb: int, m: int) -> Optional[Tensor]:
    """Microbatch ``m``'s M-RoPE positions ``[3, mb, S]`` (None when the
    batch carries none)."""
    p = batch.get("positions")
    if p is None:
        return None
    p = torch.as_tensor(p)
    return p.reshape(p.shape[0], M, mb, p.shape[-1])[:, m]


class _Layout:
    """Where the pipeline's slots and data shards run on a mesh: slot
    ``s`` on the ``pod`` coordinate owning stage ``s`` (stages split
    evenly over ``pod``, else all on coordinate 0), data shard ``j`` on
    ``data`` coordinate ``j``, index 0 on every other axis."""

    def __init__(self, mesh: Mesh, n_stages: int, mb: int):
        self.mesh = mesh
        stage_split = resolve_spec(["pod"], [n_stages], mesh)
        self.per_pod = n_stages // mesh.shape["pod"] if stage_split \
            else n_stages
        self.n_data = mesh.shape["data"] if resolve_spec(
            ["data"], [mb], mesh) else 1
        self.rows = mb // self.n_data

    def coord(self, s: int, j: int) -> tuple[int, ...]:
        return self.mesh.coord(pod=s // self.per_pod, data=j)

    def device(self, s: int, j: int) -> torch.device:
        return self.mesh.device(self.coord(s, j))


def make_pipeline_train_step(cfg: ArchConfig, optimizer: Optimizer,
                             n_stages: int, n_microbatches: int, *,
                             remat: bool | str = True,
                             compress: Optional[str] = None,
                             shards: Optional[int] = None):
    """``(state, batch) -> (state, {"loss", "ce"})`` — the pipelined twin
    of ``train.steps.make_train_step``, on the ambient mesh (``with
    mesh:``; off a mesh every slot runs on the params' device).

    ``compress=None`` defers to ``cfg.boundary_compression``; the learned
    codecs need ``cfg.pipeline_stages == n_stages`` (ValueError
    otherwise).  ``batch``: ``tokens`` / ``labels`` ``[B, S]`` and, for
    M-RoPE, ``positions [3, B, S]``, with ``B`` a multiple of
    ``n_microbatches``.  ``train_step.loss_fn(params, batch) -> (loss,
    ce)`` is the pipelined loss alone (a step's gradients without its
    update).  ``shards`` runs only the first ``shards`` data shards of
    every slot (None: all): the dry run's count of equal shards, once
    each (the loss then averages the shards run; a MoE shard routes on
    its own rows unless the caller sets a rule by
    ``models.layers.moe_split``, as the dry run does)."""
    if not stage_periodic(cfg, n_stages):
        raise ValueError(f"{cfg.name}: layer stack is not periodic at "
                         f"{n_stages} stages (see stage_periodic)")
    comp = _resolve_codec(cfg, n_stages, compress)
    do_remat = (remat != "none") if isinstance(remat, str) else bool(remat)
    stage_fn = _make_stage_fn(cfg, n_stages)
    rows_of = _stage_rows(cfg, n_stages)
    routes_whole = any(k in MOE_PRE for k, _ in _period_runs(cfg, n_stages))
    S_, M = n_stages, n_microbatches

    from repro_torch.dist.sharding import state_shardings
    from repro_torch.train import steps as steps_lib   # lazy: steps
                                                       # imports models

    def loss_fn(params: Tree, batch: Tree):
        tokens = torch.as_tensor(batch["tokens"])
        labels = torch.as_tensor(batch["labels"])
        B, S = tokens.shape
        if B % M:
            raise ValueError(f"batch {B} not divisible by {M} microbatches")
        mb = B // M
        home = params["embed"].device
        mesh = current_mesh() or Mesh([home], ("data",))
        lay = _Layout(mesh, S_, mb)
        # a MoE slot routes over the whole microbatch: its data shards
        # go in one lockstep call; where only some shards run (the dry
        # run's equal shards), one call each
        run = range(lay.n_data if shards is None else shards)
        calls = [list(run)] if routes_whole and shards is None else \
            [[j] for j in run]
        placed = tree_map(place_as, params,
                          state_shardings(cfg, mesh, pipeline=True)
                          ["params"])
        tok_mb = tokens.reshape(M, mb, S)
        lab_mb = labels.reshape(M, mb, S)

        def rows(t: Tensor, j: int, dev) -> Tensor:
            return t[j * lay.rows:(j + 1) * lay.rows].to(dev)

        def blocks_on(s: int, dev) -> list:
            return [tree_map(lambda a, _lo=lo, _hi=hi: gather(
                a, dev, rows=(_lo, _hi)), placed["blocks"][ri])
                for ri, lo, hi in rows_of[s]]

        def codec_on(b: int, dev) -> Optional[Tree]:
            if comp not in codecs.LEARNED:
                return None
            bp = _boundary_params(placed, comp, S_)
            return tree_map(lambda a: gather(a, dev, rows=(b, b + 1))[0],
                            bp)

        def positions(m: int, j: int, dev) -> Tensor:
            p = _mrope_rows(batch, M, mb, m)
            if p is not None:
                return p[:, j * lay.rows:(j + 1) * lay.rows].to(dev)
            return model_lib.default_positions(cfg, lay.rows, S,
                                               device=dev)

        def slots(t: int, s: int, js: list, zs: list, auxs: list) -> list:
            """Slot ``s`` at tick ``t`` on data shards ``js`` in one
            lockstep call (shards on one device share one gathered copy
            of the stage's blocks): each shard's wire tensor for slot ``s
            + 1`` and aux so far, or (ce, aux) on the last slot, shard
            after shard."""
            scope = lambda i: at(lay.coord(s, js[i]))    # noqa: E731
            devs = [lay.device(s, j) for j in js]
            blocks: dict = {}

            def stage_in(j, dev, z, aux):
                x, aux = slot_enter(t, s, j, z, aux)
                if dev not in blocks:
                    blocks[dev] = blocks_on(s, dev)
                return x, aux, positions(t - s, j, dev)
            ins = per_shard(scope, stage_in, js, devs, zs, auxs)
            xs, outs = stage_fn([blocks[d] for d in devs],
                                *map(list, zip(*ins)), scope)
            # the stage's gathered blocks and inputs go before the head
            del ins
            blocks.clear()
            return [v for pair in per_shard(
                scope, lambda j, x, aux: slot_leave(t, s, j, x, aux), js,
                xs, outs) for v in pair]

        def slot_enter(t: int, s: int, j: int, z: Optional[Tensor],
                       aux: Optional[Tensor]):
            """The stage input and aux of slot ``s``, shard ``j``."""
            m, dev = t - s, lay.device(s, j)
            if s == 0:
                x = model_lib.embed(cfg, {"embed": gather(
                    placed["embed"], dev)}, rows(tok_mb[m], j, dev))
                aux = torch.zeros((), dtype=torch.float32, device=dev)
                return x, aux
            return _decode(cfg, comp, codec_on(s - 1, dev), z), aux

        def slot_leave(t: int, s: int, j: int, x: Tensor, aux: Tensor):
            """The stage output onward: the wire and aux sent to slot
            ``s + 1``, or (ce, aux) on the last slot."""
            m, dev = t - s, lay.device(s, j)
            if s < S_ - 1:
                nxt = lay.coord(s + 1, j)
                out = _encode(cfg, comp, codec_on(s, dev), x)
                return send(out, mesh, nxt), send(aux, mesh, nxt)
            head_p = {k: gather_tree(placed[k], dev)
                      for k in ("final_norm", "embed", "head")
                      if k in placed and (k != "embed"
                                          or cfg.tie_embeddings)}
            logits = model_lib.head(cfg, head_p, x)
            return steps_lib.cross_entropy(
                logits, rows(lab_mb[m], j, dev)), aux

        def tick(t: int, *carry):
            """Every live slot of tick ``t``; ``carry`` the inbound
            (wire, aux) pairs of slots 1..S-1 (None where dead)."""
            out = []
            for s in range(S_):
                if not 0 <= t - s < M:
                    out += [None, None] * lay.n_data
                    continue
                got: dict = {}
                for js in calls:
                    ins = [carry[2 * i:2 * i + 2] if s else (None, None)
                           for i in ((s - 1) * lay.n_data + j for j in js)]
                    res = slots(t, s, js, [z for z, _ in ins],
                                [a for _, a in ins])
                    got.update((j, res[2 * i:2 * i + 2])
                               for i, j in enumerate(js))
                for j in range(lay.n_data):
                    out += got.get(j, [None, None])
            return tuple(out)

        ces, auxs = [], []
        wire: tuple = (None, None) * ((S_ - 1) * lay.n_data)
        for t in range(M + S_ - 1):
            if do_remat and torch.is_grad_enabled():
                out = torch.utils.checkpoint.checkpoint(
                    tick, t, *wire, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                out = tick(t, *wire)
            k = 2 * lay.n_data
            # slot s's outputs feed slot s + 1 next tick; the last slot's
            # are (ce, aux) of microbatch t - (S - 1)
            wire = out[:(S_ - 1) * k]
            if 0 <= t - (S_ - 1) < M:
                last = out[(S_ - 1) * k:]
                ces.append(torch.stack([c.to(home) for c in last[0::2]
                                        if c is not None]
                                       ).mean())
                # the shards' aux: a MoE microbatch's balance loss is the
                # sum of its shards' shares (run alike: n_data times the
                # one run), 0 for other kinds
                shares = [a.to(home) for a in last[1::2] if a is not None]
                auxs.append(torch.stack(shares).sum() *
                            (lay.n_data / len(shares)) if routes_whole
                            else torch.stack(shares).mean())
        ce = torch.stack(ces).mean()
        return ce + torch.stack(auxs).mean(), ce

    def train_step(state: Tree, batch: Tree):
        params = state["params"]
        loss, ce, grads = steps_lib._value_and_grad(loss_fn, params, batch)
        updates, opt = optimizer.update(grads, state["opt"], params)
        del grads
        new_params = tree_map(lambda p, u: p + u.to(p.dtype), params,
                              updates)
        return ({"params": new_params, "opt": opt,
                 "step": state["step"] + 1},
                {"loss": loss, "ce": ce})

    train_step.loss_fn = loss_fn
    return train_step


def _make_whisper_reference_loss_fn(cfg: ArchConfig, n_stages: int,
                                    n_microbatches: int, comp: str):
    """The sequential staged whisper reference: the encoder pod, then the
    decoder slice chain, with the int8 crossings of the elastic path
    (boundary 0 the encoder output; interior boundaries the hidden state
    and the encoder state; token ids uncompressed).
    ``batch["tokens"]`` is the ``{"audio", "tok"}`` payload."""
    from repro_torch.models import whisper as W
    from repro_torch.train import steps as steps_lib
    if comp in codecs.LEARNED:
        raise NotImplementedError(
            "learned boundary codecs are unsupported for encoder-decoder "
            "stacks (tree-valued boundaries)")
    M = n_microbatches
    per = cfg.n_layers // (n_stages - 1)

    def cross(x):
        return codecs.int8_boundary(cfg, x) if comp == "int8" else x

    def loss_fn(params: Tree, batch: Tree):
        audio = torch.as_tensor(batch["tokens"]["audio"])
        tok = torch.as_tensor(batch["tokens"]["tok"])
        labels = torch.as_tensor(batch["labels"])
        B, S = tok.shape
        if B % M:
            raise ValueError(f"batch {B} not divisible by {M} microbatches")
        mb = B // M
        dev = params["embed"].device
        ces = []
        for m in range(M):
            au = audio.reshape(M, mb, *audio.shape[1:])[m].to(dev)
            tk = tok.reshape(M, mb, S)[m].to(dev)
            lab = labels.reshape(M, mb, S)[m].to(dev)
            enc = cross(W.encode(cfg, params, au, remat=False))
            x = W.embed_tokens(cfg, params["embed"], tk)
            for s in range(1, n_stages):
                lo = (s - 1) * per
                blocks_s = tree_map(lambda a, _lo=lo: a[_lo:_lo + per],
                                    params["dec_blocks"])
                x = W.dec_scan(cfg, blocks_s, x, enc,
                               torch.arange(S, device=dev), remat=False)
                if s < n_stages - 1:   # interior boundary: whole tree
                    x, enc = cross(x), cross(enc)
            logits = model_lib.head(cfg, params, x)
            ces.append(steps_lib.cross_entropy(logits, lab))
        ce = torch.stack(ces).mean()
        return ce, ce

    return loss_fn


def make_reference_loss_fn(cfg: ArchConfig, n_stages: int,
                           n_microbatches: int, *,
                           compress: Optional[str] = None):
    """The sequential one-device twin of the pipelined loss: the same
    staged computation (per microbatch, stage after stage, the same
    boundary crossing between consecutive stages), with no buffer and no
    bubble.  Periodic stacks run the one stage core a stage; other
    stacks their plan's stage chain; encoder-decoder stacks the whisper
    chain.  ``loss_fn(params, batch) -> (ce + aux, ce)``."""
    try:
        plan = get_stage_plan(cfg, n_stages)
    except ValueError as e:
        raise ValueError(
            f"{cfg.name}: layer stack cannot split at {n_stages} stages "
            f"({e})") from e
    comp = _resolve_codec(cfg, n_stages, compress)
    if plan.is_encdec:
        return _make_whisper_reference_loss_fn(cfg, n_stages,
                                               n_microbatches, comp)
    if plan.periodic:
        rows_of = _stage_rows(cfg, n_stages)
    else:
        per = cfg.n_layers // n_stages
        rows_of = [_run_rows(cfg, spec.runs, s * per)
                   for s, spec in enumerate(plan.stages)]
    cores = [make_block_core(cfg, list(spec.runs), spec.reps)
             for spec in plan.stages]
    M = n_microbatches

    from repro_torch.train import steps as steps_lib

    def loss_fn(params: Tree, batch: Tree):
        tokens = torch.as_tensor(batch["tokens"])
        labels = torch.as_tensor(batch["labels"])
        B, S = tokens.shape
        if B % M:
            raise ValueError(f"batch {B} not divisible by {M} microbatches")
        mb = B // M
        dev = params["embed"].device
        bparams = (_boundary_params(params, comp, n_stages)
                   if comp in codecs.LEARNED else None)
        stage_blocks = [[tree_map(lambda a, _lo=lo, _hi=hi: a[_lo:_hi],
                                  params["blocks"][ri])
                         for ri, lo, hi in rows] for rows in rows_of]
        ces, auxs = [], []
        for m in range(M):
            tok = tokens.reshape(M, mb, S)[m].to(dev)
            lab = labels.reshape(M, mb, S)[m].to(dev)
            pos = _mrope_rows(batch, M, mb, m)
            pos = (pos.to(dev) if pos is not None else
                   model_lib.default_positions(cfg, mb, S, device=dev))
            x = model_lib.embed(cfg, params, tok)
            aux = torch.zeros((), dtype=torch.float32, device=dev)
            for s in range(n_stages):
                (x,), (aux,) = cores[s]([stage_blocks[s]], [x], [aux],
                                        [pos])
                if s < n_stages - 1:
                    x = boundary_crossing(cfg, comp, bparams, s, x)
            logits = model_lib.head(cfg, params, x)
            ces.append(steps_lib.cross_entropy(logits, lab))
            auxs.append(aux)
        ce = torch.stack(ces).mean()
        return ce + torch.stack(auxs).mean(), ce

    return loss_fn
