"""MeshExecutor and MeshSpanExecutor — a SWARM peer backed by a device
mesh (port of ``repro.runtime.mesh``).

The paper's swarms are heterogeneous (§3): one peer may be a lone
preemptible T4, another an 8-device node.  These executors make the
latter a pipeline peer like any other: the stage (or span) step runs
over the peer's mesh by the ``repro_torch.dist`` sharding rules, while
the elastic scheduler above speaks the same
:class:`~repro_torch.runtime.base.StageExecutor` protocol to it as to a
single-device peer.  One process drives the mesh (see
:mod:`repro_torch.dist.mesh`).

* **State.**  A stage's params, optimizer state and gradient
  accumulator are :class:`~repro_torch.dist.mesh.Placed` trees laid out
  by ``stage_param_shardings`` (FSDP over ``data``, storage over
  ``model``); any optimizer subtree shaped like the params (AdamW's
  moments, DPU's banked gradients) follows the params' layout, other
  leaves replicate.
* **Compute.**  Each executor runs the stage or span programs that
  :mod:`repro_torch.runtime.numeric` shares (``get_stage_programs``,
  ``get_span_program``), so a mesh peer and a numeric peer of one stage
  compute the same function.  The microbatch is split along dim 0 over
  ``batch_axis`` when it divides evenly (``dp_shards``), otherwise it
  runs whole, as ``resolve_spec``'s fallback replicates it.  Data shard
  ``i``'s home is the device at ``batch_axis`` index ``i`` (index 0 on
  the other axes).  Which of two paths a stage takes is set by the mesh
  and the stage's layers (``compute_path``; no option selects it):

  - ``"tensor_parallel"``: with more than one ``model`` shard and only
    the kinds of ``dist.tensor_parallel.SUPPORTED_KINDS`` (the dense
    ``attn`` stack, llama4-scout's ``moe``, DeepSeek-V2's ``mla`` and
    ``mla_moe``), the model shards of data shard ``i`` compute
    together, as JAX's GSPMD program does: the device at ``model`` index
    ``j`` gets model block ``j`` of each leaf, gathered over ``data`` (a
    leaf the rules split over ``model`` as its block, any other leaf
    whole), heads, FFN columns, routed experts and the vocabulary are
    split by each leaf's resolved spec (MLA's down-projections
    replicate: every shard computes the latents), activation partials
    are all-reduced at home, and a MoE layer routes at home and
    takes each routed row back from its expert's shard.  The learned
    codec's ``w_c`` / ``w_d`` are gathered whole at home, where the wire
    runs, as on the other path.  Each model shard's gradients come back
    as its blocks, reduce-scattered into the shards that hold them.
  - ``"gathered"``: otherwise (one model shard; an SSM, hymba or
    whisper stage) every leaf is gathered whole onto the data shard's
    home, which computes alone: there the ``model`` axis
    shards storage only.

  A stage with a MoE block routes over the whole microbatch, as JAX's
  jitted program does with the batch sharded over ``data``: its data
  shards go to the program in one call and run in lockstep, layer by
  layer, each MoE layer taking the microbatch's capacity, slot offsets
  and route counts (``models.layers.MoESplit``), on either path; shards
  on one device (one list of devices) share one gathered copy of the
  params.  Any other stage takes its shards one call each, so one
  shard's activations live at a time.
* **Combining shards.**  The stage programs' loss is a token *sum* (so
  microbatch gradients add, App. E), so the shards combine with weight
  one: losses add (in f64), input cotangents and outputs concatenate
  along dim 0, and parameter gradients are reduce-scattered into the
  params' layout, summed in f64 (exact for a few f32 parts).  The mesh
  step is the one-device step up to the order of the batch's reductions;
  on a one-device mesh it is the numeric step bit for bit.
* **Wire and state transfer.**  Outputs, cotangents, exported gradients
  and exported state are gathered onto the mesh's first device
  (``device``), where the int8 wire codec runs, so a mesh peer hands
  tensors to a single-device peer and back as numeric peers do.
  ``snapshot`` / ``restore`` speak ``NumericExecutor``'s host format, so
  state crosses backends bit for bit.  Gradients fold into the f64
  accumulator of :func:`repro_torch.runtime.base.fold_into`.

Mesh-backed serving (``session_program``) is not implemented, as in the
JAX package.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.compression import codecs
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.mesh import Mesh, NamedSharding, Placed, at, \
    gather_tree, place_as, reduce_scatter_tree
from repro_torch.dist.sharding import DEFAULT_RULES, ShardingRules, \
    stage_param_shardings
from repro_torch.models import params as P
from repro_torch.models.config import ArchConfig
from repro_torch.models.stage_plan import get_stage_plan
from repro_torch.runtime.base import CORE_SLOTS, StageState, dispatched, \
    fold_into, host_snapshot, install_snapshot, place, single_stage, \
    slot_export, slot_install, wire_bwd_codec, wire_fwd_codec
from repro_torch.runtime.numeric import get_span_program, get_stage_programs
from repro_torch.tree import tree_leaves, tree_map

Tree = Any

_SERVING = ("mesh-backed serving is not implemented (as in the JAX "
            "package): serve spans on the numeric and pipeline backends")


def _structure(tree: Tree):
    """A hashable picture of a tree's nodes, leaves as ``*``."""
    if isinstance(tree, dict):
        return ("d", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return ("l", tuple(_structure(v) for v in tree))
    return None if tree is None else "*"


def _is_array(a) -> bool:
    return isinstance(a, (torch.Tensor, np.ndarray, Placed))


class _MeshBacked:
    """What both mesh executors share: the mesh, the data split, and
    placing, gathering and combining trees."""

    def _setup(self, cfg: ArchConfig, n_stages: int, seq_len: int,
               mesh: Mesh, compress: Optional[str], quant_block: int,
               rules: Optional[ShardingRules], batch_axis: str) -> None:
        self.cfg = cfg
        self.n_stages = n_stages
        self.seq_len = seq_len
        self.plan = get_stage_plan(cfg, n_stages)
        self.mesh = mesh
        self.rules = rules or DEFAULT_RULES
        self.batch_axis = batch_axis
        self.compress_mode = codecs.resolve_mode(cfg, compress)
        self.quant_block = quant_block
        self.device_count = mesh.size
        self.device = mesh.devices.flat[0]
        self._repl = NamedSharding(mesh, ())

    def _set_path(self, stages) -> None:
        kinds = {k for s in stages for k in self.plan.stages[s].kinds}
        self.tensor_parallel = tp.runs_tensor_parallel(self.cfg, kinds,
                                                       self.mesh)

    @property
    def compute_path(self) -> str:
        """``"tensor_parallel"`` or ``"gathered"`` (module docstring)."""
        return "tensor_parallel" if self.tensor_parallel else "gathered"

    def _args(self) -> tuple:
        return (self.mesh, self.compress_mode, self.quant_block, self.rules,
                self.batch_axis)

    # ---------------------------------------------------------- the split
    def dp_shards(self, batch: int) -> int:
        """The data-parallel split of a ``batch``-row microbatch: the
        ``batch_axis`` size where it divides the batch, else 1 (the
        batch runs whole, as ``resolve_spec`` replicates it)."""
        n = int(self.mesh.shape.get(self.batch_axis, 1))
        return n if n > 1 and batch % n == 0 else 1

    def _data_devices(self, n: int) -> list[torch.device]:
        if n == 1:
            return [self.device]
        return [self.mesh.device(self.mesh.coord(**{self.batch_axis: i}))
                for i in range(n)]

    def _shards_of(self, inp: Tree, *extra: Tree):
        """``(device, inp_i, *extra_i, i)`` per data shard ``i``: every
        leaf split along dim 0 and put on its shard's device (a leaf
        already there unsplit is used as it is)."""
        batch = tree_leaves(inp)[0].shape[0]
        n = self.dp_shards(batch)
        devs = self._data_devices(n)
        rows = batch // n

        def piece(t, i, dev):
            if t is None:
                return None
            return tree_map(lambda a: place(a if n == 1 else
                                            a[i * rows:(i + 1) * rows],
                                            dev), t)
        return [(dev, piece(inp, i, dev), *(piece(e, i, dev)
                                            for e in extra), i)
                for i, dev in enumerate(devs)]

    def _calls(self, shards: list) -> list:
        """The program calls a microbatch's data shards take: all in one
        where the program routes over the whole microbatch (MoE), else
        one shard a call."""
        return [shards] if self.prog.routes_whole else [[sh]
                                                        for sh in shards]

    def _run_fwd(self, state: StageState, inp: Tree,
                 labels: Optional[torch.Tensor], last: bool) -> Tree:
        outs = []
        for group in self._calls(self._shards_of(inp, labels)):
            ps = self._params(state, group)
            outs += self.prog.fwd_shards(ps, [sh[1] for sh in group],
                                         [sh[2] for sh in group])
            del ps
        return self._sum(outs) if last else self._cat(outs)

    def _bwd_parts(self, state: StageState, shards: list, last: bool,
                   losses: list, gxs: list):
        """Each shard's gradients in row order (its loss and input
        cotangent appended to ``losses`` / ``gxs``), a shard's dropped
        once the consumer has folded them."""
        for group in self._calls(shards):
            for out in self.prog.bwd_shards(
                    self._params(state, group), [sh[1] for sh in group],
                    [sh[2] for sh in group]):
                if last:
                    loss, gx, gp = out
                else:
                    (gx, gp), loss = out, None
                losses.append(loss)
                gxs.append(gx)
                del out
                if self.tensor_parallel:
                    yield from self._per_model_shard(gp)
                else:
                    yield gp
                del gp

    def _params(self, state: StageState, shards: list) -> list:
        """Each shard's params, gathered on its device once a distinct
        device (shards of a virtual mesh share one gathered copy); on
        the tensor-parallel path each data shard's
        :class:`~repro_torch.dist.tensor_parallel.ModelShards`, model
        block ``j`` on the device at ``model`` index ``j``, gathered once
        a distinct list of devices."""
        got: dict = {}
        if self.tensor_parallel:
            out = []
            for sh in shards:
                group = tp.Group.of(self.mesh, **{self.batch_axis: sh[-1]})
                key = tuple(group.devs)
                if key not in got:
                    got[key] = self._model_shards(state, sh[-1]).trees
                out.append(tp.ModelShards(got[key], group))
            return out
        for dev, *_ in shards:
            if dev not in got:
                got[dev] = self._gathered(state, dev)
        return [got[dev] for dev, *_ in shards]

    def _model_shards(self, state: StageState, i: int) -> tp.ModelShards:
        """Data shard ``i``'s model shards and their blocks."""
        group = tp.Group.of(self.mesh, **{self.batch_axis: i})
        trees = []
        for j, (d, c) in enumerate(zip(group.devs, group.coords)):
            with at(c):
                trees.append(self._blocks(state, d, j))
        return tp.ModelShards(trees, group)

    def _reduce_grads(self, parts, shardings, shapes):
        """Reduce-scatter the gradient parts ``_bwd_parts`` yields: one
        a data shard, or on the tensor-parallel path one a model shard
        of each data shard (its blocks)."""
        if not self.tensor_parallel:
            return reduce_scatter_tree(parts, shardings)
        groups = [tp.Group.of(self.mesh, **{self.batch_axis: i})
                  for i in range(int(self.mesh.shape.get(self.batch_axis,
                                                         1)))]
        return reduce_scatter_tree(
            parts, shardings, sources=[c for g in groups for c in g.coords],
            wheres=[{tp.MODEL_AXIS: j} for g in groups
                    for j in range(g.m)], shapes=shapes)

    def _cat(self, outs: list) -> Tree:
        """Per-shard outputs or cotangents joined along dim 0 on
        ``device``."""
        if outs[0] is None:
            return None
        if len(outs) == 1:
            return place(outs[0], self.device)
        return tree_map(lambda *xs: torch.cat(
            [x.to(self.device) for x in xs], dim=0), *outs)

    def _sum(self, losses: list):
        """Per-shard token-sum losses added in f64 on ``device``."""
        if len(losses) == 1:
            return losses[0]
        total = losses[0].to(self.device, torch.float64)
        for loss in losses[1:]:
            total = total + loss.to(self.device, torch.float64)
        return total

    # ---------------------------------------------------------- placement
    def _place(self, tree: Tree, shardings: Tree) -> Tree:
        return tree_map(place_as, tree, shardings)

    def _place_opt(self, opt: Tree, shardings: Tree) -> Tree:
        """Optimizer placement: a subtree shaped like the params tree
        takes the params' shardings leaf for leaf; other array leaves
        replicate, anything else passes."""
        if opt is None:
            return None
        shape = _structure(shardings)

        def walk(sub):
            if _structure(sub) == shape:
                return self._place(sub, shardings)
            if isinstance(sub, dict):
                return {k: walk(v) for k, v in sub.items()}
            if isinstance(sub, (list, tuple)):
                return type(sub)(walk(v) for v in sub)
            return place_as(sub, self._repl) if _is_array(sub) else sub

        return walk(opt)

    def _host(self, tree: Tree) -> Tree:
        return gather_tree(tree, self.device)

    def _snapshot_view(self, view: StageState, slots) -> Tree:
        host = StageState(params=self._host(view.params),
                          opt=self._host(view.opt), version=view.version)
        host.slots.update({k: v for k, v in view.slots.items()
                           if k not in CORE_SLOTS})
        return host_snapshot(host, slots=slots)

    def _restore_view(self, view: StageState, snap: Tree, shardings: Tree,
                      slots) -> None:
        placed = dict(snap)
        placed["params"] = self._place(snap["params"], shardings)
        placed["opt"] = self._place_opt(snap.get("opt"), shardings)
        install_snapshot(view, placed, self.device, slots=slots)

    def _adopt_view(self, view: StageState, new_params: Tree, new_opt: Tree,
                    shardings: Tree) -> None:
        view.params = self._place(new_params, shardings)
        view.opt = self._place_opt(new_opt, shardings)
        view.version += 1
        view.reset_progress()

    def session_program(self, total_len: int):
        raise NotImplementedError(_SERVING)

    # ------------------------------------------------- dispatch / collect
    def dispatch_fwd(self, state: StageState, inp: Tree,
                     labels: Optional[torch.Tensor] = None):
        # outputs are gathered onto ``device``; collect orders the
        # consumer behind the gather's copies
        return dispatched(self.run_fwd(state, inp, labels), self.device)

    def dispatch_bwd(self, state: StageState, inp: Tree,
                     dy: Optional[Tree] = None,
                     labels: Optional[torch.Tensor] = None):
        return dispatched(self.run_bwd(state, inp, dy, labels), self.device)

    # --------------------------------------------------------- wire codec
    def wire_fwd(self, y: Tree) -> Tree:
        return wire_fwd_codec(self, y)

    def wire_bwd(self, gx: Tree) -> Tree:
        return wire_bwd_codec(self, gx)


class MeshExecutor(_MeshBacked):
    """Run one pipeline stage data-parallel over a device mesh."""

    def __init__(self, cfg: ArchConfig, n_stages: int, seq_len: int,
                 stage: int, mesh: Mesh, compress: Optional[str] = None,
                 quant_block: int = 64,
                 rules: Optional[ShardingRules] = None,
                 batch_axis: str = "data"):
        self._setup(cfg, n_stages, seq_len, mesh, compress, quant_block,
                    rules, batch_axis)
        self.stage = stage
        self.prog = get_stage_programs(cfg, n_stages, seq_len,
                                       self.compress_mode)[stage]
        self.fwd_flops_per_token = self.prog.fwd_flops_per_token
        self.bwd_flops_per_token = self.prog.bwd_flops_per_token
        self.param_shardings = stage_param_shardings(self.prog.specs, mesh,
                                                     self.rules)
        self._set_path(self.stages)

    @property
    def stages(self) -> range:
        return range(self.stage, self.stage + 1)

    # ---------------------------------------------------------- lifecycle
    def init_state(self, seed: int) -> StageState:
        state = StageState(params=self._place(
            P.init(seed, self.prog.specs, self.device),
            self.param_shardings))
        state.reset_progress()
        return state

    def for_stage(self, stage: int) -> "MeshExecutor":
        if stage == self.stage:
            return self
        return MeshExecutor(self.cfg, self.n_stages, self.seq_len, stage,
                            *self._args())

    def for_span(self, span: range):
        if len(span) == 1:
            return self.for_stage(span.start)
        return MeshSpanExecutor(self.cfg, self.n_stages, self.seq_len,
                                (span.start, span.stop), *self._args())

    # ---------------------------------------------------------- execution
    def _last(self) -> bool:
        return self.stage == self.n_stages - 1

    def _gathered(self, state: StageState, dev: torch.device) -> Tree:
        return gather_tree(state.params, dev)

    def _blocks(self, state: StageState, dev, j: int) -> Tree:
        return tp.gather_block(state.params, dev, j)

    def _per_model_shard(self, gp: list):
        yield from gp

    def run_fwd(self, state: StageState, inp: Tree,
                labels: Optional[torch.Tensor] = None) -> Tree:
        return self._run_fwd(state, inp, labels, self._last())

    def run_bwd(self, state: StageState, inp: Tree,
                dy: Optional[Tree] = None,
                labels: Optional[torch.Tensor] = None):
        losses, gxs = [], []
        parts = self._bwd_parts(state, self._shards_of(
            inp, labels if self._last() else dy), self._last(), losses, gxs)
        gp = self._reduce_grads(parts, self.param_shardings,
                                tree_map(lambda p: p.shape, state.params))
        loss = self._sum(losses) if self._last() else None
        return loss, self._cat(gxs), gp

    # -------------------------------------------------------- accumulation
    def accumulate(self, state: StageState, gp: Optional[Tree],
                   loss: Optional[float], n_tokens: int,
                   stage: Optional[int] = None) -> None:
        single_stage(self, stage)
        fold_into(state, gp, loss, n_tokens)

    def export_grads(self, state: StageState,
                     stage: Optional[int] = None) -> Tree:
        single_stage(self, stage)
        return self._host(state.grad_acc)

    def export_state(self, state: StageState,
                     stage: Optional[int] = None):
        single_stage(self, stage)
        return self._host(state.params), self._host(state.opt)

    def adopt_step(self, state: StageState, new_params: Tree,
                   new_opt: Tree, stage: Optional[int] = None) -> None:
        single_stage(self, stage)
        self._adopt_view(state, new_params, new_opt, self.param_shardings)

    # ---------------------------------------------------- state transfer
    def snapshot(self, state: StageState, stage: Optional[int] = None,
                 slots=()) -> Tree:
        single_stage(self, stage)
        return self._snapshot_view(state, slots)

    def restore(self, state: StageState, snap: Tree,
                stage: Optional[int] = None, slots=()) -> None:
        single_stage(self, stage)
        self._restore_view(state, snap, self.param_shardings, slots)

    # ------------------------------------------------------ keyed slots
    def export_slot(self, state: StageState, name: str, key,
                    stage: Optional[int] = None) -> Tree:
        single_stage(self, stage)
        return slot_export(state, name, key)

    def install_slot(self, state: StageState, name: str, key, value: Tree,
                     stage: Optional[int] = None) -> None:
        single_stage(self, stage)
        slot_install(state, name, key, value, self.device)

    def drop_slot(self, state: StageState, name: str, key=None,
                  stage: Optional[int] = None) -> None:
        single_stage(self, stage)
        state.drop_slot(name, key)


class MeshSpanExecutor(_MeshBacked):
    """Stages ``[lo, hi)`` fused in one program, over a device mesh.

    :class:`~repro_torch.runtime.pipeline.PipelineExecutor`'s span fusion
    with :class:`MeshExecutor`'s placement: intra-span boundaries stay on
    the devices of the data shard that computes them, while state stays
    per-stage-keyed — each covered stage keeps placed params, optimizer
    state and accumulator of exactly the single-stage shape, so
    All-Reduce groups, checkpoint cuts and span <-> single hand-offs
    work unchanged."""

    def __init__(self, cfg: ArchConfig, n_stages: int, seq_len: int,
                 span: tuple[int, int], mesh: Mesh,
                 compress: Optional[str] = None, quant_block: int = 64,
                 rules: Optional[ShardingRules] = None,
                 batch_axis: str = "data"):
        lo, hi = span
        if not (0 <= lo < hi <= n_stages):
            raise ValueError(f"span [{lo}, {hi}) outside [0, {n_stages})")
        self._setup(cfg, n_stages, seq_len, mesh, compress, quant_block,
                    rules, batch_axis)
        self.span = (lo, hi)
        self.stage = lo                       # entry stage
        self.prog = get_span_program(cfg, n_stages, seq_len, (lo, hi),
                                     self.compress_mode)
        self.fwd_flops_per_token = self.prog.fwd_flops_per_token
        self.bwd_flops_per_token = self.prog.bwd_flops_per_token
        self.param_shardings = {
            s: stage_param_shardings(self.prog.specs[s], mesh, self.rules)
            for s in self.stages}
        self._set_path(self.stages)

    @property
    def stages(self) -> range:
        return range(*self.span)

    def _require(self, stage: Optional[int]) -> int:
        if stage is None:
            raise ValueError(
                f"span executor [{self.span[0]}, {self.span[1]}) needs an "
                "explicit covered stage for per-stage state operations")
        if stage not in self.stages:
            raise ValueError(f"stage {stage} outside span {self.span}")
        return stage

    def _covers_last(self) -> bool:
        return self.span[1] == self.n_stages

    # ---------------------------------------------------------- lifecycle
    def init_state(self, seed: int) -> StageState:
        state = StageState(per_stage={})
        for i, s in enumerate(self.stages):
            sub = StageState(params=self._place(
                P.init(seed + i, self.prog.specs[s], self.device),
                self.param_shardings[s]))
            sub.reset_progress()
            state.per_stage[s] = sub
        return state

    def for_span(self, span: range):
        if (span.start, span.stop) == self.span:
            return self
        if len(span) == 1:
            return MeshExecutor(self.cfg, self.n_stages, self.seq_len,
                                span.start, *self._args())
        return MeshSpanExecutor(self.cfg, self.n_stages, self.seq_len,
                                (span.start, span.stop), *self._args())

    def for_stage(self, stage: int):
        return self.for_span(range(stage, stage + 1))

    # ---------------------------------------------------------- execution
    def _gathered(self, state: StageState, dev: torch.device) -> tuple:
        return tuple(gather_tree(state.per_stage[s].params, dev)
                     for s in self.stages)

    def _blocks(self, state: StageState, dev, j: int) -> tuple:
        return tuple(tp.gather_block(state.per_stage[s].params, dev, j)
                     for s in self.stages)

    def _per_model_shard(self, gps: tuple):
        """A data shard's per-stage gradients (each a list over model
        shards) as one tuple over the stages a model shard."""
        for j in range(len(gps[0])):
            yield tuple(g[j] for g in gps)

    def run_fwd(self, state: StageState, inp: Tree,
                labels: Optional[torch.Tensor] = None) -> Tree:
        return self._run_fwd(state, inp, labels, self._covers_last())

    def run_bwd(self, state: StageState, inp: Tree,
                dy: Optional[Tree] = None,
                labels: Optional[torch.Tensor] = None):
        losses, gxs = [], []
        parts = self._bwd_parts(
            state, self._shards_of(inp, labels if self._covers_last()
                                   else dy), self._covers_last(), losses,
            gxs)
        shardings = tuple(self.param_shardings[s] for s in self.stages)
        gps = self._reduce_grads(parts, shardings, tuple(
            tree_map(lambda p: p.shape, state.per_stage[s].params)
            for s in self.stages))
        loss = self._sum(losses) if self._covers_last() else None
        # per-stage gradients keyed by global stage id, as
        # PipelineExecutor keys them
        return loss, self._cat(gxs), dict(zip(self.stages, gps))

    # -------------------------------------------------------- accumulation
    def accumulate(self, state: StageState, gp: Optional[Tree],
                   loss: Optional[float], n_tokens: int,
                   stage: Optional[int] = None) -> None:
        fold_into(state.per_stage[self._require(stage)], gp, loss, n_tokens)

    def export_grads(self, state: StageState,
                     stage: Optional[int] = None) -> Tree:
        return self._host(state.per_stage[self._require(stage)].grad_acc)

    def export_state(self, state: StageState,
                     stage: Optional[int] = None):
        sub = state.per_stage[self._require(stage)]
        return self._host(sub.params), self._host(sub.opt)

    def adopt_step(self, state: StageState, new_params: Tree,
                   new_opt: Tree, stage: Optional[int] = None) -> None:
        s = self._require(stage)
        self._adopt_view(state.per_stage[s], new_params, new_opt,
                         self.param_shardings[s])

    # ---------------------------------------------------- state transfer
    def snapshot(self, state: StageState, stage: Optional[int] = None,
                 slots=()) -> Tree:
        if stage is None:
            return {"per_stage": {
                s: self._snapshot_view(state.per_stage[s], slots)
                for s in self.stages}}
        return self._snapshot_view(state.per_stage[self._require(stage)],
                                   slots)

    def restore(self, state: StageState, snap: Tree,
                stage: Optional[int] = None, slots=()) -> None:
        if state.per_stage is None:
            state.per_stage = {}
        if stage is None:
            for s, sub_snap in snap["per_stage"].items():
                self.restore(state, sub_snap, stage=int(s), slots=slots)
            return
        s = self._require(stage)
        sub = state.per_stage.setdefault(s, StageState())
        self._restore_view(sub, snap, self.param_shardings[s], slots)

    # ------------------------------------------------------ keyed slots
    def export_slot(self, state: StageState, name: str, key,
                    stage: Optional[int] = None) -> Tree:
        return slot_export(state.per_stage[self._require(stage)], name, key)

    def install_slot(self, state: StageState, name: str, key, value: Tree,
                     stage: Optional[int] = None) -> None:
        slot_install(state.per_stage[self._require(stage)], name, key,
                     value, self.device)

    def drop_slot(self, state: StageState, name: str, key=None,
                  stage: Optional[int] = None) -> None:
        if stage is None:
            for sub in state.views():
                sub.drop_slot(name, key)
            return
        state.per_stage[self._require(stage)].drop_slot(name, key)
