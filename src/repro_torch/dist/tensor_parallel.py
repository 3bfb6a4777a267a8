"""Tensor-parallel compute over a mesh's ``model`` axis for the dense
attention stack, the ``moe`` kind (expert parallelism) and the ``mla``
and ``mla_moe`` kinds (DeepSeek-V2's latent attention): the per-leaf
plan, the model shards of one data shard, the all-reduces of activation
partials and of cotangents, the gathers a MoE layer makes at home, and
the vocab-parallel embedding and cross-entropy.

The JAX package has no counterpart file.  There GSPMD partitions each
product of the jitted step by its operands' layouts
(``repro.dist.sharding``: "FSDP-over-``data`` + tensor-parallel-over-
``model``") and inserts the collectives itself.  The port writes out the
program GSPMD derives, one data shard at a time, for the block kinds of
:data:`SUPPORTED_KINDS`; a stage or model holding any other kind keeps
the gathered path (every leaf gathered whole onto the data shard's
device, which computes alone).

**Plan.**  Which tensors split is read off each leaf's *resolved* spec
(:func:`split_dim`, after ``dist.constrain.resolve_spec``'s divisibility
fallback), never off its logical names: a leaf whose spec puts
``model`` on a dim is held by model shard ``j`` as its block ``j`` only
(:func:`gather_block`, gathered over ``data``), every other leaf whole.
The layer code reads what it holds: a head, FFN or vocab dim shorter
than the config's is split.

**Scheme.**  A data shard's model shards form a :class:`Group`;
``devs[0]`` is its *home*, the device the data shard computes on without
tensor parallelism, where its residual stream lives.

* Column-parallel inputs: the input is sent to every shard
  (:func:`fanout`), each projects onto its own heads or FFN columns (the
  norm before it runs on every shard, on the shard's copy).  MLA's
  down-projections (``w_dq``, ``w_dkv``, ``w_krope``) replicate over
  ``model``: every shard computes the latents from its copy, then its
  heads' up-projections (``models.mla.mla_part``).
* Row-parallel outputs: each shard's partial ``[rows, S, d]``, left in
  f32 by its product, is summed at home (:func:`all_reduce`) before the
  residual add: added in f32 in shard order and rounded once to the
  compute dtype, as one device rounds the whole product once.
* Work whose weights replicate and whose output is used once (attention
  whose heads do not divide ``model``, an FFN whose width does not, an
  embedding or head whose vocab does not, routed experts whose count
  does not) runs whole at home, as one device runs it: no shard repeats
  it.
* Routed experts split over ``model`` (``"experts": "model"``, expert
  parallelism sharing the axis, as JAX's rules say): home gathers the
  router's column blocks (:func:`gather_home`) and routes as one device
  does.  Where one data shard computes a microbatch, each shard runs its
  experts over the pairs routed to them from its copy of the stream, and
  home takes each pair's row from its expert's shard by selection
  (:func:`select_home`), then weights and sums: the routed output is the
  one-device one (``models.layers.apply_moe_tp``).  Where the microbatch
  is split over every data shard and the model width divides ``data``,
  the routed expert stacks stay on their FSDP slice (``gather_block``
  with ``data``) and each expert's C slots are computed once per
  microbatch, in the layout JAX compiles
  (``models.layers.apply_moe_a2a``): at each model index the data
  shards' coordinates (a :class:`Column`) exchange the stream's columns
  (:func:`columns_to_slices`, an all-to-all) and the route's integers
  (:func:`gather_slots`, an all-gather), fill ``[E / m, C, d / n]``,
  sum their gate and up partials (:func:`sum_partials`, an all-reduce
  in f32) and send each pair's row slice to its home
  (:func:`rows_to_home`).  Either way the data shards of a microbatch
  route in lockstep, as on the gathered path
  (``models.blocks.apply_lockstep_tp``).
* One autograd graph spans the shards.  :func:`fanout`'s backward is the
  all-reduce of the shards' cotangents (f32, rounded once), so the
  stage's input cotangent is their sum; a replicated leaf used on
  several shards (a norm scale, ``wk``/``wv`` where only ``wq`` splits,
  or MLA's down-projections) gets one partial gradient a shard, which
  the caller's reduce-scatter adds, as JAX's all-reduce of those
  partials does.

Serving (``models.blocks``' serving halves, ``models.model.
lm_prefill_tp`` / ``lm_decode_step_tp``): each decode cache is held by
the model shards as JAX's layout holds it (``dist.sharding.
cache_shardings_from_specs``: a block a shard where the kv heads split
``model``, else a copy a shard, MLA's latent cache always a copy).
Every shard writes its own block or copy from its copy of the stream,
by the same ops on the same bits as any other shard, so the copies are
equal to the bit and no cache crosses a shard.  The greedy token is
taken from vocab-split logits without gathering them
(:func:`vocab_parallel_argmax`).

Every collective here is logged (``dist.mesh.log_collective``): an
all-reduce as received by each shard of the group, a gather to home
(``all-gather``, ``all-to-all``) as received by home; an exchange over
``data`` as received by each coordinate of its column, forward and
backward; and counted in :data:`ALL_REDUCES` by what it carries.  With
one model shard none of this runs: the one-device functions are the
``m = 1`` case.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.dist.mesh import Mesh, NamedSharding, Placed, at, \
    axis_names_of, gather, gather_tree, log_collective
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like

Tree = Any

MODEL_AXIS = "model"
DATA_AXIS = "data"
# the routed expert stacks of a ``moe`` subtree: held as their data slice
# where each expert's slots are computed once per microbatch
EXPERT_STACKS = ("wi_gate", "wi_up", "wo")
# the block kinds whose layers compute tensor-parallel (the dense
# attention stack, attention + routed experts, and latent attention with
# a dense FFN or routed experts); a stage holding any other kind keeps
# the gathered path
SUPPORTED_KINDS = frozenset({"attn", "moe", "mla", "mla_moe"})
# stage subtrees gathered whole at home and absent on the other shards:
# the learned codec, whose ``bottleneck`` split is not computed on
WHOLE_AT_HOME = ("boundary",)

# collectives made, by what they carry: "activation" (a layer's attention
# or FFN partials, forward and recompute), "cotangent" (fanout's
# backward), "embedding" (the vocab-parallel rows), "loss" (the
# cross-entropy's max, exponential sum and gold logit), and a MoE layer's
# "router" (its column blocks gathered at home), "expert_rows" (each
# pair's row taken at home from its expert's shard) and "shared_expert"
# (the shared expert's partials), and serving's "argmax" (each vocab
# block's largest logit and its index, gathered at home).  Where experts
# are computed once per microbatch, a MoE layer counts once a pass
# "expert_columns" (the stream's columns over ``data``), "expert_slots"
# (the route's integers), "expert_partials" (the gate and up partials)
# and "expert_rows" (each pair's row slices at home); the backward of
# the first and third counts under "cotangent"
ALL_REDUCES: collections.Counter = collections.Counter()


# ------------------------------------------------------------------ plan
def model_size(mesh) -> int:
    return int(mesh.shape.get(MODEL_AXIS, 1))


def split_dim(sharding: NamedSharding, axis: str = MODEL_AXIS
              ) -> Optional[int]:
    """The dim a leaf's resolved spec puts ``axis`` on (None: the leaf
    replicates over it)."""
    for d, entry in enumerate(sharding.spec):
        if axis in axis_names_of(entry):
            return d
    return None


def runs_tensor_parallel(cfg, kinds, mesh) -> bool:
    """Does a stage (or model) holding layers of ``kinds`` compute
    tensor-parallel on ``mesh``?  Only with more than one model shard,
    every kind supported, and no encoder (whisper keeps the gathered
    path)."""
    return (model_size(mesh) > 1 and not cfg.encoder_layers
            and set(kinds) <= SUPPORTED_KINDS)


# ------------------------------------------------------------- the group
@dataclasses.dataclass
class Group:
    """The model shards of one data shard: ``devs[j]`` and ``coords[j]``
    are model shard ``j``'s device and mesh coordinate; ``devs[0]`` is
    home."""
    devs: list
    coords: list

    @classmethod
    def of(cls, mesh: Mesh, **at_axes: int) -> "Group":
        """The model shards of the coordinate with ``at_axes``."""
        coords = [mesh.coord(**at_axes, **{MODEL_AXIS: j})
                  for j in range(model_size(mesh))]
        return cls([mesh.devices[c] for c in coords], coords)

    @property
    def m(self) -> int:
        return len(self.devs)

    @property
    def home(self) -> torch.device:
        return self.devs[0]

    def scope(self, j: int):
        """The context model shard ``j``'s ops run in (its coordinate)."""
        return at(self.coords[j])

    def per_shard(self, f: Callable, *cols) -> list:
        """``f(j, *entries)`` for every shard, each in its scope."""
        out = []
        for j, args in enumerate(zip(*cols)):
            with self.scope(j):
                out.append(f(j, *args))
        return out


@dataclasses.dataclass
class ModelShards:
    """One data shard's params over its model shards: ``trees[j]`` on
    ``group.devs[j]``, each the block :func:`gather_block` gives;
    ``data`` the data shard whose slice of the routed expert stacks they
    hold (None: the stacks whole over ``data``)."""
    trees: list
    group: Group
    data: Optional[int] = None

    def sub(self, key) -> "ModelShards":
        """Every shard's ``tree[key]`` (a span's per-stage tree)."""
        return ModelShards([t[key] for t in self.trees], self.group,
                           self.data)


def _expert_mask(t, parent, key, is_leaf, out: list) -> None:
    # module-level, as ``tree._collect`` (a closure calling itself is a
    # reference cycle)
    if (is_leaf is not None and is_leaf(t)) or not (
            t is None or isinstance(t, (dict, list, tuple))):
        out.append(parent == "moe" and key in EXPERT_STACKS)
    elif isinstance(t, dict):
        for k in sorted(t):
            _expert_mask(t[k], key, k, is_leaf, out)
    elif isinstance(t, (list, tuple)):
        for v in t:
            _expert_mask(v, None, None, is_leaf, out)


def expert_mask(tree: Tree, is_leaf=None, key=None) -> list:
    """For each leaf of ``tree`` (``tree_leaves`` order; ``key`` the
    tree's own key in its parent): is it a routed expert stack
    (:data:`EXPERT_STACKS` of a ``moe`` subtree)?"""
    out: list = []
    _expert_mask(tree, None, key, is_leaf, out)
    return out


def slices_experts(mesh, n_shards: int, batch_axis: str = DATA_AXIS
                   ) -> bool:
    """Are the routed expert stacks held as their data slice, a
    microbatch split into ``n_shards`` over ``batch_axis``?  Only where
    it is split over every shard of ``data``, with more than one model
    shard (ROADMAP 5(d)1; a stack whose width does not divide ``data``
    replicates over it and comes whole all the same)."""
    return (batch_axis == DATA_AXIS and model_size(mesh) > 1
            and n_shards > 1 and int(mesh.shape.get(DATA_AXIS, 1))
            == n_shards)


def _sliced(mesh, spec) -> bool:
    """Does a routed expert stack laid out by ``spec`` come as its data
    slice: its experts split over ``model`` and its width over
    ``data``?"""
    sh = NamedSharding(mesh, tuple(spec))
    return split_dim(sh) is not None and \
        split_dim(sh, DATA_AXIS) is not None


def holds_slices(shardings: Tree) -> bool:
    """Does a routed expert stack of ``shardings`` (a stage's, or a
    span's per-stage dict, of ``NamedSharding`` s) come as its data
    slice: its experts split over ``model`` and its width over
    ``data``?"""
    is_sh = lambda x: isinstance(x, NamedSharding)  # noqa: E731
    return any(e and _sliced(sh.mesh, sh.spec) for sh, e in zip(
        tree_leaves(shardings, is_leaf=is_sh),
        expert_mask(shardings, is_sh)))


def gather_block(tree: Tree, device, j: int, data: Optional[int] = None
                 ) -> Tree:
    """Model block ``j`` of every placed leaf of a stage (or model) tree,
    gathered over the other axes onto ``device``: a leaf split over
    ``model`` as its block ``j``, any other leaf whole.  With ``data``,
    a routed expert stack comes as the block of coordinate ``(data,
    j)``: its own FSDP slice of the model width, never gathered over
    ``data`` (where its experts split ``model`` and its width splits
    ``data``; else as any other leaf).  The subtrees of
    :data:`WHOLE_AT_HOME` come whole at ``j == 0`` and as None
    elsewhere."""
    def blk(key, sub):
        out = []
        for p, e in zip(tree_leaves(sub), expert_mask(sub, key=key)):
            where = {MODEL_AXIS: j}
            if e and data is not None and isinstance(p, Placed) and \
                    _sliced(p.mesh, p.spec):
                where[DATA_AXIS] = data
            out.append(gather(p, device, where=where)
                       if isinstance(p, Placed) else p)
        return tree_unflatten_like(sub, out)
    return {k: (gather_tree(sub, device) if j == 0 else None)
            if k in WHOLE_AT_HOME else blk(k, sub) for k, sub in tree.items()}


def block_bytes(specs: Tree, shardings: Tree, j: int,
                data: Optional[int] = None) -> int:
    """The bytes :func:`gather_block` gives model shard ``j`` of a stage
    (or model) tree, reckoned from its ``ParamSpec`` tree and the plan:
    a leaf split over ``model`` a ``1 / m`` block, any other leaf whole,
    with ``data`` a routed expert stack whose experts split ``model`` and
    whose width splits ``data`` a ``1 / (m n)`` block, the
    :data:`WHOLE_AT_HOME` subtrees whole at ``j == 0`` only."""
    from repro_torch.models.params import is_spec
    total = 0
    for k, sub in specs.items():
        if k in WHOLE_AT_HOME and j:
            continue
        for spec, sh, e in zip(
                tree_leaves(sub, is_leaf=is_spec), tree_leaves(
                    shardings[k], is_leaf=lambda x: isinstance(
                        x, NamedSharding)), expert_mask(sub, is_spec, k)):
            d = None if k in WHOLE_AT_HOME else split_dim(sh)
            n = math.prod(spec.shape)
            if d is not None:
                n //= model_size(sh.mesh)
            if e and data is not None and _sliced(sh.mesh, sh.spec):
                n //= int(sh.mesh.shape[DATA_AXIS])
            total += n * torch.empty((), dtype=spec.dtype).element_size()
    return total


# ----------------------------------------------------------- collectives
def _move(x: torch.Tensor, group: Group, j: int) -> torch.Tensor:
    """``x`` on shard ``j``'s device: a copy where the device differs, or
    on ``meta`` where the coordinate does (the dry run reckons each
    coordinate's bytes), else ``x`` itself (a virtual mesh)."""
    dev = group.devs[j]
    copy = dev.type == "meta" and group.coords[j] != group.coords[0]
    return x.to(dev, copy=copy)


class _Fanout(torch.autograd.Function):
    """Home's ``x`` on every shard; backward: the shards' cotangents
    summed at home in f32, rounded once (an all-reduce)."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group, ctx.dtype = group, x.dtype
        outs = []
        for j in range(group.m):
            with group.scope(j):
                y = _move(x, group, j)
                outs.append(y.view_as(y) if y is x else y)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        group = ctx.group
        live = [g for g in gs if g is not None]
        with group.scope(0):
            total = live[0].to(group.home, torch.float32)
            for g in live[1:]:
                total = total + g.to(group.home, torch.float32)
            total = total.to(ctx.dtype)
        _logged(group, "cotangent", _nbytes(total))
        return None, total


class _AllReduce(torch.autograd.Function):
    """The shards' partials summed at home in f32, rounded once to
    ``dtype``; backward: home's cotangent on every shard, in its
    partial's dtype."""

    @staticmethod
    def forward(ctx, group, dtype, *parts):
        ctx.group, ctx.dtypes = group, [p.dtype for p in parts]
        with group.scope(0):
            total = parts[0].to(group.home, torch.float32)
            for p in parts[1:]:
                total = total + p.to(group.home, torch.float32)
            return total.to(dtype)

    @staticmethod
    def backward(ctx, g):
        group = ctx.group
        outs = []
        for j in range(group.m):
            with group.scope(j):
                outs.append(_move(g, group, j).to(ctx.dtypes[j]))
        return (None, None, *outs)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _logged(group: Group, what: str, nbytes: int, kind: str = "all-reduce",
            coords: Optional[list] = None) -> None:
    """Count a collective under ``what`` and log it as ``kind`` received
    by ``coords`` (default: every shard of the group)."""
    ALL_REDUCES[what] += 1
    log_collective(kind, group.coords if coords is None else coords, nbytes)


def fanout(x: torch.Tensor, group: Group) -> list:
    """Home's ``x`` on every shard of ``group`` (differentiable)."""
    return list(_Fanout.apply(group, x))


def all_reduce(parts: Sequence[torch.Tensor], group: Group,
               what: str = "activation",
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The sum of the shards' ``parts`` at home, added in f32 in shard
    order and rounded once to ``dtype`` (default: the parts'):
    differentiable.  A layer's row-parallel partials come in f32
    (``models.layers._RowPartial``), so its output is rounded to the
    compute dtype once, after the sum, as one device rounds its whole
    product once."""
    out = _AllReduce.apply(group, dtype or parts[0].dtype, *parts)
    _logged(group, what, _nbytes(out))
    return out


def all_reduce_max(parts: Sequence[torch.Tensor], group: Group
                   ) -> torch.Tensor:
    """The elementwise max of the shards' ``parts`` at home (no
    gradient)."""
    with torch.no_grad(), group.scope(0):
        out = parts[0].to(group.home)
        for p in parts[1:]:
            out = torch.maximum(out, p.to(group.home))
    _logged(group, "loss", _nbytes(out))
    return out


def _at_home(x: torch.Tensor, group: Group, j: int) -> torch.Tensor:
    """Shard ``j``'s ``x`` on home's device, as :func:`_move` moves the
    other way (differentiable: the cotangent goes back to shard
    ``j``)."""
    copy = group.home.type == "meta" and group.coords[j] != group.coords[0]
    return x.to(group.home, copy=copy)


def gather_home(parts: Sequence[torch.Tensor], group: Group, what: str,
                dim: int = -1) -> torch.Tensor:
    """The shards' ``parts`` joined along ``dim`` at home (an all-gather
    received by home; differentiable: each shard's cotangent is its
    slice of home's)."""
    with group.scope(0):
        out = torch.cat([_at_home(p, group, j) for j, p in enumerate(parts)],
                        dim)
    _logged(group, what, sum(_nbytes(p) for p in parts[1:]), "all-gather",
            group.coords[:1])
    return out


def select_home(parts: Sequence[torch.Tensor], owner: torch.Tensor,
                group: Group, what: str) -> torch.Tensor:
    """Row ``r`` of shard ``owner[r]``'s part, for every row, at home
    (``parts[j]`` ``[R, ...]`` on shard ``j``, ``owner`` ``[R]`` int at
    home): taken by selection, never summed, so each row is its owner's
    to the bit.  Logged as an all-to-all received by home;
    differentiable: shard ``j``'s cotangent is home's on its rows,
    zeros elsewhere.  The expert-parallel MoE uses it where one data
    shard computes a microbatch (``models.layers.apply_moe_tp``); where
    the microbatch is split over ``data`` and experts are computed once
    per microbatch, :func:`rows_to_home` takes its place."""
    with group.scope(0):
        out = parts[0]
        for j in range(1, group.m):
            mine = (owner == j).reshape((-1,) + (1,) * (out.dim() - 1))
            out = torch.where(mine, _at_home(parts[j], group, j), out)
    _logged(group, what, sum(_nbytes(p) for p in parts[1:]), "all-to-all",
            group.coords[:1])
    return out


# ---------------------------------------------- exchanges over ``data``
@dataclasses.dataclass
class Column:
    """The coordinates of a microbatch's data shards at one model index:
    ``devs[i]`` / ``coords[i]`` data shard ``i``'s.  The first
    ``computed`` compute; where fewer than all do (the dry run computes
    data shard 0 for equal ones), each other shard's part in an exchange
    stands as shard 0's tensor of the same shape, moved and logged from
    its own coordinate, so that each computed coordinate receives the
    bytes a real exchange gives it (a reckoning of shapes and bytes, not
    of values)."""
    devs: list
    coords: list
    computed: int

    @classmethod
    def of(cls, groups: Sequence[Group], j: int,
           computed: Optional[int] = None) -> "Column":
        return cls([g.devs[j] for g in groups], [g.coords[j] for g in groups],
                   len(groups) if computed is None else computed)

    @property
    def n(self) -> int:
        return len(self.devs)

    def scope(self, i: int):
        return at(self.coords[i])

    def per_shard(self, f: Callable, *cols) -> list:
        """``f(i, *entries)`` for every computed data shard, each in its
        scope."""
        out = []
        for i, args in enumerate(zip(*cols)):
            with self.scope(i):
                out.append(f(i, *args))
        return out

    def cross(self, x: torch.Tensor, src: int, dst: int) -> torch.Tensor:
        """``x`` from data shard ``src``'s coordinate on ``dst``'s (a copy
        on ``meta`` where the coordinates differ, as :func:`_move`)."""
        dev = self.devs[dst]
        copy = dev.type == "meta" and self.coords[src] != self.coords[dst]
        with self.scope(dst):
            return x.to(dev, copy=copy)

    def log(self, kind: str, nbytes: Sequence[int]) -> None:
        """Log ``nbytes[i]`` received by data shard ``i``'s coordinate."""
        for c, b in zip(self.coords, nbytes):
            if b:
                log_collective(kind, [c], b)


def _row_bounds(rows: Sequence[int]) -> list:
    out, lo = [], 0
    for r in rows:
        out.append((lo, lo + r))
        lo += r
    return out


class _ColumnsToSlices(torch.autograd.Function):
    """Every data shard's rows of the stream, slice ``i`` of its columns,
    at data shard ``i``'s coordinate (an all-to-all over ``data``);
    backward: the transpose, each source's rows of every slice's
    cotangent joined back along its columns."""

    @staticmethod
    def forward(ctx, col, dn, count, *xs):
        ctx.col, ctx.dn, ctx.count = col, dn, count
        ctx.bounds = _row_bounds([x.shape[0] for x in xs])
        outs = []
        for i in range(col.computed):
            sl = slice(i * dn, (i + 1) * dn)
            pieces = [col.cross(x[:, sl], src, i) for src, x in
                      enumerate(xs)]
            with col.scope(i):
                outs.append(torch.cat(pieces))
        es = xs[0].element_size()
        col.log("all-to-all", [
            sum(x.shape[0] for s, x in enumerate(xs) if s != i) * dn * es
            for i in range(col.n)])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        col, dn, bounds = ctx.col, ctx.dn, ctx.bounds
        grads = []
        for src in range(col.computed):
            lo, hi = bounds[src]
            pieces = []
            for i in range(col.n):
                g = gs[i if i < col.computed else 0]
                pieces.append(col.cross(g[lo:hi], i, src))
            with col.scope(src):
                grads.append(torch.cat(pieces, dim=1))
        es = gs[0].element_size()
        col.log("all-to-all", [(hi - lo) * dn * es * (col.n - 1)
                               for lo, hi in bounds])
        ALL_REDUCES["cotangent"] += ctx.count
        return (None, None, None, *grads,
                *([None] * (col.n - col.computed)))


def columns_to_slices(xs: Sequence[torch.Tensor], col: Column, dn: int,
                      count: bool = True) -> list:
    """Data shard ``i``'s coordinate's ``[sum rows, dn]``: every data
    shard's rows (``xs[s]`` ``[rows_s, d]`` on shard ``s``'s coordinate,
    row order; a list of ``col.n`` where shards past ``col.computed``
    stand as shard 0's) sliced to columns ``i * dn`` on, for each
    computed ``i`` (differentiable).  ``count``: count it in
    :data:`ALL_REDUCES` (once a layer pass over every model index), its
    backward under "cotangent"."""
    xs = list(xs) + [xs[0]] * (col.n - len(xs))
    ALL_REDUCES["expert_columns"] += count
    return list(_ColumnsToSlices.apply(col, dn, count, *xs))


def gather_slots(slots: Sequence[torch.Tensor], homes: Sequence[Group],
                 col: Column, count: bool = True) -> list:
    """Every data shard's integers (``slots[s]`` at data shard ``s``'s
    home, row order; ``homes`` every data shard's group), joined at each
    computed coordinate of ``col`` (an
    all-gather over ``data``; the integers reach a data shard's model
    shards with its stream, unlogged, as :func:`on_shards` sends
    them)."""
    slots = list(slots) + [slots[0]] * (col.n - len(slots))
    out = []
    for i in range(col.computed):
        with col.scope(i):
            out.append(torch.cat([
                s.to(col.devs[i], copy=col.devs[i].type == "meta"
                     and homes[k].coords[0] != col.coords[i])
                for k, s in enumerate(slots)]))
    es = slots[0].element_size()
    col.log("all-gather", [sum(s.numel() for k, s in enumerate(slots)
                               if k != i) * es for i in range(col.n)])
    ALL_REDUCES["expert_slots"] += count
    return out


class _SumPartials(torch.autograd.Function):
    """The data shards' f32 partials summed in data order, rounded once
    to ``dtype``, on every computed coordinate (an all-reduce over
    ``data``); backward: the cotangents summed the same way, in f32."""

    @staticmethod
    def forward(ctx, col, dtype, count, *parts):
        ctx.col, ctx.count = col, count
        total = _sum_at(col, parts)
        col.log("all-reduce", [_nbytes(total)] * col.n)
        return _distinct([col.cross(total, 0, i).to(dtype)
                          for i in range(col.computed)])

    @staticmethod
    def backward(ctx, *gs):
        col = ctx.col
        gs = list(gs) + [gs[0]] * (col.n - col.computed)
        total = _sum_at(col, gs)
        col.log("all-reduce", [_nbytes(total)] * col.n)
        ALL_REDUCES["cotangent"] += ctx.count
        grads = _distinct([col.cross(total, 0, i)
                           for i in range(col.computed)])
        return (None, None, None, *grads,
                *([None] * (col.n - col.computed)))


def _distinct(ts: list) -> tuple:
    """``ts`` with a repeated tensor (one device listed twice) cloned."""
    out: list = []
    for t in ts:
        out.append(t.clone() if any(t is o for o in out) else t)
    return tuple(out)


# the rows of another shard's partial received at a time by
# :func:`_sum_at`: an all-reduce receives in chunks, so no coordinate
# holds a second whole partial beside its own and the sum
SUM_CHUNK_BYTES = 64 << 20


def _sum_at(col: Column, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``parts`` (one a data shard, on its coordinate, ``[E, C, .]``)
    added in f32 in data order at data shard 0's coordinate, each other
    shard's part received :data:`SUM_CHUNK_BYTES` of slots at a time
    (elementwise, so the bits are the whole sum's)."""
    with col.scope(0):
        total = parts[0].to(torch.float32, copy=True)
        step = max(1, SUM_CHUNK_BYTES // max(
            1, _nbytes(total[:, :1])))
        for i, p in enumerate(parts[1:], 1):
            for lo in range(0, p.shape[1], step):
                total[:, lo:lo + step].add_(col.cross(
                    p[:, lo:lo + step], i, 0).to(torch.float32))
    return total


def sum_partials(parts: Sequence[torch.Tensor], col: Column,
                 dtype: torch.dtype, count: bool = True) -> list:
    """The sum of the data shards' f32 ``parts`` (one a computed
    coordinate of ``col``) on each of them, rounded once to ``dtype``
    (differentiable; ``count`` as :func:`columns_to_slices`)."""
    parts = list(parts) + [parts[0]] * (col.n - len(parts))
    ALL_REDUCES["expert_partials"] += count
    return list(_SumPartials.apply(col, dtype, count, *parts))


class _RowsToHome(torch.autograd.Function):
    """Home's ``[R, n * dn]``: column slice ``i`` of row ``r`` from the
    coordinate ``(i, owner[r])``, taken by selection; backward: each
    coordinate's slice of the cotangent on its rows, zeros elsewhere,
    made on that coordinate."""

    @staticmethod
    def forward(ctx, home, cols, owner, *parts):
        ctx.home, ctx.cols = home, cols
        ctx.save_for_backward(owner)
        m = len(cols)
        slices = []
        for i in range(cols[0].n):
            with at(home.coords[0]):
                out = _to_home(parts[i * m], home, cols[0], i)
                for j in range(1, m):
                    mine = (owner == j)[:, None]
                    out = torch.where(mine, _to_home(parts[i * m + j], home,
                                                     cols[j], i), out)
                slices.append(out)
        with at(home.coords[0]):
            return torch.cat(slices, dim=1)

    @staticmethod
    def backward(ctx, g):
        (owner,) = ctx.saved_tensors
        home, cols = ctx.home, ctx.cols
        m, n, comp = len(cols), cols[0].n, cols[0].computed
        dn = g.shape[1] // n
        grads = [None] * (n * m)
        for i in range(comp):
            for j, col in enumerate(cols):
                dev = col.devs[i]
                copy = dev.type == "meta" and col.coords[i] != home.coords[0]
                with col.scope(i):
                    gi = g[:, i * dn:(i + 1) * dn].to(dev, copy=copy)
                    mine = owner.to(dev, copy=copy) == j
                    grads[i * m + j] = torch.where(mine[:, None], gi, 0.0)
        return (None, None, None, *grads)


def _to_home(x: torch.Tensor, home: Group, col: Column, i: int
             ) -> torch.Tensor:
    copy = home.home.type == "meta" and col.coords[i] != home.coords[0]
    return x.to(home.home, copy=copy)


def rows_to_home(parts: Sequence[Sequence[torch.Tensor]],
                 owner: torch.Tensor, home: Group, cols: Sequence[Column]
                 ) -> torch.Tensor:
    """A data shard's pairs' rows ``[R, n * dn]`` at its ``home``:
    ``parts[i][j]`` ``[R, dn]`` on coordinate ``(i, j)`` (``cols[j]``'s
    ``i``; zeros where model shard ``j`` does not own the pair; rows
    past ``cols[j].computed`` stand as shard 0's), column slice ``i`` of
    row ``r`` taken from ``(i, owner[r])`` by selection, never summed.
    Logged as an all-to-all received by home; differentiable."""
    n, m = cols[0].n, len(cols)
    parts = [list(parts[i]) if i < len(parts) else
             [p.detach() for p in parts[0]] for i in range(n)]
    flat = [p for row in parts for p in row]
    nb = _nbytes(flat[0])
    log_collective("all-to-all", home.coords[:1], nb * (n * m - 1))
    return _RowsToHome.apply(home, list(cols), owner, *flat)


def on_shards(x: torch.Tensor, group: Group) -> list:
    """A tensor that takes no gradient (positions, token ids, labels)
    on every shard."""
    return [_move(x, group, j) for j in range(group.m)]


# ------------------------------------------------------------ vocabulary
def embed_rows(table: torch.Tensor, tokens: torch.Tensor, lo: int
               ) -> torch.Tensor:
    """The rows of a vocab block starting at id ``lo`` for ``tokens``:
    zero rows for ids outside the block."""
    local = tokens.long() - lo
    inside = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    return rows * inside[..., None].to(rows.dtype)


def vocab_parallel_embed(tables: Sequence[torch.Tensor],
                         tokens: torch.Tensor, group: Group
                         ) -> torch.Tensor:
    """The embedding rows of ``tokens`` from a vocab-split table
    (``tables[j]`` shard ``j``'s block): each shard looks up the ids in
    its range, zero rows elsewhere, and the rows are summed at home.
    One shard holds each id, so the f32 sum is exact: home gets the
    one-device lookup's values."""
    toks = on_shards(tokens, group)
    vj = tables[0].shape[0]
    parts = group.per_shard(lambda j, t, ids: embed_rows(t, ids, j * vj),
                            tables, toks)
    return all_reduce(parts, group, "embedding")


def vocab_parallel_nll(logits: Sequence[torch.Tensor], labels: torch.Tensor,
                       group: Group) -> torch.Tensor:
    """Per-token ``logsumexp - gold`` ``[B, S]`` f32 at home from
    vocab-split logits (``logits[j]`` ``[B, S, V / m]``, any float),
    without gathering them: the max over shards (all-reduced), the sum
    of exponentials over shards, and the gold logit from the shard that
    owns the label (taken by ``gather``, as ``train.steps.cross_entropy``
    takes it)."""
    vj = logits[0].shape[-1]
    ls = group.per_shard(lambda j, x: x.to(torch.float32), logits)
    mx = all_reduce_max([x.detach().amax(-1) for x in ls], group)
    mxs = on_shards(mx, group)
    se = all_reduce(group.per_shard(
        lambda j, x, m: torch.exp(x - m[..., None]).sum(-1), ls, mxs),
        group, "loss")
    labs = on_shards(labels, group)

    def gold(j, x, lab):
        local = lab.long() - j * vj
        inside = (local >= 0) & (local < vj)
        g = torch.gather(x, -1, local.clamp(0, vj - 1)[..., None])[..., 0]
        return g * inside.to(g.dtype)
    gl = all_reduce(group.per_shard(gold, ls, labs), group, "loss")
    with group.scope(0):
        return mx + torch.log(se) - gl



def vocab_parallel_argmax(parts: Sequence[torch.Tensor], group: Group
                          ) -> torch.Tensor:
    """``torch.argmax(dim=-1)`` of the rows the shards' vocab blocks form
    (``parts[j]`` shard ``j``'s ``[..., V / m]``, block ``j`` of the
    vocab), at home, without gathering them: each shard's largest logit
    and its first index there, then at home the largest, the lowest
    global index among equals (the earlier shard's where two blocks
    tie), NaN above every number, as ``torch.argmax`` takes them.  One
    part is the whole row at home."""
    if len(parts) == 1:
        with group.scope(0):
            return parts[0].argmax(-1)
    vj = parts[0].shape[-1]

    def local(j, x):
        i = x.argmax(-1)
        return x.gather(-1, i[..., None])[..., 0], i + j * vj
    loc = group.per_shard(local, parts)
    with torch.no_grad(), group.scope(0):
        val, idx = loc[0]
        for j, (v, i) in enumerate(loc[1:], 1):
            v, i = _at_home(v, group, j), _at_home(i, group, j)
            better = (v > val) | (v.isnan() & ~val.isnan())
            val = torch.where(better, v, val)
            idx = torch.where(better, i, idx)
    _logged(group, "argmax", sum(_nbytes(v) + _nbytes(i)
                                 for v, i in loc[1:]),
            "all-gather", group.coords[:1])
    return idx


# ----------------------------------------------------------------- caches
def cache_shards(tree: Tree, coord: tuple) -> Tree:
    """A placed cache tree's blocks at mesh coordinate ``coord``: the
    block or copy that coordinate reads and writes in place."""
    return tree_map(lambda p: p.shards[coord] if isinstance(p, Placed)
                    else p, tree)


def check_cache_blocks(caches: Tree, shapes: Tree, shardings: Tree,
                       coord: tuple) -> None:
    """Raise unless every leaf of ``caches`` (a model shard's serving
    caches) has the shape of its block at ``coord`` by ``shardings``
    (JAX's cache layout for the whole batch; ``shapes`` a tree of the
    leaves' global ``torch.Size``)."""
    from repro_torch.dist.mesh import shard_slices
    sizes = tree_leaves(shapes, is_leaf=lambda x: isinstance(x,
                                                              torch.Size))
    shs = tree_leaves(shardings, is_leaf=lambda x: isinstance(
        x, NamedSharding))
    want = [torch.Size(x.stop - x.start for x in shard_slices(
        n, s.mesh, tuple(s.spec), coord)) for n, s in zip(sizes, shs)]
    got = [t.shape for t in tree_leaves(caches)]
    if got != want:
        raise ValueError(f"caches at {coord}: blocks {got} where the "
                         f"layout gives {want}")
