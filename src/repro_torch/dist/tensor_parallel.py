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
  does; each shard runs its experts over the pairs routed to them from
  its copy of the stream, and home takes each pair's row from its
  expert's shard by selection (:func:`select_home`), then weights and
  sums: the routed output is the one-device one.  The data shards of a
  microbatch route in lockstep, as on the gathered path
  (``models.layers.apply_moe_tp``, ``models.blocks.apply_lockstep_tp``).
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
(``all-gather``, ``all-to-all``) as received by home; and counted in
:data:`ALL_REDUCES` by what it carries.  With one model shard none of this
runs: the one-device functions are the ``m = 1`` case.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.dist.mesh import Mesh, NamedSharding, Placed, at, \
    axis_names_of, gather, gather_tree, log_collective
from repro_torch.tree import tree_leaves, tree_map

Tree = Any

MODEL_AXIS = "model"
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
# block's largest logit and its index, gathered at home)
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
    ``group.devs[j]``, each the block :func:`gather_block` gives."""
    trees: list
    group: Group

    def sub(self, key) -> "ModelShards":
        """Every shard's ``tree[key]`` (a span's per-stage tree)."""
        return ModelShards([t[key] for t in self.trees], self.group)


def gather_block(tree: Tree, device, j: int) -> Tree:
    """Model block ``j`` of every placed leaf of a stage (or model) tree,
    gathered over the other axes onto ``device``: a leaf split over
    ``model`` as its block ``j``, any other leaf whole.  The subtrees of
    :data:`WHOLE_AT_HOME` come whole at ``j == 0`` and as None
    elsewhere."""
    def blk(sub):
        return tree_map(lambda p: gather(p, device, where={MODEL_AXIS: j})
                        if isinstance(p, Placed) else p, sub)
    return {k: (gather_tree(sub, device) if j == 0 else None)
            if k in WHOLE_AT_HOME else blk(sub) for k, sub in tree.items()}


def block_bytes(specs: Tree, shardings: Tree, j: int) -> int:
    """The bytes :func:`gather_block` gives model shard ``j`` of a stage
    (or model) tree, reckoned from its ``ParamSpec`` tree and the plan:
    a leaf split over ``model`` a ``1 / m`` block, any other leaf whole,
    the :data:`WHOLE_AT_HOME` subtrees whole at ``j == 0`` only."""
    from repro_torch.models.params import is_spec
    total = 0
    for k, sub in specs.items():
        if k in WHOLE_AT_HOME and j:
            continue
        for spec, sh in zip(tree_leaves(sub, is_leaf=is_spec), tree_leaves(
                shardings[k], is_leaf=lambda x: isinstance(
                    x, NamedSharding))):
            d = None if k in WHOLE_AT_HOME else split_dim(sh)
            n = math.prod(spec.shape)
            if d is not None:
                n //= model_size(sh.mesh)
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
    zeros elsewhere."""
    with group.scope(0):
        out = parts[0]
        for j in range(1, group.m):
            mine = (owner == j).reshape((-1,) + (1,) * (out.dim() - 1))
            out = torch.where(mine, _at_home(parts[j], group, j), out)
    _logged(group, what, sum(_nbytes(p) for p in parts[1:]), "all-to-all",
            group.coords[:1])
    return out


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
