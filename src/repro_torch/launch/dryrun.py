"""The port's dry run (port of ``repro.launch.dryrun``): every
(architecture x input shape x mesh) cell at full size on a ``meta``
production mesh, with no allocation and no card, recorded as one JSON
artifact a cell.

JAX lowers and compiles each cell's step over 256 (512) forced host
devices and reads XLA's memory and cost analyses.  The port runs its
own step instead, on ``meta`` tensors laid out over
``launch.mesh.make_production_mesh(devices=[meta] * n)``, by the port's
mesh scheme (``runtime.mesh.MeshExecutor``'s): the arguments laid out by
the ``dist.sharding`` rules, data shard ``i`` computing on ``batch_axis``
index ``i`` (index 0 on the other axes) with the parameters gathered
there, or, for the block kinds of ``dist.tensor_parallel.SUPPORTED_KINDS``
(the dense attention stack, llama4-scout's ``moe``, deepseek-v2's
``mla_moe``), over its ``model`` coordinates with each leaf's model
block: the train step's gradients reduce-scattered into the state's
layout, the prefill and decode steps' caches held where JAX's layout
holds them, each coordinate reading and writing its own.  Every
coordinate's gathers, reductions and placements run (free on meta) and
are logged (``dist.mesh.record_collectives``); data shards of equal
shapes are computed once (``computed_shards``) and stand for the others.
:class:`~repro_torch.launch.hlo_analysis.DeviceLedger` keeps each
coordinate's live bytes, FLOPs and bytes moved; the kernels' meta
routes report their work to it.  The record is of the busiest device
(``device``): the most argument plus live bytes.

Record keys are JAX's with JAX's meanings (``status``, ``reason``,
``n_devices``, ``memory.{argument,output,temp,alias}_bytes`` and
``peak_per_device = argument + output + temp - alias``, ``collectives``,
``probe``).  ``flops_per_device`` / ``bytes_per_device`` stand where
JAX has ``hlo_flops_per_device_raw`` / ``hlo_bytes_per_device_raw``:
they count the whole step (aten ops priced by
``torch.utils.flop_counter``, plus the kernels' counted work) and need
no probe correction; ``flops_per_device_mean`` is the mean over the
coordinates that computed (the ledger places a backward op made outside
any coordinate by its largest input, so work moves between a data
shard's model coordinates).  Every figure is a reckoning on meta, not a
measurement.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--jobs 8]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Optional

import torch
# imported before any step: torch imports it lazily inside the first op
# that reaches a ``torch._disable_dynamo`` wrapper, and that import leaves
# a reference cycle through the caller's frames (a traceback), which keeps
# whatever those frames hold (a gathered weight) until the garbage
# collector runs
import torch._dynamo  # noqa: F401

from repro_torch.configs import (ASSIGNED, REGISTRY, SHAPES, ShapeSpec,
                                 cell_supported, get_config)
from repro_torch.dist import mesh as mesh_lib
from repro_torch.dist import pipeline as pipe_lib
from repro_torch.dist import sharding as sh
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.mesh import Placed, at, gather, gather_tree, \
    log_collective, place_as, reduce_scatter_tree, scatter_block
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.optim.adamw import adamw
from repro_torch.train import steps as steps_lib
from repro_torch.tree import tree_leaves, tree_map

Tree = Any
ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "artifacts" / \
    "dryrun_torch"
PIPELINE_MICROBATCHES = 8
META = torch.device("meta")


@dataclasses.dataclass
class Cell:
    """One cell's step on its laid-out arguments: ``run()`` executes it
    (on meta, under the caller's ledger and recorder) and returns
    ``(held, aliased)``: per coordinate, the output tensors it holds and
    those of them that are arguments written in place.  ``args`` holds
    the arguments (placed trees, or whole tensors on ``home`` where the
    step takes them so)."""
    run: Callable[[], tuple[dict, dict]]
    args: Tree
    mesh: Any
    pipeline: bool
    data_shards: int
    computed_shards: int
    home: tuple


def _pod_axes(mesh) -> bool:
    return "pod" in mesh.axis_names


def _data_shards(mesh, sharding) -> list[dict[str, int]]:
    """``{axis: index}`` of each data shard of a batch-major sharding:
    the coordinates of its batch dim's axes, shard ``i`` numbered as JAX
    numbers blocks."""
    axes = mesh_lib.axis_names_of(sharding.spec[0] if sharding.spec
                                  else None)
    sizes = [mesh.shape[a] for a in axes]
    out = []
    for i in range(math.prod(sizes)):
        idx, rest = {}, i
        for a, n in zip(reversed(axes), reversed(sizes)):
            idx[a] = rest % n
            rest //= n
        out.append(idx)
    return out


def _gather_where(tree: Tree, dev, where: dict) -> Tree:
    return tree_map(lambda p: gather(p, dev, where=where)
                    if isinstance(p, Placed) else p, tree)


def _scatter_all(values: Tree, shardings: Tree, shapes: Tree, where: dict,
                 out: Optional[Tree] = None) -> Tree:
    """Each leaf's data-shard part back onto its coordinates (in place
    into ``out``'s shards where given)."""
    if out is None:
        return tree_map(lambda v, s, a: scatter_block(v, s, a.shape, where),
                        values, shardings, shapes)
    return tree_map(lambda v, s, p: scatter_block(v, s, p.shape, where,
                                                  out=p),
                    values, shardings, out)


def _rules(strategy: str) -> Optional[sh.ShardingRules]:
    """JAX's ``--strategy dp``: everything replicated but the vocab
    (kept on ``model``: a replicated LM head re-multiplies the whole
    [T, d] x [d, V] on every device)."""
    if strategy != "dp":
        return None
    rules = dict.fromkeys(sh.DEFAULT_RULES.rules)
    rules["vocab"] = "model"
    return sh.ShardingRules(rules=rules)


def _shard_grad_fn(cfg: ArchConfig, remat, accum: int, batch: int,
                   n: int, group=None):
    """``(grad_fn, alike)``: the gradients data shard 0 of ``n`` computes
    from its rows of a ``batch``-row step, and how many shards alike
    each of its MoE layers routes with (:func:`_alike`).  JAX splits
    the whole batch into ``accum`` microbatches first (microbatch ``j``
    the rows ``j * batch / accum`` on) and lays each over the mesh.  A
    shard holding at least ``accum`` rows splits its own rows into
    ``accum`` parts, part ``j`` in microbatch ``j``; a shard holding
    fewer computes its rows whole, in the one microbatch they belong
    to.  Either way a MoE layer sees one of the microbatch's equal parts
    and takes the microbatch's capacity."""
    rows = batch // n
    parts = accum if rows >= accum else 1
    if rows % parts or (batch // accum) % (rows // parts):
        raise ValueError(f"{batch} rows over {n} data shards do not split "
                         f"into {accum} microbatches")
    alike = (batch // accum) // (rows // parts)
    if group is None:
        return steps_lib.make_grad_fn(cfg, remat, parts), alike
    return steps_lib.make_grad_fn(cfg, remat, parts, group=group), alike


def _alike(n: int):
    """Route every MoE layer inside as data shard 0 of ``n`` shards that
    route alike: C from ``n`` times the shard's tokens, the route counts
    ``n`` times its own, its slots from 0.  The dry run computes one
    shard for ``n`` equal ones, so the others' routing does not exist;
    the layer takes the microbatch's capacity, as JAX's program does."""
    if n == 1:
        return contextlib.nullcontext()
    return L.moe_split(lambda tokens, counts: L.MoESplit(
        tokens * n, torch.zeros_like(counts), counts * n))


def _reduce_scatter_alike(grads: Tree, shardings: Tree, coords: list
                          ) -> Tree:
    """``reduce_scatter_tree([grads] * n, shardings, sources=coords)``
    on meta, where every data shard's gradients stand as shard 0's.
    Folding one more equal part runs the same ops as the part before, so
    the parts after the second are not run again: each adds the second
    part's bytes moved, coordinate by coordinate, to the open ledgers
    and its reduce-scatter moves to the recorder (``--strategy dp``'s
    256 replicated parts took about five minutes of meta ops to fold).
    Tensors off meta fold every part."""
    n = len(coords)
    if n <= 2 or any(t.device.type != "meta" for t in tree_leaves(grads)):
        return reduce_scatter_tree([grads] * n, shardings, sources=coords)
    ledgers = hlo_analysis.active_ledgers()
    snaps: list = []

    def parts():
        yield grads
        snaps.append([dict(led.bytes) for led in ledgers])
        yield grads
        snaps.append([dict(led.bytes) for led in ledgers])

    gp = reduce_scatter_tree(parts(), shardings, sources=coords[:2])
    for led, before, after in zip(ledgers, *snaps):
        for c, b in after.items():
            led.work_bytes[c] += (b - before.get(c, 0.0)) * (n - 2)
    rec = mesh_lib._recorder()
    if rec is not None:
        later = [tuple(c) for c in coords[2:]]
        leaves = list(zip(tree_leaves(grads), tree_leaves(
            shardings,
            is_leaf=lambda x: isinstance(x, mesh_lib.NamedSharding))))
        mesh = leaves[0][1].mesh
        for c in mesh.coords():
            nbytes = 0
            for t, s in leaves:
                sl = mesh_lib.shard_slices(t.shape, s.mesh, tuple(s.spec), c)
                nbytes += math.prod(len(range(*x.indices(d))) for x, d
                                    in zip(sl, t.shape)) * t.element_size()
            k = len(later) - later.count(tuple(c))
            if k:
                rec.log("reduce-scatter", c, nbytes * k,
                        times=k * len(leaves))
    return gp


def _tensor_parallel(cfg: ArchConfig, mesh, batch_axes) -> bool:
    """Does the cell's step (train, prefill or decode) compute
    tensor-parallel over ``model`` (the kinds of
    ``tensor_parallel.SUPPORTED_KINDS``, ``model`` not folded into the
    batch)?  A MoE model's data shard 0 then routes under
    :func:`_alike`, on its model shards as on the gathered path."""
    return tp.MODEL_AXIS not in mesh_lib.axis_names_of(batch_axes) and \
        tp.runs_tensor_parallel(cfg, set(cfg.block_kinds), mesh)


def _reduce_scatter_blocks_alike(grads: list, shardings: Tree,
                                 groups: list, shapes: Tree) -> Tree:
    """The tensor-parallel counterpart of :func:`_reduce_scatter_alike`:
    ``grads[j]`` is model shard ``j``'s gradient blocks, and every data
    shard's (``groups[i]``) stand as data shard 0's.  The first two data
    shards' parts are folded; each later one adds the second one's
    bytes moved to the open ledgers, and its reduce-scatter moves (the
    blocks each coordinate receives from the other coordinates) to the
    recorder.  A routed expert stack held as its data slice moves
    nowhere: each coordinate adds its own."""
    m, n = len(grads), len(groups)
    wheres = [{tp.MODEL_AXIS: j} for j in range(m)]
    meta = all(t.device.type == "meta" for t in tree_leaves(grads))
    k = n if n <= 2 or not meta else 2
    ledgers = hlo_analysis.active_ledgers()
    snaps: list = []

    def parts():
        for _ in range(k):
            yield from grads
            snaps.append([dict(led.bytes) for led in ledgers])
    gp = reduce_scatter_tree(parts(), shardings,
                             sources=[c for g in groups[:k]
                                      for c in g.coords],
                             wheres=wheres * k, shapes=shapes)
    if k == n:
        return gp
    for led, before, after in zip(ledgers, *snaps):
        for c, b in after.items():
            led.work_bytes[c] += (b - before.get(c, 0.0)) * (n - 2)
    rec = mesh_lib._recorder()
    if rec is None:
        return gp
    shs = tree_leaves(shardings,
                      is_leaf=lambda x: isinstance(x, mesh_lib.NamedSharding))
    parts_j = [mesh_lib._leaves_like(g, shardings, lambda x: isinstance(
        x, mesh_lib.NamedSharding)) for g in grads]
    mesh = shs[0].mesh
    for j in range(m):
        got: dict = {}                  # coord -> (bytes, moves)
        for t, s, shape in zip(parts_j[j], shs, tree_leaves(
                shapes, is_leaf=lambda x: isinstance(x, torch.Size))):
            if t is None:
                continue
            whole = tuple(t.shape) == tuple(shape)
            if not whole and tuple(r.stop - r.start for r in
                                   mesh_lib._block_region(
                                       shape, mesh, tuple(s.spec),
                                       wheres[j])) != tuple(t.shape):
                continue         # its own coordinate's shard: no move
            for c in mesh.coords():
                if not whole and c[mesh.axis_names.index(tp.MODEL_AXIS)] \
                        != j and tp.split_dim(s) is not None:
                    continue
                sl = mesh_lib.shard_slices(shape, mesh, tuple(s.spec), c)
                b, nm = got.get(c, (0, 0))
                got[c] = (b + math.prod(x.stop - x.start for x in sl)
                          * t.element_size(), nm + 1)
        for g in groups[2:]:
            for c, (b, nm) in got.items():
                if c != g.coords[j]:
                    rec.log("reduce-scatter", c, b, times=nm)
    return gp


def _mesh_train_step(cfg: ArchConfig, optimizer, mesh, st_sh: Tree,
                     b_sh: Tree, remat, accum: int, batch: int):
    """The train step over ``mesh`` by MeshExecutor's scheme: data shard
    0 computes with its rows split into microbatches as
    ``_shard_grad_fn`` says; every other shard's gathers run and its
    gradients are shard 0's (equal shapes); the gradients are
    reduce-scattered into the state's layout (f64, as MeshExecutor sums
    them), the clip norm's partial sums all-reduced, and AdamW updates
    the busiest coordinate's shards.  A dense attention stack,
    llama4-scout's ``moe`` layers or deepseek-v2's ``mla_moe`` layers
    compute tensor-parallel over ``model`` (``dist.tensor_parallel``):
    data shard 0's model shard ``j`` gathers model block ``j`` of each
    leaf and computes with it, and each model shard's gradients are
    reduce-scattered as its blocks; any other model gathers every leaf
    whole onto data shard 0's coordinate, which computes alone."""
    shards = _data_shards(mesh, b_sh["tokens"])
    coords = [mesh.coord(**w) for w in shards]
    c0 = coords[0]
    if _tensor_parallel(cfg, mesh, b_sh["tokens"].spec[0]):
        return _mesh_train_step_tp(cfg, optimizer, mesh, st_sh, shards,
                                   remat, accum, batch)
    grad_fn, alike = _shard_grad_fn(cfg, remat, accum, batch, len(coords))

    def step(state: Tree, batch: Tree):
        dev = mesh.devices[c0]
        with at(c0), _alike(alike):
            params = gather_tree(state["params"], dev)
            loss, ce, grads = grad_fn(params, _gather_where(batch, dev,
                                                           shards[0]))
            del params
        for c in coords[1:]:
            with at(c):
                gather_tree(state["params"], mesh.devices[c])
        gp = _reduce_scatter_alike(grads, st_sh["params"], coords)
        del grads
        return _update(optimizer, mesh, c0, state, gp, loss, ce)

    return step, len(coords), c0


def _mesh_train_step_tp(cfg: ArchConfig, optimizer, mesh, st_sh: Tree,
                        shards: list, remat, accum: int, batch: int):
    """:func:`_mesh_train_step`'s tensor-parallel step."""
    groups = [tp.Group.of(mesh, **w) for w in shards]
    c0 = groups[0].coords[0]
    grad_fn, alike = _shard_grad_fn(cfg, remat, accum, batch, len(groups),
                                    groups[0])
    sliced = _expert_slices(mesh, shards, alike)

    def step(state: Tree, batch: Tree):
        with _alike(alike), _moe_stands(groups, sliced):
            trees = _model_blocks(state["params"], groups[0], mesh,
                                  0 if sliced else None)
            with at(c0):
                b = _gather_where(batch, mesh.devices[c0], shards[0])
            # outside any coordinate: each shard's ops run in its own
            # scope, and the backward pass is owned by its inputs' shards
            loss, ce, grads = grad_fn(trees, b)
            del trees, b
        for i, g in enumerate(groups[1:], 1):
            _model_blocks(state["params"], g, mesh, i if sliced else None)
        gp = _reduce_scatter_blocks_alike(
            grads, st_sh["params"], groups,
            tree_map(lambda p: p.shape, state["params"]))
        del grads
        return _update(optimizer, mesh, c0, state, gp, loss, ce)

    return step, len(groups), c0


def _model_blocks(params: Tree, group: tp.Group, mesh,
                  data: Optional[int] = None) -> list:
    """Each of ``group``'s model coordinates' blocks of ``params``
    (:func:`~repro_torch.dist.tensor_parallel.gather_block`, the routed
    expert stacks as data slice ``data`` where given), gathered as that
    coordinate."""
    out = []
    for j, c in enumerate(group.coords):
        with at(c):
            out.append(tp.gather_block(params, mesh.devices[c], j, data))
    return out


def _mean_flops(ledger, mesh) -> float:
    """The FLOPs of a coordinate that computed, on average over them."""
    busy = [f for f in map(ledger.total_flops, mesh.coords()) if f > 0]
    return sum(busy) / max(len(busy), 1)


def _expert_slices(mesh, shards: list, alike: int) -> bool:
    """Do the cell's routed expert stacks stay on their data slice, each
    expert's slots computed once per microbatch
    (``models.layers.apply_moe_a2a``)?  Where the microbatch is split
    over every ``data`` shard and nothing else (``alike`` of them route
    together)."""
    return all(set(w) == {tp.DATA_AXIS} for w in shards) and \
        alike == len(shards) and tp.slices_experts(mesh, len(shards))


def _moe_stands(groups: list, sliced: bool):
    """Data shard 0's expert-parallel MoE layers stand for ``groups``
    where the expert stacks hold their data slice."""
    if not sliced:
        return contextlib.nullcontext()
    return L.moe_data_groups(groups)


def _prefill_cell_tp(cfg: ArchConfig, mesh, args: Tree, shards: list,
                     cache_sh: Tree, cache_meta: Tree, last_only: bool
                     ) -> Cell:
    """The prefill cell over data shard 0's model coordinates
    (``make_prefill_step`` with its group): coordinate ``j`` gathers
    model block ``j`` of each leaf and computes with it, and its caches
    stay there as its block of ``cache_sh`` (checked), with no gather to
    home and no scatter from it.  Data shard 0 stands for all
    (:func:`_alike`); every other data shard's gathers run."""
    groups = [tp.Group.of(mesh, **w) for w in shards]
    g0, c0 = groups[0], groups[0].coords[0]
    step = steps_lib.make_prefill_step(cfg, last_only=last_only, group=g0)
    shapes = tree_map(lambda a: a.shape, cache_meta)
    sliced = _expert_slices(mesh, shards, len(groups))

    def run():
        with _alike(len(groups)), _moe_stands(groups, sliced):
            trees = _model_blocks(args["params"], g0, mesh,
                                  0 if sliced else None)
            with at(c0):
                batch = _gather_where(args["batch"], mesh.devices[c0],
                                      shards[0])
            nxt, caches = step(trees, batch)
            del trees, batch
        held: dict = {c0: [nxt]}
        for c, cj in zip(g0.coords, caches):
            tp.check_cache_blocks(cj, shapes, cache_sh, c)
            held.setdefault(c, []).extend(tree_leaves(cj))
        for i, g in enumerate(groups[1:], 1):
            _model_blocks(args["params"], g, mesh, i if sliced else None)
        return held, {}
    return Cell(run, args, mesh, False, len(groups), 1, c0)


def _decode_cell_tp(cfg: ArchConfig, mesh, args: Tree, shards: list,
                    pos: int) -> Cell:
    """The decode cell over data shard 0's model coordinates
    (``make_serve_step`` with its group): coordinate ``j`` gathers model
    block ``j`` of each leaf and reads and writes its own cache blocks
    in place (outputs aliasing the arguments, on every coordinate).
    Data shard 0 stands for all; every other data shard's gathers
    run."""
    groups = [tp.Group.of(mesh, **w) for w in shards]
    g0, c0 = groups[0], groups[0].coords[0]
    step = steps_lib.make_serve_step(cfg, group=g0)
    sliced = _expert_slices(mesh, shards, len(groups))

    def run():
        with _alike(len(groups)), _moe_stands(groups, sliced):
            trees = _model_blocks(args["params"], g0, mesh,
                                  0 if sliced else None)
            local = [tp.cache_shards(args["caches"], c) for c in g0.coords]
            with at(c0):
                tok = gather(args["token"], mesh.devices[c0], where=shards[0])
            nxt, _ = step(trees, local, tok, pos)
            del trees, local, tok
        for i, g in enumerate(groups[1:], 1):
            _model_blocks(args["params"], g, mesh, i if sliced else None)
        aliased = {c: [a.shards[c] for a in tree_leaves(args["caches"])]
                   for g in groups for c in g.coords}
        held: dict = {c0: [nxt]}
        for c, ts in aliased.items():
            held.setdefault(c, []).extend(ts)
        return held, aliased
    return Cell(run, args, mesh, False, len(groups), 1, c0)


def _update(optimizer, mesh, c0: tuple, state: Tree, gp: Tree, loss, ce):
    """The clip norm's all-reduce and AdamW on ``c0``'s shards."""
    log_collective("all-reduce", mesh.coords(), 4)
    with at(c0):
        local = lambda t: tree_map(
            lambda p: p.shards[c0] if isinstance(p, Placed) else p, t)
        params = local(state["params"])
        updates, opt = optimizer.update(local(gp), local(state["opt"]),
                                        params)
        del gp
        new_params = tree_map(lambda p, u: p + u.to(p.dtype), params,
                              updates)
    return {"params": new_params, "opt": opt,
            "step": local(state["step"]) + 1}, {"loss": loss, "ce": ce}


def build_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, remat="block",
               accum: int = 1, opt_bf16: bool = False,
               full_logits: bool = False, strategy: str = "auto") -> Cell:
    """The cell's :class:`Cell`, JAX's three branches on the port's
    steps: train (``make_train_step``'s gradients over the mesh, or
    ``make_pipeline_train_step`` with 8 microbatches on a ``multi`` mesh
    and a stage-periodic config), prefill (``make_prefill_step``) and
    decode (``make_serve_step``, caches by
    ``cache_shardings_from_specs``); each over data shard 0's model
    coordinates where :func:`_tensor_parallel` holds."""
    multipod = _pod_axes(mesh)
    batch_axis = ("pod", "data") if multipod else "data"
    if strategy == "dp":
        batch_axis = (("pod", "data", "model") if multipod
                      else ("data", "model"))
    rules = _rules(strategy)
    specs = steps_lib.input_specs(cfg, shape)
    home = (0,) * len(mesh.axis_names)

    def placed(tree: Tree, shardings: Tree) -> Tree:
        return tree_map(place_as, tree, shardings)

    if shape.kind == "train":
        opt = adamw(state_dtype=torch.bfloat16 if opt_bf16
                    else torch.float32)
        state = specs["state"]
        if opt_bf16:
            for k in ("m", "v"):
                state["opt"][k] = tree_map(lambda x: torch.empty(
                    x.shape, dtype=torch.bfloat16, device=META),
                    state["opt"][k])
        if multipod and pipe_lib.stage_periodic(cfg, mesh.shape["pod"]):
            # the pipeline step takes the state whole on its home device
            # and places the params itself every step
            step = pipe_lib.make_pipeline_train_step(
                cfg, opt, mesh.shape["pod"], PIPELINE_MICROBATCHES,
                remat=remat, shards=1)
            batch = specs["batch"]
            n_data = pipe_lib._Layout(
                mesh, mesh.shape["pod"],
                shape.global_batch // PIPELINE_MICROBATCHES).n_data

            def run():
                with mesh, _alike(n_data):
                    return {home: list(step(state, batch))}, {}
            return Cell(run, {"state": state, "batch": batch}, mesh, True,
                        n_data, 1, home)
        st_sh = sh.state_shardings(cfg, mesh, rules=rules)
        b_sh = sh.batch_shardings(cfg, mesh, specs["batch"],
                                  batch_axis=batch_axis)
        args = {"state": placed(state, st_sh),
                "batch": placed(specs["batch"], b_sh)}
        step, n, c0 = _mesh_train_step(cfg, opt, mesh, st_sh, b_sh, remat,
                                       accum, shape.global_batch)
        return Cell(lambda: ({c0: list(step(args["state"], args["batch"]))},
                             {}), args, mesh, False, n, 1, c0)

    p_sh = sh.param_shardings(cfg, mesh, rules)
    cache_specs = steps_lib.decode_cache_param_specs(cfg, shape)
    cache_sh = sh.cache_shardings_from_specs(cfg, mesh, cache_specs,
                                             batch_axis=batch_axis,
                                             rules=rules)
    cache_meta = steps_lib.decode_cache_specs(cfg, shape)
    params = placed(specs["params"], p_sh)

    if shape.kind == "prefill":
        step = steps_lib.make_prefill_step(cfg, last_only=not full_logits)
        b_sh = sh.batch_shardings(cfg, mesh, specs["batch"],
                                  batch_axis=batch_axis)
        args = {"params": params, "batch": placed(specs["batch"], b_sh)}
        shards = _data_shards(mesh, b_sh["tokens"])
        if _tensor_parallel(cfg, mesh, b_sh["tokens"].spec[0] if
                            b_sh["tokens"].spec else None):
            return _prefill_cell_tp(cfg, mesh, args, shards, cache_sh,
                                    cache_meta, not full_logits)

        def run():
            held: dict = {}
            for i, w in enumerate(shards):
                c = mesh.coord(**w)
                dev = mesh.devices[c]
                with at(c):
                    p = gather_tree(args["params"], dev)
                    if i == 0:    # equal shards: shard 0 stands for all
                        with _alike(len(shards)):
                            nxt, caches = step(p, _gather_where(
                                args["batch"], dev, w))
                    del p
                    held.setdefault(c, []).append(nxt)
                    for blocks in tree_leaves(_scatter_all(
                            caches, cache_sh, cache_meta, w),
                            is_leaf=lambda x: isinstance(x, dict) and
                            all(isinstance(k, tuple) for k in x)):
                        for cc, t in blocks.items():
                            held.setdefault(cc, []).append(t)
            return held, {}
        return Cell(run, args, mesh, False, len(shards), 1,
                    mesh.coord(**shards[0]))

    step = steps_lib.make_serve_step(cfg)
    tok_sh = sh.batch_shardings(cfg, mesh, {"tokens": specs["token"]},
                                batch_axis=batch_axis)["tokens"]
    # the step takes the position as a host integer: no device argument
    # (JAX passes a device scalar, and prunes it where no layer reads it)
    args = {"params": params, "caches": placed(specs["caches"], cache_sh),
            "token": place_as(specs["token"], tok_sh)}
    shards = _data_shards(mesh, tok_sh)
    pos = shape.seq_len - 1
    if _tensor_parallel(cfg, mesh, tok_sh.spec[0] if tok_sh.spec else None):
        return _decode_cell_tp(cfg, mesh, args, shards, pos)

    def run():
        held: dict = {}
        for i, w in enumerate(shards):
            c = mesh.coord(**w)
            dev = mesh.devices[c]
            with at(c):
                p = gather_tree(args["params"], dev)
                local = _gather_where(args["caches"], dev, w)
                if i == 0:        # equal shards: shard 0 stands for all
                    tok = gather(args["token"], dev, where=w)
                    with _alike(len(shards)):
                        nxt, computed = step(p, local, tok, pos)
                del p, local
                held.setdefault(c, []).append(nxt)
                # the new cache rows back onto the shard's coordinates,
                # in place: the caches are outputs aliasing the arguments
                _scatter_all(computed, cache_sh, None, w, out=args["caches"])
        aliased = {c: [a.shards[c] for a in tree_leaves(args["caches"])]
                   for c in held}
        for c, ts in aliased.items():
            held[c] += ts
        return held, aliased

    return Cell(run, args, mesh, False, len(shards), 1,
                mesh.coord(**shards[0]))


def _shard_bytes(tree: Tree, coord: tuple, home: tuple) -> int:
    """Bytes of ``tree``'s leaves held at ``coord``: a placed leaf's
    shard there, a whole tensor on ``home``."""
    total = 0
    for a in tree_leaves(tree):
        if isinstance(a, Placed):
            t = a.shards[coord]
            total += t.numel() * t.element_size()
        elif isinstance(a, torch.Tensor) and coord == home:
            total += a.numel() * a.element_size()
    return total


def _tensor_bytes(ts: list) -> int:
    """Bytes of the tensors of the trees ``ts``, each tensor once."""
    seen, total = set(), 0
    for a in tree_leaves(ts):
        if isinstance(a, torch.Tensor) and id(a) not in seen:
            seen.add(id(a))
            total += a.numel() * a.element_size()
    return total


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             skip_probe: bool = False, remat: str = "block",
             accum: int = 1, cf: float = 0.0, opt_bf16: bool = False,
             full_logits: bool = False, strategy: str = "auto",
             breakdown: bool = False, layers: int = 0) -> dict:
    """One cell's record.  ``breakdown``: run the step a second time and
    add what the busiest device holds at its peak, grouped by the op
    that made each storage (``peak_breakdown``,
    :meth:`~repro_torch.launch.hlo_analysis.DeviceLedger.breakdown`).
    ``layers``: the depth cut to its first ``layers`` layers (a
    prediction's 1- and 2-layer runs, extrapolated to full depth)."""
    cfg = get_config(arch)
    if layers:
        cfg = cfg.with_overrides(n_layers=layers, block_pattern=(
            cfg.block_pattern[:layers] if cfg.block_pattern else None))
    if cf and cfg.moe is not None:
        cfg = cfg.with_overrides(
            moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    shape = SHAPES[shape_name]
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                    "time": time.strftime("%Y-%m-%d %H:%M:%S")}
    if layers:
        record["layers"] = cfg.n_layers
    ok, reason = cell_supported(cfg, shape)
    if not ok:
        record["status"] = "skipped"
        record["reason"] = reason
        return record

    n = 512 if mesh_kind == "multi" else 256
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                devices=[META] * n)
    t0 = time.time()
    cell = build_cell(cfg, shape, mesh, remat=remat, accum=accum,
                      opt_bf16=opt_bf16, full_logits=full_logits,
                      strategy=strategy)
    t_build = time.time() - t0
    t0 = time.time()
    ledger = hlo_analysis.DeviceLedger(home=cell.home)
    with mesh_lib.record_collectives() as rec, ledger:
        held, aliased = cell.run()
    t_run = time.time() - t0

    def argument(c):
        return _shard_bytes(cell.args, c, cell.home)

    # the busiest device; among equals the one that computes
    dev = max(mesh.coords(),
              key=lambda c: (argument(c) + ledger.peak.get(c, 0),
                             c == cell.home))
    arg_b = argument(dev)
    out_b = _tensor_bytes(held.get(dev, []))
    alias_b = _tensor_bytes(aliased.get(dev, []))
    # the ledger's peak holds the step's new outputs at their peak
    temp_b = max(ledger.peak.get(dev, 0) - (out_b - alias_b), 0)
    record.update({
        "status": "ok",
        "remat": remat,
        "accum": accum,
        "capacity_factor": cf or None,
        "strategy": strategy,
        "pipeline": cell.pipeline,
        "build_s": round(t_build, 2),
        "run_s": round(t_run, 2),
        "n_devices": int(mesh.size),
        "device": list(dev),
        "data_shards": cell.data_shards,
        "computed_shards": cell.computed_shards,
        "memory": {
            "argument_bytes": arg_b,
            "output_bytes": out_b,
            "temp_bytes": temp_b,
            "alias_bytes": alias_b,
            "peak_per_device": arg_b + out_b + temp_b - alias_b,
        },
        "flops_per_device": ledger.total_flops(dev),
        # the mean over the coordinates that computed: the ledger books
        # a backward op made outside any coordinate on its largest
        # input's owner, which moves work between a data shard's model
        # coordinates but not out of them
        "flops_per_device_mean": _mean_flops(ledger, mesh),
        "bytes_per_device": ledger.total_bytes(dev),
        "kernel_flops_per_device": ledger.kernel_flops.get(dev, 0.0),
        "collectives": hlo_analysis.collective_bytes(rec, dev),
        "reckoned_on": "meta",
    })
    if breakdown:
        again = build_cell(cfg, shape, mesh, remat=remat, accum=accum,
                           opt_bf16=opt_bf16, full_logits=full_logits,
                           strategy=strategy)
        watched = hlo_analysis.DeviceLedger(
            home=again.home, watch=(dev, ledger.peak.get(dev, 0)))
        with mesh_lib.record_collectives(), watched:
            again.run()
        record["peak_breakdown"] = watched.breakdown()
    if cell.pipeline:
        record["argument_layout"] = ("the state and batch whole on the "
                                     "home device; the step places the "
                                     "params itself every step")
    if shape.kind != "train" or not skip_probe:
        try:
            record["probe"] = hlo_analysis.layer_flop_probe(cfg, shape)
        except Exception as e:           # probe is best-effort
            record["probe_error"] = f"{type(e).__name__}: {e}"
    return record


def artifact_path(arch: str, shape: str, mesh: str) -> str:
    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
    return str(ARTIFACT_DIR / f"{mesh}__{arch}__{shape}.json")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(REGISTRY), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="parallel worker processes for --all")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--remat", default="block",
                    choices=["block", "2level", "none"])
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--opt-bf16", action="store_true")
    ap.add_argument("--full-logits", action="store_true",
                    help="paper-naive prefill emitting [B,S,V] logits")
    ap.add_argument("--strategy", default="auto", choices=["auto", "dp"])
    ap.add_argument("--cf", type=float, default=0.0)
    ap.add_argument("--breakdown", action="store_true",
                    help="add the busiest device's holdings at its peak")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers")
    ap.add_argument("--tag", default="",
                    help="artifact name suffix (hillclimb iterations)")
    args = ap.parse_args()

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s, m) for m in meshes for a in ASSIGNED
                 for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, m) for m in meshes]

    if args.jobs > 1 and len(cells) > 1:
        pending = [(a, s, m) for (a, s, m) in cells
                   if args.force or not os.path.exists(artifact_path(a, s, m))]
        print(f"{len(pending)} cells to run, {args.jobs} workers")
        procs: list = []
        n_fail = 0
        while pending or procs:
            while pending and len(procs) < args.jobs:
                a, s, m = pending.pop(0)
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", a, "--shape", s, "--mesh", m, "--force"]
                procs.append(((a, s, m), subprocess.Popen(
                    cmd, stdout=subprocess.DEVNULL,
                    stderr=subprocess.PIPE)))
            done = []
            for i, (cell, p) in enumerate(procs):
                if p.poll() is not None:
                    done.append(i)
                    tag = "OK" if p.returncode == 0 else "FAIL"
                    print(f"[{tag}] {cell}", flush=True)
                    if p.returncode != 0:
                        n_fail += 1
                        sys.stderr.write(p.stderr.read().decode()[-2000:])
            for i in reversed(done):
                procs.pop(i)
            time.sleep(0.5)
        sys.exit(1 if n_fail else 0)

    n_fail = 0
    for a, s, m in cells:
        path = artifact_path(a, s, m + args.tag if args.tag else m)
        if not args.force and os.path.exists(path) and args.all:
            print(f"[cached] {m}/{a}/{s}")
            continue
        t0 = time.time()
        try:
            rec = run_cell(a, s, m, remat=args.remat, accum=args.accum,
                           cf=args.cf, opt_bf16=args.opt_bf16,
                           full_logits=args.full_logits,
                           strategy=args.strategy,
                           breakdown=args.breakdown, layers=args.layers)
        except Exception as e:
            rec = {"arch": a, "shape": s, "mesh": m, "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
            n_fail += 1
        rec["cell_s"] = round(time.time() - t0, 2)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        stat = rec["status"]
        extra = ""
        if stat == "ok":
            extra = (f" run={rec['run_s']}s "
                     f"peak/dev={rec['memory']['peak_per_device']/2**30:.2f}"
                     f"GiB flops/dev={rec['flops_per_device']:.3g}")
        elif stat == "error":
            extra = " " + rec["error"][:160]
        print(f"[{stat}] {m}/{a}/{s}{extra} ({rec['cell_s']}s)", flush=True)
    sys.exit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
