"""Expert parallelism over the mesh's ``model`` axis for the ``moe`` kind
(``models.layers.apply_moe_tp``, ``models.blocks.moe_apply_tp``): the
layer, a split microbatch, mesh and span peers and the dry run's train
cell, against the port's one-device layer and the JAX package, on
virtual CPU meshes (one device listed 2-4 times), at reduced
llama4-scout (4 experts, top-1, a shared expert, 4 heads, 2 kv heads,
d 64).

Tolerances: the routes (each pair's expert, slot and kept flag) are the
one-device layer's exactly, and so is the routed output, in f32 and in
bf16 (each expert's products are the one-device ones, and home takes
each pair's row from its expert's shard by selection); the whole layer
lies within 1e-5 of its largest entry in f32 (the shared expert's
partials are summed in f32).  Over 2 data x 2 model shards the layer
lies within 1e-5 of JAX's ``apply_moe`` over the whole microbatch and
the aux shares add up to JAX's aux.  A stage's loss, input cotangent
and gradients lie within 1e-5 of JAX's ``MeshExecutor`` (each leaf's
largest entry, absolute below 1: top-1 routing leaves the router's
gradient only rounding noise of ~1e-8, as ``test_torch_moe_split.py``
notes), and a 3-step trajectory within 2e-4 of JAX's reference.
"""
import dataclasses
import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.runtime as jrt
from repro.configs import get_reduced as j_get_reduced
from repro.models import layers as jL

from repro_torch.dist import mesh as M
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.sharding import DEFAULT_RULES, stage_param_shardings
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import layers as L
from repro_torch.models import params as P
from repro_torch.models.blocks import TP_APPLY
from repro_torch.models.params import from_numpy_tree
from repro_torch.runtime import MeshExecutor, MeshSpanExecutor, StageState
from repro_torch.tree import tree_leaves, tree_map
from test_torch_families import _numpy_init, assert_close, port_cfg
from test_torch_mesh import SEQ, _jax_params, _jax_reference, _runner
from test_torch_train import TRAJ_ATOL, _assert_exactly_once

torch.set_num_threads(1)   # as tests/test_torch_train.py explains

ROOT = Path(__file__).resolve().parents[1]
ARCH = "llama4-scout-17b-a16e"
CPU = torch.device("cpu")
TOL = 1e-5


def _configs(cf=None, **kw):
    jcfg = j_get_reduced(ARCH)
    if cf is not None:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
    jcfg = dataclasses.replace(jcfg, **kw)
    return jcfg, port_cfg(jcfg)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _mesh(shape):
    return make_debug_mesh(shape, ("data", "model"),
                           devices=[CPU] * (shape[0] * shape[1]))


def _blocks(tree, specs, mesh):
    """Every model shard's block of ``tree`` (placed by the rules),
    gathered over ``data`` for data shard 0."""
    placed = tree_map(M.place_as, tree, stage_param_shardings(specs, mesh))
    return [tp.gather_block(placed, CPU, j)
            for j in range(mesh.shape["model"])]


def _tilted(rows, d, seed=7):
    """Inputs sharing one direction, which tilts the router to some
    experts so that the capacity binds."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, SEQ, d))
            + rng.standard_normal(d)).astype(np.float32)


# ------------------------------------------------------------- the layer
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [2, 4])
def test_moe_half_over_model_shards_equals_one_device(m, dtype):
    """The MoE half over ``m`` model shards against the one-device
    ``apply_moe`` on the same weights: identical routes, the routed
    output (no shared expert) equal to the bit, the aux equal, and in
    f32 the whole layer within 1e-5 of its largest entry."""
    _, tcfg = _configs(param_dtype=dtype, compute_dtype=dtype)
    mesh = _mesh((1, m))
    group = tp.Group.of(mesh, data=0)
    specs = L.moe_specs(tcfg)
    p = P.init(3, specs, "cpu")
    ps = _blocks(p, specs, mesh)
    assert L.experts_split(tcfg, ps[0])
    assert ps[0]["wi_gate"].shape[0] == tcfg.moe.num_experts // m
    x = torch.from_numpy(_tilted(2, tcfg.d_model)).to(tcfg.compute_jdtype)
    T = x.shape[0] * x.shape[1]
    one = L.moe_route(tcfg, p, x)
    got = L.moe_route_tp(tcfg, ps, x, group)
    for a, b in zip(got, one):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    plan_one = L._moe_plan(tcfg, one, T)
    plan_tp = L._moe_plan(tcfg, got, T)
    for a, b in zip(plan_tp[:3], plan_one[:3]):      # expert, slot, kept
        assert torch.equal(a, b)
    assert int((~plan_one[2]).sum()) > 0            # the capacity binds
    routed = tcfg.with_overrides(moe=dataclasses.replace(tcfg.moe,
                                                         num_shared=0))
    drop = lambda t: {k: v for k, v in t.items() if k != "shared"}
    y1, a1 = L.apply_moe(routed, drop(p), x)
    y2, a2 = L.apply_moe_tp(routed, [drop(q) for q in ps], x, group)
    assert torch.equal(y2, y1)
    assert float(a2) == float(a1)
    y1, a1 = L.apply_moe(tcfg, p, x)
    tp.ALL_REDUCES.clear()
    y2, a2 = L.apply_moe_tp(tcfg, ps, x, group)
    assert dict(tp.ALL_REDUCES) == {"router": 1, "expert_rows": 1,
                                    "shared_expert": 1}
    assert float(a2) == float(a1)
    if dtype == "float32":
        assert _rel(y2.numpy(), y1.numpy()) <= TOL


def test_experts_not_dividing_model_run_whole_at_home():
    """4 experts over ``model`` 3 replicate (the divisibility rule): the
    MoE half runs ``apply_moe`` whole at home, to the bit, with no
    router gather and no rows returned, and a mesh peer of such a stage
    still takes the tensor-parallel path."""
    _, tcfg = _configs()
    mesh = _mesh((1, 3))
    specs = L.moe_specs(tcfg)
    p = P.init(4, specs, "cpu")
    ps = _blocks(p, specs, mesh)
    assert not L.experts_split(tcfg, ps[0])
    x = torch.from_numpy(_tilted(2, tcfg.d_model))
    tp.ALL_REDUCES.clear()
    y, aux = L.apply_moe_tp(tcfg, ps, x, tp.Group.of(mesh, data=0))
    assert not tp.ALL_REDUCES
    y1, a1 = L.apply_moe(tcfg, p, x)
    assert torch.equal(y, y1) and float(aux) == float(a1)
    assert MeshExecutor(tcfg, 2, SEQ, 1, mesh,
                        compress="none").compute_path == "tensor_parallel"


def _split_tp(tcfg, ps, x, groups):
    ys, auxs = L.apply_moe_shards_tp(tcfg, [ps] * len(groups),
                                     list(x.chunk(len(groups))), groups)
    return torch.cat(ys), sum(float(a) for a in auxs)


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_split_moe_tp_equals_jax_whole_microbatch(cf, monkeypatch):
    """2 data x 2 model shards, each data shard routed under its
    ``MoESplit``, against JAX's ``apply_moe`` over the whole input: the
    layer within 1e-5 of its largest entry, the aux shares adding up to
    JAX's aux, with the capacity binding.  Control: the routed half
    taken from home's experts only (the other experts' pairs left at
    zero) misses the bound."""
    jcfg, tcfg = _configs(cf)
    host = _numpy_init(jL.moe_specs(jcfg), 3)
    x = _tilted(4, jcfg.d_model)
    jy, jaux = jax.jit(functools.partial(jL.apply_moe, jcfg))(
        jax.tree.map(jnp.asarray, host), jnp.asarray(x))
    mesh = _mesh((2, 2))
    groups = [tp.Group.of(mesh, data=i) for i in range(2)]
    ps = _blocks(from_numpy_tree(host, "cpu"), L.moe_specs(tcfg), mesh)
    xt = torch.from_numpy(x)
    y, aux = _split_tp(tcfg, ps, xt, groups)
    assert _rel(y.numpy(), jy) <= TOL
    assert abs(aux - float(jaux)) <= TOL * abs(float(jaux))
    m, T = jcfg.moe, x.shape[0] * x.shape[1]
    C = max(1, int(cf * T * m.top_k / m.num_experts))
    sel = L.moe_route(tcfg, from_numpy_tree(host, "cpu"), xt)[2]
    assert int(torch.bincount(sel.reshape(-1)).max()) > C
    monkeypatch.setattr(tp, "select_home",
                        lambda parts, owner, group, what: parts[0])
    y_home, _ = _split_tp(tcfg, ps, xt, groups)
    assert _rel(y_home.numpy(), jy) > 1e-2


# ------------------------------------------------------ mesh executors
def test_supported_paths_of_moe_executors():
    """A reduced llama4-scout ``MeshExecutor`` (both stages) and
    ``MeshSpanExecutor`` take the tensor-parallel path on (1, 2) and
    (2, 2); the kind is registered for the lockstep block core."""
    _, tcfg = _configs()
    assert "moe" in TP_APPLY and "moe" in tp.SUPPORTED_KINDS
    for shape in [(1, 2), (2, 2)]:
        mesh = _mesh(shape)
        exs = [MeshExecutor(tcfg, 2, SEQ, s, mesh, compress="none")
               for s in range(2)]
        exs.append(MeshSpanExecutor(tcfg, 2, SEQ, (0, 2), mesh,
                                    compress="none"))
        for ex in exs:
            assert ex.prog.routes_whole
            assert ex.compute_path == "tensor_parallel"


def _stage1_params(jcfg):
    """Numpy weights of the last stage (one ``moe`` layer and the head),
    by JAX's init rules."""
    return _numpy_init(jrt.build_stage_programs(
        jcfg, 2, SEQ, compress="none")[1].specs, 1)


def _stage_inputs(tcfg, rows=4, seed=3):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, SEQ, tcfg.d_model))
         + rng.standard_normal(tcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, tcfg.vocab_size, (rows, SEQ)).astype(np.int32)
    return x, labels


def test_moe_stage_collectives_a_layer():
    """The last stage (one ``moe`` layer) on (2, 2), its experts computed
    once per microbatch (``apply_moe_a2a``): forward, an attention
    all-reduce and a router gather a data shard, once a layer the
    columns' all-to-all over ``data``, the slots' all-gather, the gate
    and up partials' all-reduces and the rows' return home, then a
    shared-expert all-reduce a data shard, besides the head's three;
    backward recomputes them and adds a cotangent all-reduce for the
    attention's fanout, the MoE's and the head's a data shard, the
    columns' transpose and the two partials' sums; the two data shards'
    calls go to the program at once."""
    jcfg, tcfg = _configs()
    host = _stage1_params(jcfg)
    ex = MeshExecutor(tcfg, 2, SEQ, 1, _mesh((2, 2)), compress="none")
    st = StageState()
    ex.restore(st, {"params": host, "opt": None})
    x, labels = _stage_inputs(tcfg)
    xt, lt = torch.as_tensor(x), torch.as_tensor(labels)
    want = {"activation": 2, "router": 2, "expert_columns": 1,
            "expert_slots": 1, "expert_partials": 2, "expert_rows": 1,
            "shared_expert": 2, "loss": 6}
    tp.ALL_REDUCES.clear()
    with M.record_collectives() as rec:
        ex.run_fwd(st, xt, lt)
    assert dict(tp.ALL_REDUCES) == want
    assert rec.counts[(0, 0)]["all-to-all"] == 2        # columns, rows
    assert rec.counts[(0, 1)]["all-to-all"] == 1        # columns
    tp.ALL_REDUCES.clear()
    ex.run_bwd(st, xt, labels=lt)
    assert dict(tp.ALL_REDUCES) == {**want, "cotangent": 9}


_JAX_MESH = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "src")
    import jax, numpy as np
    from repro.configs import get_reduced
    from repro.launch.mesh import make_debug_mesh
    from repro.runtime import MeshExecutor, build_numeric_executors
    d = np.load(sys.argv[1], allow_pickle=True).item()
    cfg = get_reduced("llama4-scout-17b-a16e")
    mesh = make_debug_mesh((2, 2), ("data", "model"))
    num = build_numeric_executors(cfg, 2, 32, compress="none")
    st = num[1].init_state(jax.random.PRNGKey(0))
    num[1].restore(st, {"params": d["params"], "opt": None})
    mex = MeshExecutor(cfg, 2, 32, 1, mesh, compress="none")
    sm = mex.init_state(jax.random.PRNGKey(9))
    mex.restore(sm, num[1].snapshot(st))
    loss, gx, gp = mex.run_bwd(sm, d["x"], labels=d["labels"])
    out = {"loss": np.asarray(loss), "gx": np.asarray(gx),
           "gp": [np.asarray(a) for a in jax.tree.leaves(gp)],
           "fwd": np.asarray(mex.run_fwd(sm, d["x"], d["labels"]))}
    np.save(sys.argv[2], out, allow_pickle=True)
""")


def test_moe_stage_matches_jax_mesh_executor(tmp_path):
    """The last stage's forward and ``run_bwd`` on a 2 x 2 ``("data",
    "model")`` mesh, the microbatch of 4 split 2 + 2: the port's
    expert-parallel mesh peer (a virtual CPU mesh) against JAX's
    ``MeshExecutor`` on 4 forced CPU devices (GSPMD over the same
    layout), on shared numpy params and inputs: loss, input cotangent
    and every gradient within 1e-5 of each leaf's largest entry
    (absolute below 1)."""
    jcfg, tcfg = _configs()
    params = _stage1_params(jcfg)
    x, labels = _stage_inputs(tcfg)
    np.save(tmp_path / "in.npy", {"params": params, "x": x,
                                  "labels": labels}, allow_pickle=True)
    r = subprocess.run([sys.executable, "-c", _JAX_MESH,
                        str(tmp_path / "in.npy"), str(tmp_path / "out.npy")],
                       capture_output=True, text=True, cwd=ROOT,
                       timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-3000:]
    want = np.load(tmp_path / "out.npy", allow_pickle=True).item()
    mex = MeshExecutor(tcfg, 2, SEQ, 1, _mesh((2, 2)), compress="none")
    assert mex.compute_path == "tensor_parallel"
    assert mex.dp_shards(x.shape[0]) == 2
    st = StageState()
    mex.restore(st, {"params": params, "opt": None})
    xt, lt = torch.as_tensor(x), torch.as_tensor(labels)
    loss, gx, gp = mex.run_bwd(st, xt, labels=lt)
    fwd = float(mex.run_fwd(st, xt, lt))
    for a in (float(loss), fwd):
        assert abs(a - float(want["loss"])) <= TOL * abs(float(want["loss"]))
    assert float(want["fwd"]) == pytest.approx(float(want["loss"]), rel=TOL)
    assert _rel(gx.numpy(), want["gx"]) <= TOL
    got = [M.gather(a, CPU).numpy() for a in tree_leaves(gp)]
    assert len(got) == len(want["gp"])
    for a, b in zip(got, want["gp"]):
        assert_close(a, b, TOL)


@pytest.mark.parametrize("shape,whole", [((1, 2), False), ((2, 2), False),
                                         ((2, 2), True)],
                         ids=["1x2", "2x2", "2x2-whole"])
def test_moe_tp_trajectory_equals_jax_reference(shape, whole, monkeypatch):
    """Expert-parallel mesh peers at both stages beside numeric peers,
    and a mesh span peer over [0, 2): a 3-step trajectory within 2e-4 of
    JAX's sequential reference, each microbatch processed exactly once.
    The experts route top-2 here.  At top-1 a token's renormalised gate
    is exactly 1, so the router's true gradient is zero and each
    package's is rounding noise (~1e-8), which AdamW normalises into
    steps of about the learning rate: the routes then drift apart, and
    the port's one-device numeric peers alone leave JAX's reference by
    4.9e-4 at step 3.  ``whole``: the weights replicated over ``data``
    (the rules without FSDP), so each data shard holds the expert stacks
    whole and the shards run in lockstep under their split contexts
    (``apply_moe_shards_tp``, never ``apply_moe_a2a``), their expert
    gradients summed over ``data``."""
    jcfg, tcfg = _configs(moe=dataclasses.replace(j_get_reduced(ARCH).moe,
                                                  top_k=2))
    calls = {"apply_moe_shards_tp": 0, "apply_moe_a2a": 0}
    for name in calls:
        def spy(*a, _f=getattr(L, name), _k=name, **kw):
            calls[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(L, name, spy)
    rules = DEFAULT_RULES.with_rules(embed=None) if whole else None
    jprogs, jp = _jax_params(jcfg, "none")
    want = _jax_reference(jcfg, jprogs, jp, 2, 8, monkeypatch)
    r = _runner(tcfg, jp, "none", 2, 8)
    r.build(peers_per_stage=1)
    mesh = _mesh(shape)
    for s in range(2):
        ex = MeshExecutor(tcfg, 2, SEQ, s, mesh, compress="none",
                          rules=rules)
        assert ex.compute_path == "tensor_parallel"
        assert ex.slices_experts(shape[0]) == (shape[0] > 1 and not whole)
        r.add_peer(s, executor=ex)
    span = MeshSpanExecutor(tcfg, 2, SEQ, (0, 2), mesh, compress="none",
                            rules=rules)
    assert span.compute_path == "tensor_parallel"
    r.add_peer(range(0, 2), executor=span)
    m = r.run(until=1e6)
    np.testing.assert_allclose(m["loss"], want, atol=TRAJ_ATOL, rtol=0)
    _assert_exactly_once(r, 2, 4)
    if whole:
        assert calls["apply_moe_shards_tp"] > 0
        assert calls["apply_moe_a2a"] == 0


@pytest.mark.parametrize("alike", [1, 2])
def test_whole_model_grad_fn_over_model_shards(alike):
    """The dry run's whole-model step (``train.steps.make_grad_fn`` over a
    data shard's model shards, ``lm_apply_tp`` with each layer
    checkpointed) against the one-device step, at 1 and 2 microbatches,
    whole and under the dry run's rule of ``alike`` equal data shards:
    the loss within 1e-6, every gradient within 1e-5 of its largest
    entry (absolute below 1: the router's is rounding noise)."""
    from repro_torch.launch.dryrun import _alike
    from repro_torch.train import steps as S
    _, tcfg = _configs()
    specs = S.model_specs(tcfg)
    params = P.init(5, specs, "cpu")
    mesh = _mesh((1, 2))
    sh = stage_param_shardings(specs, mesh)
    placed = tree_map(M.place_as, params, sh)
    trees = [tp.gather_block(placed, CPU, j) for j in range(2)]
    # the stacked [layers, E, d, f] experts, split over model
    assert trees[0]["blocks"][0]["moe"]["wi_gate"].shape[1] == \
        tcfg.moe.num_experts // 2
    g = torch.Generator().manual_seed(6)
    batch = {"tokens": torch.randint(0, tcfg.vocab_size, (4, SEQ),
                                     generator=g),
             "labels": torch.randint(0, tcfg.vocab_size, (4, SEQ),
                                     generator=g)}
    group = tp.Group.of(mesh, data=0)
    for accum in (1, 2):
        with _alike(alike):
            l1, _, g1 = S.make_grad_fn(tcfg, "block", accum)(params, batch)
            l2, _, g2 = S.make_grad_fn(tcfg, "block", accum,
                                       group=group)(trees, batch)
        assert abs(float(l1) - float(l2)) <= 1e-6 * abs(float(l1))
        gp = M.reduce_scatter_tree(
            iter(g2), sh, wheres=[{"model": 0}, {"model": 1}],
            shapes=tree_map(lambda a: a.shape, params))
        for a, b in zip(tree_leaves(gp), tree_leaves(g1)):
            assert_close(M.gather(a, CPU).numpy(), b.double().numpy(), TOL)


# ---------------------------------------------------------------- meta
class _Shapes(TorchDispatchMode):
    """The shape of every tensor an op returns, by the mesh coordinate
    it runs as."""

    def __init__(self):
        super().__init__()
        self.seen: set = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out if isinstance(out, (list, tuple))
                             else [out]):
            if isinstance(t, torch.Tensor):
                self.seen.add((M.current_coord(), tuple(t.shape)))
        return out


def test_dryrun_train_cell_is_expert_parallel(monkeypatch):
    """llama4-scout's ``train_4k`` cell (depth cut to one layer) computes
    tensor-parallel on the production mesh, each expert's C slots once
    per microbatch (``apply_moe_a2a``): data shard 0's 16 model
    coordinates each run their one expert over its data slice, ``[1, C,
    d / 16]`` and ``[1, C, f]``, and no op on any coordinate returns a
    whole ``[E, ., .]`` MoE tensor, a shard's ``[1, Cb, d]`` buffer or a
    whole-width dispatch buffer; home receives the rows and the router
    gather, and the busiest device's peak falls below a quarter of the
    gathered path's."""
    from repro_torch.launch import dryrun
    full = dryrun.get_config(ARCH).with_overrides(n_layers=1)
    monkeypatch.setattr(dryrun, "get_config", lambda a: full)
    m = full.moe
    shape = dryrun.SHAPES["train_4k"]
    C = int(m.capacity_factor * shape.global_batch * shape.seq_len
            * m.top_k / m.num_experts)
    Cb = min(C, shape.global_batch // 16 * shape.seq_len * m.top_k)
    with _Shapes() as spy:
        rec = dryrun.run_cell(ARCH, "train_4k", "single", skip_probe=True)
    assert rec["status"] == "ok"
    assert dryrun._tensor_parallel(full, dryrun.make_production_mesh(
        devices=[torch.device("meta")] * 256), "data")
    shapes = {s for _, s in spy.seen}
    E, d, f = m.num_experts, full.d_model, m.d_ff_expert
    assert (1, C, f) in shapes and (1, C, d // 16) in shapes
    assert {(E, C, f), (E, C, d), (E, Cb, f), (E, Cb, d), (1, Cb, d),
            (E * C + 1, d), (E * Cb + 1, d), (Cb + 1, d)} \
        .isdisjoint(shapes)
    coords = {c for c, s in spy.seen if s == (1, C, f) and c is not None}
    assert len(coords) == 16
    counts = rec["collectives"]["counts"]
    assert counts["all-to-all"] >= 1 and counts["all-gather"] >= 1
    monkeypatch.setattr(dryrun, "_tensor_parallel", lambda *a: False)
    base = dryrun.run_cell(ARCH, "train_4k", "single", skip_probe=True)
    assert rec["memory"]["peak_per_device"] < \
        base["memory"]["peak_per_device"] / 4
