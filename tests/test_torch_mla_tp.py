"""Multi-head latent attention over the mesh's ``model`` axis for the
``mla`` and ``mla_moe`` kinds (``models.mla.mla_part``,
``models.blocks.mla_apply_tp`` / ``mla_moe_apply_tp``): the MLA half, a
split microbatch, mesh and span peers and the dry run's train cell,
against the port's one-device layer and the JAX package, on virtual CPU
meshes (one device listed 2-4 times), at reduced deepseek-v2 (4 heads,
``kv_lora`` 32, nope 16, rope 8, v 16, 4 experts top-2, one shared
expert of 32, d 64), with ``q_lora_rank`` 0 (``wq``) and 24 (``w_dq`` /
``w_uq``).  The ``mla`` kind is reached through ``block_pattern=("mla",)
* n``: no registered config uses it.

Tolerances: the MLA half over 2 and 4 model shards lies within 1e-5 of
the one-device half's largest entry in f32 (the heads' partials are
summed in f32), and over 3 (4 heads do not divide) it runs whole at
home, equal to the bit.  Over 2 data x 2 model shards a layer lies within
1e-5 of JAX's layer over the whole microbatch; the routes are the
one-device routes of the same router inputs exactly, and the aux shares
add up to JAX's aux.  A stage's loss, input cotangent and gradients lie
within 1e-5 of JAX's ``MeshExecutor`` (each leaf's largest entry,
absolute below 1), and a 3-step trajectory within 2e-4 of JAX's
reference.
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

import repro.runtime as jrt
from repro.configs import get_reduced as j_get_reduced
from repro.models import blocks as jB

from repro_torch.dist import mesh as M
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.sharding import stage_param_shardings
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import mla as mla_lib
from repro_torch.models import params as P
from repro_torch.models.params import from_numpy_tree
from repro_torch.runtime import MeshExecutor, MeshSpanExecutor, StageState
from repro_torch.tree import tree_leaves, tree_map
from test_torch_families import _numpy_init, assert_close, port_cfg
from test_torch_mesh import SEQ, _jax_reference, _runner
from test_torch_train import TRAJ_ATOL, _assert_exactly_once

torch.set_num_threads(1)   # as tests/test_torch_train.py explains

ROOT = Path(__file__).resolve().parents[1]
ARCH = "deepseek-v2-236b"
CPU = torch.device("cpu")
TOL = 1e-5


def _configs(cf=None, q_lora=0, kind="mla_moe"):
    jcfg = j_get_reduced(ARCH)
    jcfg = dataclasses.replace(
        jcfg, block_pattern=(kind,) * jcfg.n_layers,
        mla=dataclasses.replace(jcfg.mla, q_lora_rank=q_lora))
    if cf is not None:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
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


def _half_specs(tcfg):
    return {"ln1": L.norm_specs(tcfg), "mla": mla_lib.mla_specs(tcfg)}


def _half_params(tcfg, seed=3):
    """The MLA half's weights, the norm scale drawn too (its gradient is
    one partial a shard)."""
    p = P.init(seed, _half_specs(tcfg), "cpu")
    g = torch.Generator().manual_seed(seed)
    p["ln1"]["scale"] = 1 + 0.1 * torch.randn(p["ln1"]["scale"].shape,
                                              generator=g)
    return p


def _one_device_half(tcfg, p, x, pos):
    return x + mla_lib.apply_mla(tcfg, p["mla"],
                                 L.apply_norm(tcfg, p["ln1"], x), pos)


# ------------------------------------------------------------- the half
@pytest.mark.parametrize("q_lora", [0, 24], ids=["wq", "w_dq"])
@pytest.mark.parametrize("m", [2, 4])
def test_mla_half_over_model_shards_equals_one_device(m, q_lora):
    """The MLA half over ``m`` model shards against the one-device half
    on the same weights: each shard holds ``H / m`` heads of the
    up-projections and ``wo`` and the down-projections whole; one
    activation all-reduce; the output, the input cotangent and the
    gradients (a split leaf's blocks joined, a replicated leaf's partials
    summed) within 1e-5 of the largest entry."""
    _, tcfg = _configs(q_lora=q_lora)
    mesh = _mesh((1, m))
    group = tp.Group.of(mesh, data=0)
    p = _half_params(tcfg)
    ps = _blocks(p, _half_specs(tcfg), mesh)
    H = tcfg.n_heads
    assert mla_lib.mla_heads_split(tcfg, ps[0]["mla"])
    assert ps[0]["mla"]["wo"].shape[0] == ps[0]["mla"]["w_uk"].shape[1] \
        == H // m
    down = ["w_dkv", "w_krope"] + (["w_dq"] if q_lora else [])
    for k in down:
        assert ps[1]["mla"][k].shape == p["mla"][k].shape
    x0 = torch.from_numpy(_tilted(2, tcfg.d_model))
    pos = torch.arange(SEQ)
    x1 = x0.clone().requires_grad_()
    p1 = tree_map(lambda a: a.detach().clone().requires_grad_(), p)
    y1 = _one_device_half(tcfg, p1, x1, pos)
    x2 = x0.clone().requires_grad_()
    ps2 = [tree_map(lambda a: a.detach().clone().requires_grad_(), q)
           for q in ps]
    tp.ALL_REDUCES.clear()
    y2 = B._mla_half_tp(tcfg, ps2, x2, pos, group)
    assert dict(tp.ALL_REDUCES) == {"activation": 1}
    assert _rel(y2.detach().numpy(), y1.detach().numpy()) <= TOL
    g = torch.from_numpy(_tilted(2, tcfg.d_model, seed=8))
    (y1 * g).sum().backward()
    (y2 * g).sum().backward()
    assert _rel(x2.grad.numpy(), x1.grad.numpy()) <= TOL
    for sub, key in [(s, k) for s in p1 for k in p1[s]]:
        want = p1[sub][key]
        got = [q[sub][key] for q in ps2]
        if got[0].shape == want.shape:        # replicated: partials add
            total = sum(a.grad.double() for a in got)
        else:                                 # split on the heads dim
            dim = next(i for i, (a, b) in enumerate(
                zip(got[0].shape, want.shape)) if a != b)
            total = torch.cat([a.grad.double() for a in got], dim)
        assert_close(total.numpy(), want.grad.double().numpy(), TOL)


def test_mla_heads_not_dividing_model_run_whole_at_home():
    """4 heads over ``model`` 3 replicate (the divisibility rule): the
    MLA half runs ``apply_mla`` whole at home, to the bit, with no
    all-reduce, and a mesh peer of such a stage still takes the
    tensor-parallel path."""
    for q_lora in (0, 24):
        _, tcfg = _configs(q_lora=q_lora)
        mesh = _mesh((1, 3))
        p = _half_params(tcfg, seed=4)
        ps = _blocks(p, _half_specs(tcfg), mesh)
        assert not mla_lib.mla_heads_split(tcfg, ps[0]["mla"])
        x = torch.from_numpy(_tilted(2, tcfg.d_model))
        pos = torch.arange(SEQ)
        tp.ALL_REDUCES.clear()
        y = B._mla_half_tp(tcfg, ps, x, pos, tp.Group.of(mesh, data=0))
        assert not tp.ALL_REDUCES
        assert torch.equal(y, _one_device_half(tcfg, p, x, pos))
        assert MeshExecutor(tcfg, 2, SEQ, 1, mesh, compress="none"
                            ).compute_path == "tensor_parallel"


# ---------------------------------------------------- a split microbatch
def _record_plans(monkeypatch) -> list:
    """Record every ``_moe_plan`` call's routes: ``(expert, slot in the
    whole microbatch, kept)`` a pair."""
    seen, plan = [], L._moe_plan

    def spy(cfg, route, T):
        out = plan(cfg, route, T)
        provider = L.split_provider()
        off = 0 if provider is None else \
            provider(T, route[3].sum(0)).offsets[out[0]]
        seen.append((out[0], off + out[1], out[2]))
        return out
    monkeypatch.setattr(L, "_moe_plan", spy)
    return seen


def _record_router_inputs(monkeypatch) -> list:
    seen, route = [], L.moe_route_tp

    def spy(cfg, ps, x, group):
        seen.append(x.detach().clone())
        return route(cfg, ps, x, group)
    monkeypatch.setattr(L, "moe_route_tp", spy)
    return seen


@pytest.mark.parametrize("kind,cf", [("mla", None), ("mla_moe", 0.5),
                                     ("mla_moe", 1.25)])
@pytest.mark.parametrize("q_lora", [0, 24], ids=["wq", "w_dq"])
def test_split_layer_equals_jax_whole_microbatch(kind, cf, q_lora,
                                                 monkeypatch):
    """One layer over 2 data x 2 model shards (``apply_lockstep_tp``)
    against JAX's ``mla_apply`` / ``mla_moe_apply`` over the whole
    microbatch: within 1e-5 of its largest entry.  For ``mla_moe`` the
    aux shares add up to JAX's aux, and each pair's expert, slot and kept
    flag are those the port's one-device ``apply_moe`` gives the same
    router inputs joined into one microbatch, with the capacity
    binding."""
    jcfg, tcfg = _configs(cf, q_lora, kind)
    specs_fn, apply_fn = {"mla": (jB.mla_specs, jB.mla_apply),
                          "mla_moe": (jB.mla_moe_specs, jB.mla_moe_apply)
                          }[kind]
    host = _numpy_init(specs_fn(jcfg), 3)
    x = _tilted(4, jcfg.d_model)
    pos = np.arange(SEQ)
    jy, jaux = jax.jit(functools.partial(apply_fn, jcfg))(
        jax.tree.map(jnp.asarray, host), jnp.asarray(x), jnp.asarray(pos))
    mesh = _mesh((2, 2))
    groups = [tp.Group.of(mesh, data=i) for i in range(2)]
    tspecs = B.REGISTRY[kind][0](tcfg)
    ps = _blocks(from_numpy_tree(host, "cpu"), tspecs, mesh)
    plans = _record_plans(monkeypatch)
    inputs = _record_router_inputs(monkeypatch)
    tpos = torch.arange(SEQ)
    ys, auxs = B.apply_lockstep_tp(tcfg, kind, [ps, ps],
                                   list(torch.from_numpy(x).chunk(2)),
                                   [tpos, tpos], groups)
    assert _rel(torch.cat(ys).numpy(), jy) <= TOL
    if kind == "mla":
        assert not plans and float(sum(auxs)) == float(jaux) == 0.0
        return
    aux = sum(float(a) for a in auxs)
    assert abs(aux - float(jaux)) <= TOL * abs(float(jaux))
    assert len(plans) == len(inputs) == 2
    whole = torch.cat(inputs)
    T = whole.shape[0] * whole.shape[1]
    route = L.moe_route(tcfg, from_numpy_tree(host, "cpu")["moe"], whole)
    monkeypatch.undo()
    e, slot, keep, _, _ = L._moe_plan(tcfg, route, T)
    for got, want in zip(zip(*plans), (e, slot, keep)):
        assert torch.equal(torch.cat(got), want)
    assert int((~keep).sum()) > 0                 # the capacity binds


# ------------------------------------------------------ mesh executors
@pytest.mark.parametrize("kind", ["mla", "mla_moe"])
def test_supported_paths_of_mla_executors(kind):
    """A reduced deepseek-v2 ``MeshExecutor`` (both stages) and
    ``MeshSpanExecutor`` take the tensor-parallel path on (1, 2) and
    (2, 2); both kinds are registered, and ``mla_moe`` routes over the
    whole microbatch in lockstep."""
    _, tcfg = _configs(kind=kind)
    assert kind in B.TP_APPLY and kind in tp.SUPPORTED_KINDS
    assert ("mla_moe" in B.MOE_PRE_TP) and ("mla" not in B.MOE_PRE_TP)
    for shape in [(1, 2), (2, 2)]:
        mesh = _mesh(shape)
        exs = [MeshExecutor(tcfg, 2, SEQ, s, mesh, compress="none")
               for s in range(2)]
        exs.append(MeshSpanExecutor(tcfg, 2, SEQ, (0, 2), mesh,
                                    compress="none"))
        for ex in exs:
            assert ex.prog.routes_whole == (kind == "mla_moe")
            assert ex.compute_path == "tensor_parallel"


def _stage_params(jcfg, s=1):
    """Numpy weights of stage ``s`` of 2 (one layer; the last stage has
    the head), by JAX's init rules."""
    return _numpy_init(jrt.build_stage_programs(
        jcfg, 2, SEQ, compress="none")[s].specs, 1 + s)


def _stage_inputs(tcfg, rows=4, seed=3):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, SEQ, tcfg.d_model))
         + rng.standard_normal(tcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, tcfg.vocab_size, (rows, SEQ)).astype(np.int32)
    return x, labels


@pytest.mark.parametrize("kind", ["mla", "mla_moe"])
def test_mla_stage_collectives_a_layer(kind):
    """The last stage (one layer) on (2, 2): forward, a layer a data
    shard, one MLA all-reduce, then the FFN's all-reduce (``mla``) or a
    router gather and a shared-expert all-reduce a data shard and, once
    a layer for the microbatch, the columns' all-to-all, the slots'
    all-gather, the gate and up partials' all-reduces and the rows'
    return home (``mla_moe``, ``apply_moe_a2a``), besides the head's
    three; backward recomputes them and adds a cotangent all-reduce for
    each fanout and, for ``mla_moe``, the columns' transpose and the two
    partials' sums."""
    jcfg, tcfg = _configs(kind=kind)
    ex = MeshExecutor(tcfg, 2, SEQ, 1, _mesh((2, 2)), compress="none")
    st = StageState()
    ex.restore(st, {"params": _stage_params(jcfg), "opt": None})
    x, labels = _stage_inputs(tcfg)
    xt, lt = torch.as_tensor(x), torch.as_tensor(labels)
    moe = kind == "mla_moe"
    want = ({"activation": 4, "loss": 6} if not moe else
            {"activation": 2, "router": 2, "expert_columns": 1,
             "expert_slots": 1, "expert_partials": 2, "expert_rows": 1,
             "shared_expert": 2, "loss": 6})
    tp.ALL_REDUCES.clear()
    with M.record_collectives() as rec:
        ex.run_fwd(st, xt, lt)
    assert dict(tp.ALL_REDUCES) == want
    assert rec.counts[(0, 0)]["all-to-all"] == 2 * moe   # columns, rows
    tp.ALL_REDUCES.clear()
    ex.run_bwd(st, xt, labels=lt)
    assert dict(tp.ALL_REDUCES) == {**want, "cotangent": 6 + 3 * moe}


_JAX_MESH = textwrap.dedent("""
    import dataclasses, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "src")
    import jax, numpy as np
    from repro.configs import get_reduced
    from repro.launch.mesh import make_debug_mesh
    from repro.runtime import MeshExecutor, build_numeric_executors
    d = np.load(sys.argv[1], allow_pickle=True).item()
    cfg = get_reduced("deepseek-v2-236b")
    cfg = dataclasses.replace(cfg, mla=dataclasses.replace(
        cfg.mla, q_lora_rank=int(sys.argv[3])))
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


@pytest.mark.parametrize("q_lora", [0, 24], ids=["wq", "w_dq"])
def test_mla_moe_stage_matches_jax_mesh_executor(q_lora, tmp_path):
    """The last ``mla_moe`` stage's forward and ``run_bwd`` on a 2 x 2
    ``("data", "model")`` mesh, the microbatch of 4 split 2 + 2: the
    port's tensor-parallel mesh peer (a virtual CPU mesh) against JAX's
    ``MeshExecutor`` on 4 forced CPU devices (GSPMD over the same
    layout), on shared numpy params and inputs: loss, input cotangent
    and every gradient within 1e-5 of each leaf's largest entry
    (absolute below 1), the replicated down-projections' gradients
    summed from one partial a model shard."""
    jcfg, tcfg = _configs(q_lora=q_lora)
    params = _stage_params(jcfg)
    x, labels = _stage_inputs(tcfg)
    np.save(tmp_path / "in.npy", {"params": params, "x": x,
                                  "labels": labels}, allow_pickle=True)
    r = subprocess.run([sys.executable, "-c", _JAX_MESH,
                        str(tmp_path / "in.npy"), str(tmp_path / "out.npy"),
                        str(q_lora)],
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


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_mla_moe_tp_trajectory_equals_jax_reference(shape, monkeypatch):
    """Tensor-parallel mesh peers at both stages beside numeric peers,
    and a mesh span peer over [0, 2): a 3-step trajectory of reduced
    deepseek-v2 (top-2) within 2e-4 of JAX's sequential reference, each
    microbatch processed exactly once."""
    jcfg, tcfg = _configs()
    jprogs = jrt.build_stage_programs(jcfg, 2, SEQ, compress="none")
    jp = [_numpy_init(p.specs, s) for s, p in enumerate(jprogs)]
    want = _jax_reference(jcfg, jprogs, jp, 2, 8, monkeypatch)
    r = _runner(tcfg, jp, "none", 2, 8)
    r.build(peers_per_stage=1)
    mesh = _mesh(shape)
    for s in range(2):
        ex = MeshExecutor(tcfg, 2, SEQ, s, mesh, compress="none")
        assert ex.compute_path == "tensor_parallel"
        r.add_peer(s, executor=ex)
    span = MeshSpanExecutor(tcfg, 2, SEQ, (0, 2), mesh, compress="none")
    assert span.compute_path == "tensor_parallel"
    r.add_peer(range(0, 2), executor=span)
    m = r.run(until=1e6)
    np.testing.assert_allclose(m["loss"], want, atol=TRAJ_ATOL, rtol=0)
    _assert_exactly_once(r, 2, 4)


@pytest.mark.parametrize("kind,alike", [("mla", 1), ("mla_moe", 1),
                                        ("mla_moe", 2)])
def test_whole_model_grad_fn_over_model_shards(kind, alike):
    """The dry run's whole-model step (``train.steps.make_grad_fn`` over a
    data shard's model shards, ``lm_apply_tp`` with each layer
    checkpointed, so the recompute routes as the forward did) against
    the one-device step, at 1 and 2 microbatches, whole and under the
    dry run's rule of ``alike`` equal data shards: the loss within 1e-6,
    every gradient within 1e-5 of its largest entry."""
    from repro_torch.launch.dryrun import _alike
    from repro_torch.train import steps as S
    _, tcfg = _configs(q_lora=24, kind=kind)
    specs = S.model_specs(tcfg)
    params = P.init(5, specs, "cpu")
    mesh = _mesh((1, 2))
    sh = stage_param_shardings(specs, mesh)
    placed = tree_map(M.place_as, params, sh)
    trees = [tp.gather_block(placed, CPU, j) for j in range(2)]
    # the stacked [layers, r, H, k] up-projections, split over model
    assert trees[0]["blocks"][0]["mla"]["w_uk"].shape[2] == \
        tcfg.n_heads // 2
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
def test_dryrun_train_cell_computes_mla_tensor_parallel(monkeypatch):
    """deepseek-v2's ``train_4k`` cell (depth cut to one layer) computes
    tensor-parallel on the production mesh: each of data shard 0's 16
    model coordinates runs flash over its 8 of the 128 heads at the
    ``(192, 128)`` head dims, and no coordinate runs all 128.  Each
    expert's slots are computed once per microbatch
    (``apply_moe_a2a``): home receives every pair's row slice ``[T k, d
    / 16]`` from each of the 255 other coordinates, forward and
    recompute (bf16, T = 16 x 4,096 tokens, k = 6: 128.3 GB, where
    whole rows from the 15 other model shards were 120.8 GB), and the
    other data shards' columns of the stream, ``[T, d / 16]`` from 15,
    forward, recompute and the backward's transpose (1.9 GB); and the
    busiest coordinate's peak falls below a third of the gathered
    path's (forced here as ``test_torch_tp.py`` forces it)."""
    from repro_torch.launch import dryrun
    from repro_torch.models import flash as flash_lib
    full = dryrun.get_config(ARCH).with_overrides(
        n_layers=1, block_pattern=("mla_moe",))
    monkeypatch.setattr(dryrun, "get_config", lambda a: full)
    assert dryrun._tensor_parallel(full, dryrun.make_production_mesh(
        devices=[torch.device("meta")] * 256), "data")
    heads, fa = [], flash_lib.flash_attention

    def spy(q, k, v, **kw):
        heads.append((M.current_coord(), q.shape[2], q.shape[3],
                      v.shape[3]))
        return fa(q, k, v, **kw)
    monkeypatch.setattr(flash_lib, "flash_attention", spy)
    rec = dryrun.run_cell(ARCH, "train_4k", "single", skip_probe=True)
    assert rec["status"] == "ok"
    assert {h[1:] for h in heads} == {(8, 192, 128)}
    assert len({h[0] for h in heads}) == 16
    shape = dryrun.SHAPES["train_4k"]
    pairs = shape.global_batch // 16 * shape.seq_len * full.moe.top_k
    coll = rec["collectives"]
    assert coll["counts"]["all-reduce"] > 3
    tokens = shape.global_batch // 16 * shape.seq_len
    dn = full.d_model // 16
    assert coll["bytes"]["all-to-all"] == \
        2 * 255 * pairs * dn * 2 + 3 * 15 * tokens * dn * 2
    monkeypatch.setattr(dryrun, "_tensor_parallel", lambda *a: False)
    base = dryrun.run_cell(ARCH, "train_4k", "single", skip_probe=True)
    assert rec["memory"]["peak_per_device"] < \
        base["memory"]["peak_per_device"] / 3
