"""MoE routing over a data-split microbatch, against the JAX package's
whole-microbatch routing.

JAX's ``apply_moe`` takes its capacity C, each routed pair's slot (a
token-major ``cumsum``) and the Switch balance loss over the whole
microbatch, and its jitted stage and pipeline programs keep those
semantics with the batch sharded over ``data``.  The port runs a data
shard's program on its own rows, so a MoE layer of a split microbatch
takes a ``models.layers.MoESplit`` (the microbatch's token count, the
shard's slot offsets, the microbatch's route counts) and the shards of
a MoE stage run in lockstep.  Held here, on the CPU at reduced width:

* ``apply_moe`` over 2 and 4 shards, joined, against JAX's
  ``apply_moe`` over the whole input (llama4-scout's top-1 + shared
  expert, deepseek-v2's top-2 ``mla_moe`` config), at capacity factors
  0.5 and 1.25, both binding: outputs within 1e-5 of their largest
  entry, the shards' aux shares adding up to JAX's aux;
* a MoE stage's ``run_bwd`` on 2- and 4-way virtual meshes against the
  same executor on one device (itself held to JAX's stage program):
  gradients within 1e-5 of each leaf's largest entry; a
  ``MeshSpanExecutor`` over both stages too;
* the shifting-buffer pipeline over ``pod`` 2 x ``data`` 2 against JAX's
  staged reference: loss within 1e-4, gradients within 1e-3;
* the dry run's two MoE pipeline cells (depth cut to a layer a stage)
  and xlstm-125m ``train_4k --strategy dp --accum 2``, whose
  ``argument_bytes`` equal JAX's.

Each case also shows that the check bites: the shards routed on their
own rows (what the port computed before) miss the bound.
"""
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.dist import pipeline as jpipe
from repro.models import layers as jL
from repro.runtime.stage_model import build_stage_programs as j_build
from repro.train import steps as jsteps

from repro_torch.dist import pipeline as tpipe
from repro_torch.dist.mesh import gather
from repro_torch.launch.mesh import make_debug_mesh, make_peer_mesh
from repro_torch.models import layers as tL
from repro_torch.models.params import from_numpy_tree, to_numpy_tree
from repro_torch.runtime import MeshExecutor, MeshSpanExecutor, \
    build_numeric_executors
from repro_torch.train.steps import _value_and_grad
from repro_torch.tree import tree_leaves
from test_torch_families import _numpy_init, assert_close, port_cfg

torch.set_num_threads(1)   # as tests/test_torch_train.py explains

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
TOL = 1e-5
LOSS_ATOL, GRAD_ATOL = 1e-4, 1e-3       # JAX's pipeline tests' bounds
SEQ = 16
ARCHS = ["llama4-scout-17b-a16e", "deepseek-v2-236b"]


def _configs(arch, cf=None):
    jcfg = j_get_reduced(arch)
    if cf is not None:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
    return jcfg, port_cfg(jcfg)


def _rel(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _split_moe(tcfg, p, x, n, split=True):
    """``apply_moe`` over ``n`` row shards of ``x``, joined, and the
    shards' aux summed; ``split=False`` routes each shard on its own."""
    xs = list(x.chunk(n))
    if not split:
        outs = [tL.apply_moe(tcfg, p, xi) for xi in xs]
    else:
        outs = list(zip(*tL.apply_moe_shards(tcfg, [p] * n, xs)))
    return torch.cat([y for y, _ in outs]), sum(float(a) for _, a in outs)


# ---------------------------------------------------------- the layer
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("cf", [0.5, 1.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_split_moe_equals_jax_whole_microbatch(arch, cf, n):
    jcfg, tcfg = _configs(arch, cf)
    host = _numpy_init(jL.moe_specs(jcfg), 3)
    rng = np.random.default_rng(7)
    # a direction every token shares tilts the router to some experts,
    # so that the capacity binds at 1.25 too
    x = (rng.standard_normal((4, SEQ, jcfg.d_model))
         + rng.standard_normal(jcfg.d_model)).astype(np.float32)
    jy, jaux = jax.jit(functools.partial(jL.apply_moe, jcfg))(
        jax.tree.map(jnp.asarray, host), jnp.asarray(x))
    p = from_numpy_tree(host, "cpu")
    y, aux = _split_moe(tcfg, p, torch.from_numpy(x), n)
    assert _rel(y.numpy(), jy) <= TOL
    assert abs(aux - float(jaux)) <= TOL * abs(float(jaux))
    # the capacity binds, and routing each shard on its own rows (C and
    # the slots of the shard alone) is another function
    T, m = 4 * SEQ, jcfg.moe
    C = max(1, int(cf * T * m.top_k / m.num_experts))
    sel = tL.moe_route(tcfg, p, torch.from_numpy(x))[2]
    assert int(torch.bincount(sel.reshape(-1)).max()) > C
    y_own, _ = _split_moe(tcfg, p, torch.from_numpy(x), n, split=False)
    assert _rel(y_own.numpy(), jy) > 1e-2


def test_split_moe_without_context_is_unchanged():
    """No context: the layer is the whole-input layer; a context of one
    shard (offsets 0, its own counts) computes the same numbers."""
    _, tcfg = _configs(ARCHS[0], 1.25)
    p = from_numpy_tree(_numpy_init(jL.moe_specs(_configs(ARCHS[0])[0]),
                                    3), "cpu")
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, SEQ, tcfg.d_model)).astype(np.float32))
    y, aux = tL.apply_moe(tcfg, p, x)
    y1, aux1 = _split_moe(tcfg, p, x, 1)
    torch.testing.assert_close(y1, y, rtol=0, atol=0)
    assert aux1 == pytest.approx(float(aux), rel=1e-6)
    from repro_torch.launch.dryrun import _alike
    with _alike(2):                        # the dry run's rule
        y2, _ = tL.apply_moe(tcfg, p, x[:1])
    assert y2.shape == (1, SEQ, tcfg.d_model)


# ----------------------------------------------------- mesh executors
def _stage_state(tcfg, n_stages=2, seed=11):
    num = build_numeric_executors(tcfg, n_stages, SEQ, device="cpu")
    states = []
    for s, e in enumerate(num):
        st = e.init_state(seed + s)
        states.append(st)
    return num, states


def _mesh_bwd(tcfg, num, sts, k, tok, lab, s=1):
    """Stage ``s``'s ``run_bwd`` on a ``k``-way virtual mesh: (loss, gx,
    gradient leaves gathered)."""
    m = MeshExecutor(tcfg, 2, SEQ, s, make_peer_mesh(devices=[CPU] * k))
    st = m.init_state(0)
    m.restore(st, num[s].snapshot(sts[s]))
    w = num[0].run_fwd(sts[0], tok)
    loss, gx, gp = m.run_bwd(st, w, labels=lab)
    return float(loss), gx, [gather(a, CPU) for a in tree_leaves(gp)]


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_stage_on_split_mesh_equals_unsplit(arch, k):
    """F3: stage 1's ``run_bwd`` at the config's own capacity factor
    (1.25) on a ``k``-way virtual mesh, the microbatch of 4 split ``k``
    ways, against the one-device executor, which equals JAX's stage
    program on the same weights."""
    jcfg, tcfg = _configs(arch)
    num, sts = _stage_state(tcfg)
    rng = np.random.default_rng(9)
    tok = torch.as_tensor(rng.integers(0, jcfg.vocab_size, (4, SEQ)))
    lab = torch.as_tensor(rng.integers(0, jcfg.vocab_size, (4, SEQ)))
    loss1, gx1, g1 = _mesh_bwd(tcfg, num, sts, 1, tok, lab)
    lossk, gxk, gk = _mesh_bwd(tcfg, num, sts, k, tok, lab)
    assert abs(lossk - loss1) <= TOL * abs(loss1)
    assert _rel(gxk, gx1) <= TOL
    for a, b in zip(gk, g1):
        assert _rel(a, b) <= TOL
    # the unsplit executor is JAX's stage program (at
    # test_torch_families.py's tolerance: 1e-5 of a leaf's largest
    # entry, absolute below 1; top-1 routing leaves the router only
    # rounding noise of ~1e-9)
    jprog = j_build(jcfg, 2, SEQ)[1]
    w = num[0].run_fwd(sts[0], tok).numpy()
    jl, jgx, jgp = jprog.bwd(jax.tree.map(jnp.asarray, to_numpy_tree(
        sts[1].params)), jnp.asarray(w), jnp.asarray(lab.numpy()))
    assert abs(loss1 - float(jl)) <= TOL * abs(float(jl))
    assert_close(gx1.numpy(), jgx)
    for a, b in zip(g1, jax.tree.leaves(jax.device_get(jgp))):
        assert_close(a.numpy(), b)
    # the check bites: each shard run on its own rows misses the bound
    w, rows = torch.as_tensor(w), 4 // k
    halves = [num[1].run_bwd(sts[1], w[i * rows:(i + 1) * rows],
                             labels=lab[i * rows:(i + 1) * rows])
              for i in range(k)]
    g_own = [sum(a.double() for a in leaves) for leaves in
             zip(*(tree_leaves(h[2]) for h in halves))]
    assert max(_rel(a, b) for a, b in zip(g_own, g1)) > 1e-3


def test_moe_span_on_split_mesh_equals_unsplit():
    """A ``MeshSpanExecutor`` over both stages, 2-way, against one
    device."""
    jcfg, tcfg = _configs(ARCHS[0])
    num, sts = _stage_state(tcfg)
    rng = np.random.default_rng(10)
    tok = torch.as_tensor(rng.integers(0, jcfg.vocab_size, (4, SEQ)))
    lab = torch.as_tensor(rng.integers(0, jcfg.vocab_size, (4, SEQ)))
    out = {}
    for k in (1, 2):
        ex = MeshSpanExecutor(tcfg, 2, SEQ, (0, 2),
                              make_peer_mesh(devices=[CPU] * k))
        st = ex.init_state(0)
        for s in range(2):
            ex.restore(st, num[s].snapshot(sts[s]), stage=s)
        assert float(ex.run_fwd(st, tok, lab)) > 0
        loss, _, gps = ex.run_bwd(st, tok, labels=lab)
        out[k] = (float(loss), [gather(a, CPU) for s in range(2)
                                for a in tree_leaves(gps[s])])
    assert abs(out[2][0] - out[1][0]) <= TOL * abs(out[1][0])
    for a, b in zip(out[2][1], out[1][1]):
        assert _rel(a, b) <= TOL


@pytest.mark.parametrize("arch,calls", [(ARCHS[0], [4]), (ARCHS[1], [4]),
                                        ("yi-6b", [1, 1, 1, 1])])
def test_mesh_executor_hands_a_moe_stage_all_shards_at_once(arch, calls):
    """Through one code path, a 4-way mesh peer hands a MoE stage's
    program a microbatch's four shards in one call (they route over the
    whole microbatch) and a dense stage's one shard a call (one shard's
    activations live at a time), forward and backward alike."""
    _, tcfg = _configs(arch)
    num, sts = _stage_state(tcfg)
    m = MeshExecutor(tcfg, 2, SEQ, 1, make_peer_mesh(devices=[CPU] * 4))
    st = m.init_state(0)
    m.restore(st, num[1].snapshot(sts[1]))
    assert m.prog.routes_whole == (arch in ARCHS)
    rng = np.random.default_rng(12)
    tok = torch.as_tensor(rng.integers(0, tcfg.vocab_size, (4, SEQ)))
    lab = torch.as_tensor(rng.integers(0, tcfg.vocab_size, (4, SEQ)))
    w = num[0].run_fwd(sts[0], tok)
    seen = {"fwd": [], "bwd": []}
    prog = m.prog
    fwd_shards, bwd_shards = prog.fwd_shards, prog.bwd_shards

    def spy_fwd(ps, *a):
        seen["fwd"].append(len(ps))
        return fwd_shards(ps, *a)

    def spy_bwd(ps, *a):
        seen["bwd"].append(len(ps))
        return bwd_shards(ps, *a)
    m.prog = dataclasses.replace(prog, fwd_shards=spy_fwd,
                                 bwd_shards=spy_bwd)
    loss_f = float(m.run_fwd(st, w, lab))
    loss_b, _, _ = m.run_bwd(st, w, labels=lab)
    assert seen == {"fwd": calls, "bwd": calls}
    assert abs(float(loss_b) - loss_f) <= TOL * abs(loss_f)


# ------------------------------------------------------------ pipeline
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_pipeline_over_pod_and_data_equals_jax_reference(arch):
    """The shifting-buffer step over ``pod`` 2 x ``data`` 2 (each
    microbatch of 2 split 1 + 1, its MoE layers in lockstep) against
    JAX's staged reference: the loss (CE + the balance loss) within
    1e-4, every gradient within 1e-3 of its leaf's largest entry."""
    jcfg, tcfg = _configs(arch)
    host = _numpy_init(jsteps.model_specs(jcfg), 4)
    rng = np.random.default_rng(12)
    batch = {k: rng.integers(0, jcfg.vocab_size, (4, SEQ)).astype(np.int32)
             for k in ("tokens", "labels")}
    ref = jpipe.make_reference_loss_fn(jcfg, 2, 2)
    (want, _), jg = jax.jit(jax.value_and_grad(ref, has_aux=True))(
        jax.tree.map(jnp.asarray, host),
        {k: jnp.asarray(v) for k, v in batch.items()})
    step = tpipe.make_pipeline_train_step(tcfg, None, 2, 2)
    mesh = make_debug_mesh((2, 2), ("pod", "data"), devices=[CPU] * 4)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    with mesh:
        loss, _, g = _value_and_grad(step.loss_fn,
                                     from_numpy_tree(host, "cpu"), tb)
    assert abs(float(loss) - float(want)) < LOSS_ATOL
    for a, b in zip(jax.tree.leaves(jax.device_get(jg)), tree_leaves(g)):
        a = np.asarray(a, np.float64)
        scale = np.abs(a).max() + 1e-9
        np.testing.assert_allclose(b.double().numpy() / scale, a / scale,
                                   atol=GRAD_ATOL, rtol=0)


# ------------------------------------------------------------- dry run
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_pipeline_dryrun_cells_build(arch, monkeypatch):
    """F1: the ``train_4k`` cell on the multi-pod mesh takes the pipeline
    path (a MoE microbatch of 32 rows split over ``data`` 16) and ends
    ``ok``; depth cut to one layer a stage (both full-depth cells run
    from the CLI in minutes)."""
    from repro_torch.launch import dryrun
    full = dryrun.get_config(arch)
    kinds = full.block_kinds[:2]
    monkeypatch.setattr(dryrun, "get_config", lambda a: full.with_overrides(
        n_layers=2, block_pattern=kinds if full.block_pattern else None))
    rec = dryrun.run_cell(arch, "train_4k", "multi", skip_probe=True)
    assert rec["status"] == "ok", rec.get("reason")
    assert rec["pipeline"] is True
    assert rec["flops_per_device"] > 0


def test_dp_accumulation_at_one_row_a_shard_equals_jax_arguments():
    """F2: xlstm-125m ``train_4k --strategy dp --accum 2`` puts one row on
    each of 256 shards, fewer than ``accum``: the shard computes its row
    in the microbatch it belongs to, and the cell's ``argument_bytes``
    equal JAX's (JAX's dry run in a subprocess: its 512 forced host
    devices must not reach this process)."""
    from repro_torch.launch import dryrun
    code = ("import json\n"
            "from repro.launch import dryrun as d\n"
            "print(json.dumps(d.run_cell('xlstm-125m', 'train_4k', "
            "'single', skip_probe=True, accum=2, strategy='dp')))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=600,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                                JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-3000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    got = dryrun.run_cell("xlstm-125m", "train_4k", "single",
                          skip_probe=True, accum=2, strategy="dp")
    assert want["status"] == got["status"] == "ok", got.get("reason")
    assert got["memory"]["argument_bytes"] == \
        want["memory"]["argument_bytes"]


@pytest.mark.parametrize("accum,batch,n,want", [
    (2, 256, 256, (1, 128)), (2, 256, 16, (2, 16)), (1, 256, 16, (1, 16)),
    (4, 32, 16, (1, 4))])
def test_shard_grad_fn_splits_globally_below_accum(accum, batch, n, want):
    """A shard of ``batch / n`` rows: ``accum`` parts of its own rows where
    it holds at least ``accum``, else its rows whole; a MoE layer routes
    as one of the microbatch's equal parts."""
    from repro_torch.launch import dryrun
    calls = []
    orig = dryrun.steps_lib.make_grad_fn
    try:
        dryrun.steps_lib.make_grad_fn = lambda cfg, remat, a: calls.append(
            a)
        _, alike = dryrun._shard_grad_fn(None, "block", accum, batch, n)
    finally:
        dryrun.steps_lib.make_grad_fn = orig
    assert (calls[0], alike) == want


def test_reduce_scatter_alike_equals_folding_every_part():
    """The dry run's fold of equal gradient parts (the parts past the
    second replayed) records what folding every part records: the
    ledger's bytes a coordinate, its peak, and the collective moves."""
    from repro_torch.dist import mesh as M
    from repro_torch.launch import dryrun
    from repro_torch.launch import hlo_analysis as H
    meta = torch.device("meta")
    mesh = make_debug_mesh((4, 2), ("data", "model"), devices=[meta] * 8)
    grads = {"a": torch.empty(64, 32, device=meta),
             "b": torch.empty(8, device=meta)}
    shardings = {"a": M.NamedSharding(mesh, ("data", "model")),
                 "b": M.NamedSharding(mesh, ())}
    coords = [mesh.coord(data=i) for i in range(4)]

    def record(fold):
        with M.record_collectives() as rec, H.DeviceLedger() as led:
            gp = fold()
        return ({c: led.total_bytes(c) for c in mesh.coords()},
                dict(led.peak), rec.bytes, rec.counts,
                [tuple(p.shards[c].shape for c in mesh.coords())
                 for p in tree_leaves(gp)])

    fast = record(lambda: dryrun._reduce_scatter_alike(grads, shardings,
                                                       coords))
    slow = record(lambda: M.reduce_scatter_tree(
        [grads] * len(coords), shardings, sources=coords))
    assert fast == slow
    assert sum(fast[3][c]["reduce-scatter"] for c in fast[3]) > 0
