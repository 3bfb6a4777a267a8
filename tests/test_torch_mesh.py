"""Mesh-backed SWARM peers in the port against the JAX package: the
counterparts of the mesh cases of ``tests/test_runtime.py`` (mixed
mesh + numeric swarms under churn, snapshots across backends, the
protocol, the 4-device mixed swarm) and of ``tests/test_async_overlap.py``
(``for_span`` widths, span snapshots, a mesh span peer under the async
tick), on virtual meshes of the CPU (one device listed 2 or 4 times:
the placement, splitting, gathering and reduction code of distinct
devices, without their copies).  Plus the repair these executors need in
``SwarmRunner``: a migrated, resized or revived mesh peer stays
mesh-backed.

Tolerances: on a one-device mesh, or where the microbatch does not
divide the data axis (it then runs whole), a mesh peer equals a numeric
peer to the bit; with the microbatch split, it equals the numeric
program run on each half to the bit, and the whole microbatch's
gradients within 1e-5 of each leaf's largest entry (the order of the
batch's reductions);
trajectories within 2e-4 of JAX's sequential reference (the JAX tests'
bound), JAX's ``wq`` / ``wk`` scaled by 0.3 as ``test_torch_train.py``
explains.  About 48 s serial on the CPU, mostly JAX's references.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.runtime as jrt
from conftest import reference_losses as j_reference_losses
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.optim import adamw as j_adamw

from repro_torch.core.faults import TraceEvent
from repro_torch.core.sim import Sleep
from repro_torch.core.swarm import SwarmConfig, SwarmRunner
from repro_torch.dist.mesh import Placed, gather, place
from repro_torch.dist.sharding import DEFAULT_RULES, ShardingRules
from repro_torch.launch.mesh import make_debug_mesh, make_peer_mesh, \
    make_production_mesh
from repro_torch.models.params import from_numpy_tree, to_numpy_tree
from repro_torch.optim import adamw
from repro_torch.runtime import (MeshExecutor, MeshSpanExecutor,
                                 StageExecutor, build_numeric_executors)
from repro_torch.tree import tree_leaves
from test_torch_families import _numpy_init
from test_torch_train import TRAJ_ATOL, _assert_exactly_once, _close_rel, \
    _configs, _scaled

torch.set_num_threads(1)   # as tests/test_torch_train.py explains

SEQ, STEPS = 32, 3
CPU = torch.device("cpu")
BOTTLENECK = dict(boundary_compression="bottleneck", bottleneck_dim=16)


def _cpu_mesh(n: int):
    return make_peer_mesh(devices=[CPU] * n)


def _batches(mb: int):
    ds = JSyntheticLM(256, SEQ, mb, seed=17)
    cache = {}

    def data_fn(i):
        if i not in cache:
            cache[i] = {k: np.asarray(v) for k, v in ds.batch(i).items()}
        return cache[i]
    return data_fn


def _jax_params(jcfg, codec, n_stages=2):
    """JAX's stage programs and numpy weights drawn by JAX's init rules
    (``_numpy_init``: JAX's own init compiles one program a leaf)."""
    jprogs = jrt.build_stage_programs(jcfg, n_stages, SEQ, compress=codec)
    jp = [_scaled(_numpy_init(p.specs, s)) for s, p in enumerate(jprogs)]
    return jprogs, jp


def _jax_reference(jcfg, jprogs, jp, mb, gb, monkeypatch):
    monkeypatch.setattr(jrt, "init_stage_params", lambda progs, key: [
        jax.tree.map(jnp.asarray, p) for p in jp])
    return j_reference_losses(jcfg, jprogs, j_adamw(lr=1e-2, grad_clip=0.0),
                              0, STEPS, SEQ, mb, gb)


def _runner(tcfg, jp, codec, mb, gb, **kw):
    """A port runner whose step-0 state is JAX's params (trainers not
    built yet)."""
    topt = adamw(lr=1e-2, grad_clip=0.0)
    base = dict(n_stages=len(jp), microbatch_size=mb, seq_len=SEQ,
                global_batch=gb, n_trainers=3, rebalance_period=0.0,
                codec=codec, max_steps=STEPS)
    base.update(kw)
    r = SwarmRunner(tcfg, SwarmConfig(**base), topt, seed=0,
                    data_fn=_batches(mb), record_accumulation=True,
                    device="cpu")
    r._ref_params = [from_numpy_tree(p, "cpu") for p in jp]
    r._ref_opt = [topt.init(p) for p in r._ref_params]
    return r


def _port_stage(tcfg, jp, codec, s=1):
    """Numeric executors of 2 stages, stage ``s``'s state on JAX's
    params, and a boundary input + labels for it."""
    num = build_numeric_executors(tcfg, 2, SEQ, compress=codec,
                                  device="cpu")
    st = [num[i].init_state(0) for i in range(2)]
    for i in range(2):
        num[i].restore(st[i], {"params": jp[i], "opt": None})
    b = _batches(2)(0)
    w = num[0].wire_fwd(num[0].run_fwd(st[0], b["tokens"]))
    return num, st, w, torch.as_tensor(b["labels"]), b


def _leaves_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ------------------------------------------------------- executor parity
@pytest.mark.parametrize("n,rules", [(1, None), (4, None), (4, "repl")],
                         ids=["one-device", "4-way-unsplit",
                              "4-way-replicated"])
def test_mesh_bwd_equals_numeric_to_the_bit(n, rules):
    """On a one-device mesh, and on a 4-way mesh whose microbatch of 2
    does not divide the data axis (it runs whole), a mesh peer's
    forward and backward equal a numeric peer's to the bit, with the
    default rules (params FSDP over ``data``, gathered before use) and
    with every rule replicated: the executor's placement, gathering and
    wire add no numerics of their own."""
    jcfg, tcfg = _configs(**BOTTLENECK)
    _, jp = _jax_params(jcfg, "bottleneck")
    num, st, w, labels, _ = _port_stage(tcfg, jp, "bottleneck")
    loss_n, gx_n, gp_n = num[1].run_bwd(st[1], w, labels=labels)
    repl = ShardingRules(rules={k: None for k in DEFAULT_RULES.rules})
    mex = MeshExecutor(tcfg, 2, SEQ, 1, _cpu_mesh(n), compress="bottleneck",
                       rules=repl if rules else None)
    assert mex.dp_shards(2) == 1 and mex.device_count == n
    st_m = mex.init_state(9)
    mex.restore(st_m, num[1].snapshot(st[1]))
    assert float(mex.run_fwd(st_m, w, labels)) == \
        float(num[1].run_fwd(st[1], w, labels))
    loss_m, gx_m, gp_m = mex.run_bwd(st_m, w, labels=labels)
    assert float(loss_n) == float(loss_m)
    torch.testing.assert_close(gx_m, gx_n, rtol=0, atol=0)
    assert all(isinstance(g, Placed) for g in tree_leaves(gp_m))
    for a, c in zip(tree_leaves(gp_n), tree_leaves(gp_m)):
        torch.testing.assert_close(gather(c, CPU), a.to(torch.float64),
                                   rtol=0, atol=0)


def test_mesh_split_batch_matches_numeric_up_to_reduction_order():
    """A 2-way mesh splits a microbatch of 2 into 1 + 1: the loss is the
    shards' token sums added, the input cotangent their concatenation,
    the gradients reduce-scattered into the params' FSDP layout (each
    shard half the embed dim, on its own device coordinate) — equal to
    the one-device step up to reduction order, and to the numeric
    program run on each half apart to the bit; stage 0's forward too."""
    jcfg, tcfg = _configs(**BOTTLENECK)
    _, jp = _jax_params(jcfg, "bottleneck")
    num, st, w, labels, b = _port_stage(tcfg, jp, "bottleneck")
    mesh = _cpu_mesh(2)
    m1 = MeshExecutor(tcfg, 2, SEQ, 1, mesh, compress="bottleneck")
    assert m1.dp_shards(2) == 2 and m1.dp_shards(3) == 1
    st_m = m1.init_state(3)
    m1.restore(st_m, num[1].snapshot(st[1]))
    wq = st_m.params["blocks"][0]["attn"]["wq"]
    assert wq.spec[1] == "data" and wq.shards[1].shape[1] == \
        wq.shape[1] // 2
    loss_n, gx_n, gp_n = num[1].run_bwd(st[1], w, labels=labels)
    loss_m, gx_m, gp_m = m1.run_bwd(st_m, w, labels=labels)
    assert abs(float(loss_m) - float(loss_n)) <= 1e-6 * abs(float(loss_n))
    _close_rel(gx_m, gx_n)
    for a, c in zip(tree_leaves(gp_n), tree_leaves(gp_m)):
        _close_rel(gather(c, CPU), a)
    # exactly the numeric program run on each half: losses added in
    # f64, gradients summed in f64, cotangents joined
    halves = [num[1].run_bwd(st[1], w[i:i + 1], labels=labels[i:i + 1])
              for i in range(2)]
    assert float(loss_m) == float(halves[0][0]) + float(halves[1][0])
    torch.testing.assert_close(gx_m, torch.cat([h[1] for h in halves]),
                               rtol=0, atol=0)
    for c, h0, h1 in zip(tree_leaves(gp_m), tree_leaves(halves[0][2]),
                         tree_leaves(halves[1][2])):
        torch.testing.assert_close(gather(c, CPU),
                                   h0.double() + h1.double(), rtol=0, atol=0)
    m0 = m1.for_stage(0)
    st0 = m0.init_state(4)
    m0.restore(st0, num[0].snapshot(st[0]))
    _close_rel(m0.run_fwd(st0, b["tokens"]),
               num[0].run_fwd(st[0], b["tokens"]))


def test_executors_satisfy_protocol():
    _, tcfg = _configs(**BOTTLENECK)
    num = build_numeric_executors(tcfg, 2, SEQ, compress="bottleneck",
                                  device="cpu")[0]
    msh = MeshExecutor(tcfg, 2, SEQ, 0, _cpu_mesh(1), compress="bottleneck")
    assert isinstance(num, StageExecutor) and isinstance(msh,
                                                         StageExecutor)
    assert msh.for_stage(1).stage == 1 and msh.for_stage(0) is msh
    with pytest.raises(NotImplementedError, match="serving"):
        msh.session_program(64)


def test_mesh_numeric_snapshot_restore_roundtrip():
    """State downloads cross backends: numeric -> mesh -> numeric
    through the host format, bit for bit, the accumulator zeroed."""
    _, tcfg = _configs(**BOTTLENECK)
    execs = build_numeric_executors(tcfg, 2, SEQ, compress="bottleneck",
                                    device="cpu")
    mex = MeshExecutor(tcfg, 2, SEQ, 0, _cpu_mesh(2), compress="bottleneck")
    st = execs[0].init_state(3)
    st.opt = adamw().init(st.params)
    st.version = 7
    snap = execs[0].snapshot(st)
    mst = mex.init_state(4)
    mex.restore(mst, snap)
    assert mst.version == 7
    assert isinstance(mst.opt["m"]["embed"], Placed)
    back = mex.snapshot(mst)
    _leaves_equal(snap, back)
    st2 = execs[0].init_state(5)
    execs[0].restore(st2, back)
    _leaves_equal(to_numpy_tree(st.params), to_numpy_tree(st2.params))
    assert all(float(x.abs().max()) == 0.0
               for x in tree_leaves(st2.grad_acc))


# ------------------------------------------------------- swarms vs JAX
def test_mixed_mesh_numeric_churn_equals_jax_reference(monkeypatch):
    """A churn trace on a heterogeneous swarm — 2-way mesh peers at both
    stages (the microbatch of 2 split 1 + 1) beside numeric peers, the
    learned bottleneck codec on — stays within 2e-4 of JAX's fault-free
    reference, each (stage, microbatch) admitted once, and the mesh
    peers really accumulate."""
    jcfg, tcfg = _configs(**BOTTLENECK)
    jprogs, jp = _jax_params(jcfg, "bottleneck")
    want = _jax_reference(jcfg, jprogs, jp, 2, 8, monkeypatch)
    r = _runner(tcfg, jp, "bottleneck", 2, 8)
    r.build(peers_per_stage=2)
    mesh = _cpu_mesh(2)
    for s in range(2):
        r.add_peer(s, executor=MeshExecutor(tcfg, 2, SEQ, s, mesh,
                                            compress="bottleneck"))
    r.apply_trace([TraceEvent(0.02, -1), TraceEvent(0.05, -1),
                   TraceEvent(0.25, +1)])
    m = r.run(until=1e6)
    assert r.step == STEPS and m["failures"] == 2 and m["joins"] == 1
    mesh_ids = {p.id for p in r.peers.values()
                if isinstance(p.executor, MeshExecutor)}
    assert any(kind == "acc" and pid in mesh_ids
               for (kind, *_r, pid) in r.ledger_log)
    np.testing.assert_allclose(m["loss"], want, atol=TRAJ_ATOL, rtol=0)
    _assert_exactly_once(r, 2, 4)


def test_mixed_swarm_with_4_way_virtual_mesh(monkeypatch):
    """``test_runtime.py``'s 4-device mixed swarm on a virtual 4-way CPU
    mesh: params FSDP over the peer's data axis, a microbatch of 4 split
    over the 4 coordinates, a numeric peer a stage beside them, a peer
    killed: within 2e-4 of JAX's reference."""
    jcfg, tcfg = _configs(**BOTTLENECK)
    jprogs, jp = _jax_params(jcfg, "bottleneck")
    want = _jax_reference(jcfg, jprogs, jp, 4, 16, monkeypatch)
    r = _runner(tcfg, jp, "bottleneck", 4, 16)
    r.build(peers_per_stage=1)
    mesh = _cpu_mesh(4)
    for s in range(2):
        ex = MeshExecutor(tcfg, 2, SEQ, s, mesh, compress="bottleneck")
        assert ex.device_count == 4 and ex.dp_shards(4) == 4
        r.add_peer(s, executor=ex)
    r.apply_trace([TraceEvent(0.05, -1)])
    m = r.run(until=1e6)
    assert r.step == STEPS and m["failures"] == 1
    assert max(want) - min(want) > 1e-3           # params really move
    np.testing.assert_allclose(m["loss"], want, atol=TRAJ_ATOL, rtol=0)
    _assert_exactly_once(r, 2, 4)


# ------------------------------------------------------- mesh spans
def test_mesh_for_span_widths():
    _, tcfg = _configs()
    mex = MeshExecutor(tcfg, 2, SEQ, 0, _cpu_mesh(1))
    wide = mex.for_span(range(0, 2))
    assert isinstance(wide, MeshSpanExecutor) and wide.stages == range(0, 2)
    assert wide.for_span(range(0, 2)) is wide
    narrow = wide.for_span(range(1, 2))
    assert isinstance(narrow, MeshExecutor) and narrow.stage == 1
    assert mex.for_span(range(0, 1)) is mex
    assert wide.mesh is mex.mesh


def test_mesh_span_snapshot_interop_with_singles():
    """Per-stage snapshots cross MeshSpanExecutor <-> single-stage
    executors bit for bit, and the whole-state snapshot round-trips."""
    _, tcfg = _configs()
    num = build_numeric_executors(tcfg, 2, SEQ, device="cpu")
    mspan = MeshExecutor(tcfg, 2, SEQ, 0, _cpu_mesh(2)).for_span(range(0, 2))
    sts = [e.init_state(3 + i) for i, e in enumerate(num)]
    for st_ in sts:
        st_.opt = adamw().init(st_.params)
        st_.version = 5
    pst = mspan.init_state(4)
    for s in range(2):
        mspan.restore(pst, num[s].snapshot(sts[s]), stage=s)
    assert pst.stage_view(0).version == 5
    for s in range(2):
        st2 = num[s].init_state(9)
        num[s].restore(st2, mspan.snapshot(pst, stage=s))
        _leaves_equal(to_numpy_tree(st2.params), to_numpy_tree(sts[s].params))
        assert all(float(x.abs().max()) == 0.0
                   for x in tree_leaves(st2.grad_acc))
    pst2 = mspan.init_state(11)
    mspan.restore(pst2, mspan.snapshot(pst))
    for s in range(2):
        _leaves_equal(mspan.snapshot(pst2, stage=s)["params"],
                      to_numpy_tree(sts[s].params))


def test_mesh_span_in_mixed_swarm_equals_jax_reference(monkeypatch):
    """A 2-way MeshSpanExecutor peer on [0, 2) beside single-stage
    numeric peers, under the async tick: within 2e-4 of JAX's
    reference, the span peer accumulating under both stages, exactly
    once."""
    jcfg, tcfg = _configs()
    jprogs, jp = _jax_params(jcfg, "none")
    want = _jax_reference(jcfg, jprogs, jp, 2, 8, monkeypatch)
    r = _runner(tcfg, jp, "none", 2, 8, overlap=True)
    r.build(peers_per_stage=2)
    base = MeshExecutor(tcfg, 2, SEQ, 0, _cpu_mesh(2), compress="none")
    span_peer = r.add_peer(range(0, 2), executor=base.for_span(range(0, 2)))
    m = r.run(until=1e6)
    assert r.step == STEPS
    accs = {s for (k, _t, s, _i, _a, pid) in r.ledger_log
            if k == "acc" and pid == span_peer.id}
    assert accs == {0, 1}, accs
    np.testing.assert_allclose(m["loss"], want, atol=TRAJ_ATOL, rtol=0)
    _assert_exactly_once(r, 2, 4)


# ------------------------------------------------------- mesh peers stay
def test_moved_and_revived_mesh_peers_keep_their_mesh():
    """``SwarmRunner`` re-targets a mesh peer's own backend: a migrated
    mesh peer, a resized mesh span peer and a revived mesh peer are all
    still backed by their mesh (the runner's shared executors would make
    them one-device peers), and training still completes exactly
    once."""
    _, tcfg = _configs(n_layers=6)
    topt = adamw(lr=1e-2, grad_clip=0.0)
    r = SwarmRunner(tcfg, SwarmConfig(
        n_stages=3, microbatch_size=2, seq_len=SEQ, global_batch=8,
        n_trainers=2, rebalance_period=0.0, codec="none", max_steps=STEPS),
        topt, seed=0, data_fn=_batches(2), record_accumulation=True,
        device="cpu")
    r.build(peers_per_stage=1)
    mesh = _cpu_mesh(2)
    mover = r.add_peer(1, executor=MeshExecutor(tcfg, 3, SEQ, 1, mesh))
    span = r.add_peer(range(0, 2), executor=MeshSpanExecutor(
        tcfg, 3, SEQ, (0, 2), mesh))
    seen = {}

    def churn():
        yield Sleep(0.02)
        yield from r._migrate(mover, 2)
        seen["migrated"] = mover.executor
        yield from r._resize_span(span, range(0, 1))
        seen["resized"] = span.executor
        r._fail_peer(mover)
        yield from r._join_new_peer(span=range(1, 3))
        seen["revived"] = mover.executor
    r.sim.spawn(churn())
    m = r.run(until=1e6)
    assert r.step == STEPS and m["joins"] == 1
    for key, ex in seen.items():
        assert isinstance(ex, (MeshExecutor, MeshSpanExecutor)), key
        assert ex.mesh is mesh, key
    assert seen["migrated"].stages == range(2, 3)
    assert isinstance(seen["resized"], MeshExecutor)
    assert seen["resized"].stages == range(0, 1)
    assert isinstance(seen["revived"], MeshSpanExecutor)
    assert mover.alive and mover.stages == range(1, 3)
    _assert_exactly_once(r, 3, 4)
    assert all(np.isfinite(m["loss"]))


# ------------------------------------------------------- meshes
def test_meshes_never_shrink():
    """Asking for more devices than exist raises a ValueError naming
    both counts; nothing builds a smaller mesh or moves to the CPU."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"needs {n + 4} devices; {n} "
                                         "local CUDA devices"):
        make_peer_mesh(n + 4)
    with pytest.raises(ValueError, match="needs 256 devices; 8 devices"):
        make_production_mesh(devices=[CPU] * 8)
    with pytest.raises(ValueError, match="needs 8 devices; 4"):
        make_debug_mesh((2, 2, 2), ("pod", "data", "model"),
                        devices=[CPU] * 4)
    mesh = make_production_mesh(multi_pod=True, devices=[CPU] * 512)
    assert dict(mesh.shape) == {"pod": 2, "data": 16, "model": 16}


def test_placed_in_place_updates_refuse_shared_storage():
    """A placement of views (every shard on the source's device) may
    share storage; ``add_`` / ``zero_`` refuse it, while accumulators
    made shard by shard accept them."""
    mesh = make_debug_mesh((2, 2), devices=[CPU] * 4)
    x = torch.arange(32.).reshape(4, 8)
    p = place(x, mesh, ("data",))            # replicated over model
    with pytest.raises(ValueError, match="share storage"):
        p.zero_()
    acc = torch.zeros_like(p)
    acc.add_(place(x, mesh, ("data",)))
    torch.testing.assert_close(gather(acc, CPU), x, rtol=0, atol=0)
    torch.testing.assert_close(gather(p, CPU, rows=(1, 3)), x[1:3],
                               rtol=0, atol=0)
