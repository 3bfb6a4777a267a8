"""The port's async tick against the JAX package and its own synchronous
tick: in-flight boundary transfers, the executors' dispatch/collect
pair, the bounded-staleness All-Reduce and delayed parameter updates
(DPU), the counterpart of ``tests/test_async_overlap.py`` (its mesh
cases belong to the multi-GPU executors).

Tolerances: ``overlap=True, staleness=0`` only moves the virtual clock,
so its losses equal the blocking tick's float for float; a
``staleness=1`` run equals the port's sequential DPU reference float
for float (a round's gradients add in f64 slots, so neither arrival
order nor churn moves a bit); virtual-clock metrics and timing-only
replays equal JAX's exactly.  Against JAX's own ``staleness=1`` runner
on JAX's weights and batches the losses agree within 1e-5 (``wq``/``wk``
scaled by 0.3, as ``tests/test_torch_train.py`` explains); the DPU
wrapper agrees with JAX's within f32 rounding.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_dense_config
from test_torch_train import _assert_exactly_once, _jax_batches
from repro.ckpt import checkpoint as jck
from repro.core import SwarmConfig as JSwarmConfig
from repro.core import SwarmRunner as JSwarmRunner
from repro.core import faults as jfaults
from repro.core.peer import Peer as JPeer
import repro.runtime as jrt
from repro.optim import adamw as j_adamw, lamb as j_lamb
from repro.optim import delayed_parameter_updates as j_dpu

from repro_torch.ckpt import checkpoint as tck
from repro_torch.core import faults as tfaults
from repro_torch.core.faults import TraceEvent
from repro_torch.core.peer import MBPS, DeviceProfile
from repro_torch.core.peer import Peer as TPeer
from repro_torch.core.sim import Sleep
from repro_torch.core.swarm import SwarmConfig, SwarmRunner
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import from_numpy_tree, to_numpy_tree
from repro_torch.optim import adamw, lamb, delayed_parameter_updates
from repro_torch.runtime import PipelineExecutor
from repro_torch.train.reference import reference_losses
from repro_torch.tree import tree_leaves, tree_map

SEQ, MB, GB, STEPS = 32, 2, 8, 3
JAX_ATOL = 1e-5
ATTN_SCALE = 0.3
BACKENDS = ("numeric", "span")
BOTTLENECK = dict(boundary_compression="bottleneck", bottleneck_dim=16)


def _configs(**kw):
    jcfg = tiny_dense_config(**kw)
    return jcfg, ArchConfig(**{f.name: getattr(jcfg, f.name)
                               for f in dataclasses.fields(jcfg)})


def _scfg(Config=SwarmConfig, **kw):
    # one trainer: deterministic routing, so sync and async runs see the
    # same (peer, sample) schedule
    base = dict(n_stages=2, microbatch_size=MB, seq_len=SEQ,
                global_batch=GB, n_trainers=1, rebalance_period=0.0,
                codec="none", max_steps=STEPS)
    base.update(kw)
    return Config(**base)


def _build(r, backend):
    if backend == "numeric":
        r.build(peers_per_stage=1)
    else:                          # one span peer over the whole pipe
        r.add_peer(range(0, 2))
        r.build(peers_per_stage=0)


def _run(backend, seed, **kw):
    _, tcfg = _configs()
    r = SwarmRunner(tcfg, _scfg(**kw), adamw(lr=1e-2, grad_clip=0.0),
                    seed=seed, device="cpu")
    _build(r, backend)
    m = r.run(until=1e6)
    assert r.step == STEPS
    return r, m


def _opt():
    return adamw(lr=1e-2, grad_clip=0.0)


# ------------------------------------------------- delay 0: float for float
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("backend", BACKENDS)
def test_overlap_delay0_equals_sync(backend, seed):
    """overlap=True, staleness=0 reorders only the virtual clock: the
    losses are the blocking tick's, float for float, and the run ends no
    later on the virtual clock."""
    rs, sync = _run(backend, seed)
    ra, asy = _run(backend, seed, overlap=True)
    assert asy["loss"] == sync["loss"]
    assert asy["inflight_bytes"] > 0
    assert asy["overlap_fraction"] >= 0
    if backend == "numeric":       # two peers: an edge to hide
        assert asy["overlap_fraction"] > 0
    assert all(v >= 0.0 for v in asy["peer_idle_s"].values())
    assert ra._t_stopped <= rs._t_stopped + 1e-9
    assert sync["overlap_fraction"] == 0.0 and sync["inflight_bytes"] == 0


@pytest.mark.parametrize("staleness", [0, 1])
@pytest.mark.parametrize("backend", BACKENDS)
def test_overlap_clock_matches_jax_runner(backend, staleness, monkeypatch):
    """The virtual clock of a numeric overlap run is JAX's exactly:
    in-flight bytes, the serial and in-flight wire seconds, the overlap
    fraction, per-peer idle seconds, step times and the stop instant."""
    jcfg, tcfg = _configs()
    out = []
    for Runner, Config, cfg, opt, peer_cls, kw in (
            (JSwarmRunner, JSwarmConfig, jcfg,
             j_adamw(lr=1e-2, grad_clip=0.0), JPeer, {}),
            (SwarmRunner, SwarmConfig, tcfg, _opt(), TPeer,
             {"device": "cpu"})):
        monkeypatch.setattr(peer_cls, "_ids", 0)
        r = Runner(cfg, _scfg(Config, overlap=True, staleness=staleness),
                   opt, numeric=True, seed=0, **kw)
        _build(r, backend)
        m = r.run(until=1e6)
        out.append((m["inflight_bytes"], m["wire_serial_s"],
                    m["wire_inflight_s"], m["overlap_fraction"],
                    m["peer_idle_s"], m["step_time"], r._t_stopped,
                    m["wire_bytes"], r.step))
    assert out[0] == out[1]


def test_count_inflight_wire_clamps_per_edge():
    """A wait past the serial estimate (FIFO queueing on a shared link)
    counts as the serial cost, not as negative overlap."""
    _, tcfg = _configs()
    r = SwarmRunner(tcfg, _scfg(), _opt(), numeric=False)
    r.count_inflight_wire(2.0, 0.5, 10.0)
    r.count_inflight_wire(1.0, 3.0, 6.0)
    assert (r.metrics["wire_serial_s"], r.metrics["wire_inflight_s"],
            r.metrics["inflight_bytes"]) == (3.0, 1.5, 16.0)


# ------------------------------------------------- delay 1: DPU
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("overlap", [True, False])
def test_staleness1_equals_sequential_dpu_reference(overlap, seed):
    """A staleness=1 runner wraps its optimizer in DPU itself; its losses
    equal the staged reference driven by an explicitly DPU-wrapped
    optimizer, float for float."""
    r, m = _run("numeric", seed, overlap=overlap, staleness=1)
    ref = reference_losses(r.cfg, r.programs,
                           delayed_parameter_updates(_opt(), 1), seed,
                           STEPS, SEQ, MB, GB, device="cpu")
    assert m["loss"] == ref
    # the first step applies no update: step 2's loss is taken on the
    # step-0 parameters, unlike the synchronous run's
    _, sync = _run("numeric", seed)
    assert m["loss"][0] == sync["loss"][0]
    assert m["loss"][1] != sync["loss"][1]


def _jax_params(jcfg, n_stages=2):
    jprogs = jrt.build_stage_programs(jcfg, n_stages, SEQ, compress="none")
    jp = jax.tree.map(np.array, jax.device_get(jrt.init_stage_params(
        jprogs, jax.random.PRNGKey(0))))
    for tree in jp:
        for blk in tree["blocks"]:
            for key in ("wq", "wk"):
                blk["attn"][key] = blk["attn"][key] * np.float32(ATTN_SCALE)
    return jprogs, jp


@pytest.mark.parametrize("overlap", [True, False])
def test_staleness1_matches_jax_runner(overlap):
    """JAX's staleness=1 runner and the port's, on JAX's weights and
    batches: the same losses within 1e-5."""
    jcfg, tcfg = _configs()
    jprogs, jp = _jax_params(jcfg)
    data_fn = _jax_batches()
    jr = JSwarmRunner(jcfg, _scfg(JSwarmConfig, overlap=overlap,
                                  staleness=1),
                      j_adamw(lr=1e-2, grad_clip=0.0), numeric=True,
                      seed=0, programs=jprogs, data_fn=data_fn)
    jr._ref_params = [jax.tree.map(jnp.asarray, p) for p in jp]
    jr.build(peers_per_stage=1)
    want = jr.run(until=1e6)["loss"]
    r = SwarmRunner(tcfg, _scfg(overlap=overlap, staleness=1), _opt(),
                    seed=0, data_fn=data_fn, device="cpu")
    r.build(peers_per_stage=1)
    jopt = j_dpu(j_adamw(lr=1e-2, grad_clip=0.0), delay=1)
    for p in r.peers.values():
        p.executor.restore(p.state, {
            "params": jp[p.stage],
            "opt": jax.device_get(jopt.init(jax.tree.map(jnp.asarray,
                                                         jp[p.stage]))),
            "version": 0})
    got = r.run(until=1e6)["loss"]
    assert r.step == STEPS and len(got) == STEPS
    np.testing.assert_allclose(got, want, atol=JAX_ATOL, rtol=0)


def test_dpu_flag_implies_staleness():
    assert _scfg(dpu=True).staleness == 1
    assert _scfg(dpu=True, staleness=2).staleness == 2
    with pytest.raises(ValueError):
        _scfg(staleness=-1)


@pytest.mark.parametrize("kw", [dict(overlap=True), dict(staleness=1),
                                dict(dpu=True)])
def test_async_knobs_build_and_train(kw):
    """Each async knob builds a runner and trains it; staleness > 0 (or
    dpu) wraps the optimizer in DPU, whose state the peers hold."""
    r, m = _run("numeric", 0, **kw)
    assert len(m["loss"]) == STEPS and np.isfinite(m["loss"]).all()
    assert r.overlap == bool(kw.get("overlap"))
    dpu = r.scfg.staleness > 0
    for p in r.peers.values():
        opt = p.state.opt
        assert ("have_banked" in opt) == dpu
        if dpu:
            assert opt["have_banked"].dtype == torch.bool
            assert bool(opt["have_banked"])
            assert int(opt["inner"]["count"]) == STEPS - 1


# ------------------------------------------------- DPU vs JAX
@pytest.mark.parametrize("inner", ["adamw", "lamb"])
@pytest.mark.parametrize("delay", [0, 1])
def test_dpu_matches_jax(delay, inner):
    """Four updates of ``delayed_parameter_updates`` on the same numpy
    params and gradients: updates and state leaves equal JAX's within
    f32 rounding (the 0-d bool flag and the step count exactly)."""
    rng = np.random.default_rng(delay)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    make = {"adamw": (j_adamw, adamw), "lamb": (j_lamb, lamb)}[inner]
    jopt = j_dpu(make[0](lr=1e-2), delay)
    topt = delayed_parameter_updates(make[1](lr=1e-2), delay)
    jp = jax.tree.map(jnp.asarray, params)
    tp = from_numpy_tree(params, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(4):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(from_numpy_tree(g, "cpu"), ts, tp)
        for a, b in zip(tree_leaves(to_numpy_tree(tu)),
                        jax.tree.leaves(jax.device_get(ju))):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
        tl = tree_leaves(to_numpy_tree(ts))
        jl = jax.tree.leaves(jax.device_get(js))
        assert len(tl) == len(jl)
        for a, b in zip(tl, jl):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tp = tree_map(lambda p, u: p + u, tp, tu)
    if delay:
        assert ts["have_banked"].dtype == torch.bool and \
            ts["have_banked"].shape == ()


def test_dpu_first_step_keeps_inner_state():
    """Step 1 under DPU: a zero update, the inner state (moments, step
    count) unchanged, the gradients banked in f32."""
    tp = {"w": torch.randn(5, 2)}
    opt = delayed_parameter_updates(adamw(lr=1e-2), 1)
    st = opt.init(tp)
    g = {"w": torch.randn(5, 2)}
    upd, st1 = opt.update(g, st, tp)
    assert torch.equal(upd["w"], torch.zeros(5, 2))
    assert int(st1["inner"]["count"]) == 0
    assert torch.equal(st1["inner"]["m"]["w"], st["inner"]["m"]["w"])
    assert torch.equal(st1["banked"]["w"], g["w"])
    assert bool(st1["have_banked"]) and not bool(st["have_banked"])
    assert delayed_parameter_updates(opt, 0) is opt


# ------------------------------------------------- churn under the async tick
def _force_migration(runner, at):
    """Sim process: migrate one peer out of a stage with more than one
    serving peer (the JAX package's ``tests/test_churn.py`` helper)."""
    yield Sleep(at)
    if runner.stopped:
        return
    for s in range(runner.n_stages):
        group = sorted((p for p in runner.peers.values()
                        if p.alive and p.serving and p.stage == s),
                       key=lambda p: p.id)
        if len(group) > 1:
            yield from runner._migrate(group[0], (s + 1) % runner.n_stages)
            return


@pytest.mark.parametrize("seed", [0, 1])
def test_async_churn_equals_dpu_reference(seed):
    """``tests/test_async_overlap.py``'s churn trace (two failures, a
    warm join, a forced migration) on an overlapped staleness=1 swarm:
    each (stage, microbatch) admitted exactly once per round, and the
    losses equal the fault-free sequential DPU reference float for
    float."""
    _, tcfg = _configs()
    r = SwarmRunner(tcfg, _scfg(n_trainers=3, overlap=True, staleness=1),
                    _opt(), seed=seed, record_accumulation=True,
                    device="cpu")
    r.build(peers_per_stage=3)
    r.apply_trace([TraceEvent(0.01 + 0.01 * seed, -1),
                   TraceEvent(0.05, -1), TraceEvent(0.22, +1)])
    r.sim.spawn(_force_migration(r, at=0.12))
    m = r.run(until=1e6)
    assert r.step == STEPS
    assert m["failures"] == 2 and m["joins"] == 1
    ref = reference_losses(tcfg, r.programs,
                           delayed_parameter_updates(_opt(), 1), seed,
                           STEPS, SEQ, MB, GB, device="cpu")
    assert m["loss"] == ref
    _assert_exactly_once(r, 2, GB // MB)


def test_resize_under_the_async_barrier_catches_up():
    """The bounded-staleness barrier installs its step at the barrier
    instant into serving peers only, so a stage a peer keeps across a
    resize whose download outlasts a step is still re-adopted once
    before the peer serves: the losses equal the fault-free async run's
    to the bit."""
    _, tcfg = _configs(**BOTTLENECK)
    slow = DeviceProfile("slow", 1e8, 400 * MBPS, 400 * MBPS, 0.005)
    thin = dataclasses.replace(slow, name="thin", down_bw=4 * MBPS)

    def run(grow: bool):
        r = SwarmRunner(tcfg, _scfg(codec="bottleneck", n_trainers=3,
                                    max_steps=4, overlap=True, staleness=1),
                        _opt(), seed=0, device="cpu",
                        profile_fn=lambda i: thin if i == 2 else slow)
        r.build([1, 2])
        log = []

        def script():
            yield Sleep(0.5)
            C = [p for p in r.peers.values() if p.stages == range(1, 2)][-1]
            before = r.step
            yield from r.merge_spans(C, range(0, 2))
            log.append((before, r.step, C.stages, sorted(
                q.state.stage_view(1).version for q in r._covering(1))))
        if grow:
            r.sim.spawn(script())
        m = r.run(until=1e6)
        assert r.step == 4
        return m, log

    base, _ = run(False)
    grown, log = run(True)
    (before, after, span, versions), = log
    assert after > before and span == range(0, 2)   # a step landed
    assert len(set(versions)) == 1 and grown["span_changes"] == 1
    assert grown["loss"] == base["loss"]


# ------------------------------------------------- timing-only replays
def _replay(Runner, Config, cfg, opt, faults, period, overlap, staleness,
            **kw):
    trace = faults.synth_preemptible_trace(
        horizon_s=600.0, target_peers=16, mean_lifetime_s=900.0, seed=3)
    r = Runner(cfg, Config(n_stages=2, microbatch_size=1, seq_len=128,
                           global_batch=64, n_trainers=8,
                           rebalance_period=period, codec="int8",
                           overlap=overlap, staleness=staleness),
               opt, numeric=False, seed=4, **kw)
    r.build(peers_per_stage=8)
    r.apply_trace(trace)
    return r, r.run(until=600.0)


REPLAY_CFG = dict(n_layers=4, d_model=1024, d_ff=4096, vocab_size=5000)


@pytest.mark.parametrize("period,overlap,staleness", [
    (0.0, True, 1), (0.0, True, 0), (0.0, False, 1), (60.0, True, 0)])
def test_timing_replay_async_matches_jax(period, overlap, staleness,
                                         monkeypatch):
    """A timing-only preemption replay (``numeric=False``) under the
    async tick: the virtual clock, step times, the three wire metrics,
    per-peer idle seconds, steps, migrations, failures and joins equal
    JAX's exactly.  Peer names restart in both packages."""
    jcfg, tcfg = _configs(**REPLAY_CFG)
    out = []
    for Runner, Config, cfg, opt, faults, peer_cls in (
            (JSwarmRunner, JSwarmConfig, jcfg, j_adamw(), jfaults, JPeer),
            (SwarmRunner, SwarmConfig, tcfg, adamw(), tfaults, TPeer)):
        monkeypatch.setattr(peer_cls, "_ids", 0)
        r, m = _replay(Runner, Config, cfg, opt, faults, period, overlap,
                       staleness)
        out.append((r.sim.now, m["step_time"], m["wire_serial_s"],
                    m["wire_inflight_s"], m["inflight_bytes"],
                    m["overlap_fraction"], m["peer_idle_s"], r.step,
                    m["migrations"], m["failures"], m["joins"],
                    r.throughput()))
    assert out[0] == out[1]
    assert out[1][7] > 0 and out[1][9] > 0
    assert (out[1][4] > 0) == overlap
    assert (out[1][8] > 0) == (period > 0)


@pytest.mark.parametrize("overlap", [True, False])
def test_async_barrier_rechecks_the_round_after_a_window(overlap,
                                                         monkeypatch):
    """The replay above with Alg. 2 every 60 s and staleness=1: an
    All-Reduce window is still open when a round completes, and while
    the barrier waits on it a migration releases ledger rows whose
    recomputes go in flight.  The port re-checks the barrier after the
    wait, so every step averages the complete round, exactly once; the
    JAX package steps on the incomplete round and then fails on the
    stale recomputes' settles (a KeyError in its ledger)."""
    jcfg, tcfg = _configs(**REPLAY_CFG)
    monkeypatch.setattr(JPeer, "_ids", 0)
    with pytest.raises(KeyError):
        _replay(JSwarmRunner, JSwarmConfig, jcfg, j_adamw(), jfaults,
                60.0, overlap, 1)
    monkeypatch.setattr(TPeer, "_ids", 0)
    r, m = _replay(SwarmRunner, SwarmConfig, tcfg, adamw(), tfaults, 60.0,
                   overlap, 1, record_accumulation=True)
    assert r.step > 20 and m["migrations"] > 0 and m["failures"] > 0
    _assert_exactly_once(r, 2, 64)


# ------------------------------------------------- executors
@pytest.mark.parametrize("backend", BACKENDS)
def test_dispatch_collect_equals_run_on_cpu(backend):
    """``dispatch_fwd``/``dispatch_bwd`` then collect give ``run_fwd`` /
    ``run_bwd``'s values to the bit; on the CPU collect holds no
    event."""
    _, tcfg = _configs()
    r = SwarmRunner(tcfg, _scfg(), _opt(), seed=0, device="cpu")
    _build(r, backend)
    peers = sorted(r.peers.values(), key=lambda p: p.stage)
    b = r.next_microbatch()
    x, labels, outs = b.tokens, b.labels, []
    for p in peers:
        last = p.stages.stop == 2
        lab = labels if last else None
        collect = p.executor.dispatch_fwd(p.state, x, lab)
        assert not hasattr(collect, "event")
        y = collect()
        torch.testing.assert_close(y, p.executor.run_fwd(p.state, x, lab),
                                   rtol=0, atol=0)
        outs.append((p, x))
        x = y
    dy = None
    for p, inp in reversed(outs):
        last = p.stages.stop == 2
        kw = {"labels": labels} if last else {"dy": dy}
        got = p.executor.dispatch_bwd(p.state, inp, **kw)()
        want = p.executor.run_bwd(p.state, inp, **kw)
        for a, w in zip(tree_leaves(got), tree_leaves(want)):
            torch.testing.assert_close(a, w, rtol=0, atol=0)
        if backend == "span":
            assert sorted(got[2]) == [0, 1]   # keyed by global stage
        dy = got[1]
    assert isinstance(peers[0].executor, PipelineExecutor) == \
        (backend == "span")


@pytest.mark.parametrize("staleness", [0, 1])
def test_barrier_install_order(staleness):
    """The blocking barrier computes every stage's step before its first
    All-Reduce sleep, then installs each after its ring's time; the
    bounded-staleness barrier sleeps nothing, so it installs each stage
    before computing the next (one stage's old and new state alive
    together)."""
    _, tcfg = _configs()
    r = SwarmRunner(tcfg, _scfg(staleness=staleness, max_steps=1), _opt(),
                    seed=0, device="cpu")
    _build(r, "numeric")
    log, opt = [], r.optimizer

    def update(g, state, params):
        log.append("update")
        return opt.update(g, state, params)
    r.optimizer = dataclasses.replace(opt, update=update)
    for p in r.peers.values():
        def adopt(*a, _adopt=p.executor.adopt_step, _s=p.stage, **k):
            log.append(f"adopt{_s}")
            return _adopt(*a, **k)
        p.executor.adopt_step = adopt
    r.run(until=1e6)
    assert r.step == 1
    want = (["update", "update", "adopt0", "adopt1"] if staleness == 0
            else ["update", "adopt0", "update", "adopt1"])
    assert log == want


# ------------------------------------------------- checkpoints
CKPT_KW = dict(n_stages=2, microbatch_size=2, seq_len=16, global_batch=4,
               n_trainers=1, rebalance_period=0.0, codec="bottleneck",
               max_steps=2, staleness=1)


def test_dpu_state_checkpoints_cross_between_packages(tmp_path):
    """A staleness=1 run's cut holds DPU's nested ``inner`` / ``banked``
    / ``have_banked`` tree with its 0-d bool leaf: written by the port it
    restores in the JAX package, and the other way round, leaf for leaf
    (paths, dtypes, shapes, bits); the restored tree installs into a
    port peer with the bool leaf a 0-d ``torch.bool``."""
    jcfg, tcfg = _configs(**BOTTLENECK)
    jr = JSwarmRunner(jcfg, JSwarmConfig(**CKPT_KW), j_adamw(), seed=0)
    jr.build(peers_per_stage=1)
    jr.run(until=1e6)
    tr = SwarmRunner(tcfg, SwarmConfig(**CKPT_KW), adamw(), seed=0,
                     device="cpu")
    tr.build(peers_per_stage=1)
    tr.run(until=1e6)
    jpeers = sorted(jr.peers.values(), key=lambda p: p.stage)
    tpeers = sorted(tr.peers.values(), key=lambda p: p.stage)
    for s, (jp_, tp_) in enumerate(zip(jpeers, tpeers)):
        js = jax.device_get(jp_.executor.snapshot(jp_.state))
        ts = tp_.executor.snapshot(tp_.state)
        assert ts["opt"]["have_banked"].dtype == np.bool_
        assert ts["opt"]["have_banked"].shape == ()
        jdir, tdir = str(tmp_path / f"j{s}"), str(tmp_path / f"t{s}")
        jck.save_checkpoint(jdir, 2, js)
        tck.save_checkpoint(tdir, 2, ts)
        got, _ = tck.restore_checkpoint(jdir, like=ts)
        back, _ = jck.restore_checkpoint(tdir, like=js)
        for a, b in ((got, js), (jax.device_get(back), ts)):
            pa, la = tck._flatten_with_paths(a)
            pb, lb = tck._flatten_with_paths(b)
            assert pa == pb
            for path, x, y in zip(pa, la, lb):
                x, y = np.asarray(x), np.asarray(y)
                assert x.shape == y.shape, path
                if path != "version":
                    assert x.dtype == y.dtype, path
                np.testing.assert_array_equal(x, y, err_msg=path)
        tp_.executor.restore(tp_.state, got)
        flag = tp_.state.opt["have_banked"]
        assert flag.dtype == torch.bool and flag.shape == () and bool(flag)
