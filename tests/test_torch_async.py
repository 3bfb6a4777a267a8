"""The port's async tick against the JAX package and its own synchronous
tick: in-flight boundary transfers, the executors' dispatch/collect
pair, the bounded-staleness All-Reduce and delayed parameter updates
(DPU), the counterpart of ``tests/test_async_overlap.py`` (its mesh
cases belong to the multi-GPU executors).  The DPU cases (staleness 1
against the sequential DPU reference and JAX's runner, the DPU wrapper,
churn under DPU and DPU state through checkpoints) are in
``tests/test_torch_async_dpu.py``, so that ``--dist loadfile`` spreads
the two halves over two workers.

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

import numpy as np
import pytest
import torch

from conftest import tiny_dense_config
from test_torch_train import _assert_exactly_once
from repro.core import SwarmConfig as JSwarmConfig
from repro.core import SwarmRunner as JSwarmRunner
from repro.core import faults as jfaults
from repro.core.peer import Peer as JPeer
from repro.optim import adamw as j_adamw

from repro_torch.core import faults as tfaults
from repro_torch.core.peer import MBPS, DeviceProfile
from repro_torch.core.peer import Peer as TPeer
from repro_torch.core.sim import Sleep
from repro_torch.core.swarm import SwarmConfig, SwarmRunner
from repro_torch.models.config import ArchConfig
from repro_torch.optim import adamw
from repro_torch.runtime import PipelineExecutor
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)   # as tests/test_torch_train.py explains

SEQ, MB, GB, STEPS = 32, 2, 8, 3
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


# ------------------------------------------------- resizes under the barrier
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
