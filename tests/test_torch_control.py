"""SWARM's control plane in the port against the JAX package: synthetic
preemption traces, the Alg. 2 migration planner, timing-only replays,
and numeric runs with rebalancing migration, global rollback and cold
resume.

Tolerances: traces, planner decisions and timing-only replays are exact
(the same numpy draws and the same virtual clock).  Numeric losses are
bit-equal to the port's own fault-free run (a round's gradients add in
f64, so neither a migration's recompute nor a rollback's replay moves a
bit) and within 2e-4 of JAX's fault-free sequential reference over the
steps run, the bound of ``tests/test_torch_train.py``, with JAX's
``wq``/``wk`` scaled by 0.3 for the reason given there.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.runtime as jrt
from conftest import reference_losses as j_reference_losses
from conftest import tiny_dense_config
from repro.core import SwarmConfig as JSwarmConfig
from repro.core import SwarmRunner as JSwarmRunner
from repro.core import faults as jfaults
from repro.core import rebalance as jrb
from repro.core.dht import DHT as JDHT
from repro.core.peer import Peer as JPeer
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.optim import adamw as j_adamw

from repro_torch.core import faults as tfaults
from repro_torch.core import rebalance as trb
from repro_torch.core.dht import DHT as TDHT
from repro_torch.core.peer import MBPS, DeviceProfile
from repro_torch.core.peer import Peer as TPeer
from repro_torch.core.sim import Sleep
from repro_torch.core.swarm import SwarmConfig, SwarmRunner
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import from_numpy_tree
from repro_torch.optim import adamw

SEQ, MB = 32, 2
TRAJ_ATOL = 2e-4
ATTN_SCALE = 0.3
# compute-bound peers, so queues build and Alg. 2 sees unequal loads
SLOW = DeviceProfile("slow", 1e8, 400 * MBPS, 400 * MBPS, 0.005)
SHARED = dict(share_groups=3, n_layers=6, boundary_compression="bottleneck",
              bottleneck_dim=16)


def _configs(**kw):
    jcfg = tiny_dense_config(**kw)
    return jcfg, ArchConfig(**{f.name: getattr(jcfg, f.name)
                               for f in dataclasses.fields(jcfg)})


# ------------------------------------------------------------ traces
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_synth_trace_matches_jax(seed):
    kw = dict(horizon_s=6 * 3600.0, target_peers=40,
              mean_lifetime_s=1800.0, seed=seed)
    got = tfaults.synth_preemptible_trace(**kw)
    want = jfaults.synth_preemptible_trace(**kw)
    assert len(got) > 10
    assert [dataclasses.astuple(e) for e in got] == \
        [dataclasses.astuple(e) for e in want]
    regions = ("us-a", "eu-b")
    assert [dataclasses.astuple(e) for e in tfaults.synth_preemptible_trace(
        **kw, regions=regions)] == [
        dataclasses.astuple(e) for e in jfaults.synth_preemptible_trace(
            **kw, regions=regions)]
    np.testing.assert_array_equal(
        tfaults.active_counts(got, 40, 6 * 3600.0),
        jfaults.active_counts(want, 40, 6 * 3600.0))
    assert tfaults.constant_pool(8, 100.0) == []


# ------------------------------------------------------------ planner
def _dhts(loads_per_stage):
    """The same load records in a DHT of each package."""
    class Clock:
        def __call__(self):
            return 0.0
    out, pps = [], {}
    for DHT in (JDHT, TDHT):
        dht = DHT(Clock())
        for s, loads in enumerate(loads_per_stage):
            pps[s] = []
            for i, q in enumerate(loads):
                pid = f"s{s}p{i}"
                dht.store(dht.load_key(s), pid, q, ttl=100)
                pps[s].append(pid)
        out.append(dht)
    return out[0], out[1], pps


@pytest.mark.parametrize("loads", [
    [[0.1, 0.2, 0.3], [9.0]],               # migrates s0p0 -> stage 1
    [[0.1], [9.0, 9.0]],                    # never empties a stage
    [[1.0, 1.0], [1.0, 1.0]],               # balanced: stays put
    [[0.1, 0.2, 0.3], [9.0, 8.0]],
    [[2.0, 0.5, 3.0], [0.1], [7.0, 1.0]],
])
def test_plan_migration_matches_jax(loads):
    jd, td, pps = _dhts(loads)
    n = len(loads)
    want = jrb.plan_migration(jd, n, pps)
    for src in (td, trb.ControlSnapshot.capture(td, n)):
        got = trb.plan_migration(src, n, pps)
        assert (None if got is None else dataclasses.astuple(got)) == \
            (None if want is None else dataclasses.astuple(want))
        assert trb.stage_loads(src, n) == jrb.stage_loads(jd, n)


def test_snapshot_is_frozen_and_checked():
    _, td, pps = _dhts([[0.1, 0.2, 0.3], [9.0]])
    snap = trb.ControlSnapshot.capture(td, 2)
    td.store(td.load_key(0), "s0p0", 99.0, ttl=100)     # late announce
    mig = trb.plan_migration(snap, 2, pps)
    assert mig is not None and mig.peer == "s0p0"       # pre-write view
    assert snap.queue_of("s0p1", 0) == 0.2
    assert snap.queue_of("nobody", 0, default=-1.0) == -1.0
    with pytest.raises(ValueError, match="snapshot"):
        trb.plan_migration(snap, 3, pps)


# ------------------------------------------------------------ timing only
def test_default_config_constructs_on_cpu():
    _, tcfg = _configs(n_layers=6)          # the default's 3 stages
    r = SwarmRunner(tcfg, SwarmConfig(), adamw(), device="cpu")
    assert r.scfg.rebalance_period == 300.0


@pytest.mark.parametrize("name", ["swarm-1b-bottleneck", "swarm-1b-maxout",
                                  "yi-6b"])
def test_param_counts_match_jax(name):
    """The throughput-mode All-Reduce prices 2 bytes per parameter of
    ``total_params``: the port counts the JAX package's specs (stage-
    stacked codec pairs of a declared pipeline included)."""
    from repro.configs import get_config as j_get_config
    from repro.models import flops as jflops
    from repro_torch.configs import get_config
    from repro_torch.models import flops as tflops
    jcfg, tcfg = j_get_config(name), get_config(name)
    assert tflops.total_params(tcfg) == jflops.total_params(jcfg)


ZONES = ("us-east", "eu-west", "ap-south")


@pytest.mark.parametrize("period,regions", [
    pytest.param(0.0, None, id="0.0"),
    pytest.param(60.0, None, id="60.0"),
    pytest.param(60.0, ZONES, id="60.0-zones")])
def test_timing_replay_matches_jax(period, regions, monkeypatch):
    """``tests/test_system.py``'s preemption replay, numeric=False: the
    same migrations, failures, joins, steps and throughput, exactly.
    With ``regions`` the trace is zone-tagged and ``region_fn`` places
    the initial peers round-robin over the zones, so every preemption
    may only take a peer of its own zone: the same peers die, and the
    survivors sit in the same zones, in both packages.  Peer names come
    from a per-process counter in each package, so both start at peer1
    whatever other tests of the process built."""
    jcfg, tcfg = _configs(n_layers=4, d_model=1024, d_ff=4096,
                          vocab_size=5000)
    kw = {} if regions is None else {
        "region_fn": lambda i: regions[i % len(regions)]}
    out = []
    for Runner, Config, cfg, opt, faults, peer_cls in (
            (JSwarmRunner, JSwarmConfig, jcfg, j_adamw(), jfaults, JPeer),
            (SwarmRunner, SwarmConfig, tcfg, adamw(), tfaults, TPeer)):
        monkeypatch.setattr(peer_cls, "_ids", 0)
        trace = faults.synth_preemptible_trace(
            horizon_s=1200.0, target_peers=16, mean_lifetime_s=900.0,
            seed=3, regions=regions)
        r = Runner(cfg, Config(n_stages=2, microbatch_size=1, seq_len=128,
                               global_batch=64, n_trainers=8,
                               rebalance_period=period, codec="int8"),
                   opt, numeric=False, seed=4, **kw)
        r.build(peers_per_stage=8)
        r.apply_trace(trace)
        m = r.run(until=1200.0)
        out.append((m["migrations"], m["failures"], m["joins"], r.step,
                    m["step_time"], r.throughput(), r.throughput(300.0),
                    m["peer_idle_s"],
                    sorted((pid, p.region, p.alive)
                           for pid, p in r.peers.items())))
    assert out[0] == out[1]
    if regions is not None:
        # the zone filter decided something: some peer outside the
        # first zone died, and the fleet still spans every zone
        peers = out[1][-1]
        assert {z for _, z, _ in peers} == set(regions)
        assert any(not alive and z != regions[0] for _, z, alive in peers)
    assert out[1][1] > 0 and out[1][2] > 0
    assert (out[1][0] > 0) == (period > 0)
    assert r.executors == [None, None] and r._ref_params is None


# ------------------------------------------------------------ numeric
def _jax_params(jcfg, n_stages):
    jprogs = jrt.build_stage_programs(jcfg, n_stages, SEQ,
                                      compress="bottleneck")
    jp = jrt.init_stage_params(jprogs, jax.random.PRNGKey(0))
    jp = jax.tree.map(np.array, jax.device_get(jp))
    for tree in jp:
        for blk in tree["blocks"]:
            for key in ("wq", "wk"):
                blk["attn"][key] = blk["attn"][key] * np.float32(ATTN_SCALE)
    return jprogs, jp


def _jax_reference(jcfg, jprogs, jp, steps, gb, monkeypatch):
    monkeypatch.setattr(jrt, "init_stage_params", lambda progs, key: [
        jax.tree.map(jnp.asarray, p) for p in jp])
    return j_reference_losses(jcfg, jprogs, j_adamw(lr=1e-2, grad_clip=0.0),
                              0, steps, SEQ, MB, gb)


def _data_fn():
    ds = JSyntheticLM(256, SEQ, MB, seed=17)
    return lambda i: {k: np.asarray(v) for k, v in ds.batch(i).items()}


def _port_runner(tcfg, jp, peers, gb, steps, **kw):
    """A port runner whose step-0 reference state is JAX's params (so
    cold starts, migrations and rollbacks all restore them)."""
    opt = adamw(lr=1e-2, grad_clip=0.0)
    r = SwarmRunner(tcfg, SwarmConfig(
        n_stages=3, microbatch_size=MB, seq_len=SEQ, global_batch=gb,
        codec="bottleneck", max_steps=steps, **kw), opt, seed=0,
        data_fn=_data_fn(), record_accumulation=True, device="cpu",
        profile_fn=lambda i: SLOW)
    r._ref_params = [from_numpy_tree(p, "cpu") for p in jp]
    r._ref_opt = [opt.init(p) for p in r._ref_params]
    r.build(peers)
    return r


def test_migration_run_equals_fault_free(monkeypatch):
    """A stage-1 peer migrates to stage 0 mid-round (Alg. 2, period 0.31
    s on compute-bound peers): its gradients are released and
    recomputed by survivors, every (stage, microbatch) is admitted once
    per round, and the losses equal the fault-free run's bit for bit and
    JAX's reference within TRAJ_ATOL."""
    from test_torch_train import _assert_exactly_once
    jcfg, tcfg = _configs(**SHARED)
    jprogs, jp = _jax_params(jcfg, 3)
    gb, steps = 16, 3
    base = _port_runner(tcfg, jp, [1, 2, 1], gb, steps, n_trainers=4,
                        rebalance_period=0.0)
    want = base.run(until=1e6)["loss"]
    r = _port_runner(tcfg, jp, [1, 2, 1], gb, steps, n_trainers=4,
                     rebalance_period=0.31)
    m = r.run(until=1e6)
    assert m["migrations"] >= 1
    assert any(e[0] == "rel" for e in r.ledger_log)
    assert m["recomputed_microbatches"] >= 1
    _assert_exactly_once(r, 3, gb // MB)
    assert sorted(len(r._covering(s)) for s in range(3)) == [1, 1, 2]
    np.testing.assert_array_equal(m["loss"], want)
    ref = _jax_reference(jcfg, jprogs, jp, steps, gb, monkeypatch)
    np.testing.assert_allclose(m["loss"], ref, atol=TRAJ_ATOL, rtol=0)


def _strand_stage_1(runner, at_step):
    """Sim process: once stage 1's only peer holds gradients of the round
    after ``at_step``, preempt it and warm-join a replacement (which
    finds no donor)."""
    while not runner.stopped:
        held = runner.ledger.stage_counts()[1]
        if runner.step == at_step and held > 0:
            victim = runner._covering(1)[0]
            runner._fail_peer(victim)
            yield from runner._join_new_peer(span=range(1, 2))
            return
        yield Sleep(0.01)


def test_rollback_and_cold_resume(tmp_path, monkeypatch):
    """ckpt_period 2, 4 steps: stage 1's only peer dies during step 4 and
    its replacement finds no donor, so the whole pipeline rolls back to
    the step-2 cut and replays; the losses equal the fault-free run's.
    A runner cold-started on the same directory resumes at step 4 and
    its step-5 loss equals the fault-free run's too."""
    jcfg, tcfg = _configs(**SHARED)
    jprogs, jp = _jax_params(jcfg, 3)
    gb = 8
    want = _port_runner(tcfg, jp, [1, 1, 1], gb, 5, n_trainers=2,
                        rebalance_period=0.0).run(until=1e6)["loss"]
    ckpt = str(tmp_path / "ckpt")
    r = _port_runner(tcfg, jp, [1, 1, 1], gb, 4, n_trainers=2,
                     rebalance_period=0.0, ckpt_dir=ckpt, ckpt_period=2)
    r.sim.spawn(_strand_stage_1(r, 3))
    m = r.run(until=1e6)
    assert m["failures"] == 1 and m["joins"] == 1
    assert m["rollbacks"] == [(3, 2)]
    assert (1, 2) in m["ckpt_restores"]
    assert r.step == 4 and r._common_ckpt_step() == 4
    assert not any(r.ledger.stage_counts())
    np.testing.assert_array_equal(m["loss"], want[:4])
    del r
    resumed = _port_runner(tcfg, jp, [1, 1, 1], gb, 5, n_trainers=2,
                           rebalance_period=0.0, ckpt_dir=ckpt,
                           ckpt_period=2)
    assert resumed._resume_step == 4 and resumed.step == 4
    assert sorted(resumed.metrics["ckpt_restores"]) == \
        [(0, 4), (1, 4), (2, 4)]
    got = resumed.run(until=1e6)["loss"]
    np.testing.assert_array_equal(got, want[4:])
    ref = _jax_reference(jcfg, jprogs, jp, 5, gb, monkeypatch)
    np.testing.assert_allclose(want, ref, atol=TRAJ_ATOL, rtol=0)
    shutil.rmtree(ckpt)
