"""Span peers in the port against the JAX package: fused span programs,
``PipelineExecutor`` training, span splits and merges, Alg. 2's span
resizes, and region-priced links; one counterpart per case of
``tests/test_span_runtime.py``, plus the planners and the link model.

A span peer runs stages ``[lo, hi)`` through one fused program.  The
property the slice rests on: a fused span gives every covered stage the
gradient the chain of single-stage programs gives it, bit for bit on one
device (``test_port_span_equals_port_chain_to_the_bit``).

Tolerances: against JAX, span-program gradients at 1e-5 of each leaf's
largest entry and the loss at 1e-6 relative (f32); trajectories within
2e-4 of JAX's sequential reference (the bound of JAX's own span tests);
planners, link prices and timing-only replays exactly.  JAX's ``wq`` and
``wk`` are scaled by 0.3, for the reason ``tests/test_torch_train.py``
gives.  Port runs against port runs are equal to the bit: a round's
gradients add in f64, so neither the peers' split nor the fusion moves a
bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.runtime as jrt
from conftest import reference_losses as j_reference_losses
from repro.compression.quant8 import _roundtrip as j_roundtrip
from repro.core import SwarmConfig as JSwarmConfig
from repro.core import SwarmRunner as JSwarmRunner
from repro.core import faults as jfaults
from repro.core import rebalance as jrb
from repro.core import square_cube as jsc
from repro.core.peer import DeviceProfile as JDeviceProfile
from repro.core.peer import Peer as JPeer
from repro.models.stage_plan import get_stage_plan as j_get_stage_plan
from repro.optim import adamw as j_adamw

from repro_torch.core import faults as tfaults
from repro_torch.core import rebalance as trb
from repro_torch.core import square_cube as tsc
from repro_torch.core.faults import TraceEvent
from repro_torch.core.ledger import MicrobatchLedger
from repro_torch.core.peer import MBPS, DeviceProfile
from repro_torch.core.peer import Peer as TPeer
from repro_torch.core.sim import Sleep
from repro_torch.core.swarm import SwarmConfig, SwarmRunner
from repro_torch.core.trainer import Microbatch
from repro_torch.models.params import from_numpy_tree, to_numpy_tree
from repro_torch.models.stage_plan import get_stage_plan
from repro_torch.optim import adamw
from repro_torch.runtime import (PipelineExecutor, StageExecutor,
                                 build_numeric_executors,
                                 build_span_program, build_stage_programs,
                                 compile_stats, get_span_program,
                                 reset_compile_stats)
from repro_torch.tree import tree_leaves
from test_torch_train import GRAD_RTOL, TRAJ_ATOL, _assert_exactly_once, \
    _close_rel, _configs, _jax_batches, _scaled

torch.set_num_threads(1)   # as tests/test_torch_train.py explains

SEQ, MB, GB, STEPS = 32, 2, 8, 3
BOTTLENECK = dict(boundary_compression="bottleneck", bottleneck_dim=16)
# three stages of one ALBERT-shared layer applied twice (swarm-1b's
# structure at tiny width)
SHARED3 = dict(BOTTLENECK, share_groups=3, n_layers=6)


def _opts():
    return j_adamw(lr=1e-2, grad_clip=0.0), adamw(lr=1e-2, grad_clip=0.0)


def _jax_params(jcfg, n_stages, codec="bottleneck"):
    jprogs = jrt.build_stage_programs(jcfg, n_stages, SEQ, compress=codec)
    jp = [_scaled(p) for p in jrt.init_stage_params(
        jprogs, jax.random.PRNGKey(0))]
    return jprogs, jp


def _jax_reference(jcfg, jprogs, jp, monkeypatch):
    monkeypatch.setattr(jrt, "init_stage_params", lambda progs, key: [
        jax.tree.map(jnp.asarray, p) for p in jp])
    return j_reference_losses(jcfg, jprogs, _opts()[0], 0, STEPS, SEQ, MB,
                              GB)


def _port_runner(tcfg, jp, n_stages, **kw):
    """A port runner (trainers not built yet) whose step-0 reference
    state is JAX's params, so every peer, joiner and split half
    installs them."""
    topt = _opts()[1]
    r = SwarmRunner(tcfg, SwarmConfig(
        n_stages=n_stages, microbatch_size=MB, seq_len=SEQ,
        global_batch=GB, n_trainers=3, rebalance_period=0.0,
        codec="bottleneck", max_steps=STEPS, **kw), topt, seed=0,
        data_fn=_jax_batches(), record_accumulation=True, device="cpu")
    r._ref_params = [from_numpy_tree(p, "cpu") for p in jp]
    r._ref_opt = [topt.init(p) for p in r._ref_params]
    return r


def _span_peer(runner, lo, hi):
    return runner.add_peer(range(lo, hi), executor=PipelineExecutor(
        runner.cfg, runner.n_stages, SEQ, (lo, hi), compress="bottleneck",
        device="cpu"))


# ------------------------------------------------------- span programs
def _chain_inputs(tprogs, tp, b):
    """The single-stage chain's boundary inputs and its backward: (xs,
    per-stage input cotangents gxs, per-stage grads gps, loss)."""
    S = len(tprogs)
    xs = [torch.as_tensor(b["tokens"])]
    for s in range(S - 1):
        xs.append(tprogs[s].fwd(tp[s], xs[-1]))
    labels = torch.as_tensor(b["labels"])
    loss, gx, gp = tprogs[S - 1].bwd(tp[S - 1], xs[-1], labels)
    gxs, gps = {S - 1: gx}, {S - 1: gp}
    for s in range(S - 2, -1, -1):
        gx, gps[s] = tprogs[s].bwd(tp[s], xs[s], gx)
        gxs[s] = gx
    return xs, gxs, gps, loss


SPANS3 = [(0, 2), (1, 3), (0, 3)]


@pytest.mark.parametrize("kw", [SHARED3, dict(BOTTLENECK, n_layers=6),
                                dict(SHARED3, wire_quant=True)],
                         ids=["shared", "dense", "shared-wq"])
def test_port_span_equals_port_chain_to_the_bit(kw):
    """A fused span's fwd output or loss, its inbound cotangent and every
    covered stage's gradients equal the chain of single-stage programs'
    to the bit (rtol=0, atol=0), for spans [0,2), [1,3), [0,3) of 3
    stages."""
    _, tcfg = _configs(**kw)
    tprogs = build_stage_programs(tcfg, 3, SEQ, "bottleneck")
    tp = [from_numpy_tree(p, "cpu") for p in _jax_params(
        _configs(**kw)[0], 3)[1]]
    b = _jax_batches()(0)
    xs, gxs, gps, loss = _chain_inputs(tprogs, tp, b)
    labels = torch.as_tensor(b["labels"])
    for lo, hi in SPANS3:
        prog = build_span_program(tcfg, 3, SEQ, (lo, hi), "bottleneck")
        ps = tuple(tp[lo:hi])
        if hi == 3:
            torch.testing.assert_close(prog.fwd(ps, xs[lo], labels), loss,
                                       rtol=0, atol=0)
            got_loss, gx, got = prog.bwd(ps, xs[lo], labels)
            torch.testing.assert_close(got_loss, loss, rtol=0, atol=0)
        else:
            torch.testing.assert_close(prog.fwd(ps, xs[lo]), xs[hi],
                                       rtol=0, atol=0)
            gx, got = prog.bwd(ps, xs[lo], gxs[hi])
        if lo == 0:
            assert gx is None
        else:
            torch.testing.assert_close(gx, gxs[lo], rtol=0, atol=0)
        assert len(got) == hi - lo
        for s, g in zip(range(lo, hi), got):
            for a, c in zip(tree_leaves(g), tree_leaves(gps[s])):
                torch.testing.assert_close(a, c, rtol=0, atol=0)


@pytest.mark.parametrize("span", SPANS3, ids=str)
def test_span_program_matches_jax_per_leaf(span):
    """The port's ``SpanProgram`` against JAX's ``get_span_program`` on
    JAX's weights, batch and cotangent: per-leaf gradients at 1e-5, the
    loss at 1e-6 relative."""
    jcfg, tcfg = _configs(**SHARED3)
    jprogs, jp = _jax_params(jcfg, 3)
    lo, hi = span
    b = _jax_batches()(0)
    jx = [jnp.asarray(b["tokens"])]
    for s in range(2):
        jx.append(jprogs[s].fwd(jp[s], jx[-1]))
    jspan = jrt.get_span_program(jcfg, 3, SEQ, span, "bottleneck")
    tspan = get_span_program(tcfg, 3, SEQ, span, "bottleneck")
    assert tspan.span == span and list(tspan.stages) == list(range(lo, hi))
    assert tspan.fwd_flops_per_token == jspan.fwd_flops_per_token
    jps = tuple(jax.tree.map(jnp.asarray, p) for p in jp[lo:hi])
    tps = tuple(from_numpy_tree(p, "cpu") for p in jp[lo:hi])
    tin = torch.as_tensor(np.asarray(jx[lo]))
    if hi == 3:
        jlabels = jnp.asarray(b["labels"])
        jl, jgx, jg = jspan.bwd(jps, jx[lo], jlabels)
        tl, tgx, tg = tspan.bwd(tps, tin, torch.as_tensor(b["labels"]))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        np.testing.assert_allclose(
            float(tspan.fwd(tps, tin, torch.as_tensor(b["labels"]))),
            float(jspan.fwd(jps, jx[lo], jlabels)), rtol=1e-6)
    else:
        rng = np.random.default_rng(2)
        dy = rng.standard_normal(np.shape(jx[hi])).astype(np.float32)
        _close_rel(tspan.fwd(tps, tin).numpy(),
                   np.asarray(jspan.fwd(jps, jx[lo])))
        jgx, jg = jspan.bwd(jps, jx[lo], jnp.asarray(dy))
        tgx, tg = tspan.bwd(tps, tin, torch.from_numpy(dy))
    if lo == 0:
        assert tgx is None and jgx is None
    else:
        _close_rel(tgx.numpy(), jgx)
    for j, t in zip(jg, tg):
        for a, c in zip(jax.tree.leaves(jax.device_get(j)),
                        tree_leaves(to_numpy_tree(t))):
            _close_rel(c, a, GRAD_RTOL)


def test_encoder_decoder_span_still_raises():
    """Encoder-decoder span programs build (the whisper slice), and
    still raise under a learned boundary codec, as the JAX package's
    refuse it (tree-valued boundaries)."""
    _, tcfg = _configs(encoder_layers=2, n_layers=4)
    prog = build_span_program(tcfg, 3, SEQ, (1, 3))
    assert prog.span == (1, 3) and set(prog.specs) == {1, 2}
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        build_span_program(tcfg, 3, SEQ, (1, 3), compress="bottleneck")


# ------------------------------------------------- mixed-swarm churn
def test_span_peer_in_mixed_swarm_matches_jax(monkeypatch):
    """A peer serving [0, 2) through ``PipelineExecutor`` beside
    single-stage peers of both stages, learned codec on, under churn:
    JAX's all-single-stage reference trajectory within 2e-4, the span
    peer accumulated under both stages, exactly once."""
    jcfg, tcfg = _configs(**BOTTLENECK)
    jprogs, jp = _jax_params(jcfg, 2)
    want = _jax_reference(jcfg, jprogs, jp, monkeypatch)
    r = _port_runner(tcfg, jp, 2)
    r.build(peers_per_stage=2)
    span_peer = _span_peer(r, 0, 2)
    r.apply_trace([TraceEvent(0.02, -1), TraceEvent(0.25, +1)])
    m = r.run(until=1e6)
    assert r.step == STEPS
    assert m["failures"] == 1 and m["joins"] == 1
    assert {s for (k, _t, s, _i, _a, pid) in r.ledger_log
            if k == "acc" and pid == span_peer.id} == {0, 1}
    np.testing.assert_allclose(m["loss"], want, atol=TRAJ_ATOL, rtol=0)
    _assert_exactly_once(r, 2, GB // MB)


def test_span_split_and_merge_matches_jax(monkeypatch):
    """Spans [0, 2) and [2, 4) of a 4-stage pipeline: a mid-run split
    of the first span into two single-stage peers (the joiner downloads
    stage 1 from the span peer) and a merge back, then the [1, 2) peer
    dies; JAX's 4-stage reference within 2e-4, exactly once."""
    jcfg, tcfg = _configs(**BOTTLENECK)
    jprogs, jp = _jax_params(jcfg, 4)
    want = _jax_reference(jcfg, jprogs, jp, monkeypatch)
    r = _port_runner(tcfg, jp, 4)
    A = _span_peer(r, 0, 2)
    _span_peer(r, 2, 4)
    r.build(peers_per_stage=0)                  # trainers only

    def script(r):
        yield Sleep(0.10)
        yield from r.split_span(A, at=1)
        assert A.stages == range(0, 1), A.stages
        yield Sleep(0.10)
        C = next(p for p in r.peers.values()
                 if p.alive and p.serving and p.stages == range(1, 2))
        yield from r.merge_spans(A, range(0, 2))
        assert A.stages == range(0, 2), A.stages
        r._fail_peer(C)             # safe: A covers stage 1 again

    r.sim.spawn(script(r))
    m = r.run(until=1e6)
    assert r.step == STEPS
    assert m["span_changes"] == 2 and m["joins"] == 1
    assert m["failures"] == 1
    np.testing.assert_allclose(m["loss"], want, atol=TRAJ_ATOL, rtol=0)
    _assert_exactly_once(r, 4, GB // MB)


def test_span_peer_killed_midrun_matches_jax(monkeypatch):
    """A dying span peer releases only rows of its covered stages, the
    single-stage peers recompute them, and the trajectory stays on
    JAX's reference."""
    jcfg, tcfg = _configs(**BOTTLENECK)
    jprogs, jp = _jax_params(jcfg, 2)
    want = _jax_reference(jcfg, jprogs, jp, monkeypatch)
    r = _port_runner(tcfg, jp, 2)
    r.build(peers_per_stage=1)
    span_peer = _span_peer(r, 0, 2)

    def script(r):
        yield Sleep(0.06)
        r._fail_peer(span_peer)

    r.sim.spawn(script(r))
    m = r.run(until=1e6)
    assert r.step == STEPS and m["failures"] == 1
    rel = {s for (k, _t, s, _i, _a, pid) in r.ledger_log
           if k == "rel" and pid == span_peer.id}
    assert rel <= {0, 1}
    np.testing.assert_allclose(m["loss"], want, atol=TRAJ_ATOL, rtol=0)
    _assert_exactly_once(r, 2, GB // MB)


def test_resize_during_a_step_catches_up_the_kept_stage():
    """A stage-1 peer grows to [0, 2) while its download of stage 0
    outlasts a step: the All-Reduce installs that step only into serving
    peers, so the stage it kept is a version behind when the download
    ends; it re-adopts the stage before serving, and the losses equal
    the fault-free run's to the bit.  (The JAX package serves the stale
    stage here: its losses leave the reference.)"""
    jcfg, tcfg = _configs(**BOTTLENECK)
    jp = _jax_params(jcfg, 2)[1]
    slow = DeviceProfile("slow", 1e8, 400 * MBPS, 400 * MBPS, 0.005)
    thin = dataclasses.replace(slow, name="thin", down_bw=4 * MBPS)

    def run(grow: bool):
        r = _port_runner(tcfg, jp, 2)
        r.scfg = dataclasses.replace(r.scfg, max_steps=4)
        r.profile_fn = lambda i: thin if i == 2 else slow
        r.build([1, 2])
        log = []

        def script(r):
            yield Sleep(0.5)
            C = [p for p in r.peers.values() if p.stages == range(1, 2)][-1]
            before = r.step
            yield from r.merge_spans(C, range(0, 2))
            log.append((before, r.step, C.stages, sorted(
                q.state.stage_view(1).version for q in r._covering(1))))
        if grow:
            r.sim.spawn(script(r))
        m = r.run(until=1e6)
        assert r.step == 4
        return m, log

    base, _ = run(False)
    grown, log = run(True)
    (before, after, span, versions), = log
    assert after > before and span == range(0, 2)   # a step landed
    assert len(set(versions)) == 1 and grown["span_changes"] == 1
    np.testing.assert_array_equal(grown["loss"], base["loss"])


# --------------------------------------------------- wire accounting
def test_span_swarm_moves_no_host_bytes_and_equal_losses():
    """All-span peers against all-single peers on the same weights and
    batches: the same losses to the bit, and no boundary byte through
    the host for the fused swarm."""
    jcfg, tcfg = _configs(**BOTTLENECK)
    jp = _jax_params(jcfg, 2)[1]

    def run(span: bool):
        r = _port_runner(tcfg, jp, 2)
        if span:
            _span_peer(r, 0, 2)
            _span_peer(r, 0, 2)
            r.build(peers_per_stage=0)
        else:
            r.build(peers_per_stage=2)
        m = r.run(until=1e6)
        assert r.step == STEPS
        return m

    single, span = run(span=False), run(span=True)
    np.testing.assert_array_equal(span["loss"], single["loss"])
    assert span["wire_bytes"] == 0.0 and single["wire_bytes"] > 0.0


# --------------------------------------------------- protocol / interop
def test_span_executor_protocol_and_for_span():
    _, tcfg = _configs(**BOTTLENECK)
    pex = PipelineExecutor(tcfg, 4, SEQ, (1, 3), compress="bottleneck",
                           device="cpu")
    assert isinstance(pex, StageExecutor)
    assert pex.stages == range(1, 3) and pex.stage == 1
    assert pex.for_span(range(1, 3)) is pex
    assert pex.for_span(range(2, 3)).stages == range(2, 3)
    assert pex.for_stage(0).stages == range(0, 1)
    assert isinstance(pex.for_span(range(0, 4)), PipelineExecutor)
    num = build_numeric_executors(tcfg, 4, SEQ, compress="bottleneck",
                                  device="cpu")[0]
    assert num.for_span(range(0, 1)) is num
    grown = num.for_span(range(0, 2))
    assert isinstance(grown, PipelineExecutor)
    assert grown.stages == range(0, 2)
    # the span's state carries each stage's codec side
    st = pex.init_state(0)
    assert set(st.per_stage) == {1, 2}
    assert all("boundary" in st.stage_view(s).params for s in (1, 2))
    with pytest.raises(ValueError, match="explicit covered stage"):
        pex.export_grads(st)
    with pytest.raises(ValueError, match="outside span"):
        pex.export_grads(st, stage=0)


def test_span_snapshot_interop_with_singles_and_jax():
    """Per-stage snapshots cross span <-> single executors bitwise, a
    JAX span peer's whole-state snapshot restores in the port's span
    executor and back, and a download never imports gradients."""
    jcfg, tcfg = _configs(**BOTTLENECK)
    num = build_numeric_executors(tcfg, 2, SEQ, compress="bottleneck",
                                  device="cpu")
    pex = PipelineExecutor(tcfg, 2, SEQ, (0, 2), compress="bottleneck",
                           device="cpu")
    sts = [e.init_state(3 + s) for s, e in enumerate(num)]
    for st in sts:
        st.opt = adamw().init(st.params)
        st.version = 5
    pst = pex.init_state(4)
    for s in range(2):
        pex.restore(pst, num[s].snapshot(sts[s]), stage=s)
    assert pst.stage_view(0).version == 5
    for s in range(2):
        st2 = num[s].init_state(9)
        num[s].restore(st2, pex.snapshot(pst, stage=s))
        for a, b in zip(tree_leaves(st2.params), tree_leaves(sts[s].params)):
            assert torch.equal(a, b)
        assert all(float(g.abs().max()) == 0.0
                   for g in tree_leaves(st2.grad_acc))
    # a JAX span peer's snapshot, restored here and sent back
    jpex = jrt.PipelineExecutor(jcfg, 2, SEQ, (0, 2), compress="bottleneck")
    jst = jpex.init_state(jax.random.PRNGKey(4))
    for s in range(2):
        jst.stage_view(s).opt = j_adamw().init(jst.stage_view(s).params)
    jsnap = jpex.snapshot(jst)
    pst2 = pex.init_state(11)
    pex.restore(pst2, jsnap)
    jst2 = jpex.init_state(jax.random.PRNGKey(7))
    jpex.restore(jst2, pex.snapshot(pst2))
    for s in range(2):
        for a, b in zip(jax.tree.leaves(jst2.stage_view(s).params),
                        jax.tree.leaves(jst.stage_view(s).params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_int8_wire_codec_applies_at_span_edges_only():
    """A [0, 2) span of a 4-stage int8 pipeline: the fused 0 -> 1
    boundary is not quantized (its fwd equals the raw two-stage chain
    and differs from the quantized one), and its outbound edge is JAX's
    int8 round trip of the same tensor."""
    jcfg, tcfg = _configs()
    num = build_numeric_executors(tcfg, 4, SEQ, compress="int8",
                                  device="cpu")
    pex = PipelineExecutor(tcfg, 4, SEQ, (0, 2), compress="int8",
                           device="cpu")
    sts = [e.init_state(s) for s, e in enumerate(num)]
    pst = pex.init_state(1)
    for s in range(2):
        pex.restore(pst, num[s].snapshot(sts[s]), stage=s)
    tok = torch.as_tensor(_jax_batches()(0)["tokens"])
    y = pex.run_fwd(pst, tok)
    raw = num[1].run_fwd(sts[1], num[0].run_fwd(sts[0], tok))
    assert torch.equal(y, raw)
    quant = num[1].run_fwd(sts[1],
                           num[0].wire_fwd(num[0].run_fwd(sts[0], tok)))
    assert float((raw - quant).abs().max()) > 0.0
    np.testing.assert_array_equal(
        pex.wire_fwd(y).numpy(),
        np.asarray(j_roundtrip(jnp.asarray(y.numpy()), pex.quant_block)))
    # the cotangent crosses the span's edge quantized too (not at 0)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(
        pex.wire_bwd(g).numpy(),
        np.asarray(j_roundtrip(jnp.asarray(g.numpy()), pex.quant_block)))
    assert pex.wire_bwd(None) is None


# --------------------------------------------------- ledger over spans
def test_ledger_span_peer_holds_one_row_per_covered_stage():
    """A span peer admits each covered (stage, microbatch) exactly once;
    after its death a re-issued attempt folds only its lost stages."""
    led = MicrobatchLedger(3)
    led.open_round([0])
    assert led.next_index() == (0, 1)
    assert led.record(0, 0, "single")
    assert led.record(1, 0, "span") and led.record(2, 0, "span")
    assert not led.record(1, 0, "span")
    assert not led.record(2, 0, "other")
    led.settle(0)
    assert led.complete()
    assert sorted(led.release_all("span")) == [(1, 0), (2, 0)]
    assert led.next_index() == (0, 2)
    assert not led.record(0, 0, "other")
    assert led.record(1, 0, "other") and led.record(2, 0, "other")
    led.settle(0)
    assert led.complete()


def test_swarm_accumulate_spans_all_covered_stages_exactly_once():
    """``SwarmRunner.accumulate`` with a timing-mode span peer: one row
    and one fold per covered stage, the loss on the last stage only,
    nothing on re-delivery, a partial fold when another peer holds a
    covered stage."""
    _, tcfg = _configs()
    r = SwarmRunner(tcfg, SwarmConfig(
        n_stages=2, microbatch_size=1, seq_len=64, global_batch=4,
        n_trainers=0, rebalance_period=0.0, codec="none", max_steps=1),
        adamw(), numeric=False, seed=0, record_accumulation=True)
    span_peer = r.add_peer(range(0, 2))
    single = r.add_peer(1)
    idx = r.ledger.round_indices
    mb = Microbatch(index=idx[0], size=1, n_tokens=64)
    assert r.accumulate(span_peer, None, mb, loss=1.0)
    assert r.ledger.acc[0][mb.index] == span_peer.id
    assert r.ledger.acc[1][mb.index] == span_peer.id
    assert span_peer.state.stage_view(0).token_count == 64
    assert span_peer.state.stage_view(1).loss_sum == 1.0
    assert span_peer.state.stage_view(0).loss_sum == 0.0
    assert not r.accumulate(span_peer, None, mb, loss=1.0)
    mb2 = Microbatch(index=idx[1], size=1, n_tokens=64)
    assert r.accumulate(single, None, mb2, loss=2.0)
    assert r.accumulate(span_peer, None, mb2, loss=2.0)
    assert r.ledger.acc[0][mb2.index] == span_peer.id
    assert r.ledger.acc[1][mb2.index] == single.id
    assert span_peer.state.stage_view(1).token_count == 64


# --------------------------------------------------- planners and links
def _snapshots(n_stages, peer_queues):
    """The same frozen load view in both packages: ``peer_queues`` maps
    pid -> {stage: queue}."""
    queues = tuple({pid: q[s] for pid, q in peer_queues.items() if s in q}
                   for s in range(n_stages))
    loads = tuple(float(sum(q.values())) for q in queues)
    return (jrb.ControlSnapshot(n_stages, queues, loads),
            trb.ControlSnapshot(n_stages, queues, loads))


PLANNER_CASES = [
    # n_stages, spans, queues: the inputs of tests/test_rebalance.py
    (2, {"wide": (0, 2), "s0": (0, 1), "s1": (1, 2)},
     {"wide": {0: 5.0, 1: 5.0}, "s0": {0: 0.1}, "s1": {1: 9.0}}),
    (2, {"wide": (0, 2), "s1": (1, 2)},
     {"wide": {0: 5.0, 1: 5.0}, "s1": {1: 9.0}}),
    (2, {"a": (0, 1), "b": (1, 2), "c": (1, 2)},
     {"a": {0: 1.0}, "b": {1: 0.5}, "c": {1: 0.5}}),
    (2, {"a": (0, 1), "b": (1, 2)}, {"a": {0: 1.0}, "b": {1: 1.0}}),
    (3, {"a": (0, 2), "b": (1, 2), "c": (2, 3)},
     {"a": {0: 1.0, 1: 1.0}, "b": {1: 1.0}, "c": {2: 2.0}}),
    (2, {"a": (0, 1), "b": (1, 2), "c": (1, 2)},
     {"a": {0: 0.003}, "b": {1: 0.001}, "c": {1: 0.001}}),
]


def _change(ch):
    return None if ch is None else dataclasses.astuple(ch)


@pytest.mark.parametrize("case", PLANNER_CASES)
@pytest.mark.parametrize("costs", [None, "bytes", "links"])
def test_plan_span_change_matches_jax(case, costs):
    n, spans, queues = case
    jsnap, tsnap = _snapshots(n, queues)
    bc = None
    if costs == "bytes":
        bc = [float(3 + b) for b in range(n - 1)]
    elif costs == "links":
        bc = tsc.default_wan_table().edge_costs(
            [1e6] * (n - 1), ["us-east", "ap", "eu"][:n])
    got = trb.plan_span_change(tsnap, n, spans, boundary_costs=bc)
    assert _change(got) == _change(
        jrb.plan_span_change(jsnap, n, spans, boundary_costs=bc))
    assert trb.spans_route(n, list(spans.values())) == \
        jrb.spans_route(n, list(spans.values()))


@pytest.mark.parametrize("layout", [
    [(0, 2), (1, 2)], [(0, 1), (1, 3)], [(0, 2), (0, 1), (1, 3)],
    [(0, 2), (1, 2), (1, 3)], [(1, 2)], [(0, 2), (1, 3)]])
def test_spans_route_matches_jax(layout):
    n = max(hi for _, hi in layout)
    assert trb.spans_route(n, layout) == jrb.spans_route(n, layout)


@settings(max_examples=60, deadline=None)
@given(n=st.integers(1, 5), data=st.data())
def test_plan_span_change_matches_jax_drawn(n, data):
    n_peers = data.draw(st.integers(1, 7))
    spans, queues = {}, {}
    for i in range(n_peers):
        lo = data.draw(st.integers(0, n - 1))
        hi = data.draw(st.integers(lo + 1, n))
        spans[f"p{i}"] = (lo, hi)
        queues[f"p{i}"] = {s: data.draw(st.floats(0.0, 10.0))
                           for s in range(lo, hi)}
    bc = data.draw(st.one_of(st.none(), st.lists(
        st.floats(0.0, 5.0), min_size=n - 1, max_size=n - 1)))
    imb = data.draw(st.sampled_from([1.0, 1.25, 2.0]))
    jsnap, tsnap = _snapshots(n, queues)
    assert _change(trb.plan_span_change(
        tsnap, n, spans, imbalance=imb, boundary_costs=bc)) == _change(
        jrb.plan_span_change(jsnap, n, spans, imbalance=imb,
                             boundary_costs=bc))
    layout = list(spans.values())
    assert trb.spans_route(n, layout) == jrb.spans_route(n, layout)


def test_link_model_matches_jax():
    """``LinkTable`` prices, ``link_boundary_costs``, ``fusion_groups``,
    ``periodic`` and the square-cube exponents equal JAX's."""
    jt, tt = jsc.default_wan_table(), tsc.default_wan_table()
    regions = ["us-east", "eu", "ap", "us-west", "eu", "mars"]
    nbytes = [1e6, 2.5e7, 3e3, 0.0, 7e5]
    assert tt.edge_costs(nbytes, regions) == jt.edge_costs(nbytes, regions)
    with pytest.raises(ValueError, match="stage regions"):
        tt.edge_costs(nbytes, regions[:3])
    part = tsc.LinkTable([tsc.LinkSpec("a", "b", 10.0, 0.5)])
    jpart = jsc.LinkTable([jsc.LinkSpec("a", "b", 10.0, 0.5)])
    for a, b in (("a", "b"), ("b", "a"), ("a", "a"), ("a", "c")):
        assert part.transfer_time(1e5, a, b) == jpart.transfer_time(
            1e5, a, b)
    for spec_name in ("BASE", "XXLARGE", "GPT3", "OURS"):
        ts, js = getattr(tsc, spec_name), getattr(jsc, spec_name)
        assert tsc.scaling_exponents(ts) == jsc.scaling_exponents(js)
        assert tsc.utilization(ts) == jsc.utilization(js)
        assert tsc.stage_times(ts, bandwidth_mbps=100.0) == \
            jsc.stage_times(js, bandwidth_mbps=100.0)
    for kw, n in ((SHARED3, 3), (dict(n_layers=6), 3), ({}, 4),
                  (dict(encoder_layers=2, n_layers=4), 3)):
        jcfg, tcfg = _configs(**kw)
        jplan, tplan = j_get_stage_plan(jcfg, n), get_stage_plan(tcfg, n)
        assert tplan.periodic == jplan.periodic
        assert [st.structural_key for st in tplan.stages] == \
            [st.structural_key for st in jplan.stages]
        for span in (None, (0, n), (1, n), (0, 1)):
            assert tplan.fusion_groups(span) == jplan.fusion_groups(span)
        regs = ["us-east", "ap", "eu", "us-west"][:n]
        for comp in ("none", "int8"):
            assert tplan.link_boundary_costs(
                2, SEQ, regions=regs, links=tt, compression=comp) == \
                jplan.link_boundary_costs(2, SEQ, regions=regs, links=jt,
                                          compression=comp)


# --------------------------------------------------- span rebalancing
def test_rebalance_loop_shrinks_span_peer_onto_bottleneck():
    """``spans=True``, timing-only, in both packages: with stage 1 hot
    (slow single-stage peers behind it) Alg. 2's span branch shrinks the
    fast span peer onto one stage, the layout still routes, exactly
    once, and the two packages make the same moves."""
    out = []
    for Runner, Config, Profile, peer_cls, opt, cfg in (
            (JSwarmRunner, JSwarmConfig, JDeviceProfile, JPeer, j_adamw(),
             _configs()[0]),
            (SwarmRunner, SwarmConfig, DeviceProfile, TPeer, adamw(),
             _configs()[1])):
        slow = Profile("slow", 5e8, 800 * MBPS, 800 * MBPS, 1e-4)
        fast = Profile("fast", 40e9, 800 * MBPS, 800 * MBPS, 1e-4)
        peer_cls._ids = 0
        r = Runner(cfg, Config(
            n_stages=2, microbatch_size=1, seq_len=512, global_batch=16,
            n_trainers=6, rebalance_period=0.5, codec="none",
            max_steps=30, spans=True), opt, numeric=False, seed=0,
            record_accumulation=True)
        r.build(peers_per_stage=2)
        for p in r.peers.values():
            p.profile = slow if p.stage == 1 else fast
        wide = r.add_peer(range(0, 2), profile=fast)
        m = r.run(until=60.0)
        out.append((m["span_changes"], m["migrations"], r.step,
                    m["step_time"], (wide.stages.start, wide.stages.stop),
                    sorted((pid, p.stages.start, p.stages.stop, p.alive)
                           for pid, p in r.peers.items())))
    assert out[0] == out[1]
    assert out[1][0] >= 1
    assert wide.alive and len(wide.stages) == 1
    layout = [(p.stages.start, p.stages.stop) for p in r.peers.values()
              if p.alive and p.serving]
    assert trb.spans_route(2, layout)
    _assert_exactly_once(r, 2, 16)


ZONES = ("us-east", "eu", "ap")


def test_span_link_table_replay_matches_jax(monkeypatch):
    """A timing-only replay with span peers, ``spans=True``, the WAN
    link table and a zone-tagged preemption trace: the same span
    changes, migrations, failures, joins, steps, step times,
    throughput, wire bytes and final span layout as JAX, exactly."""
    jcfg, tcfg = _configs(n_layers=6, d_model=1024, d_ff=4096,
                          vocab_size=5000)
    out = []
    for Runner, Config, cfg, opt, faults, sc, peer_cls in (
            (JSwarmRunner, JSwarmConfig, jcfg, j_adamw(), jfaults, jsc,
             JPeer),
            (SwarmRunner, SwarmConfig, tcfg, adamw(), tfaults, tsc, TPeer)):
        monkeypatch.setattr(peer_cls, "_ids", 0)
        trace = faults.synth_preemptible_trace(
            horizon_s=900.0, target_peers=12, mean_lifetime_s=900.0,
            seed=3, regions=ZONES)
        r = Runner(cfg, Config(
            n_stages=3, microbatch_size=1, seq_len=128, global_batch=64,
            n_trainers=8, rebalance_period=60.0, codec="int8", spans=True,
            link_table=sc.default_wan_table()), opt, numeric=False,
            seed=4, region_fn=lambda i: ZONES[i % len(ZONES)])
        r.build(peers_per_stage=2)
        r.add_peer(range(0, 2))
        r.add_peer(range(1, 3))
        r.apply_trace(trace)
        m = r.run(until=900.0)
        out.append((m["span_changes"], m["migrations"], m["failures"],
                    m["joins"], r.step, m["step_time"], r.throughput(),
                    r.throughput(300.0), m["wire_bytes"],
                    r._stage_regions(),
                    sorted((pid, p.region, p.alive, p.stages.start,
                            p.stages.stop) for pid, p in r.peers.items())))
    assert out[0] == out[1]
    assert out[1][0] > 0 and out[1][2] > 0 and out[1][3] > 0
    assert r._span_execs == {}              # timing-only: no executors


# --------------------------------------------------- program accounting
def test_one_program_per_span_and_codec():
    """N span peers of one (span, codec) share one program, recorded as
    one fwd and one bwd build; a second same-shape runner builds
    nothing."""
    reset_compile_stats()
    jcfg, tcfg = _configs(**BOTTLENECK)
    jp = _jax_params(jcfg, 2)[1]

    def run():
        r = _port_runner(tcfg, jp, 2)
        _span_peer(r, 0, 2)
        _span_peer(r, 0, 2)
        r.build(peers_per_stage=0)
        r.run(until=1e6, max_steps=1)
        assert r.step == 1

    run()
    keys = {k: v for k, v in compile_stats()["per_key"].items()
            if (0, 2) in k}
    assert sorted(k[-2] for k in keys) == ["bwd", "fwd"]
    assert all(v == 1 for v in keys.values()), keys
    run()
    assert {k: v for k, v in compile_stats()["per_key"].items()
            if (0, 2) in k} == keys
    assert get_span_program(tcfg, 2, SEQ, (0, 2), "bottleneck") is \
        get_span_program(tcfg, 2, SEQ, (0, 2), "bottleneck")
    reset_compile_stats()
    assert compile_stats()["traces"] == 0


def test_span_config_registered_with_bottleneck_shapes():
    """swarm-1b-span: swarm-1b-bottleneck's shapes and stage params, so
    its span runs are held to the same losses."""
    from repro.configs import get_config as j_get_config
    from repro_torch.configs import get_config
    span, base = get_config("swarm-1b-span"), get_config(
        "swarm-1b-bottleneck")
    assert dataclasses.replace(span, name=base.name) == base
    jspan = j_get_config("swarm-1b-span")
    assert {f.name: getattr(span, f.name) for f in dataclasses.fields(span)
            } == {f.name: getattr(jspan, f.name)
                  for f in dataclasses.fields(jspan)}
    assert SwarmConfig(spans=True,
                       link_table=tsc.default_wan_table()).spans
