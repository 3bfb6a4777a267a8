"""The port's delayed parameter updates (DPU) against the JAX package
and its own sequential reference: the DPU half of
``tests/test_torch_async.py``, split off so that ``--dist loadfile``
puts the two halves on two workers; it shares that file's configs,
runner helpers and tolerances.

Tolerances: a ``staleness=1`` run equals the port's sequential DPU
reference float for float (a round's gradients add in f64 slots, so
neither arrival order nor churn moves a bit); against JAX's own
``staleness=1`` runner on JAX's weights and batches the losses agree
within 1e-5 (``wq``/``wk`` scaled by 0.3, as
``tests/test_torch_train.py`` explains); the DPU wrapper agrees with
JAX's within f32 rounding; DPU state crosses checkpoints of either
package leaf for leaf.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_async import BOTTLENECK, GB, MB, SEQ, STEPS, _configs, \
    _opt, _run, _scfg
from test_torch_train import _assert_exactly_once, _jax_batches
from repro.ckpt import checkpoint as jck
from repro.core import SwarmConfig as JSwarmConfig
from repro.core import SwarmRunner as JSwarmRunner
import repro.runtime as jrt
from repro.optim import adamw as j_adamw, lamb as j_lamb
from repro.optim import delayed_parameter_updates as j_dpu

from repro_torch.ckpt import checkpoint as tck
from repro_torch.core.faults import TraceEvent
from repro_torch.core.sim import Sleep
from repro_torch.core.swarm import SwarmConfig, SwarmRunner
from repro_torch.models.params import from_numpy_tree, to_numpy_tree
from repro_torch.optim import adamw, lamb, delayed_parameter_updates
from repro_torch.train.reference import reference_losses
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)   # as tests/test_torch_train.py explains

JAX_ATOL = 1e-5
ATTN_SCALE = 0.3


@functools.lru_cache(maxsize=None)
def _sync_losses(seed: int) -> tuple:
    """The synchronous numeric run's losses from ``seed``, run once per
    seed for the module."""
    return tuple(_run("numeric", seed)[1]["loss"])


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
    sync = _sync_losses(seed)
    assert m["loss"][0] == sync[0]
    assert m["loss"][1] != sync[1]


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
