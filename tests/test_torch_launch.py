"""The port's launchers and the paper's baselines against the JAX
package: the elastic re-meshing policy and the Table 2 baseline models
for every registered config, the training launcher's cut-and-resume on the
CPU (equal to the uninterrupted run to the bit), a train state written
by JAX's ``save_checkpoint`` resuming in the port's ``make_state`` tree,
and the launcher's device rule.  Serial time ≈ 30 s on one CPU core.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import save_checkpoint as j_save_checkpoint
from repro.configs import REGISTRY as J_REGISTRY, get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.core import baselines as jb
from repro.core import peer as jpeer
from repro.launch import elastic as je
from repro.optim import adamw as j_adamw
from repro.train import steps as js

from repro_torch.ckpt import restore_checkpoint
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import baselines as tb
from repro_torch.core import peer as tpeer
from repro_torch.launch import elastic as te
from repro_torch.launch import train as launch_train
from repro_torch.models.params import from_numpy_tree, to_numpy_tree
from repro_torch.optim import adamw
from repro_torch.train import steps as ts
from repro_torch.tree import tree_leaves

from test_torch_families import assert_close

torch.set_num_threads(1)   # as tests/test_torch_train.py explains

ARCHS = sorted(J_REGISTRY)
BASELINE_RTOL = 1e-12


# ---------------------------------------------------------------- elastic
def _speeds(n, mixed):
    return [(1.0, 2.0, 0.5, 1.5)[i % 4] for i in range(n)] if mixed \
        else None


@pytest.mark.parametrize("arch", ARCHS)
def test_elastic_plans_match_jax(arch):
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    assert te.layer_costs(tcfg, 4096) == je.layer_costs(jcfg, 4096)
    for n in range(1, 9):
        for mixed in (False, True):
            speeds = _speeds(n, mixed)
            want = je.plan_mesh(jcfg, n, pod_speeds=speeds)
            got = te.plan_mesh(tcfg, n, pod_speeds=speeds)
            assert (got.n_pods, got.layer_splits, got.microbatches,
                    got.bubble_fraction, got.stage_bounds) == \
                (want.n_pods, want.layer_splits, want.microbatches,
                 want.bubble_fraction, want.stage_bounds)
            for m in range(1, 9):
                a = je.replan_on_failure(jcfg, want, m, seq=2048)
                b = te.replan_on_failure(tcfg, got, m, seq=2048)
                assert (b.layer_splits, b.bubble_fraction) == \
                    (a.layer_splits, a.bubble_fraction)
                a = je.replan_on_join(jcfg, want, m)
                b = te.replan_on_join(tcfg, got, m)
                assert (b.layer_splits, b.bubble_fraction) == \
                    (a.layer_splits, a.bubble_fraction)


def test_balanced_splits_match_jax_on_random_costs():
    rng = np.random.default_rng(0)
    for _ in range(200):
        costs = list(rng.uniform(0.1, 10.0, rng.integers(2, 25)))
        n = int(rng.integers(1, len(costs) + 1))
        speeds = list(rng.uniform(0.25, 4.0, n))
        assert te.balanced_splits(costs, n, speeds) == \
            je.balanced_splits(costs, n, speeds)


# ---------------------------------------------------------------- baselines
def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-300)


@pytest.mark.parametrize("arch", ARCHS)
def test_baselines_match_jax(arch):
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    for prof in ("T4", "V100", "A100"):
        jp, tp = getattr(jpeer, prof), getattr(tpeer, prof)
        for wire in ("none", "int8", "bottleneck", "maxout"):
            for fn in ("gpipe", "one_f1b"):
                a = getattr(jb, fn)(jcfg, jp, compress=wire)
                b = getattr(tb, fn)(tcfg, tp, compress=wire)
                assert b.name == a.name
                assert _rel(b.throughput, a.throughput) <= BASELINE_RTOL
                assert _rel(b.allreduce_time, a.allreduce_time) <= \
                    BASELINE_RTOL
        a, b = jb.zero_offload(jcfg, jp), tb.zero_offload(tcfg, tp)
        assert b.name == a.name == "ZeRO-Offload"
        assert _rel(b.throughput, a.throughput) <= BASELINE_RTOL
        assert _rel(b.allreduce_time, a.allreduce_time) <= BASELINE_RTOL


# ---------------------------------------------------------------- launcher
LAUNCH_CASES = {
    "yi-6b": [],
    "qwen2-vl-2b": ["--optimizer", "lamb", "--dpu", "--remat", "2level"],
    "whisper-large-v3": ["--remat", "none"],
}


def _args(arch, extra, steps, ckpt=None):
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--steps",
            str(steps), "--batch", "4", "--seq", "16", "--accum", "2"]
    if ckpt is not None:
        argv += ["--ckpt-dir", str(ckpt)]
    return argv + extra


@pytest.mark.parametrize("arch", sorted(LAUNCH_CASES))
def test_launcher_resume_equals_uninterrupted(arch, tmp_path):
    """``main`` cut after step 2 and restarted on its checkpoint directory
    gives steps 3-4 the uninterrupted run's losses, to the bit."""
    extra = LAUNCH_CASES[arch]
    full, summary = launch_train.main(_args(arch, extra, 4))
    assert len(full) == 4 and all(np.isfinite(full))
    assert summary["arch"] == arch and summary["device"] == "cpu"
    assert summary["tokens_per_s"] > 0
    cut, _ = launch_train.main(_args(arch, extra, 2, tmp_path))
    assert cut == full[:2]
    resumed, summary = launch_train.main(_args(arch, extra, 4, tmp_path))
    assert summary["start"] == 2
    assert resumed == full[2:]


def test_launcher_needs_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "yi-6b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.make_state(get_reduced("yi-6b"), adamw(), 0)


def test_jax_checkpoint_restores_into_port_state(tmp_path):
    """A JAX ``make_state`` written by JAX's ``save_checkpoint`` restores
    into the port's ``make_state`` tree; one step of each package on the
    same batch then agrees."""
    jcfg, tcfg = j_get_reduced("yi-6b"), get_reduced("yi-6b")
    jopt, topt = j_adamw(lr=1e-3), adamw(lr=1e-3)
    jstate = js.make_state(jcfg, jopt, jax.random.PRNGKey(3))
    j_save_checkpoint(str(tmp_path), 0, jstate)
    like = ts.make_state(tcfg, topt, 0, device="cpu")
    host, step = restore_checkpoint(str(tmp_path), like)
    assert step == 0
    tstate = from_numpy_tree(host, "cpu")
    for a, b in zip(tree_leaves(tstate), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rng = np.random.default_rng(4)
    batch = {k: rng.integers(0, jcfg.vocab_size, (4, 16), dtype=np.int32)
             for k in ("tokens", "labels")}
    jnew, jm = jax.jit(js.make_train_step(jcfg, jopt))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tnew, tm = ts.make_train_step(tcfg, topt)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
        1e-5 * abs(float(jm["loss"]))
    for a, b in zip(tree_leaves(to_numpy_tree(tnew["params"])),
                    jax.tree.leaves(jnew["params"])):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-4, rtol=0)
    assert int(tnew["step"]) == int(jnew["step"]) == 1
    assert_close(float(tm["ce"]), float(jm["ce"]), 1e-5)
