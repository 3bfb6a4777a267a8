"""The port's examples (``repro_torch.examples``) on the CPU at small
size, against the JAX package's examples where they compute the same
thing: ``serve_pipeline``'s tokens against JAX's
``full_session_program`` on the same numpy weights and prompts, and
``elastic_failures``' replays against JAX's example's on the same
trace (failures, joins, migrations, recomputes and throughput, at a
shorter horizon).  Each example's ``main`` runs with ``--device cpu``
and raises without it (no card here).  A few seconds each."""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.core.faults import synth_preemptible_trace as j_trace
from repro.models import model as jm
from repro.serve import full_session_program as j_session

from repro_torch.core.faults import synth_preemptible_trace
from repro_torch.examples import elastic_failures, quickstart, \
    serve_pipeline, train_swarm_lm
from test_torch_families import _numpy_init

torch.set_num_threads(1)   # as tests/test_torch_train.py explains

ROOT = pathlib.Path(__file__).resolve().parent.parent
HORIZON = 600.0


def _jax_example(name: str):
    """The JAX package's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mod", [quickstart, elastic_failures,
                                 serve_pipeline, train_swarm_lm],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_examples_need_the_card_unless_told(mod):
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main([])


def test_quickstart_loss_falls_through_a_preemption():
    out = quickstart.main(["--device", "cpu", "--steps", "4"])
    assert len(out["losses"]) == 4
    assert out["losses"][-1] < out["losses"][0]
    assert out["failures"] == 1


def test_train_swarm_lm_sets_both_curves_side_by_side():
    out = train_swarm_lm.main(["--device", "cpu", "--steps", "3",
                               "--seq", "16", "--batch", "8"])
    assert len(out["swarm_losses"]) == len(out["ref_losses"]) == 3
    assert out["parity"] == "OK"
    assert all(np.isfinite(out["swarm_losses"] + out["ref_losses"]))
    # the same data and the same init rule: step 1's losses agree
    assert abs(out["swarm_losses"][0] - out["ref_losses"][0]) < 0.25


def test_train_swarm_lm_takes_the_jax_examples_optimizer_by_default():
    """Both arms take JAX's ``adamw(lr=3e-3)`` unless told otherwise: its
    global-norm clip of 1.0 (per stage in SWARM), which binds here, so
    ``--grad-clip 0`` trains other curves."""
    argv = ["--device", "cpu", "--steps", "2", "--seq", "16",
            "--batch", "8"]
    base = train_swarm_lm.main(argv)
    clip1 = train_swarm_lm.main(argv + ["--grad-clip", "1.0"])
    clip0 = train_swarm_lm.main(argv + ["--grad-clip", "0"])
    for k in ("swarm_losses", "ref_losses"):
        assert base[k] == clip1[k]
        assert base[k][-1] != clip0[k][-1]


@pytest.mark.parametrize("arch", ["yi-6b", "llama4-scout-17b-a16e"])
def test_serve_pipeline_tokens_equal_jax(arch):
    """The example's greedy tokens on JAX's numpy weights and prompts are
    JAX's ``full_session_program``'s."""
    jcfg = j_get_reduced(arch)
    host = _numpy_init(jm.lm_specs(jcfg), 2)
    prompts = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    new = 5
    got = serve_pipeline.main(["--arch", arch, "--device", "cpu",
                               "--new-tokens", str(new)],
                              params=host, prompts=prompts)
    prog = j_session(jcfg, 8 + new)
    jparams = jax.tree.map(jnp.asarray, host)
    tok, kv = prog.prefill(jparams, jnp.asarray(prompts))
    want = [tok]
    for i in range(new - 1):
        tok, kv = prog.decode(jparams, kv, tok, jnp.int32(8 + i))
        want.append(tok)
    np.testing.assert_array_equal(got.numpy(),
                                  np.concatenate(want, axis=1))


def test_serve_pipeline_refuses_audio():
    with pytest.raises(SystemExit):
        serve_pipeline.main(["--arch", "whisper-large-v3", "--device",
                             "cpu"])


def test_elastic_failures_replays_equal_jax(monkeypatch):
    jex = _jax_example("elastic_failures")
    monkeypatch.setattr(jex, "HORIZON", HORIZON)
    kw = dict(horizon_s=HORIZON, target_peers=24, mean_lifetime_s=1200.0,
              seed=3)
    trace, jtrace = synth_preemptible_trace(**kw), j_trace(**kw)
    assert [(e.time, e.delta) for e in trace] == \
        [(e.time, e.delta) for e in jtrace]
    rows = elastic_failures.main(["--device", "cpu", "--horizon",
                                  str(HORIZON)])
    for row, (T, overlap, _) in zip(rows, elastic_failures.SETTINGS):
        r = jex.run(T, jtrace, overlap=overlap)
        m = r.metrics
        assert row["throughput"] == r.throughput()
        for k in ("failures", "joins", "migrations",
                  "recomputed_microbatches"):
            assert row[k] == m[k], k
        assert row["overlap_fraction"] == pytest.approx(
            m["overlap_fraction"], rel=1e-12)
    assert rows[0]["failures"] > 0 and rows[1]["migrations"] > 0
