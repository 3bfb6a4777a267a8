"""Trees and snapshots across the two packages: ``from_numpy_tree`` /
``to_numpy_tree`` round trips, and executor snapshots (KV slots
included) that one package takes and the other restores."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from conftest import tiny_dense_config

from repro.runtime import StageState as JStageState
from repro.runtime import build_numeric_executors as j_build_execs
from repro.runtime.pipeline import PipelineExecutor as JPipelineExecutor
from repro.serve.programs import KV_SLOT

from repro_torch.models.config import ArchConfig as TorchArchConfig
from repro_torch.models.params import from_numpy_tree, to_numpy_tree
from repro_torch.runtime import StageState as TStageState
from repro_torch.runtime import build_numeric_executors as t_build_execs
from repro_torch.runtime.pipeline import PipelineExecutor as \
    TPipelineExecutor


def port_cfg(cfg):
    import dataclasses
    return TorchArchConfig(**{f.name: getattr(cfg, f.name)
                              for f in dataclasses.fields(cfg)})


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "blocks": [{"w": rng.standard_normal((3, 4, 5)).astype(np.float32),
                    "b": rng.standard_normal((3, 5)).astype(
                        ml_dtypes.bfloat16)}],
        "embed": rng.standard_normal((7, 4)).astype(np.float32),
        "ids": rng.integers(0, 9, (2, 3)).astype(np.int32),
        "pair": (np.float32(1.5) * np.ones(2, np.float32), None),
    }


def _assert_tree_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x.astype(np.float64),
                                      y.astype(np.float64))


def test_numpy_tree_round_trip_is_exact():
    tree = _tree()
    t = from_numpy_tree(tree, "cpu")
    assert t["blocks"][0]["b"].dtype == torch.bfloat16
    assert t["blocks"][0]["w"].shape == (3, 4, 5)       # stays stacked
    assert t["ids"].dtype == torch.int32
    _assert_tree_equal(to_numpy_tree(t), tree)


def test_jax_device_tree_round_trip():
    jtree = jax.tree.map(jnp.asarray, _tree(1))
    back = to_numpy_tree(from_numpy_tree(jax.device_get(jtree), "cpu"))
    _assert_tree_equal(back, jax.device_get(jtree))


def test_from_numpy_tree_casts_floats_only():
    t = from_numpy_tree(_tree(), "cpu", dtype=torch.bfloat16)
    assert t["embed"].dtype == torch.bfloat16
    assert t["ids"].dtype == torch.int32


def _kv(seed):
    rng = np.random.default_rng(seed)
    return [{"k": rng.standard_normal((2, 2, 6, 2, 16)).astype(np.float32),
             "v": rng.standard_normal((2, 2, 6, 2, 16)).astype(np.float32)}]


def test_snapshot_port_to_jax_and_back_with_kv():
    cfg = tiny_dense_config(n_layers=2)
    jex = j_build_execs(cfg, 1, seq_len=8)[0]
    tex = t_build_execs(port_cfg(cfg), 1, seq_len=8, device="cpu")[0]
    params = {"w": np.arange(6.0, dtype=np.float32).reshape(2, 3)}
    tstate = TStageState(params=from_numpy_tree(params, "cpu"), version=3)
    tex.install_slot(tstate, KV_SLOT, "sess-0", _kv(0))
    snap = tex.snapshot(tstate, slots=(KV_SLOT,))
    assert set(snap) == {"params", "opt", "version", "slots"}
    jstate = JStageState()
    jex.restore(jstate, snap, slots=(KV_SLOT,))
    assert jstate.version == 3
    _assert_tree_equal(jex.export_slot(jstate, KV_SLOT, "sess-0"), _kv(0))
    _assert_tree_equal(jax.device_get(jstate.params), params)
    # and back: a JAX snapshot restores into the port
    jex.install_slot(jstate, KV_SLOT, "sess-1", _kv(1))
    back = TStageState()
    tex.restore(back, jex.snapshot(jstate, slots=(KV_SLOT,)),
                slots=(KV_SLOT,))
    _assert_tree_equal(tex.export_slot(back, KV_SLOT, "sess-0"), _kv(0))
    _assert_tree_equal(tex.export_slot(back, KV_SLOT, "sess-1"), _kv(1))
    _assert_tree_equal(to_numpy_tree(back.params), params)
    # a restore without the slot sheds it, in both packages
    tex.restore(back, jex.snapshot(jstate))
    assert KV_SLOT not in back.slots
    assert set(jex.snapshot(jstate)) == {"params", "opt", "version"}


def test_span_snapshot_format_interoperates():
    cfg = tiny_dense_config()
    jex = JPipelineExecutor(cfg, 4, 8, (0, 2))
    tex = TPipelineExecutor(port_cfg(cfg), 4, 8, (0, 2), device="cpu")
    tstate = TStageState(per_stage={
        s: TStageState(params=from_numpy_tree(
            {"w": np.full((2, 2), s, np.float32)}, "cpu")) for s in (0, 1)})
    for s in (0, 1):
        tex.install_slot(tstate, KV_SLOT, "sess", _kv(s), stage=s)
    snap = tex.snapshot(tstate, slots=(KV_SLOT,))
    assert set(snap) == {"per_stage"}
    jstate = JStageState()
    jex.restore(jstate, snap, slots=(KV_SLOT,))
    for s in (0, 1):
        _assert_tree_equal(jex.export_slot(jstate, KV_SLOT, "sess", stage=s),
                           _kv(s))
    back = TStageState()
    tex.restore(back, jex.snapshot(jstate, stage=1, slots=(KV_SLOT,)),
                stage=1, slots=(KV_SLOT,))
    _assert_tree_equal(tex.export_slot(back, KV_SLOT, "sess", stage=1),
                       _kv(1))


def test_restore_aliases_tensors_already_on_device():
    """A tensor already on the executor's device is installed as is:
    serving peers hold views of the full parameter tree, no copies."""
    cfg = tiny_dense_config(n_layers=2)
    tex = t_build_execs(port_cfg(cfg), 1, seq_len=8, device="cpu")[0]
    w = torch.arange(6.0).reshape(2, 3)
    state = TStageState()
    tex.restore(state, {"params": {"w": w}})
    assert state.params["w"] is w
    assert torch.equal(state.grad_acc["w"], torch.zeros(2, 3))


@pytest.mark.parametrize("stage", [None, 0])
def test_single_stage_guard(stage):
    cfg = tiny_dense_config(n_layers=2)
    tex = t_build_execs(port_cfg(cfg), 2, seq_len=8, device="cpu")[1]
    with pytest.raises(ValueError):
        tex.snapshot(TStageState(params={}), stage=0)
    if stage is None:
        assert tex.snapshot(TStageState(params={}))["params"] == {}
