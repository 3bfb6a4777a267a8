"""The port's checkpoints (``repro_torch.ckpt``) against the JAX
package's: the same on-disk format, so a checkpoint written by either
package restores in the other leaf for leaf and bit for bit; pruning;
the runner's torn-cut intersection and its refusal of inconsistent
stage directories."""
import dataclasses
import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from conftest import tiny_dense_config
from repro.ckpt import checkpoint as jck
from repro.core import SwarmConfig as JSwarmConfig
from repro.core import SwarmRunner as JSwarmRunner
from repro.optim import adamw as j_adamw

from repro_torch.ckpt import checkpoint as tck
from repro_torch.core.swarm import SwarmConfig, SwarmRunner
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import to_numpy_tree
from repro_torch.optim import adamw

torch.set_num_threads(1)   # as tests/test_torch_train.py explains

KW = dict(n_stages=3, microbatch_size=2, seq_len=16, global_batch=4,
          n_trainers=1, rebalance_period=0.0, codec="bottleneck",
          max_steps=1)


def _cfgs():
    jcfg = tiny_dense_config(n_layers=6, share_groups=3,
                             boundary_compression="bottleneck",
                             bottleneck_dim=16, pipeline_stages=3)
    return jcfg, ArchConfig(**{f.name: getattr(jcfg, f.name)
                               for f in dataclasses.fields(jcfg)})


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"blocks": [{"w": rng.standard_normal((3, 4, 5)).astype(
            np.float32), "b": rng.standard_normal((3, 5)).astype(
                ml_dtypes.bfloat16)}],
            "embed": rng.standard_normal((7, 4)).astype(np.float32)},
        "opt": {"count": np.asarray(3, np.int32),
                "m": (np.ones(2, np.float32), None)},
        "ids": rng.integers(0, 9, (2, 3)).astype(np.int32),
        "version": 3,
    }


def _assert_same(a, b):
    """Same paths, dtypes, shapes and bits (``version`` may come back
    as a 0-d array, as in the JAX package)."""
    pa, la = tck._flatten_with_paths(a)
    pb, lb = tck._flatten_with_paths(b)
    assert pa == pb
    for p, x, y in zip(pa, la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape, p
        if p != "version":
            assert x.dtype == y.dtype, p
        np.testing.assert_array_equal(x.astype(np.float64),
                                      y.astype(np.float64), err_msg=p)


def test_paths_and_leaves_match_jax_flatten():
    tree = _tree()
    paths, leaves = tck._flatten_with_paths(tree)
    jpaths, jleaves, _ = jck._flatten_with_paths(tree)
    assert paths == jpaths
    assert len(leaves) == len(jleaves)
    assert all(a is b for a, b in zip(leaves, jleaves))


def test_round_trip(tmp_path):
    tree = _tree()
    path = tck.save_checkpoint(str(tmp_path), 7, tree)
    assert os.path.basename(path) == "step_00000007"
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert man["step"] == 7 and "bfloat16" in man["dtypes"]
    back, step = tck.restore_checkpoint(str(tmp_path), like=tree)
    assert step == 7
    _assert_same(back, tree)
    # like may hold tensors (a runner's on-device reference state)
    like = {**tree, "ids": torch.zeros(2, 3, dtype=torch.int32)}
    back, _ = tck.restore_checkpoint(str(tmp_path), like=like)
    assert back["ids"].dtype == np.int32
    np.testing.assert_array_equal(back["ids"], tree["ids"])


def test_restore_checks_structure_and_shapes(tmp_path):
    tree = _tree()
    tck.save_checkpoint(str(tmp_path), 1, tree)
    with pytest.raises(ValueError, match="structure"):
        tck.restore_checkpoint(str(tmp_path), like={**tree, "x": 1})
    bad = _tree()
    bad["params"]["embed"] = np.zeros((7, 5), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        tck.restore_checkpoint(str(tmp_path), like=bad)
    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint(str(tmp_path / "empty"), like=tree)


@pytest.fixture(scope="module")
def snaps():
    """One trained step of both packages' runners; returns their
    per-stage executor snapshots (host numpy) and the runners."""
    jcfg, tcfg = _cfgs()
    jr = JSwarmRunner(jcfg, JSwarmConfig(**KW), j_adamw(), seed=0)
    jr.build(peers_per_stage=1)
    jr.run(until=1e6)
    tr = SwarmRunner(tcfg, SwarmConfig(**KW), adamw(), seed=0,
                     device="cpu")
    tr.build(peers_per_stage=1)
    tr.run(until=1e6)
    jsnaps = [jax.device_get(p.executor.snapshot(p.state)) for p in
              sorted(jr.peers.values(), key=lambda p: p.stage)]
    tsnaps = [p.executor.snapshot(p.state) for p in
              sorted(tr.peers.values(), key=lambda p: p.stage)]
    return jsnaps, tsnaps, tr


def test_checkpoints_cross_between_packages(tmp_path, snaps):
    """A JAX checkpoint of each stage's snapshot restores into the port
    with equal paths and bit-equal leaves, and installs into a port peer;
    a port checkpoint restores into the JAX package the same way."""
    jsnaps, tsnaps, tr = snaps
    peers = sorted(tr.peers.values(), key=lambda p: p.stage)
    for s, (js, ts) in enumerate(zip(jsnaps, tsnaps)):
        assert tck._flatten_with_paths(ts)[0] == \
            jck._flatten_with_paths(js)[0]
        jdir, tdir = str(tmp_path / f"j{s}"), str(tmp_path / f"t{s}")
        jck.save_checkpoint(jdir, 1, js)
        tck.save_checkpoint(tdir, 1, ts)
        got, step = tck.restore_checkpoint(jdir, like=ts)
        assert step == 1
        _assert_same(got, js)
        peers[s].executor.restore(peers[s].state, got)
        _assert_same(to_numpy_tree(peers[s].state.params), js["params"])
        back, step = jck.restore_checkpoint(tdir, like=js)
        assert step == 1
        _assert_same(jax.device_get(back), ts)
        # the manifests agree entry for entry
        with open(os.path.join(jdir, "step_00000001", "manifest.json")) as f:
            jm = json.load(f)
        with open(os.path.join(tdir, "step_00000001", "manifest.json")) as f:
            tm = json.load(f)
        assert jm["paths"] == tm["paths"] and jm["dtypes"] == tm["dtypes"]


def test_prune_keeps_the_newest(tmp_path):
    tree = {"a": np.arange(3, dtype=np.float32)}
    for step in (1, 2, 5, 10):
        tck.save_checkpoint(str(tmp_path), step, tree)
    os.makedirs(tmp_path / "step_3")             # unpadded, still a step
    assert tck.available_steps(str(tmp_path)) == [1, 2, 3, 5, 10]
    tck.prune_checkpoints(str(tmp_path), keep=2)
    assert tck.available_steps(str(tmp_path)) == [5, 10]
    assert tck.latest_step(str(tmp_path)) == 10
    tck.prune_checkpoints(str(tmp_path), keep=0)   # a no-op
    assert tck.available_steps(str(tmp_path)) == [5, 10]
    assert tck.latest_step(str(tmp_path / "none")) is None


def _runner(ckpt_dir):
    _, tcfg = _cfgs()
    return SwarmRunner(tcfg, SwarmConfig(**{**KW, "ckpt_dir": ckpt_dir}),
                       adamw(), seed=0, device="cpu")


def test_torn_cut_resumes_the_common_step(tmp_path, snaps):
    """Stage dirs at steps {2, 4}, {2, 4} and {2} (a process died between
    per-stage saves of step 4): a runner resumes at 2, never at mixed
    versions, and its peers restore step 2."""
    _, tsnaps, _ = snaps
    root = str(tmp_path)
    for s, snap in enumerate(tsnaps):
        for step in ((2, 4) if s < 2 else (2,)):
            tck.save_checkpoint(tck.stage_dir(root, s), step, snap)
    r = _runner(root)
    assert r._common_ckpt_step() == 2 and r.step == 2
    assert r._mb_counter == 2 * 2 + 2       # resumed cursor + one round
    r.build(peers_per_stage=1)
    assert sorted(r.metrics["ckpt_restores"]) == [(0, 2), (1, 2), (2, 2)]


def test_inconsistent_stage_dir_raises(tmp_path, snaps):
    """A stage dir that has steps, but not the one asked for, is
    inconsistent with its siblings; an empty one falls back to the
    step-0 reference."""
    _, tsnaps, _ = snaps
    root = str(tmp_path)
    tck.save_checkpoint(tck.stage_dir(root, 0), 4, tsnaps[0])
    r = _runner(root)
    assert r.step == 0                   # no common step: a fresh run
    with pytest.raises(RuntimeError, match="inconsistent"):
        r._ckpt_snapshot(0, step=2)
    ref = r._ckpt_snapshot(1, step=2)    # empty dir: the reference
    assert ref["params"] is r._ref_params[1]
    assert r._ckpt_snapshot(0, step=0)["params"] is r._ref_params[0]
    got = r._ckpt_snapshot(0)            # latest
    assert r.metrics["ckpt_restores"] == [(0, 4)]
    _assert_same(got, tsnaps[0])
