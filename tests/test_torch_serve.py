"""The port's serving stack against the JAX package on shared weights:
session programs per span, the span planner and the KV ledger, and
``ServeRunner`` end to end — token for token against JAX's
``reference_generate`` (plain wire) or a JAX ``ServeRunner`` (int8
wire), in the disaggregated and the span-kill scenarios of
``tests/test_serve.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_dense_config

from repro.core.ledger import SessionKVLedger as JLedger
from repro.core.rebalance import serve_assignment as j_assign
from repro.runtime.stage_model import split_lm_params as j_split
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeRunner as JServeRunner
from repro.serve.programs import build_session_program as j_build
from repro.serve.runner import reference_generate as j_reference

from repro_torch.core.ledger import SessionKVLedger as TLedger
from repro_torch.core.rebalance import serve_assignment as t_assign
from repro_torch.models.config import ArchConfig as TorchArchConfig
from repro_torch.models.params import from_numpy_tree, to_numpy_tree
from repro_torch.runtime.stage_model import split_lm_params as t_split
from repro_torch.serve import ServeConfig, ServeRunner
from repro_torch.serve.programs import build_session_program as t_build
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)   # as tests/test_torch_train.py explains

TOL = 1e-5
S, NEW = 8, 6


def port_cfg(cfg):
    return TorchArchConfig(**{f.name: getattr(cfg, f.name)
                              for f in dataclasses.fields(cfg)})


def assert_close(a, b, tol=TOL):
    """|a - b| <= tol relative to the tensor's scale (f32 summation
    order moves the last digits of O(10) activations)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err = float(np.abs(a - b).max())
    assert err <= tol * max(1.0, float(np.abs(b).max())), err


def _prompts(cfg, n=4, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                size=(n, S))


# ------------------------------------------------------- session programs
def test_session_programs_match_jax_per_span():
    cfg = tiny_dense_config()
    tcfg = port_cfg(cfg)
    from repro.models import model as jm, params as jp
    jparams = jp.init(jax.random.PRNGKey(0), jm.lm_specs(cfg))
    jst = j_split(cfg, 4, jparams)
    tst = t_split(tcfg, 4, from_numpy_tree(jax.device_get(jparams), "cpu"))
    total = S + 3
    toks = _prompts(cfg, n=2).astype(np.int32)
    jp_ = {sp: j_build(cfg, 4, sp, total) for sp in [(0, 2), (2, 4), (0, 4)]}
    tp_ = {sp: t_build(tcfg, 4, sp, total) for sp in [(0, 2), (2, 4), (0, 4)]}
    # prefill: (0,2) from tokens, (2,4) from (0,2)'s wire, (0,4) whole
    jw, jkv02 = jp_[(0, 2)].prefill(tuple(jst[0:2]), jnp.asarray(toks))
    tw, tkv02 = tp_[(0, 2)].prefill(tuple(tst[0:2]), torch.as_tensor(toks))
    assert_close(tw.numpy(), jw)
    wire = np.array(jw)                   # both halves get the same wire
    jt, jkv24 = jp_[(2, 4)].prefill(tuple(jst[2:4]), jnp.asarray(wire))
    tt, tkv24 = tp_[(2, 4)].prefill(tuple(tst[2:4]), torch.as_tensor(wire))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    jt4, jkv04 = jp_[(0, 4)].prefill(tuple(jst), jnp.asarray(toks))
    tt4, tkv04 = tp_[(0, 4)].prefill(tuple(tst), torch.as_tensor(toks))
    np.testing.assert_array_equal(tt4.numpy(), np.asarray(jt4))
    for tkv, jkv in ((tkv02, jkv02), (tkv24, jkv24), (tkv04, jkv04)):
        for a, b in zip(tree_leaves(to_numpy_tree(tkv)),
                        jax.tree.leaves(jax.device_get(jkv))):
            assert_close(a, b)
    # two decode steps on every span
    tok = np.array(jt4)
    for step in range(2):
        pos = S + step
        jw, jkv02 = jp_[(0, 2)].decode(tuple(jst[0:2]), jkv02,
                                       jnp.asarray(tok), jnp.int32(pos))
        tw, tkv02 = tp_[(0, 2)].decode(tuple(tst[0:2]), tkv02,
                                       torch.as_tensor(tok), pos)
        assert_close(tw.numpy(), jw)
        wire = np.array(jw)
        jt, jkv24 = jp_[(2, 4)].decode(tuple(jst[2:4]), jkv24,
                                       jnp.asarray(wire), jnp.int32(pos))
        tt, tkv24 = tp_[(2, 4)].decode(tuple(tst[2:4]), tkv24,
                                       torch.as_tensor(wire), pos)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jt4, jkv04 = jp_[(0, 4)].decode(tuple(jst), jkv04, jnp.asarray(tok),
                                        jnp.int32(pos))
        tt4, tkv04 = tp_[(0, 4)].decode(tuple(tst), tkv04,
                                        torch.as_tensor(tok), pos)
        np.testing.assert_array_equal(tt4.numpy(), np.asarray(jt4))
        tok = np.array(jt4)


# ------------------------------------------------- planner and ledger
@pytest.mark.parametrize("args", [
    dict(n_prefill=2, n_decode=2, n_stages=4),
    dict(n_prefill=3, n_decode=2, n_stages=6),
    dict(n_prefill=4, n_decode=3, n_stages=8,
         stage_costs=[3, 1, 1, 1, 2, 1, 1, 2]),
    dict(n_prefill=2, n_decode=3, n_stages=6, stage_costs=[5, 1, 1, 1, 1, 5],
         decode_speeds=[1.0, 4.0, 0.5]),
    dict(n_prefill=0, n_decode=2, n_stages=4),
])
def test_serve_assignment_matches_jax(args):
    assert t_assign(**args) == j_assign(**args)


def test_session_kv_ledger_matches_jax():
    ops = [("record", 0, "s0", "p-lo"), ("record", 1, "s0", "p-lo"),
           ("record", 2, "s0", "p-hi"), ("record", 3, "s0", "p-hi"),
           ("record", 0, "s1", "pre"), ("transfer", 0, "s1", "p-lo"),
           ("record", 1, "s0", "p-x"), ("release_all", "p-hi"),
           ("record", 2, "s0", "p-hi2"), ("release", 0, "s1")]
    led = {"jax": JLedger(4), "port": TLedger(4)}
    trace = {"jax": [], "port": []}
    for name, lg in led.items():
        for op in ops:
            try:
                out = getattr(lg, op[0])(*op[1:])
            except RuntimeError as e:       # strict double-prefill guard
                out = ("raised", str(e))
            trace[name].append((op[0], out, lg.stage_counts(),
                                lg.missing_stages("s0"),
                                sorted(lg.sessions_of("p-lo"))))
    assert trace["port"] == trace["jax"]


# ---------------------------------------------------------- ServeRunner
def _port_runner(cfg, jparams, scfg_kw, kernels):
    tcfg = port_cfg(cfg.with_overrides(kernels=kernels))
    return ServeRunner(tcfg, ServeConfig(**scfg_kw),
                       params=from_numpy_tree(jax.device_get(jparams),
                                              "cpu"), device="cpu")


def _disaggregated(r):
    r.build_pools(n_prefill=2, n_decode=2)


def _span_kill(r):
    for name, span in (("d0a", (0, 2)), ("d1a", (2, 4)),
                       ("d0b", (0, 2)), ("d1b", (2, 4))):
        r.add_peer(span, pool="decode", name=name)
    r.schedule_fail(0.045, "d1a")               # lands mid-decode


SCENARIOS = {
    "disaggregated": (dict(max_sessions=2), _disaggregated),
    "span_kill": (dict(max_sessions=1), _span_kill),
}


def _check_accounting(name, summary, r):
    assert summary["failed"] == 0
    assert all(c == 0 for c in r.kv.stage_counts())
    if name == "disaggregated":
        assert summary["reprefills"] == 0
        assert summary["kv_transfers"] == 4 * 2
    else:
        assert summary["reprefills"] >= 1
        assert summary["reprefilled_stages"] == 2 * summary["reprefills"]


@pytest.mark.parametrize("kernels", ["jnp", "pallas"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_runner_matches_jax_reference(scenario, kernels):
    cfg = tiny_dense_config()
    jr = JServeRunner(cfg, JServeConfig(n_stages=4), seed=0)
    extra, setup = SCENARIOS[scenario]
    r = _port_runner(cfg, jr.params,
                     dict(n_stages=4, max_batch=2, **extra), kernels)
    setup(r)
    prompts = _prompts(cfg)
    reqs = [r.submit(p, NEW) for p in prompts]
    summary = r.run()
    ref = j_reference(cfg, jr.params, prompts, NEW)
    np.testing.assert_array_equal(np.stack([q.tokens for q in reqs]), ref)
    _check_accounting(scenario, summary, r)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_runner_int8_wire_matches_jax_runner(scenario):
    """The int8 wire is lossy, so the oracle is a JAX ServeRunner with
    the same wire, layout and failure (same virtual clock)."""
    cfg = tiny_dense_config()
    extra, setup = SCENARIOS[scenario]
    kw = dict(n_stages=4, max_batch=2, codec="int8", **extra)
    jr = JServeRunner(cfg, JServeConfig(**kw), seed=0)
    r = _port_runner(cfg, jr.params, kw, "pallas")
    prompts = _prompts(cfg)
    results = {}
    for name, runner in (("jax", jr), ("port", r)):
        setup(runner)
        reqs = [runner.submit(p, NEW) for p in prompts]
        results[name] = (runner.run(), np.stack([q.tokens for q in reqs]))
    np.testing.assert_array_equal(results["port"][1], results["jax"][1])
    for key in ("reprefills", "reprefilled_stages", "kv_transfers",
                "hop_failures", "wire_bytes", "elapsed_s"):
        assert results["port"][0][key] == results["jax"][0][key], key
    _check_accounting(scenario, results["port"][0], r)


@pytest.mark.parametrize("quant_block", [16, 256])
def test_runner_int8_wire_quant_block_matches_jax_runner(quant_block):
    """``ServeConfig.quant_block`` other than the default 64 reaches the
    int8 wire's blocks in both packages: tokens, wire bytes and the
    virtual clock equal to a JAX ServeRunner's at the same block.  At
    256 a decode hop's [2, 1, 64] wire is one zero-padded block."""
    cfg = tiny_dense_config()
    extra, setup = SCENARIOS["disaggregated"]
    kw = dict(n_stages=4, max_batch=2, codec="int8", quant_block=quant_block,
              **extra)
    jr = JServeRunner(cfg, JServeConfig(**kw), seed=0)
    r = _port_runner(cfg, jr.params, kw, "pallas")
    prompts = _prompts(cfg)
    results = {}
    for name, runner in (("jax", jr), ("port", r)):
        setup(runner)
        reqs = [runner.submit(p, NEW) for p in prompts]
        results[name] = (runner.run(), np.stack([q.tokens for q in reqs]))
    np.testing.assert_array_equal(results["port"][1], results["jax"][1])
    for key in ("kv_transfers", "wire_bytes", "elapsed_s"):
        assert results["port"][0][key] == results["jax"][0][key], key
    _check_accounting("disaggregated", results["port"][0], r)
    assert all(p.executor.quant_block == quant_block
               for p in r.decode_peers)
