"""Serving ALBERT-shared layers and learned boundary codecs in the port,
against the JAX package on shared weights: ``lm_prefill`` /
``lm_decode_step`` over shared groups (logits and every cache row),
``split_lm_params`` of a shared stack, ``ServeRunner`` serving a
``share_groups`` config token for token (plain and int8 wire), and
session programs with the bottleneck and maxout codecs against JAX's
``build_session_program``.

Tolerances: f32 activations, wire tensors and caches within 1e-5 of the
tensor's scale (summation order moves the last digits); tokens exactly.
Learned-codec weights are JAX's ``init_stage_params``, carried across
by the converter.  Under ``cfg.wire_quant`` both packages' session
programs serve the learned wire unquantized (the training stage forward
quantizes it); that case is held against JAX's too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_dense_config
from repro.models import model as jm
from repro.models import params as jparams_lib
import repro.runtime as jrt
from repro.runtime.stage_model import split_lm_params as j_split
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeRunner as JServeRunner
from repro.serve.programs import build_session_program as j_build
from repro.serve.runner import reference_generate as j_reference

from repro_torch.compression import codecs
from repro_torch.models import model as tm
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import from_numpy_tree, to_numpy_tree
from repro_torch.runtime.stage_model import split_lm_params as t_split
from repro_torch.serve import ServeConfig, ServeRunner
from repro_torch.serve.programs import build_session_program as t_build
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)   # as tests/test_torch_train.py explains

TOL = 1e-5
S, NEW = 8, 6
SHARED_BOTTLENECK = dict(share_groups=2, boundary_compression="bottleneck",
                         bottleneck_dim=16, pipeline_stages=2)
SHARED_MAXOUT = dict(share_groups=2, boundary_compression="maxout",
                     maxout_k=4, pipeline_stages=2, norm="layernorm",
                     act="geglu")
SHARED_BOTTLENECK_Q = dict(SHARED_BOTTLENECK, wire_quant=True)
BOTTLENECK3 = dict(n_layers=6, boundary_compression="bottleneck",
                   bottleneck_dim=16, pipeline_stages=3)


def _configs(**kw):
    jcfg = tiny_dense_config(**kw)
    return jcfg, ArchConfig(**{f.name: getattr(jcfg, f.name)
                               for f in dataclasses.fields(jcfg)})


def assert_close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max()) if a.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(b).max())), err


def _prompts(cfg, n=4, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                size=(n, S))


def _jax_full(jcfg, seed, attn_scale=1.0):
    """A JAX full-model tree; ``attn_scale`` scales every ``wq``/``wk``
    (see ``tests/test_torch_train.py``: the tiny config's JAX init puts
    attention logits near +-50, where f32 rounding is amplified about a
    thousandfold, and a shared stack applies each layer several times)."""
    params = jparams_lib.init(jax.random.PRNGKey(seed), jm.lm_specs(jcfg))
    if attn_scale != 1.0:
        attn = params["blocks"][0]["attn"]
        for key in ("wq", "wk"):
            attn[key] = attn[key] * attn_scale
    return params


# ------------------------------------------------------- model entry points
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("groups,layers", [(2, 4), (1, 4), (2, 6)])
def test_lm_prefill_and_decode_shared_match_jax(groups, layers, seed):
    """A shared stack of ``groups`` groups applied ``layers / groups``
    times: prefill logits and every cache row (stacked group-major), then
    two decode steps' logits and caches, within 1e-5 of JAX's (``wq`` and
    ``wk`` scaled by 0.3, see ``_jax_full``)."""
    jcfg, tcfg = _configs(n_layers=layers, share_groups=groups)
    jp = _jax_full(jcfg, seed, attn_scale=0.3)
    tp = from_numpy_tree(jax.device_get(jp), "cpu")
    toks = _prompts(jcfg, n=2, seed=seed).astype(np.int32)
    total = S + 2
    jl, jc = jm.lm_prefill(jcfg, jp, jnp.asarray(toks), cache_len=total)
    with torch.inference_mode():
        tl, tc = tm.lm_prefill(tcfg, tp, torch.as_tensor(toks),
                               cache_len=total)
    assert_close(tl.numpy(), jl)
    tleaves = tree_leaves(to_numpy_tree(tc))
    jleaves = jax.tree.leaves(jax.device_get(jc))
    assert len(tleaves) == len(jleaves)
    for a, b in zip(tleaves, jleaves):
        assert a.shape[0] == layers
        assert_close(a, b)
    tok = np.asarray(jnp.argmax(jl[:, -1:], -1)).astype(np.int32)
    for step in range(2):
        pos = S + step
        jl, jc = jm.lm_decode_step(jcfg, jp, jnp.asarray(tok), jc,
                                   jnp.int32(pos))
        with torch.inference_mode():
            tl, tc = tm.lm_decode_step(tcfg, tp, torch.as_tensor(tok), tc,
                                       pos)
        assert_close(tl.numpy(), jl)
        for a, b in zip(tree_leaves(to_numpy_tree(tc)),
                        jax.tree.leaves(jax.device_get(jc))):
            assert_close(a, b)
        tok = np.asarray(jnp.argmax(jl[:, -1:], -1)).astype(np.int32)


def test_split_lm_params_shared_matches_jax():
    """Stage ``s`` of a shared stack takes group ``s`` as a ``[s:s+1]``
    view of the full tree, with JAX's leaves and values."""
    jcfg, tcfg = _configs(share_groups=2)
    jp = _jax_full(jcfg, 0)
    full = from_numpy_tree(jax.device_get(jp), "cpu")
    tst = t_split(tcfg, 2, full)
    jst = j_split(jcfg, 2, jp)
    for t, j in zip(tst, jst):
        tl, jl = tree_leaves(to_numpy_tree(t)), jax.tree.leaves(
            jax.device_get(j))
        assert len(tl) == len(jl)
        for a, b in zip(tl, jl):
            np.testing.assert_array_equal(a, b)
    base = full["blocks"][0]["attn"]["wq"]
    for s, t in enumerate(tst):
        wq = t["blocks"][0]["attn"]["wq"]
        assert wq.shape[0] == 1 and wq.data_ptr() == base[s].data_ptr()


# ---------------------------------------------------------- ServeRunner
def _chain(r):
    for name, span in (("d0", (0, 1)), ("d1", (1, 2))):
        r.add_peer(span, pool="decode", name=name)


def _disaggregated(r):
    r.build_pools(n_prefill=1, n_decode=1)


def _span_kill(r, fail_at):
    for name, span in (("d0a", (0, 1)), ("d1a", (1, 2)),
                       ("d0b", (0, 1)), ("d1b", (1, 2))):
        r.add_peer(span, pool="decode", name=name)
    r.schedule_fail(fail_at, "d1a")


def _serve(runner, prompts):
    reqs = [runner.submit(p, NEW) for p in prompts]
    return runner.run(), np.stack([q.tokens for q in reqs])


def _port_runner(jcfg, jr, kw):
    tcfg = ArchConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(jcfg)})
    return ServeRunner(tcfg, ServeConfig(**kw), params=from_numpy_tree(
        jax.device_get(jr.params), "cpu"), device="cpu")


@pytest.mark.parametrize("scenario", ["chain", "disaggregated", "span_kill"])
@pytest.mark.parametrize("codec", ["none", "int8"])
def test_runner_shared_matches_jax(codec, scenario):
    """``ServeRunner`` serving a ``share_groups=2`` config over two
    stages: tokens, wire bytes, the virtual clock and the KV accounting
    equal a JAX ``ServeRunner``'s with the same layout and failure; with
    the plain wire the tokens are also JAX's single-process reference's.
    The kill lands halfway to the first session's end (probed on a
    failure-free run of the same layout)."""
    jcfg = tiny_dense_config(share_groups=2)
    kw = dict(n_stages=2, max_batch=2, codec=codec,
              max_sessions=1 if scenario == "span_kill" else 2)
    prompts = _prompts(jcfg)
    setup = {"chain": _chain, "disaggregated": _disaggregated}.get(scenario)
    if setup is None:
        probe = JServeRunner(jcfg, JServeConfig(**kw), seed=0)
        _span_kill(probe, 1e9)
        reqs = [probe.submit(p, NEW) for p in prompts]
        probe.run()
        fail_at = 0.5 * min(q.done_at for q in reqs)

        def setup(r):
            _span_kill(r, fail_at)
    jr = JServeRunner(jcfg, JServeConfig(**kw), seed=0)
    r = _port_runner(jcfg, jr, kw)
    results = {}
    for name, runner in (("jax", jr), ("port", r)):
        setup(runner)
        results[name] = _serve(runner, prompts)
    np.testing.assert_array_equal(results["port"][1], results["jax"][1])
    for key in ("completed", "failed", "reprefills", "reprefilled_stages",
                "kv_transfers", "hop_failures", "wire_bytes", "elapsed_s"):
        assert results["port"][0][key] == results["jax"][0][key], key
    summary = results["port"][0]
    assert summary["failed"] == 0 and all(c == 0 for c in
                                          r.kv.stage_counts())
    if scenario == "span_kill":
        assert summary["reprefills"] >= 1
    if codec == "none":
        ref = j_reference(jcfg, jr.params, prompts, NEW)
        np.testing.assert_array_equal(results["port"][1], ref)


def test_runner_refuses_learned_codecs_as_jax_does():
    """Neither package's ``ServeRunner`` splits learned-codec weights out
    of a full-model tree (``split_lm_params`` raises in both); learned
    codecs serve through per-stage session programs."""
    jcfg, tcfg = _configs(**SHARED_BOTTLENECK)
    kw = dict(n_stages=2, codec="auto")
    with pytest.raises(NotImplementedError, match="init_stage_params"):
        JServeRunner(jcfg, JServeConfig(**kw), seed=0)
    with pytest.raises(NotImplementedError, match="init_stage_params"):
        ServeRunner(tcfg, ServeConfig(**kw), seed=0, device="cpu")


# ------------------------------------------------ learned-codec sessions
def _stage_params(jcfg, tcfg, n_stages, seed=0):
    jprogs = jrt.build_stage_programs(jcfg, n_stages, S)
    jst = jrt.init_stage_params(jprogs, jax.random.PRNGKey(seed))
    tst = [from_numpy_tree(jax.device_get(p), "cpu") for p in jst]
    return jst, tst


def _generate(build, params, chain, toks, pos0, steps, to_host, from_host):
    """Prefill ``toks`` through the chain of span programs, then decode
    ``steps`` tokens; returns (wires, tokens, caches) per call, all on
    the host."""
    progs = [build(sp) for sp in chain]
    ps = [tuple(params[sp[0]:sp[1]]) for sp in chain]
    wires, outs, caches = [], [], []
    x, kvs = from_host(toks), []
    for prog, p in zip(progs, ps):
        x, kv = prog.prefill(p, x)
        kvs.append(kv)
        wires.append(to_host(x))
    outs.append(to_host(x))
    for step in range(steps):
        tok, new = x, []
        for i, (prog, p) in enumerate(zip(progs, ps)):
            tok, kv = prog.decode(p, kvs[i], tok, pos0 + step)
            new.append(kv)
            wires.append(to_host(tok))
        kvs = new
        x = tok
        outs.append(to_host(x))
    caches = [to_host(kv) for kv in kvs]
    return wires, outs, caches


@pytest.mark.parametrize("chain", [((0, 1), (1, 2)), ((0, 2),)],
                         ids=["split", "fused"])
@pytest.mark.parametrize("kw", [SHARED_BOTTLENECK, SHARED_MAXOUT,
                                SHARED_BOTTLENECK_Q],
                         ids=["shared-bottleneck", "shared-maxout",
                              "shared-bottleneck-wire-quant"])
def test_learned_session_programs_match_jax(kw, chain):
    """Session programs with a learned codec (decode at the input of
    every stage but the first, encode at the output of every stage but
    the last) and shared groups, weights from JAX's
    ``init_stage_params``: every wire tensor, token and cache row of a
    prefill and three decode steps within 1e-5 of JAX's
    ``build_session_program``, over a split and a fused span layout;
    under ``wire_quant`` too, where neither quantizes the served wire."""
    jcfg, tcfg = _configs(**kw)
    jst, tst = _stage_params(jcfg, tcfg, 2)
    total = S + 3
    toks = _prompts(jcfg, n=2).astype(np.int32)
    jw, jo, jc = _generate(
        lambda sp: j_build(jcfg, 2, sp, total), jst, chain, toks, S, 3,
        lambda t: jax.tree.map(np.asarray, jax.device_get(t)), jnp.asarray)
    tw, to, tc = _generate(
        lambda sp: t_build(tcfg, 2, sp, total), tst, chain, toks, S, 3,
        to_numpy_tree, torch.as_tensor)
    for a, b in zip(tw, jw):
        if np.asarray(b).dtype.kind in "iu":
            np.testing.assert_array_equal(a, b)
        else:
            assert_close(a, b)
    for a, b in zip(to, jo):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        assert_close(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_learned_split_chain_equals_fused_program(seed):
    """Three stages, two learned boundaries: ``(0,1)+(1,2)+(2,3)`` and
    ``(0,3)`` give the same tokens and wires to the bit (the same
    calls in the same order), and each prefill and decode step encodes
    and decodes once per boundary."""
    jcfg, tcfg = _configs(**BOTTLENECK3)
    _, tst = _stage_params(jcfg, tcfg, 3, seed)
    total = S + 3
    toks = _prompts(jcfg, n=2, seed=seed).astype(np.int32)
    calls = {"encode": 0, "decode": 0}
    enc, dec = codecs.encode_wire, codecs.decode_wire

    def counted(kind, fn):
        def call(*a, **k):
            calls[kind] += 1
            return fn(*a, **k)
        return call
    out = {}
    for name, chain in (("split", ((0, 1), (1, 2), (2, 3))),
                        ("fused", ((0, 3),))):
        calls.update(encode=0, decode=0)
        codecs.encode_wire = counted("encode", enc)
        codecs.decode_wire = counted("decode", dec)
        try:
            out[name] = _generate(
                lambda sp: t_build(tcfg, 3, sp, total), tst, chain, toks,
                S, 3, to_numpy_tree, torch.as_tensor)
        finally:
            codecs.encode_wire, codecs.decode_wire = enc, dec
        assert calls == {"encode": 2 * 4, "decode": 2 * 4}, (name, calls)
    for a, b in zip(out["split"][1], out["fused"][1]):
        np.testing.assert_array_equal(a, b)
    # the fused program's last wire is the split chain's last one
    np.testing.assert_array_equal(out["split"][0][2], out["fused"][0][0])
