"""The port's recurrent families against the JAX package on shared numpy
inputs: the four recurrent block kinds (``mamba``, ``mlstm``, ``slstm``,
``hymba``, hence the Mamba, mLSTM and sLSTM mixers) in apply, prefill
state and decode; the ragged last chunk JAX asserts on; Mamba's f32
leaves under ``compute_cast``; both full configs' parameter counts;
xlstm-125m, a mixed mLSTM/sLSTM pattern and hymba-1.5b at
``repro.configs.get_reduced`` widths through ``lm_prefill`` /
``lm_decode_step``, ``ServeRunner`` and the stage programs; the mamba
carry through a decode peer's death; the mixed attention + mamba swarm
against JAX's trajectory, fault-free and under churn.

Tolerances: f32 results within 1e-5 relative to the tensor's scale
(``TOL``: only the order of the sums differs, in the projections and in
the in-chunk scan, a doubling scan here and ``associative_scan`` in
JAX), whole models' logits and caches within 5e-5 (``MODEL_TOL``);
tokens exactly; swarm trajectories within ``TRAJ_ATOL`` (2e-4,
the JAX package's own churn bound).  Every leaf is drawn at random,
gates and ``a_log`` included (their zero inits would leave the
stabilisers and decays at trivial values).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_dense_config
import repro.runtime as jrt
from repro.configs import get_config as j_get_config, get_reduced
from repro.models import blocks as jblocks
from repro.models import model as jm
from repro.models import params as jp
from repro.models import ssm as jssm
from repro.models.config import SSMConfig as JSSMConfig
from repro.optim import adamw as j_adamw
from repro.serve.runner import reference_generate as j_reference

from repro_torch.configs import get_config
from repro_torch.core.faults import TraceEvent
from repro_torch.core.swarm import SwarmConfig, SwarmRunner
from repro_torch.models import blocks as tblocks
from repro_torch.models import model as tm
from repro_torch.models import params as tP
from repro_torch.models import ssm as tssm
from repro_torch.models.params import from_numpy_tree, to_numpy_tree
from repro_torch.optim import adamw
from repro_torch.runtime.stage_model import build_stage_programs as t_build
from repro_torch.runtime.stage_model import make_block_core
from repro_torch.serve import ServeConfig, ServeRunner
from repro_torch.tree import tree_leaves, tree_map
from test_torch_families import assert_close, port_cfg
from test_torch_train import ATTN_SCALE, TRAJ_ATOL, _jax_batches

torch.set_num_threads(1)   # as tests/test_torch_train.py explains

TOL = 1e-5
# whole models: the projections' rounding differences pass through every
# layer and, in sLSTM, 32 sequential steps (measured up to 1.1e-5 of the
# scale in the fourth layer's normaliser state)
MODEL_TOL = 5e-5


def _draw(specs, seed):
    """A numpy tree for a JAX ParamSpec tree: every leaf normal, weights
    at JAX's init scale, the zero- and one-initialised leaves (biases,
    scales, ``a_log``, ``d_skip``, mLSTM's gate projection ``w_if``) at
    0.5 around their init, ``w_if`` over the square root of its input
    width: gates of about unit scale, whose stabilisers move without
    overflowing ``exp`` in the chunkwise form of either package (at 0.5
    unscaled, JAX's mLSTM returns NaN).  Each leaf in its spec's
    dtype."""
    rng = np.random.default_rng(seed)

    def one(spec):
        a = rng.standard_normal(spec.shape)
        if spec.init in ("zeros", "ones"):
            width = spec.shape[-3] if len(spec.shape) >= 3 else 1
            a = a * 0.5 / np.sqrt(width) + (spec.init == "ones")
        elif spec.init != "embed":
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else 1
            a = np.clip(a, -2, 2) / np.sqrt(fan_in)
        return a.astype(np.float32).astype(np.dtype(spec.dtype))
    return jax.tree.map(one, specs,
                        is_leaf=lambda x: isinstance(x, jp.ParamSpec))


def _shared(specs, seed=0):
    """(JAX tree, port tree) of the same numpy weights."""
    host = _draw(specs, seed)
    return jax.tree.map(jnp.asarray, host), from_numpy_tree(host, "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaves_close(t_tree, j_tree, tol=TOL):
    tl = tree_leaves(to_numpy_tree(t_tree))
    jl = jax.tree.leaves(jax.device_get(j_tree))
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert_close(a, b, tol)


def _mixer_cfg(**kw):
    """A small config for the block kinds: d 32, 2 heads of 16, state 4,
    chunks of 8, window 8 (hymba)."""
    base = dict(name="tiny-ssm", d_model=32, n_heads=2, n_kv_heads=1,
                head_dim=16, d_ff=64, sliding_window=8,
                ssm=JSSMConfig(state_dim=4, chunk=8))
    base.update(kw)
    return tiny_dense_config(**base)


# ------------------------------------------------------------ block kinds
# (kind, T): mamba shorter than its conv tail (2 < K - 1) and over three
# chunks; mLSTM inside one chunk and over three; sLSTM; hymba past its
# window (ring cache)
KIND_CASES = [("mamba", 2), ("mamba", 24), ("mlstm", 5), ("mlstm", 24),
              ("slstm", 7), ("hymba", 16)]


@pytest.mark.parametrize("kind,T", KIND_CASES)
def test_block_kind_matches_jax(kind, T):
    """Apply, prefill (output and decode state, hymba's KV in ring layout)
    and two decode steps (outputs and states) of one block against
    JAX's ``blocks.REGISTRY``."""
    cfg = _mixer_cfg()
    tcfg = port_cfg(cfg)
    jspec, japply, jdecode, _, jprefill = jblocks.REGISTRY[kind]
    _, tapply, tdecode, _, tprefill = tblocks.REGISTRY[kind]
    jparams, tparams = _shared(jspec(cfg), 1)
    x = np.random.default_rng(2).standard_normal((2, T + 2, cfg.d_model),
                                                 np.float32)
    pos = np.arange(T)
    total = T + 2
    jy, _ = jax.jit(functools.partial(japply, cfg))(
        jparams, jnp.asarray(x[:, :T]), jnp.asarray(pos))
    ty, _ = tapply(tcfg, tparams, _t(x[:, :T]), _t(pos))
    assert_close(ty.numpy(), jy)
    jy, _, jc = jax.jit(functools.partial(jprefill, cfg, cache_len=total))(
        jparams, jnp.asarray(x[:, :T]), jnp.asarray(pos))
    with torch.inference_mode():
        ty, _, tc = tprefill(tcfg, tparams, _t(x[:, :T]), _t(pos), total)
    assert_close(ty.numpy(), jy)
    _leaves_close(tc, jc)
    j_dec = jax.jit(functools.partial(jdecode, cfg))
    for p in (T, T + 1):
        xt = x[:, p:p + 1]
        jy, jc = j_dec(jparams, jnp.asarray(xt), jc, jnp.int32(p),
                       jnp.full((2, 1), p))
        with torch.inference_mode():
            ty, tc = tdecode(tcfg, tparams, _t(xt), tc, p,
                             torch.full((2, 1), p, dtype=torch.int64))
        assert_close(ty.numpy(), jy)
        _leaves_close(tc, jc)


def test_doubling_scan_equals_the_sequential_recurrence():
    """``_doubling_scan`` at every chunk length 1..9 (powers of two and
    between) against ``h_t = a_t h_{t-1} + b_t`` step by step, in f64:
    the same products up to rounding."""
    rng = np.random.default_rng(3)
    for c in range(1, 10):
        a = torch.from_numpy(rng.uniform(0.2, 1.0, (2, c, 3, 4)))
        b = torch.from_numpy(rng.standard_normal((2, c, 3, 4)))
        a_acc, h = tssm._doubling_scan(a, b)
        want_h, want_a = torch.zeros(2, 3, 4, dtype=a.dtype), 1.0
        for t in range(c):
            want_h = a[:, t] * want_h + b[:, t]
            want_a = a[:, t] * want_a
            torch.testing.assert_close(h[:, t], want_h, rtol=1e-12,
                                       atol=1e-12)
            torch.testing.assert_close(a_acc[:, t], want_a, rtol=1e-12,
                                       atol=1e-12)


# ------------------------------------------------------------ ragged chunk
def _true_C(st):
    """mLSTM's matrix memory without its stabiliser: ``C e^m``."""
    return st["C"] * torch.exp(st["m"])[..., None, None]


@pytest.mark.parametrize("mixer", ["mamba", "mlstm"])
def test_ragged_chunk_equals_one_chunk_and_prefill_then_decode(mixer):
    """At ``T = chunk + 1`` JAX's chunked path asserts.  The port (a full
    chunk, then a chunk of 1) equals its own prefill of ``chunk``
    positions followed by one decode step at every position, in the
    state after the last and in the next decode step's output; and it
    equals JAX run with ``chunk = T`` (one chunk) in the last position's
    output, the state and the next step.  Mamba's scan is exact at any
    chunking, so there the port equals JAX's one chunk at every
    position too.  mLSTM's is not: JAX normalises a chunk's outputs by
    ``max(|n q|, 1)`` at the stabiliser of the chunk's END, so where
    its chunks end moves the outputs before the last chunk boundary
    (JAX's own chunk 8 and chunk 16 disagree there); the state and the
    last output are the same function at any chunking.  mLSTM's state
    is compared as ``C e^m``, its value without the stabiliser."""
    cfg = _mixer_cfg()
    chunk = cfg.ssm.chunk
    T = chunk + 1
    one_chunk = cfg.with_overrides(ssm=dataclasses.replace(cfg.ssm,
                                                           chunk=T))
    tcfg = port_cfg(cfg)
    specs, japply = {"mamba": (jssm.mamba_specs, jssm.apply_mamba),
                     "mlstm": (jssm.mlstm_specs, jssm.apply_mlstm)}[mixer]
    tapply, tdecode = {"mamba": (tssm.apply_mamba, tssm.apply_mamba_decode),
                       "mlstm": (tssm.apply_mlstm,
                                 tssm.apply_mlstm_decode)}[mixer]
    state = _true_C if mixer == "mlstm" else lambda st: st["h"]
    jparams, tparams = _shared(specs(cfg), 4)
    x = np.random.default_rng(5).standard_normal((2, T + 1, cfg.d_model),
                                                 np.float32)
    with pytest.raises(AssertionError):
        japply(cfg, jparams, jnp.asarray(x[:, :T]), return_state=True)
    jy, jst = jax.jit(functools.partial(japply, one_chunk,
                                        return_state=True))(
        jparams, jnp.asarray(x[:, :T]))
    jst = {k: _t(jax.device_get(v)) for k, v in jst.items()}
    with torch.inference_mode():
        ty, tst = tapply(tcfg, tparams, _t(x[:, :T]), return_state=True)
        py, pst = tapply(tcfg, tparams, _t(x[:, :chunk]), return_state=True)
        dy, pst = tdecode(tcfg, tparams, _t(x[:, chunk:T]), pst)
        assert_close(torch.cat([py, dy], 1).numpy(), ty.numpy())
        assert_close(ty[:, -1].numpy(), np.asarray(jy)[:, -1])
        if mixer == "mamba":
            assert_close(ty.numpy(), jy)
            assert_close(tst["conv"].numpy(), jst["conv"].numpy())
            assert_close(pst["conv"].numpy(), tst["conv"].numpy())
        assert_close(state(tst).numpy(), state(jst).numpy())
        assert_close(state(pst).numpy(), state(tst).numpy())
        # the next step from each state
        nxt = _t(x[:, T:T + 1])
        a, _ = tdecode(tcfg, tparams, nxt, tree_map(torch.clone, tst))
        b, _ = tdecode(tcfg, tparams, nxt, pst)
        c, _ = tdecode(tcfg, tparams, nxt, jst)
    assert_close(a.numpy(), c.numpy())
    assert_close(b.numpy(), c.numpy())


# ------------------------------------------------------------ f32 leaves
@pytest.mark.parametrize("kind", ["mamba", "hymba"])
def test_compute_cast_keeps_mamba_leaves_f32(kind):
    """In bf16, ``compute_cast`` leaves ``a_log`` and ``d_skip`` in f32
    (hymba's inside its nested ``mamba`` subtree), so the training block
    core, which casts a layer once, computes bit for bit what the block
    computes casting at each matmul, as the JAX package uses those
    leaves: uncast.  Rounded to bf16, ``A = -exp(a_log)`` and the skip
    term change."""
    cfg = _mixer_cfg(compute_dtype="bfloat16", block_pattern=(kind,),
                     n_layers=1)
    tcfg = port_cfg(cfg)
    _, tparams = _shared(jblocks.REGISTRY[kind][0](cfg), 6)
    cast = tm.compute_cast(tparams, torch.bfloat16)
    cell = cast["cell"] if kind == "mamba" else cast["mamba"]
    assert cell["a_log"].dtype == cell["d_skip"].dtype == torch.float32
    assert cell["w_in"].dtype == torch.bfloat16
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    pos = torch.arange(12)
    with torch.no_grad():
        want, _ = tblocks.REGISTRY[kind][1](tcfg, tparams, x, pos)
        stacked = tree_map(lambda a: a[None], tparams)
        (got,) = make_block_core(tcfg, [(kind, 1)])([[stacked]], [x], [pos])
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


# ------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ["xlstm-125m", "hymba-1.5b"])
def test_full_config_parameter_count_matches_jax(arch):
    """The registered configs' ``lm_specs`` count exactly JAX's
    parameters, leaf by leaf (shapes and dtypes), from specs alone."""
    jspecs = jm.lm_specs(j_get_config(arch))
    tspecs = tm.lm_specs(get_config(arch))
    assert tP.n_params(tspecs) == jp.n_params(jspecs)
    is_j = lambda x: isinstance(x, jp.ParamSpec)
    jl = jax.tree.leaves(jspecs, is_leaf=is_j)
    tl = tree_leaves(tspecs, is_leaf=tP.is_spec)
    assert [(s.shape, str(s.dtype).removeprefix("torch.")) for s in tl] == \
        [(s.shape, np.dtype(s.dtype).name) for s in jl]
    assert get_config(arch) == port_cfg(j_get_config(arch))


def test_converter_carries_the_ssm_leaves():
    """A bf16 hymba tree with its f32 ``a_log`` / ``d_skip`` and nested
    ``mamba`` subtree crosses to the port and back exactly, each leaf
    in its own dtype."""
    cfg = get_reduced("hymba-1.5b").with_overrides(param_dtype="bfloat16")
    host = _draw(jm.lm_specs(cfg), 8)
    t = from_numpy_tree(host, "cpu")
    mamba = t["blocks"][0]["mamba"]
    assert mamba["a_log"].dtype == mamba["d_skip"].dtype == torch.float32
    assert mamba["w_in"].dtype == torch.bfloat16
    assert mamba["a_log"].shape == (cfg.n_layers, 2 * cfg.d_model,
                                    cfg.ssm.state_dim)
    back = to_numpy_tree(t)
    assert jax.tree.structure(back) == jax.tree.structure(host)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(host)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.astype(np.float32),
                                      b.astype(np.float32))


# ------------------------------------------------------------ models
def _model_cfg(name):
    if name == "xlstm-mixed":        # both xLSTM kinds in one stack
        return get_reduced("xlstm-125m").with_overrides(
            n_layers=4, block_pattern=("mlstm", "slstm") * 2)
    return get_reduced(name)


S, NEW = 32, 4                       # two chunks of 16 at reduced size
MODELS = ["xlstm-125m", "xlstm-mixed", "hymba-1.5b"]


@pytest.mark.parametrize("name", MODELS)
def test_recurrent_model_and_serving_match_jax(name):
    """``lm_prefill`` / ``lm_decode_step`` logits and every cache leaf
    (hymba's KV ring past its window and mamba state), then
    ``ServeRunner`` over two stages token for token against JAX's
    ``reference_generate`` on the same weights."""
    cfg = _model_cfg(name)
    tcfg = port_cfg(cfg)
    jparams, tparams = _shared(jm.lm_specs(cfg))
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32)
    total = S + 2
    jl, jc = jax.jit(functools.partial(jm.lm_prefill, cfg, cache_len=total))(
        jparams, jnp.asarray(toks))
    with torch.inference_mode():
        tl, tc = tm.lm_prefill(tcfg, tparams, torch.as_tensor(toks),
                               cache_len=total)
    assert_close(tl.numpy(), jl, MODEL_TOL)
    _leaves_close(tc, jc, MODEL_TOL)
    tok = np.argmax(np.asarray(jl)[:, -1:], -1).astype(np.int32)
    j_decode = jax.jit(functools.partial(jm.lm_decode_step, cfg))
    for step in range(2):
        jl, jc = j_decode(jparams, jnp.asarray(tok), jc, jnp.int32(S + step))
        with torch.inference_mode():
            tl, tc = tm.lm_decode_step(tcfg, tparams, torch.as_tensor(tok),
                                       tc, S + step)
        assert_close(tl.numpy(), jl, MODEL_TOL)
        _leaves_close(tc, jc, MODEL_TOL)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)

    r = ServeRunner(tcfg, ServeConfig(n_stages=2, max_batch=2,
                                      max_sessions=1),
                    params=tparams, device="cpu")
    r.add_peer((0, 1), pool="decode", name="d0")
    r.add_peer((1, 2), pool="decode", name="d1")
    prompts = np.random.default_rng(10).integers(0, cfg.vocab_size, (4, S))
    reqs = [r.submit(p, NEW) for p in prompts]
    summary = r.run()
    assert summary["completed"] == 4 and summary["failed"] == 0
    assert all(c == 0 for c in r.kv.stage_counts())
    ref = j_reference(cfg, jparams, prompts, NEW)
    np.testing.assert_array_equal(np.stack([q.tokens for q in reqs]), ref)


@pytest.mark.parametrize("name", ["xlstm-mixed", "hymba-1.5b"])
def test_recurrent_caches_hand_off_between_pools(name):
    """Disaggregated serving: two prefill and two decode peers, so every
    stage's recurrent carry (hymba's nested ``{"kv", "ssm"}`` tree)
    crosses from its prefill holder to its decode peer through the
    executors' slot wire and the ledger's ``transfer``.  Two sessions run
    one after the other on the same peers, so a carry left behind by the
    first would change the second's tokens: both equal JAX's
    ``reference_generate``, and the ledger drains."""
    cfg = _model_cfg(name)
    jparams, tparams = _shared(jm.lm_specs(cfg))
    r = ServeRunner(port_cfg(cfg), ServeConfig(n_stages=2, max_batch=2,
                                               max_sessions=1),
                    params=tparams, device="cpu")
    r.build_pools(n_prefill=2, n_decode=2)
    prompts = np.random.default_rng(10).integers(0, cfg.vocab_size, (4, S))
    reqs = [r.submit(p, NEW) for p in prompts]
    summary = r.run()
    assert summary["completed"] == 4 and summary["failed"] == 0
    assert summary["kv_transfers"] == 2 * 2      # stages x sessions
    assert all(c == 0 for c in r.kv.stage_counts())
    ref = j_reference(cfg, jparams, prompts, NEW)
    np.testing.assert_array_equal(np.stack([q.tokens for q in reqs]), ref)


@pytest.mark.parametrize("name", ["xlstm-mixed", "hymba-1.5b"])
def test_recurrent_stage_programs_match_jax(name):
    """A two-stage split (xLSTM: an mlstm and an slstm layer a stage;
    hymba: one layer a stage): stage 0's ``fwd``, stage 1's ``fwd`` and
    ``bwd`` (loss, the boundary's cotangent and every parameter gradient,
    the f32 ``a_log`` / ``d_skip`` and hymba's attention through the
    flash backward included) against JAX's stage programs."""
    cfg = _model_cfg(name)
    tcfg = port_cfg(cfg)
    jprogs, tprogs = jrt.build_stage_programs(cfg, 2, S), t_build(tcfg, 2, S)
    jps, tps = zip(*[_shared(p.specs, 10 + s) for s, p in enumerate(jprogs)])
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    jx = jprogs[0].fwd(jps[0], jnp.asarray(toks))
    tx = tprogs[0].fwd(tps[0], torch.as_tensor(toks))
    assert_close(tx.numpy(), jx)
    wire = np.asarray(jx)
    tloss = tprogs[1].fwd(tps[1], _t(wire), torch.as_tensor(labels))
    jl, jgx, jgp = jprogs[1].bwd(jps[1], jnp.asarray(wire),
                                 jnp.asarray(labels))
    tl, tgx, tgp = tprogs[1].bwd(tps[1], _t(wire), torch.as_tensor(labels))
    assert_close(float(tl), float(jl))
    assert float(tloss) == float(tl)
    assert_close(tgx.numpy(), jgx)
    _leaves_close(tgp, jgp)
    gx0, gp0 = tprogs[0].bwd(tps[0], torch.as_tensor(toks), _t(jgx))
    _, jgp0 = jprogs[0].bwd(jps[0], jnp.asarray(toks), jgx)
    _leaves_close(gp0, jgp0)


@pytest.mark.parametrize("name", ["xlstm-mixed", "hymba-1.5b"])
def test_recurrent_span_program_equals_the_chain(name):
    """The two stages fused in one span program (a span peer's) give the
    chain of single-stage programs' loss, gradients and boundary to the
    bit, each recurrent chunk rematerialised in both."""
    from repro_torch.runtime.stage_model import build_span_program
    cfg = _model_cfg(name)
    tcfg = port_cfg(cfg)
    tprogs = t_build(tcfg, 2, S)
    tps = tuple(_shared(p.specs, 10 + s)[1]
                for s, p in enumerate(jrt.build_stage_programs(cfg, 2, S)))
    rng = np.random.default_rng(13)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, S)))
    labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, S)))
    x1 = tprogs[0].fwd(tps[0], toks)
    loss, gx, gp1 = tprogs[1].bwd(tps[1], x1, labels)
    _, gp0 = tprogs[0].bwd(tps[0], toks, gx)
    span = build_span_program(tcfg, 2, S, (0, 2))
    torch.testing.assert_close(span.fwd(tps, toks, labels), loss, rtol=0,
                               atol=0)
    got_loss, got_gx, got = span.bwd(tps, toks, labels)
    assert got_gx is None
    torch.testing.assert_close(got_loss, loss, rtol=0, atol=0)
    for g, want in zip(got, (gp0, gp1)):
        for a, b in zip(tree_leaves(g), tree_leaves(want)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------ churn
@pytest.mark.parametrize("chunk", [16, 4], ids=["reference", "ragged"])
def test_mamba_carry_survives_span_death(chunk, monkeypatch):
    """The port of the JAX package's ``TestRecurrentServing``: a decode
    span peer of a four-stage mamba stack dies mid-generation; its
    replacement re-prefills the dead span from the recorded boundary
    history and the tokens equal JAX's single-process reference, the
    strict ledger drained.  At chunks of 4 the re-prefill's length
    (prompt 8 + tokens decoded) is no multiple of the chunk: the JAX
    package's own recovery prefill would assert there."""
    cfg = tiny_dense_config(name="tiny-mamba", block_pattern=("mamba",) * 4,
                            ssm=JSSMConfig(state_dim=8, chunk=chunk))
    tcfg = port_cfg(cfg)
    jparams, tparams = _shared(jm.lm_specs(cfg), 12)
    r = ServeRunner(tcfg, ServeConfig(n_stages=4, max_batch=2,
                                      max_sessions=1),
                    params=tparams, device="cpu")
    for name, span in (("d0a", (0, 2)), ("d1a", (2, 4)),
                       ("d0b", (0, 2)), ("d1b", (2, 4))):
        r.add_peer(span, pool="decode", name=name)
    lengths = []
    orig = r._reprefill

    def recording(sess, peer, prog, missing):
        hist = sess.edges[prog.span[0]]
        lengths.append(sum(h.shape[1] for h in hist[:-1]))
        return orig(sess, peer, prog, missing)

    monkeypatch.setattr(r, "_reprefill", recording)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 8))
    reqs = [r.submit(p, 6) for p in prompts]
    r.schedule_fail(0.045, "d1a")               # lands mid-decode
    summary = r.run()
    ref = j_reference(cfg, jparams, prompts, 6)
    np.testing.assert_array_equal(np.stack([q.tokens for q in reqs]), ref)
    assert summary["failed"] == 0
    assert summary["reprefills"] >= 1
    assert summary["reprefilled_stages"] == 2 * summary["reprefills"]
    assert all(c == 0 for c in r.kv.stage_counts())
    assert len(lengths) == summary["reprefills"]
    assert all(n > 8 for n in lengths)          # after decoding began
    if chunk == 4:
        assert any(n % chunk for n in lengths), lengths


# ------------------------------------------------------------ training
SEQ, MB, GB, STEPS = 32, 2, 8, 3


def _mixed_cfg():
    """The JAX package's ``mixed_config``: 2 attention layers feeding 2
    mamba layers, one kind a stage over 2 stages."""
    return tiny_dense_config(name="tiny-mixed",
                             block_pattern=("attn", "attn", "mamba", "mamba"),
                             ssm=JSSMConfig(state_dim=8, chunk=16))


def _scaled_attn(tree):
    """JAX stage params (host numpy) with every attention's wq, wk scaled
    by ATTN_SCALE (``test_torch_train``'s reason); mamba blocks as
    drawn."""
    tree = jax.tree.map(np.array, jax.device_get(tree))
    for blk in tree["blocks"]:
        if "attn" in blk:
            for key in ("wq", "wk"):
                blk["attn"][key] = blk["attn"][key] * np.float32(ATTN_SCALE)
    return tree


J_OPT = j_adamw(lr=1e-2, grad_clip=0.0)
_add = functools.partial(jax.tree.map, lambda a, b: a + np.asarray(b))


@jax.jit
def _jax_step(grads, opt_state, params, tok):
    gm = jax.tree.map(lambda g: g / tok, grads)
    upd, opt_state = J_OPT.update(gm, opt_state, params)
    return jax.tree.map(lambda w, u: w + u.astype(w.dtype), params,
                        upd), opt_state


def _jax_reference(cfg, programs, params):
    """``conftest.reference_losses`` (the same batches, order, sums and
    token-weighted mean) with the gradient sums in numpy (the same f32
    adds) and the AdamW step jitted: one compile per stage tree instead
    of one per leaf shape and op, which took 14 of this test's 18 s."""
    from repro.data.synthetic import SyntheticLM
    S = len(programs)
    params = [jax.tree.map(jnp.asarray, p) for p in params]
    opt_states = [J_OPT.init(p) for p in params]
    ds = SyntheticLM(cfg.vocab_size, SEQ, MB, seed=17)
    idx, losses = 0, []
    for _ in range(STEPS):
        grads = [jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), p)
                 for p in params]
        loss_sum, tok = 0.0, 0
        for _ in range(GB // MB):
            b = ds.batch(idx)
            idx += 1
            xs = [b["tokens"]]
            for s in range(S - 1):
                xs.append(programs[s].fwd(params[s], xs[-1]))
            loss, gx, gp = programs[S - 1].bwd(params[S - 1], xs[-1],
                                               b["labels"])
            grads[S - 1] = _add(grads[S - 1], gp)
            for s in range(S - 2, -1, -1):
                gx, gp = programs[s].bwd(params[s], xs[s], gx)
                grads[s] = _add(grads[s], gp)
            loss_sum += float(loss)
            tok += MB * SEQ
        losses.append(loss_sum / tok)
        for s in range(S):
            params[s], opt_states[s] = _jax_step(grads[s], opt_states[s],
                                                 params[s], tok)
    return losses


@pytest.fixture(scope="module")
def mixed_programs():
    return jrt.build_stage_programs(_mixed_cfg(), 2, SEQ, compress="none")


@pytest.mark.parametrize("churn", [False, True], ids=["fault-free", "churn"])
def test_mixed_kind_swarm_matches_jax(churn, mixed_programs):
    """The port of the JAX package's ``TestMixedKindSwarm``: an attention
    stage feeding a mamba stage, fault-free (2 peers a stage) and under
    churn (3 peers a stage, two failures and a warm join), within 2e-4
    of JAX's sequential reference trajectory from the same weights and
    batches."""
    cfg, seed = _mixed_cfg(), int(churn)
    jp_ = [_scaled_attn(_draw(p.specs, 20 + 2 * seed + s))
           for s, p in enumerate(mixed_programs)]
    want = _jax_reference(cfg, mixed_programs, jp_)
    data_fn = _jax_batches()
    topt = adamw(lr=1e-2, grad_clip=0.0)
    r = SwarmRunner(port_cfg(cfg), SwarmConfig(
        n_stages=2, microbatch_size=MB, seq_len=SEQ, global_batch=GB,
        n_trainers=3, rebalance_period=0.0, codec="none", max_steps=STEPS),
        topt, seed=seed, data_fn=data_fn, device="cpu")
    r._ref_params = [from_numpy_tree(p, "cpu") for p in jp_]
    r._ref_opt = [topt.init(p) for p in r._ref_params]
    r.build(peers_per_stage=3 if churn else 2)
    if churn:
        r.apply_trace([TraceEvent(0.02, -1), TraceEvent(0.05, -1),
                       TraceEvent(0.22, +1)])
    m = r.run(until=1e6)
    assert r.step == STEPS
    if churn:
        assert m["failures"] == 2 and m["joins"] == 1
    np.testing.assert_allclose(m["loss"], want, atol=TRAJ_ATOL, rtol=0)

