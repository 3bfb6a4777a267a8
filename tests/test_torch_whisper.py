"""The port's encoder-decoder family (whisper) against the JAX package
on shared numpy inputs, at ``tests/test_hetero_swarm.py``'s tiny
whisper config (2 encoder and 4 decoder layers, d 64, f32): the model
functions (``encode``, ``dec_scan``, ``whisper_apply``,
``whisper_prefill`` and its caches, ``whisper_decode_step``), the
serving steps' audio branches, the decode position row, the encoder
pod's plan, the encoder-decoder stage and span programs, an elastic
three-stage swarm with a failure and a warm join, the refusals both
packages make, and the kernel rule on every flash call of whisper's
serving and training paths.

Tolerances: f32 model outputs and caches within 1e-5 of the tensor's
scale (``TOL``: only the order of the sums differs), greedy tokens
exactly, stage gradients within ``GRAD_RTOL`` of each leaf's largest
entry, the staged chain within 1e-6 of ``whisper_apply`` (JAX's own
bound), span programs bit-equal to the chain, and swarm trajectories
equal to the port's staged reference float for float and within
``TRAJ_ATOL`` (2e-4, the JAX test's bound) of JAX's.  The module-level
comparisons scale every attention's ``wq``/``wk`` by ``ATTN_SCALE``:
JAX's init draws them at std 1/sqrt(n_heads) (the fan-in rule reads the
heads axis), so logits reach tens and the saturated softmax amplifies
f32 rounding, as ``tests/test_torch_train.py`` explains; at that init
the two packages' logits lie 1.2e-5 of their scale apart.  The swarm
trajectory runs on JAX's own weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.runtime as jrt
from repro.models import whisper as JW
from repro.models.stage_plan import get_stage_plan as j_plan
from repro.optim import adamw as j_adamw
from repro.runtime.stage_model import split_whisper_params as j_split
from repro.serve import programs as jprograms
from repro.train import steps as jsteps
from test_hetero_swarm import W_GB, W_MB, W_SEQ, W_STEPS, \
    _whisper_batch, _whisper_reference, whisper_config
from test_torch_families import assert_close, port_cfg, _numpy_init
from test_torch_train import ATTN_SCALE, GRAD_RTOL, TRAJ_ATOL, _close_rel

from repro_torch.core.faults import TraceEvent
from repro_torch.core.swarm import SwarmConfig, SwarmRunner
from repro_torch.models import flash as tflash
from repro_torch.models import whisper as TW
from repro_torch.models.params import from_numpy_tree, to_numpy_tree
from repro_torch.models.stage_plan import get_stage_plan
from repro_torch.optim import adamw
from repro_torch.runtime import build_span_program, build_stage_programs, \
    split_whisper_params
from repro_torch.serve import programs as tprograms
from repro_torch.train import steps as tsteps
from repro_torch.train.reference import reference_losses
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)   # as tests/test_torch_train.py explains

TOL = 1e-5
JCFG = whisper_config()
TCFG = port_cfg(JCFG)
PROMPT, NEW, TOTAL = 10, 5, 16


def _weights(seed=0):
    """A full whisper tree in numpy (JAX's init rules), every attention's
    ``wq``/``wk`` scaled by ATTN_SCALE (module docstring)."""
    tree = _numpy_init(JW.whisper_specs(JCFG), seed)
    for blk in ("enc_blocks", "dec_blocks"):
        for att in ("attn", "xattn"):
            if att in tree[blk]:
                for key in ("wq", "wk"):
                    tree[blk][att][key] = (tree[blk][att][key]
                                           * np.float32(ATTN_SCALE))
    return tree


@pytest.fixture(scope="module")
def shared():
    """(JAX tree, port tree, numpy batch) of the same weights and data."""
    w = _weights()
    return jax.tree.map(jnp.asarray, w), from_numpy_tree(w, "cpu"), \
        _whisper_batch(JCFG, 0)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ model math
def test_encode_dec_scan_and_apply_match_jax(shared):
    jp, tp, b = shared
    audio, tok = b["tokens"]["audio"], b["tokens"]["tok"]
    je = jax.jit(lambda p, a: JW.encode(JCFG, p, a))(jp, audio)
    te = TW.encode(TCFG, tp, _t(audio))
    assert te.dtype == torch.float32 and te.shape == (W_MB, 8, 64)
    assert_close(te, je, TOL)
    # dec_scan over the last two decoder layers, from the same inputs
    x = np.random.default_rng(3).standard_normal(
        (W_MB, W_SEQ, 64)).astype(np.float32)
    pos = np.arange(W_SEQ)
    jx = JW.dec_scan(JCFG, jax.tree.map(lambda a: a[2:], jp["dec_blocks"]),
                     jnp.asarray(x), je, pos)
    tx = TW.dec_scan(TCFG, tree_map(lambda a: a[2:], tp["dec_blocks"]),
                     _t(x), _t(np.asarray(je)), torch.arange(W_SEQ))
    assert_close(tx, jx, TOL)
    jl, _ = jax.jit(lambda p, a, t: JW.whisper_apply(
        JCFG, p, {"audio_embed": a, "tokens": t}))(jp, audio, tok)
    tl, aux = TW.whisper_apply(TCFG, tp, {"audio_embed": _t(audio),
                                          "tokens": _t(tok)})
    assert float(aux) == 0.0 and tl.shape == (W_MB, W_SEQ, 256)
    assert_close(tl, jl, TOL)


def test_prefill_caches_and_decode_steps_match_jax(shared):
    """whisper_prefill's logits, self-KV ring and cross K/V, then five
    decode steps fed the same tokens, each step's logits and the caches
    after the last."""
    jp, tp, b = shared
    audio, tok = b["tokens"]["audio"], b["tokens"]["tok"]
    batch = {"audio_embed": audio, "tokens": tok[:, :PROMPT]}
    jl, jc = jax.jit(lambda p, bt: JW.whisper_prefill(
        JCFG, p, bt, cache_len=TOTAL))(jp, batch)
    tl, tc = TW.whisper_prefill(TCFG, tp, tree_map(_t, batch),
                                cache_len=TOTAL)
    assert tl.shape == (W_MB, 1, 256)
    assert_close(tl, jl, TOL)
    assert tc["self"]["k"].shape == (4, W_MB, TOTAL, 4, 16)
    assert tc["cross"]["k"].shape == (4, W_MB, 8, 4, 16)
    for a, c in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        assert_close(c, a, TOL)
    # the cross K/V are prefill_cross_cache's
    enc = TW.encode(TCFG, tp, _t(audio))
    for a, c in zip(tree_leaves(TW.prefill_cross_cache(TCFG, tp, enc)),
                    tree_leaves(tc["cross"])):
        assert torch.equal(a, c)
    step = jax.jit(lambda p, t, c, pos: JW.whisper_decode_step(
        JCFG, p, t, c, pos))
    for i in range(NEW):
        t = tok[:, PROMPT + i:PROMPT + i + 1]
        jl, jc = step(jp, t, jc, jnp.asarray(PROMPT + i))
        tl, tc = TW.whisper_decode_step(TCFG, tp, _t(t), tc, PROMPT + i)
        assert_close(tl, jl, TOL)
    for a, c in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        assert_close(c, a, TOL)


def test_steps_audio_branches_give_jax_greedy_tokens(shared):
    """``make_prefill_step`` / ``make_serve_step`` on an audio batch:
    the greedy tokens of a prefill and six decode steps are JAX's jitted
    steps' exactly; ``model_specs`` is ``whisper_specs``."""
    jp, tp, b = shared
    audio, tok = b["tokens"]["audio"], b["tokens"]["tok"][:, :PROMPT]
    assert [s.shape for s in tree_leaves(tsteps.model_specs(TCFG),
                                         is_leaf=lambda x: hasattr(
                                             x, "init"))] == \
        [s.shape for s in jax.tree.leaves(
            jsteps.model_specs(JCFG),
            is_leaf=lambda x: hasattr(x, "init"))]
    jpre = jax.jit(jsteps.make_prefill_step(JCFG, cache_len=TOTAL))
    jserve = jax.jit(jsteps.make_serve_step(JCFG))
    nxt, jc = jpre(jp, {"audio_embed": audio, "tokens": tok})
    want = [np.asarray(nxt)]
    for i in range(6):
        nxt, jc = jserve(jp, jc, nxt, jnp.asarray(PROMPT + i))
        want.append(np.asarray(nxt))
    tpre = tsteps.make_prefill_step(TCFG, cache_len=TOTAL)
    tserve = tsteps.make_serve_step(TCFG)
    with torch.inference_mode():
        nxt, tc = tpre(tp, {"audio_embed": _t(audio), "tokens": _t(tok)})
        got = [nxt.numpy()]
        for i in range(6):
            nxt, tc = tserve(tp, tc, nxt, PROMPT + i)
            got.append(nxt.numpy())
    np.testing.assert_array_equal(np.concatenate(got, 1),
                                  np.concatenate(want, 1))


@pytest.mark.parametrize("d,max_seq_len", [(64, 1 << 20), (1280, 3000)])
def test_decode_position_row_is_the_table_row(d, max_seq_len):
    """The row a decode step adds equals, bit for bit, row ``min(pos,
    rows - 1)`` of the whole table JAX slices (``rows = min(max_seq_len,
    2^16)``), without building the table: and it lies within f32
    rounding of JAX's row."""
    cfg = TCFG.with_overrides(d_model=d, max_seq_len=max_seq_len)
    rows = min(max_seq_len, 1 << 16)
    table = TW.sinusoid(rows, d, torch.float32)
    jtable = np.asarray(JW.sinusoid(rows, d, jnp.float32))
    for pos in (0, 7, 1499, rows - 1, rows, 70000):
        row = TW.decode_position_row(cfg, pos, torch.float32)
        assert row.shape == (1, d)
        assert torch.equal(row[0], table[min(pos, rows - 1)]), pos
        # XLA's exp and torch's differ by an ulp in a few divisors;
        # pos * div then moves the argument by up to pos ulps
        np.testing.assert_allclose(row[0].numpy(),
                                   jtable[min(pos, rows - 1)],
                                   atol=4e-3, rtol=0)


# ------------------------------------------------------------ stage plan
def test_whisper_pod_at_cross_attention_boundary():
    """The port's plan of the JAX test: the encoder pod is stage 0, the
    embed the first decoder stage's, the head the last's; the boundary
    prices equal JAX's plan's."""
    plan, jplan = get_stage_plan(TCFG, 3), j_plan(JCFG, 3)
    assert plan.is_encdec and not plan.periodic
    assert plan.stages[0].runs == (("whisper_enc", 2),)
    assert not plan.stages[0].owns_embed and plan.stages[1].owns_embed
    assert plan.stages[2].owns_head
    assert plan.stages[1].aux_slots == ("kv",)
    for comp in ("none", "int8"):
        assert plan.boundary_costs(W_MB, W_SEQ, comp) == \
            jplan.boundary_costs(W_MB, W_SEQ, comp)
    enc = 2.0 * W_MB * JCFG.encoder_max_len * JCFG.d_model
    assert plan.boundary_bytes(0, W_MB, W_SEQ) == enc + 4.0 * W_MB * W_SEQ
    progs = build_stage_programs(TCFG, 3, W_SEQ)
    jprogs = jrt.build_stage_programs(JCFG, 3, W_SEQ)
    for p, q in zip(progs, jprogs):
        assert p.fwd_flops_per_token == q.fwd_flops_per_token
        assert [s.shape for s in tree_leaves(p.specs, is_leaf=lambda x:
                                             hasattr(x, "init"))] == \
            [s.shape for s in jax.tree.leaves(
                q.specs, is_leaf=lambda x: hasattr(x, "init"))]


# ------------------------------------------------------------ stage programs
@pytest.fixture(scope="module")
def staged(shared):
    jp, tp, b = shared
    jprogs = jrt.build_stage_programs(JCFG, 3, W_SEQ)
    tprogs = build_stage_programs(TCFG, 3, W_SEQ)
    return (jprogs, j_split(JCFG, 3, jp),
            tprogs, split_whisper_params(TCFG, 3, tp), b)


def test_staged_chain_matches_whisper_apply(shared, staged):
    """Stage programs over the split of a full tree reproduce the
    whole-model loss (the pod hand-off and the payload trees lose
    nothing), and JAX's staged loss."""
    _, tp, _ = shared
    jprogs, jsp, tprogs, tsp, b = staged
    x = tree_map(_t, b["tokens"])
    assert set(x) == {"audio", "tok"}
    xs = [x]
    for s in range(2):
        xs.append(tprogs[s].fwd(tsp[s], xs[-1]))
    assert set(xs[1]) == {"enc", "tok"} and set(xs[2]) == {"x", "enc", "tok"}
    assert torch.equal(xs[2]["tok"], x["tok"])
    loss, _, _ = tprogs[2].bwd(tsp[2], xs[2], _t(b["labels"]))
    assert torch.equal(loss, tprogs[2].fwd(tsp[2], xs[2], _t(b["labels"])))
    logits, _ = TW.whisper_apply(TCFG, tp, {"audio_embed": x["audio"],
                                            "tokens": x["tok"]})
    lse = torch.logsumexp(logits.float(), -1)
    gold = torch.gather(logits.float(), -1,
                        _t(b["labels"]).long()[..., None])[..., 0]
    np.testing.assert_allclose(float(loss) / (W_MB * W_SEQ),
                               float((lse - gold).mean()), rtol=1e-6)
    jx = b["tokens"]
    for s in range(2):
        jx = jprogs[s].fwd(jsp[s], jx)
    jloss = jprogs[2].fwd(jsp[2], jx, b["labels"])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)


def _chain_grads(progs, params, b):
    """(loss, [inputs], [gx per stage], [gp per stage]) of the chain of
    single-stage programs (a package's own)."""
    xs = [b["tokens"]]
    for s in range(2):
        xs.append(progs[s].fwd(params[s], xs[-1]))
    loss, gx2, gp2 = progs[2].bwd(params[2], xs[2], b["labels"])
    gx1, gp1 = progs[1].bwd(params[1], xs[1], gx2)
    gx0, gp0 = progs[0].bwd(params[0], xs[0], gx1)
    return loss, xs, [gx0, gx1, gx2], [gp0, gp1, gp2]


def test_stage_bwd_matches_jax(staged):
    """Each stage's recompute ``bwd``: the loss, the cotangent tree
    (``{"enc"}`` out of stage 1, ``{"x", "enc"}`` out of stage 2, None
    from the pod) and every gradient leaf, within f32 rounding of JAX's;
    each stage fed JAX's own boundary input and cotangent."""
    jprogs, jsp, tprogs, tsp, b = staged
    jl, jxs, jgx, jgp = _chain_grads(jprogs, jsp, b)
    tb = {"tokens": tree_map(_t, b["tokens"]), "labels": _t(b["labels"])}
    tl, tgx2, tgp2 = tprogs[2].bwd(tsp[2], tree_map(
        lambda a: _t(np.asarray(a)), jxs[2]), tb["labels"])
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert set(tgx2) == {"x", "enc"}
    got_gx = {2: tgx2}
    got_gp = {2: tgp2}
    for s in (1, 0):
        inp = tb["tokens"] if s == 0 else tree_map(
            lambda a: _t(np.asarray(a)), jxs[s])
        dy = tree_map(lambda a: _t(np.asarray(a)), jgx[s + 1])
        got_gx[s], got_gp[s] = tprogs[s].bwd(tsp[s], inp, dy)
    assert got_gx[0] is None and jgx[0] is None
    assert set(got_gx[1]) == {"enc"}
    for s in (1, 2):
        for k in got_gx[s]:
            _close_rel(got_gx[s][k].numpy(), jgx[s][k])
    for s in range(3):
        jleaves = jax.tree.leaves(jax.device_get(jgp[s]))
        tleaves = tree_leaves(to_numpy_tree(got_gp[s]))
        assert len(jleaves) == len(tleaves)
        for a, c in zip(jleaves, tleaves):
            _close_rel(c, a, GRAD_RTOL)


@pytest.mark.parametrize("span", [(0, 2), (1, 3)])
def test_span_programs_equal_the_chain_and_jax(span, staged):
    """A span program equals the port's chain of single-stage programs
    bit for bit on the CPU (forward output or loss, the inbound
    cotangent tree, every stage's gradient) and JAX's span program
    within f32 rounding."""
    jprogs, jsp, tprogs, tsp, b = staged
    lo, hi = span
    tb = {"tokens": tree_map(_t, b["tokens"]), "labels": _t(b["labels"])}
    loss, xs, gxs, gps = _chain_grads(tprogs, tsp, tb)
    prog = build_span_program(TCFG, 3, W_SEQ, span)
    jprog = jrt.build_span_program(JCFG, 3, W_SEQ, span)
    ps, jps = tuple(tsp[lo:hi]), tuple(jsp[lo:hi])
    inp = xs[lo]
    jinp = b["tokens"] if lo == 0 else jprogs[0].fwd(jsp[0], b["tokens"])
    if hi == 3:
        out = prog.fwd(ps, inp, tb["labels"])
        assert torch.equal(out, loss)
        sl, gx, sgps = prog.bwd(ps, inp, tb["labels"])
        assert torch.equal(sl, loss)
        jl, jgx, jgps = jprog.bwd(jps, jinp, b["labels"])
        np.testing.assert_allclose(float(sl), float(jl), rtol=1e-6)
    else:
        out = prog.fwd(ps, inp)
        for k in xs[hi]:
            assert torch.equal(out[k], xs[hi][k])
        gx, sgps = prog.bwd(ps, inp, gxs[hi])
        jgx, jgps = jprog.bwd(jps, jinp, jax.tree.map(
            lambda a: jnp.asarray(a.numpy()), gxs[hi]))
    if lo == 0:
        assert gx is None and jgx is None
    else:
        for k in gxs[lo]:
            assert torch.equal(gx[k], gxs[lo][k])
            _close_rel(gx[k].numpy(), jgx[k])
    for i, s in enumerate(range(lo, hi)):
        for a, c in zip(tree_leaves(gps[s]), tree_leaves(sgps[i])):
            assert torch.equal(a, c)
        for a, c in zip(jax.tree.leaves(jax.device_get(jgps[i])),
                        tree_leaves(to_numpy_tree(sgps[i]))):
            _close_rel(c, a, GRAD_RTOL)


# ------------------------------------------------------------ elastic swarm
def test_whisper_swarm_trains_elastic():
    """The JAX test's three-stage swarm (the encoder pod and two decoder
    stages, two peers a stage) through a failure and a warm join, on
    JAX's weights and batches: every (stage, microbatch) admitted once,
    the losses equal the port's staged reference float for float and lie
    within TRAJ_ATOL of JAX's ``_whisper_reference``."""
    jprogs = jrt.build_stage_programs(JCFG, 3, W_SEQ)
    jopt = j_adamw(lr=1e-2, grad_clip=0.0)
    want = _whisper_reference(JCFG, jprogs, jopt, 0)
    jparams = [jax.tree.map(np.array, jax.device_get(p)) for p in
               jrt.init_stage_params(jprogs, jax.random.PRNGKey(0))]
    data_fn = lambda i: _whisper_batch(JCFG, i)   # noqa: E731
    opt = adamw(lr=1e-2, grad_clip=0.0)
    r = SwarmRunner(TCFG, SwarmConfig(
        n_stages=3, microbatch_size=W_MB, seq_len=W_SEQ, global_batch=W_GB,
        n_trainers=2, rebalance_period=0.0, codec="none",
        max_steps=W_STEPS), opt, seed=0, data_fn=data_fn, device="cpu",
        record_accumulation=True)
    r._ref_params = [from_numpy_tree(p, "cpu") for p in jparams]
    r._ref_opt = [opt.init(p) for p in r._ref_params]
    r.build(peers_per_stage=2)
    r.apply_trace([TraceEvent(0.03, -1), TraceEvent(0.2, +1)])
    m = r.run(until=1e6)
    assert r.step == W_STEPS
    assert m["failures"] == 1 and m["joins"] == 1
    held = [(e[1], e[2], e[3]) for e in r.ledger_log if e[0] == "acc"]
    released = [(e[1], e[2], e[3]) for e in r.ledger_log if e[0] == "rel"]
    assert sorted(set(held)) == sorted(
        (t, s, i) for t in range(W_STEPS) for s in range(3)
        for i in range(t * 2, t * 2 + 2))
    assert len(held) - len(released) == W_STEPS * 3 * (W_GB // W_MB)
    ref = reference_losses(TCFG, r.programs, opt, 0, W_STEPS, W_SEQ, W_MB,
                           W_GB, params=[from_numpy_tree(p, "cpu")
                                         for p in jparams],
                           data_fn=data_fn, device="cpu")
    assert m["loss"] == ref
    np.testing.assert_allclose(m["loss"], want, atol=TRAJ_ATOL, rtol=0)


def test_int8_wire_round_trips_the_float_leaves():
    """On the int8 wire a whisper boundary tree's float leaves (``enc``,
    ``x``) take the blockwise QDQ and ``tok`` passes through, both ways."""
    from repro_torch.runtime.numeric import build_numeric_executors
    from repro_torch.kernels.boundary.ops import int8_roundtrip
    ex = build_numeric_executors(TCFG, 3, W_SEQ, compress="int8",
                                 device="cpu")
    g = torch.Generator().manual_seed(0)
    y = {"x": torch.randn(2, W_SEQ, 64, generator=g),
         "enc": torch.randn(2, 8, 64, generator=g),
         "tok": torch.randint(0, 256, (2, W_SEQ), dtype=torch.int32)}
    for out in (ex[1].wire_fwd(y), ex[2].wire_bwd(
            {k: v for k, v in y.items() if k != "tok"})):
        for k in ("x", "enc"):
            assert torch.equal(out[k], int8_roundtrip(y[k], 64))
            assert not torch.equal(out[k], y[k])
    assert ex[1].wire_fwd(y)["tok"] is y["tok"]


# ------------------------------------------------------------ refusals
@pytest.mark.parametrize("codec", ["bottleneck", "maxout"])
def test_learned_codecs_are_refused_by_both_packages(codec):
    for build, cfg in ((jrt.build_stage_programs, JCFG),
                       (build_stage_programs, TCFG)):
        with pytest.raises(NotImplementedError, match="encoder-decoder"):
            build(cfg, 3, W_SEQ, compress=codec)
    for build, cfg in ((jrt.build_span_program, JCFG),
                       (build_span_program, TCFG)):
        with pytest.raises(NotImplementedError, match="encoder-decoder"):
            build(cfg, 3, W_SEQ, (0, 2), compress=codec)


def test_session_programs_refuse_audio(shared):
    """``full_session_program`` refuses an audio config and names the
    reference's fault: JAX's prefills ``{"tokens": tokens}`` and its
    ``whisper_prefill`` raises ``KeyError: 'audio_embed'``.  Staged
    serving refuses audio in both packages."""
    jp, _, b = shared
    jprog = jprograms.full_session_program(JCFG, TOTAL)
    with pytest.raises(KeyError, match="audio_embed"):
        jprog.prefill(jp, jnp.asarray(b["tokens"]["tok"][:, :PROMPT]))
    with pytest.raises(NotImplementedError, match="audio_embed"):
        tprograms.full_session_program(TCFG, TOTAL)
    with pytest.raises(NotImplementedError, match="LM families"):
        jprograms.build_session_program(JCFG, 2, (0, 1), TOTAL)
    with pytest.raises(NotImplementedError, match="LM families"):
        tprograms.build_session_program(TCFG, 2, (0, 1), TOTAL)


# ------------------------------------------------------------ kernel rule
def test_whisper_attention_calls_meet_the_kernel_rule(monkeypatch):
    """Every flash call of whisper's serving path (a prefill through
    ``make_prefill_step``) and training path (every stage program's
    forward and recompute, with ``lse``), in bf16 at whisper-large-v3's
    head dim 64: a head-dim pair of ``HEAD_DIMS``, q/k/v the bf16 kernel
    reads with 16-byte copies, and the call reaches the kernel wrapper
    ``flash_attention_fwd`` — the encoder's bidirectional self-attention,
    the decoder's causal self-attention and the cross-attention (Sq
    decoder tokens against Sk frames at offset 0).  The plain forward of
    ``models/flash.py`` is called zero times."""
    from repro_torch.kernels.flash_attention import kernel as fk
    cfg = TCFG.with_overrides(d_model=128, n_heads=2, n_kv_heads=2,
                              head_dim=64, encoder_max_len=24,
                              compute_dtype="bfloat16")
    seen, plain = [], []
    orig = fk.flash_attention_fwd

    def recording(q, k, v, causal=True, *args, **kw):
        assert (q.shape[-1], v.shape[-1]) in fk.HEAD_DIMS
        for name, t in (("q", q), ("k", k), ("v", v)):
            assert t.dtype == torch.bfloat16
            assert fk.bf16_layout_problem(t) is None, (
                name, tuple(t.shape), t.stride(), t.storage_offset())
        seen.append((q.shape[1], k.shape[1], bool(causal),
                     bool(kw.get("with_lse", False))))
        return orig(q, k, v, causal, *args, **kw)

    monkeypatch.setattr(fk, "flash_attention_fwd", recording)
    monkeypatch.setattr(tflash, "flash_fwd_ref",
                        lambda *a, **k: plain.append(1) or
                        pytest.fail("plain flash forward called"))
    g = torch.Generator().manual_seed(0)
    audio = torch.randn(2, 24, 128, generator=g).to(torch.bfloat16)
    tok = torch.randint(0, 256, (2, 16), generator=g, dtype=torch.int32)
    from repro_torch.models import params as tP
    params = tP.init(0, TW.whisper_specs(cfg), "cpu")
    with torch.inference_mode():
        tsteps.make_prefill_step(cfg, cache_len=20)(
            params, {"audio_embed": audio, "tokens": tok})
    enc, dec = [(24, 24, False, False)] * 2, [(16, 16, True, False),
                                              (16, 24, False, False)] * 4
    assert seen == enc + dec
    seen.clear()
    progs = build_stage_programs(cfg, 3, 16)
    sp = split_whisper_params(cfg, 3, params)
    x0 = {"audio": audio, "tok": tok}
    x1 = progs[0].fwd(sp[0], x0)
    x2 = progs[1].fwd(sp[1], x1)
    _, gx, _ = progs[2].bwd(sp[2], x2, tok)
    gx, _ = progs[1].bwd(sp[1], x1, gx)
    progs[0].bwd(sp[0], x0, gx)
    pod, half = [(24, 24, False)] * 2, [(16, 16, True), (16, 24, False)] * 2
    fwd = [c + (False,) for c in pod + half]           # stages 0, 1
    rec = [c + (True,) for c in half * 2 + pod]        # stages 2, 1, 0
    assert seen == fwd + rec
    assert not plain
