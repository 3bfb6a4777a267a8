"""The port's training slice against the JAX package on the same numpy
inputs: the flash and RMSNorm backward passes, a stage program's
recompute ``bwd`` per leaf, the optimizers, and ``SwarmRunner`` loss
trajectories against JAX's sequential reference; plus the port's own
churn replay against its fault-free run with an exactly-once ledger.

Weights are JAX's, installed through the converter; batches are JAX's,
handed in through ``data_fn``.  ``tiny_dense_config``'s JAX init puts
attention logits near +-50 (``wq``/``wk`` drawn at std 1/sqrt(n_heads)),
where the softmax saturates and f32 rounding is amplified about a
thousandfold: at that init each package's f32 stage gradients lie up to
2.4e-4 (relative to the leaf's largest entry) from the same function
computed in f64, while the two packages' f64 gradients agree to 1e-13
(``test_stage_bwd_at_jax_init_is_f32_rounding``).  AdamW's sign-like
first step turns such differences into 1e-3 loss differences by step 2.
The other stage-gradient and trajectory tests therefore scale JAX's
``wq`` and ``wk`` by 0.3 (logits near +-5), where f32 rounding is not
amplified and the two packages' f32 gradients agree to 2e-6.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reference_losses as j_reference_losses
from conftest import tiny_dense_config
import repro.runtime as jrt
from repro.core import SwarmConfig as JSwarmConfig
from repro.core import SwarmRunner as JSwarmRunner
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.kernels.rmsnorm.ops import rmsnorm_train as j_rmsnorm_train
from repro.models.flash import flash_attention as j_flash
from repro.optim import adamw as j_adamw, lamb as j_lamb

from repro_torch.core.faults import TraceEvent
from repro_torch.core.swarm import SwarmConfig, SwarmRunner
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.kernels.rmsnorm.ops import rmsnorm_train
from repro_torch.models.config import ArchConfig
from repro_torch.models.flash import flash_attention
from repro_torch.models.params import from_numpy_tree, to_numpy_tree
from repro_torch.optim import adamw, lamb
from repro_torch.runtime import build_stage_programs
from repro_torch.train.reference import reference_losses
from repro_torch.tree import tree_leaves

# one intra-op thread a process: a parallel test run (xdist) gives each
# worker a share of the cores, and torch's default of a thread per core
# oversubscribes them; the spin-waiting threads then slow the small ops of
# the stage and swarm tests about twentyfold (test_torch_async.py: 49 s
# alone, about 1,000 s beside five other workers)
torch.set_num_threads(1)

SEQ, MB, GB, STEPS = 32, 2, 8, 4
TRAJ_ATOL = 2e-4      # the bound of the JAX package's own churn tests
GRAD_RTOL = 1e-5      # f32 gradients, relative to the leaf's largest entry
ATTN_SCALE = 0.3      # see the module docstring
# at JAX's unscaled init: each f32 side's distance from the f64 gradients
# (largest measured: 2.4e-4, JAX's, shared bottleneck), with a 2x margin
INIT_F32_RTOL = 5e-4
F64_RTOL = 1e-10      # the two packages' f64 gradients (measured 1.3e-13)

SHARED_BOTTLENECK = dict(share_groups=2, boundary_compression="bottleneck",
                         bottleneck_dim=16, pipeline_stages=2)
SHARED_MAXOUT = dict(share_groups=2, boundary_compression="maxout",
                     maxout_k=4, pipeline_stages=2, norm="layernorm",
                     act="geglu")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _configs(**kw):
    jcfg = tiny_dense_config(**kw)
    return jcfg, ArchConfig(**{f: getattr(jcfg, f)
                               for f in ArchConfig.__dataclass_fields__})


def _close_rel(got, want, rtol=GRAD_RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, atol=rtol, rtol=0)


def _scaled(tree):
    """JAX stage params (host numpy) with every attention's wq, wk
    scaled by ATTN_SCALE."""
    tree = jax.tree.map(np.array, jax.device_get(tree))
    for blk in tree["blocks"]:
        for key in ("wq", "wk"):
            blk["attn"][key] = blk["attn"][key] * np.float32(ATTN_SCALE)
    return tree


def _jax_batches():
    ds = JSyntheticLM(256, SEQ, MB, seed=17)
    cache = {}

    def data_fn(i):
        if i not in cache:
            cache[i] = {k: np.asarray(v) for k, v in ds.batch(i).items()}
        return cache[i]
    return data_fn


# ------------------------------------------------------- op backwards
FLASH_CASES = [
    # B, Sq, Sk, H, KV, Dq, Dv, causal, window, q_offset, cq, ck
    (2, 40, 40, 4, 2, 16, 16, True, 0, 0, 16, 32),
    (1, 30, 30, 4, 4, 16, 16, True, 12, 0, 8, 8),
    (2, 16, 48, 6, 3, 8, 24, False, 0, 32, 16, 16),
    (1, 12, 36, 2, 1, 16, 16, True, 0, 10, 8, 16),   # q_offset != Sk-Sq
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_bwd_matches_jax_vjp(case):
    B, Sq, Sk, H, KV, Dq, Dv, causal, win, qo, cq, ck = case
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, Sq, H, Dq)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, Dq)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, Dv)).astype(np.float32)
    g = rng.standard_normal((B, Sq, H, Dv)).astype(np.float32)
    kw = dict(causal=causal, window=win, q_offset=qo, chunk_q=cq,
              chunk_k=ck)
    jo, vjp = jax.vjp(lambda a, b, c: j_flash(a, b, c, **kw),
                      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(g))
    ts = [_t(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*ts, **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo),
                               atol=1e-5, rtol=0)
    out.backward(_t(g))
    for t, jg in zip(ts, jgrads):
        _close_rel(t.grad.numpy(), jg)


def test_rms_bwd_matches_jax_vjp():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 5, 64)) * 3).astype(np.float32)
    s = (rng.standard_normal(64) + 1).astype(np.float32)
    g = rng.standard_normal((2, 5, 64)).astype(np.float32)
    jo, vjp = jax.vjp(j_rmsnorm_train, jnp.asarray(x), jnp.asarray(s))
    jgx, jgs = vjp(jnp.asarray(g))
    tx, ts = _t(x).requires_grad_(), _t(s).requires_grad_()
    out = rmsnorm_train(tx, ts)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo),
                               atol=1e-6, rtol=1e-6)
    out.backward(_t(g))
    _close_rel(tx.grad.numpy(), jgx)
    _close_rel(ts.grad.numpy(), jgs)


@pytest.mark.parametrize("name", ["adamw", "lamb"])
def test_optimizer_update_matches_jax(name):
    rng = np.random.default_rng(2)
    p = {"a": rng.standard_normal((3, 4)).astype(np.float32),
         "b": [rng.standard_normal(5).astype(np.float32)]}
    jopt = j_adamw(lr=1e-2) if name == "adamw" else j_lamb(lr=1e-2)
    topt = adamw(lr=1e-2) if name == "adamw" else lamb(lr=1e-2)
    jp, tp = jax.tree.map(jnp.asarray, p), from_numpy_tree(p, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 3)
                         .astype(np.float32), p)
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(from_numpy_tree(g, "cpu"), ts, tp)
        for a, b in zip(jax.tree.leaves(jax.device_get(ju)),
                        tree_leaves(to_numpy_tree(tu))):
            np.testing.assert_allclose(b, a, atol=1e-7, rtol=1e-5)
        jp = jax.tree.map(lambda a, u: a + u, jp, ju)
        tp = from_numpy_tree(jax.device_get(jp), "cpu")
    assert int(ts["count"]) == int(js["count"]) == 3


# ------------------------------------------------------- stage programs
@pytest.mark.parametrize("kw,codec", [
    ({}, "none"),
    (SHARED_BOTTLENECK, "bottleneck"),
    (dict(SHARED_BOTTLENECK, wire_quant=True), "bottleneck"),
    (SHARED_MAXOUT, "maxout"),
], ids=["dense", "shared-bottleneck", "shared-bottleneck-wq",
        "shared-maxout"])
def test_stage_bwd_matches_jax_per_leaf(kw, codec):
    """Each stage's recompute ``bwd`` returns JAX's ``(gx, gp)`` per leaf
    (ALBERT-shared layers re-applied ``reps`` times, learned codec
    params included), from JAX's weights and batch."""
    jcfg, tcfg = _configs(**kw)
    jprogs = jrt.build_stage_programs(jcfg, 2, SEQ, compress=codec)
    tprogs = build_stage_programs(tcfg, 2, SEQ, codec)
    jp = [_scaled(p) for p in jrt.init_stage_params(
        jprogs, jax.random.PRNGKey(0))]
    tp = [from_numpy_tree(p, "cpu") for p in jp]
    for j, t in zip(jp, tp):        # the converter keeps every leaf
        assert [a.shape for a in jax.tree.leaves(j)] == \
            [tuple(a.shape) for a in tree_leaves(t)]
    if codec != "none":        # maxout's sending side owns no params
        assert "boundary" in tp[1]
        assert ("boundary" in tp[0]) == (codec == "bottleneck")
    b = _jax_batches()(0)
    jx = jprogs[0].fwd(jp[0], jnp.asarray(b["tokens"]))
    tx = tprogs[0].fwd(tp[0], torch.as_tensor(b["tokens"]))
    _close_rel(tx.numpy(), jx)
    jl, jgx, jgp1 = jprogs[1].bwd(jp[1], jx, jnp.asarray(b["labels"]))
    tl, tgx, tgp1 = tprogs[1].bwd(tp[1], _t(np.asarray(jx)),
                                  torch.as_tensor(b["labels"]))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    _close_rel(tgx.numpy(), jgx)
    _, jgp0 = jprogs[0].bwd(jp[0], jnp.asarray(b["tokens"]), jgx)
    tgx0, tgp0 = tprogs[0].bwd(tp[0], torch.as_tensor(b["tokens"]),
                               _t(np.asarray(jgx)))
    assert tgx0 is None
    for jg, tg in ((jgp0, tgp0), (jgp1, tgp1)):
        for a, c in zip(jax.tree.leaves(jax.device_get(jg)),
                        tree_leaves(to_numpy_tree(tg))):
            _close_rel(c, a)



class _F64Torch:
    """``torch`` with ``float32`` meaning float64: installed as the
    ``torch`` of the port's stage-path modules, which name every f32
    intermediate ``torch.float32``, it runs their code in f64."""
    float32 = torch.float64

    def __getattr__(self, name):
        return getattr(torch, name)


class _F64Jnp:
    """The same for the JAX package's ``jnp`` (under x64)."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


_PORT_F32_MODULES = (
    "repro_torch.models.layers", "repro_torch.models.flash",
    "repro_torch.models.rope", "repro_torch.models.attention",
    "repro_torch.kernels.flash_attention.ref",
    "repro_torch.kernels.rmsnorm.ops", "repro_torch.kernels.rmsnorm.ref",
    "repro_torch.compression.bottleneck", "repro_torch.runtime.stage_model")
_JAX_F32_MODULES = (
    "repro.models.layers", "repro.models.flash", "repro.models.rope",
    "repro.models.attention", "repro.models.model",
    "repro.kernels.flash_attention.ref", "repro.kernels.rmsnorm.ops",
    "repro.kernels.rmsnorm.ref", "repro.kernels.boundary.ref",
    "repro.compression.bottleneck", "repro.compression.maxout",
    "repro.runtime.stage_model")


def _jax_stage_grads(jprogs, jp, b, x1, g1):
    """Both stages' JAX ``bwd`` parameter gradients (host f64 leaves):
    stage 1 from boundary input ``x1``, stage 0 under cotangent ``g1``."""
    _, _, gp1 = jprogs[1].bwd(jp[1], jnp.asarray(x1),
                              jnp.asarray(b["labels"]))
    _, gp0 = jprogs[0].bwd(jp[0], jnp.asarray(b["tokens"]),
                           jnp.asarray(g1))
    return [np.asarray(a, np.float64) for a in
            jax.tree.leaves(jax.device_get(gp0))
            + jax.tree.leaves(jax.device_get(gp1))]


def _port_stage_grads(tcfg, codec, jp, b, x1, g1):
    """The port's, from the same JAX params and inputs, in the config's
    compute dtype."""
    dt = tcfg.compute_jdtype
    tprogs = build_stage_programs(tcfg, 2, SEQ, codec)
    np_dt = {torch.float32: np.float32, torch.float64: np.float64}[dt]
    tp = [from_numpy_tree(jax.tree.map(lambda a: np.asarray(a, np_dt), p),
                          "cpu") for p in jp]
    _, _, gp1 = tprogs[1].bwd(tp[1], torch.from_numpy(x1).to(dt),
                              torch.as_tensor(b["labels"]))
    _, gp0 = tprogs[0].bwd(tp[0], torch.as_tensor(b["tokens"]),
                           torch.from_numpy(g1).to(dt))
    return [np.asarray(a, np.float64) for a in
            tree_leaves(to_numpy_tree(gp0))
            + tree_leaves(to_numpy_tree(gp1))]


@pytest.mark.parametrize("kw,codec", [
    ({}, "none"), (SHARED_BOTTLENECK, "bottleneck"),
    (SHARED_MAXOUT, "maxout")],
    ids=["dense", "shared-bottleneck", "shared-maxout"])
def test_stage_bwd_at_jax_init_is_f32_rounding(kw, codec, monkeypatch):
    """At JAX's own (unscaled) init, where the two packages' f32 stage
    gradients differ by up to 7e-5 relative, both packages run again in
    f64 from the same params and boundary inputs: their f64 gradients
    agree to F64_RTOL (the same function; an f32 intermediate left in
    either would show at 1e-5, amplified as in f32), and each f32 side
    lies within INIT_F32_RTOL of them.  So the f32 difference is rounding
    in the saturated softmax, not a fault of either side."""
    import dataclasses
    jcfg, tcfg = _configs(**kw)
    jprogs = jrt.build_stage_programs(jcfg, 2, SEQ, compress=codec)
    jp = [jax.tree.map(np.array, jax.device_get(p)) for p in
          jrt.init_stage_params(jprogs, jax.random.PRNGKey(0))]
    b = _jax_batches()(0)
    x1 = np.asarray(jprogs[0].fwd(jp[0], jnp.asarray(b["tokens"])))
    _, g1, _ = jprogs[1].bwd(jp[1], jnp.asarray(x1),
                             jnp.asarray(b["labels"]))
    g1 = np.asarray(g1)
    j32 = _jax_stage_grads(jprogs, jp, b, x1, g1)
    t32 = _port_stage_grads(tcfg, codec, jp, b, x1, g1)
    for m in _PORT_F32_MODULES:
        monkeypatch.setattr(importlib.import_module(m), "torch",
                            _F64Torch())
    for m in _JAX_F32_MODULES:
        monkeypatch.setattr(importlib.import_module(m), "jnp", _F64Jnp())
    f64 = dict(compute_dtype="float64", param_dtype="float64")
    enable_x64 = getattr(jax, "enable_x64", None)
    if enable_x64 is None:                      # jax < 0.5
        from jax.experimental import enable_x64
    with enable_x64(True):
        jp64 = [jax.tree.map(lambda a: np.asarray(a, np.float64), p)
                for p in jp]
        j64 = _jax_stage_grads(
            jrt.build_stage_programs(dataclasses.replace(jcfg, **f64), 2,
                                     SEQ, compress=codec),
            jp64, b, x1.astype(np.float64), g1.astype(np.float64))
    t64 = _port_stage_grads(dataclasses.replace(tcfg, **f64), codec, jp,
                            b, x1, g1)
    monkeypatch.undo()
    assert len(j64) == len(t64) == len(j32) == len(t32)
    for a64, b64, a32, b32 in zip(j64, t64, j32, t32):
        _close_rel(b64, a64, F64_RTOL)
        _close_rel(a32, a64, INIT_F32_RTOL)
        _close_rel(b32, a64, INIT_F32_RTOL)


def test_fold_adds_exactly_in_any_order():
    """A round's f64 accumulator is exact for addends within f64's extra
    exponent range (here eight decades), so the order microbatches fold
    in, and the split across peers, leave no trace."""
    import itertools
    from repro_torch.runtime.base import StageState, fold_into
    rng = np.random.default_rng(3)
    grads = [{"w": _t(rng.standard_normal(500)
                      * 10.0 ** rng.uniform(-4, 4, 500))} for _ in range(4)]
    sums = []
    for order in itertools.permutations(range(4)):
        st = StageState(params={"w": torch.zeros(500)})
        st.reset_progress()
        for i in order:
            fold_into(st, grads[i], None, 1)
        assert st.grad_acc["w"].dtype == torch.float64
        sums.append(st.grad_acc["w"])
    halves = StageState(params={"w": torch.zeros(500)})
    halves.reset_progress()
    fold_into(halves, grads[2], None, 1)
    fold_into(halves, grads[0], None, 1)
    other = StageState(params={"w": torch.zeros(500)})
    other.reset_progress()
    fold_into(other, grads[3], None, 1)
    fold_into(other, grads[1], None, 1)
    sums.append(halves.grad_acc["w"] + other.grad_acc["w"])
    for s in sums[1:]:
        assert torch.equal(s, sums[0])


def test_shared_layer_grads_accumulate_in_f32():
    """The stage core casts a shared layer's f32 weights to bf16 once
    for its ``reps`` applications, yet its weight gradients equal those
    of a cast at every use (JAX's), whose cotangents add in f32."""
    from repro_torch.models.blocks import REGISTRY
    from repro_torch.models import params as P
    from repro_torch.runtime.stage_model import _stage_specs, \
        make_block_core
    _, tcfg = _configs(share_groups=2, compute_dtype="bfloat16",
                       norm="layernorm", act="geglu")
    blocks = P.init(0, _stage_specs(tcfg, 0, 2), "cpu")["blocks"]
    x = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    pos = torch.arange(16)
    g = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(2)
                    ).to(torch.bfloat16)

    def grads(fn):
        leaves = [a.detach().requires_grad_() for a in tree_leaves(blocks)]
        from repro_torch.tree import tree_unflatten_like
        out = fn(tree_unflatten_like(blocks, leaves))
        return torch.autograd.grad(out, leaves, g)

    shared = grads(lambda b: make_block_core(tcfg, [("attn", 1)], 2)(
        [b], [x], [pos])[0])

    def cast_at(sub_key, w):
        return w if sub_key in ("ln1", "ln2") else w.to(torch.bfloat16)

    def per_use(b):
        y = x
        for _ in range(2):
            layer = {k: {n: cast_at(k, w[0]) for n, w in sub.items()}
                     for k, sub in b[0].items()}
            y, _ = REGISTRY["attn"][1](tcfg, layer, y, pos)
        return y
    want = grads(per_use)
    for a, b in zip(shared, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------- trajectories
def _snapshot(jtree, jopt):
    """A JAX-format stage snapshot (host numpy): params + opt state."""
    return {"params": jtree,
            "opt": jax.device_get(jopt.init(jax.tree.map(jnp.asarray,
                                                         jtree))),
            "version": 0}


def _install(runner, snaps):
    """Install per-stage JAX snapshots into every port peer (restore)."""
    for p in runner.peers.values():
        p.executor.restore(p.state, snaps[p.stage])


@pytest.mark.parametrize("kw,codec", [
    ({}, "int8"), (SHARED_BOTTLENECK, "bottleneck"),
    (SHARED_MAXOUT, "maxout")], ids=["dense-int8", "shared-bottleneck",
                                     "shared-maxout"])
def test_swarm_losses_match_jax(kw, codec, monkeypatch):
    """Port ``SwarmRunner`` (2 stages x 2 peers, 3 trainers) from JAX's
    weights and batches against JAX over 4 steps within TRAJ_ATOL.  The
    learned codecs live inside the stage programs, so JAX's sequential
    ``reference_losses`` is the oracle; JAX's reference applies no int8
    wire (its own int8 run differs from it by 2e-2), so the int8 case is
    held against JAX's ``SwarmRunner`` with the int8 wire instead."""
    jcfg, tcfg = _configs(**kw)
    jopt, topt = j_adamw(lr=1e-2, grad_clip=0.0), adamw(lr=1e-2,
                                                        grad_clip=0.0)
    jprogs = jrt.build_stage_programs(jcfg, 2, SEQ, compress=codec)
    jp = [_scaled(p) for p in jrt.init_stage_params(
        jprogs, jax.random.PRNGKey(0))]
    data_fn = _jax_batches()
    if codec == "int8":
        jr = JSwarmRunner(jcfg, JSwarmConfig(
            n_stages=2, microbatch_size=MB, seq_len=SEQ, global_batch=GB,
            n_trainers=3, rebalance_period=0.0, codec="int8",
            max_steps=STEPS), jopt, numeric=True, seed=0,
            programs=jprogs, data_fn=data_fn)
        jr._ref_params = [jax.tree.map(jnp.asarray, p) for p in jp]
        jr.build(peers_per_stage=2)
        want = jr.run(until=1e6)["loss"]
    else:
        monkeypatch.setattr(jrt, "init_stage_params", lambda progs, key: [
            jax.tree.map(jnp.asarray, p) for p in jp])
        want = j_reference_losses(jcfg, jprogs, jopt, 0, STEPS, SEQ, MB,
                                  GB)
    r = SwarmRunner(tcfg, SwarmConfig(
        n_stages=2, microbatch_size=MB, seq_len=SEQ, global_batch=GB,
        n_trainers=3, rebalance_period=0.0, codec=codec,
        max_steps=STEPS), topt, seed=0, data_fn=data_fn, device="cpu")
    r.build(peers_per_stage=2)
    _install(r, [_snapshot(p, jopt) for p in jp])
    got = r.run(until=1e6)["loss"]
    assert r.step == STEPS and len(got) == STEPS
    np.testing.assert_allclose(got, want, atol=TRAJ_ATOL, rtol=0)


def _assert_exactly_once(runner, n_stages, K):
    """Replay the ledger audit trail: a (round, stage, index) pair is
    never held twice, and at each All-Reduce barrier every stage holds
    exactly the round's K indices."""
    held = set()
    for kind, step, stage, idx, attempt, pid in runner.ledger_log:
        key = (step, stage, idx)
        if kind == "acc":
            assert key not in held, (key, attempt, pid)
            held.add(key)
        elif kind == "rel":
            assert key in held, key
            held.discard(key)
        else:
            for s in range(n_stages):
                assert sum(1 for (t, sg, _i) in held
                           if t == step and sg == s) == K, (step, s)


def _port_run(tcfg, codec, trace):
    topt = adamw(lr=1e-2, grad_clip=0.0)
    r = SwarmRunner(tcfg, SwarmConfig(
        n_stages=3, microbatch_size=MB, seq_len=SEQ, global_batch=GB,
        n_trainers=3, rebalance_period=0.0, codec=codec, max_steps=3),
        topt, seed=0, record_accumulation=True, device="cpu")
    for tree in r._ref_params:
        for blk in tree["blocks"]:
            blk["attn"]["wq"].mul_(ATTN_SCALE)
            blk["attn"]["wk"].mul_(ATTN_SCALE)
    r.build(peers_per_stage=2)
    r.apply_trace(trace)
    return r, r.run(until=1e6)


def test_churn_replay_equals_fault_free():
    """Two peers die mid-step and one warm-joins later: the
    ledger admits each (stage, microbatch) exactly once, survivors
    recompute what died, and the losses equal the fault-free run's and
    the staged reference's bit for bit."""
    _, tcfg = _configs(share_groups=3, n_layers=6,
                       boundary_compression="bottleneck", bottleneck_dim=16,
                       wire_quant=True)
    base, m0 = _port_run(tcfg, "bottleneck", [])
    churn, m1 = _port_run(tcfg, "bottleneck",
                          [TraceEvent(0.03, -1), TraceEvent(0.12, -1),
                           TraceEvent(0.25, +1)])
    assert m1["failures"] == 2 and m1["joins"] == 1
    assert m1["recomputed_microbatches"] >= 1
    _assert_exactly_once(churn, 3, GB // MB)
    # bit for bit: a round's gradients add in f64, so neither the
    # peers' split nor the recompute order changes the step
    np.testing.assert_array_equal(m1["loss"], m0["loss"])
    ref = reference_losses(tcfg, base.programs, base.optimizer, 0, 3, SEQ,
                           MB, GB, params=base._ref_params, device="cpu")
    np.testing.assert_array_equal(m0["loss"], ref)


# ------------------------------------------------------- the rest
def test_synthetic_lm_is_deterministic_markov():
    ds = SyntheticLM(256, 16, 3, seed=5)
    a, b = ds.batch(7), ds.batch(7)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], ds.batch(8)["tokens"])
    assert a["tokens"].dtype == torch.int32 and a["tokens"].shape == (3, 16)
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    t = torch.cat([a["tokens"], a["labels"][:, -1:]], 1).long()
    d = (t[:, 2:] - 5 * t[:, 1:-1] - 3 * t[:, :-2]) % 64
    assert ((d >= 0) & (d < 3)).all()          # order-2 markov, noise < 3
