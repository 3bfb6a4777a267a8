"""The port's attention families against the JAX package on shared numpy
inputs: the flash plain version at the new head-dim pairs (120, 256 and
MLA's 192/128) against the Pallas kernel in interpret mode, M-RoPE,
capacity-bounded MoE (outputs, aux loss and drops), MLA with its latent
cache and absorbed decode, the six configs (gemma-2b, qwen1.5-4b,
h2o-danube-3-4b, qwen2-vl-2b, llama4-scout, deepseek-v2) at
``repro.configs.get_reduced`` size through ``lm_prefill`` /
``lm_decode_step`` and ``ServeRunner``, the stage programs of the ``moe``
and ``mla_moe`` kinds, and the M-RoPE stage-program refusal.

Tolerances: f32 results within 1e-5 relative to the tensor's scale
(``TOL``, as ``tests/test_torch_serve.py``: only the summation order
differs); flash at 1e-5 absolute (``tests/test_torch_kernels.py``'s
``FLASH_TOL``); bf16 MoE within ``BF16_TOL`` of the scale (both
packages round each product's bf16 output, in other orders: a few bf16
ulps); tokens and MoE drops exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.kernels.flash_attention.kernel import \
    flash_attention_fwd as j_flash
from repro.models import layers as jL
from repro.models import mla as jmla
from repro.models import model as jm
from repro.models import params as jp
from repro.models import rope as jrope
from repro.runtime.stage_model import build_stage_programs as j_build
from repro.serve.runner import reference_generate as j_reference

from repro_torch.kernels.flash_attention.kernel import \
    flash_attention_fwd as t_flash
from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
from repro_torch.models import config as tconfig
from repro_torch.models import layers as tL
from repro_torch.models import mla as tmla
from repro_torch.models import model as tm
from repro_torch.models import rope as trope
from repro_torch.models.params import from_numpy_tree, to_numpy_tree
from repro_torch.runtime.stage_model import build_stage_programs as t_build
from repro_torch.serve import ServeConfig, ServeRunner
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)   # as tests/test_torch_train.py explains

TOL = 1e-5
FLASH_TOL = 1e-5
BF16_TOL = 2e-2

FAMILIES = ["gemma-2b", "qwen1.5-4b", "h2o-danube-3-4b", "qwen2-vl-2b",
            "llama4-scout-17b-a16e", "deepseek-v2-236b"]


def port_cfg(cfg, **kw):
    """The port's ArchConfig with the same fields (nested MoE / MLA / SSM
    configs as the port's dataclasses)."""
    nested = {"moe": tconfig.MoEConfig, "mla": tconfig.MLAConfig,
              "ssm": tconfig.SSMConfig}
    fields = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name in nested and v is not None:
            v = nested[f.name](**dataclasses.asdict(v))
        fields[f.name] = v
    fields.update(kw)
    return tconfig.ArchConfig(**fields)


def assert_close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err <= tol * max(1.0, float(np.abs(b).max())), err


def _t(a):
    return torch.from_numpy(np.array(a))


def _numpy_init(specs, seed):
    """A numpy tree for a JAX ParamSpec tree, drawn from ``seed`` with the
    JAX package's init rules (zeros, ones, unit-normal embeddings,
    weights at ``scale / sqrt(fan_in)``) in each spec's dtype: the
    weights both packages are handed (JAX's own init compiles one
    program per leaf shape)."""
    rng = np.random.default_rng(seed)

    def one(spec):
        if spec.init in ("zeros", "ones"):
            a = np.full(spec.shape, 1.0 if spec.init == "ones" else 0.0)
        else:
            a = rng.standard_normal(spec.shape)
            if spec.init != "embed":
                fan_in = spec.shape[-2] if len(spec.shape) >= 2 else 1
                a = np.clip(a, -2, 2) * spec.scale / np.sqrt(fan_in)
        return a.astype(np.float32).astype(np.dtype(spec.dtype))
    return jax.tree.map(one, specs,
                        is_leaf=lambda x: isinstance(x, jp.ParamSpec))


def _shared(specs, seed=0):
    """(JAX tree, port tree) of the same numpy weights."""
    host = _numpy_init(specs, seed)
    return jax.tree.map(jnp.asarray, host), from_numpy_tree(host, "cpu")


# ---------------------------------------------------------------- flash
FLASH_CASES = [
    # B, Sq, Sk, H, KV, Dqk, Dv, window: the CUDA kernel's 64-row tile
    # edges at each new head-dim pair
    (1, 65, 65, 2, 1, 120, 120, 0),       # danube's 120: a row past a tile
    (1, 70, 70, 4, 2, 120, 120, 40),      # window straddling key tiles
    (1, 65, 65, 2, 1, 256, 256, 0),       # gemma's 256 (MQA)
    (1, 40, 100, 2, 1, 256, 256, 30),     # query offset 60 + window
    (1, 65, 65, 2, 2, 192, 128, 0),       # MLA: qk 192 against v 128
    (1, 129, 129, 2, 2, 192, 128, 50),    # two tiles and a row, window
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_new_head_dims_match_pallas(case):
    """The plain version the CUDA kernel is held to on the card, with its
    ``lse``, chunked by the kernel's 64-row tiles, at MLA's explicit
    scale, against the Pallas kernel in interpret mode."""
    B, Sq, Sk, H, KV, D, Dv, win = case
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, Sq, H, D), np.float32)
    k = rng.standard_normal((B, Sk, KV, D), np.float32)
    v = rng.standard_normal((B, Sk, KV, Dv), np.float32)
    scale = D ** -0.5 if D == Dv else 192 ** -0.5
    jo, jlse = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       True, win, scale, 64, 64, True, True)
    to, tlse = flash_fwd_ref(_t(q), _t(k), _t(v), True, win, Sk - Sq,
                             64, 64, scale)
    assert to.shape == (B, Sq, H, Dv)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=FLASH_TOL,
                               rtol=0)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse),
                               atol=FLASH_TOL, rtol=0)
    # the kernel wrapper on CPU tensors is the plain version
    wo, wlse = t_flash(_t(q), _t(k), _t(v), True, win, scale, 64, 64,
                       with_lse=True)
    assert torch.equal(wo, to) and torch.equal(wlse, tlse)


# ---------------------------------------------------------------- M-RoPE
@pytest.mark.parametrize("head_dim", [128, 16])
def test_mrope_and_positions_match_jax(head_dim):
    """Qwen2-VL's sections at head dim 128, the 1/4 : 3/8 : 3/8 split
    elsewhere; text-only positions and distinct t/h/w streams."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 3, head_dim), np.float32)
    jpos = np.asarray(jrope.default_mrope_positions(2, 6, 5))
    tpos = trope.default_mrope_positions(2, 6, 5)
    np.testing.assert_array_equal(tpos.numpy(), jpos)
    streams = rng.integers(0, 50, size=(3, 2, 6))
    for pos in (jpos, streams):
        assert_close(trope.apply_mrope(_t(x), _t(pos), 1e6).numpy(),
                     jrope.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                                       1e6))
    cfg = get_reduced("qwen2-vl-2b")
    np.testing.assert_array_equal(
        tm.default_positions(port_cfg(cfg), 2, 6, 3).numpy(),
        np.asarray(jm.default_positions(cfg, 2, 6, 3)))
    assert tm.decode_positions(port_cfg(cfg), 2, 9, "cpu").shape == (3, 2, 1)


# ---------------------------------------------------------------- MoE
def _moe_cfg(top_k, shared, capacity, dtype):
    base = get_reduced("deepseek-v2-236b")
    moe = dataclasses.replace(base.moe, num_experts=8, top_k=top_k,
                              num_shared=shared, d_ff_expert=24,
                              capacity_factor=capacity)
    return base.with_overrides(d_model=32, moe=moe, param_dtype=dtype,
                               compute_dtype=dtype)


# (top_k, shared experts, capacity factor, dtype): each top_k with and
# without a binding capacity (0.5 drops pairs, 4.0 keeps all), with and
# without shared experts, in f32 and bf16
MOE_CASES = [(1, 0, 0.5, "float32"), (1, 1, 4.0, "bfloat16"),
             (2, 1, 0.5, "bfloat16"), (2, 0, 4.0, "float32"),
             (6, 1, 0.5, "float32"), (6, 0, 4.0, "bfloat16")]


@pytest.mark.parametrize("top_k,shared,capacity,dtype", MOE_CASES)
def test_moe_matches_jax(top_k, shared, capacity, dtype):
    """Output and aux loss against JAX's ``apply_moe``; capacity 0.5
    binds (pairs dropped), 4.0 does not.  The router stays f32 in a bf16
    tree."""
    cfg = _moe_cfg(top_k, shared, capacity, dtype)
    tcfg = port_cfg(cfg)
    jparams, tparams = _shared(jL.moe_specs(cfg), 1)
    assert tparams["router"].dtype == torch.float32
    x = np.random.default_rng(5).standard_normal((2, 12, 32), np.float32)
    jx = jnp.asarray(x).astype(cfg.compute_jdtype)
    tx = _t(x).to(tcfg.compute_jdtype)
    jy, jaux = jax.jit(functools.partial(jL.apply_moe, cfg))(jparams, jx)
    ty, taux = tL.apply_moe(tcfg, tparams, tx)
    assert ty.dtype == tx.dtype
    tol = TOL if dtype == "float32" else BF16_TOL
    assert_close(ty.float().numpy(), np.asarray(jy.astype(jnp.float32)), tol)
    assert_close(float(taux), float(jaux), TOL)
    # the drops: a binding capacity leaves some (token, choice) pairs out
    T, E = 24, 8
    C = max(1, int(capacity * T * top_k / E))
    probs = torch.softmax(tx.reshape(T, -1).float() @ tparams["router"], -1)
    counts = torch.bincount(tL._top_k(probs, top_k)[1].reshape(-1),
                            minlength=E)
    assert bool((counts > C).any()) == (capacity < 1.0)


def test_moe_top_k_takes_the_lower_index_on_ties():
    probs = torch.tensor([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25]])
    jw, jsel = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    tw, tsel = tL._top_k(probs, 2)
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


# ---------------------------------------------------------------- MLA
@pytest.mark.parametrize("q_lora", [0, 24])
def test_mla_prefill_cache_and_absorbed_decode_match_jax(q_lora):
    base = get_reduced("deepseek-v2-236b")
    cfg = base.with_overrides(mla=dataclasses.replace(base.mla,
                                                      q_lora_rank=q_lora))
    tcfg = port_cfg(cfg)
    jparams, tparams = _shared(jmla.mla_specs(cfg), 2)
    S, total = 7, 10
    x = np.random.default_rng(6).standard_normal((2, S + 2, cfg.d_model),
                                                 np.float32)
    pos = np.arange(S)
    jy, (jc, jr) = jax.jit(functools.partial(
        jmla.apply_mla, cfg, return_cache=True))(
            jparams, jnp.asarray(x[:, :S]), jnp.asarray(pos))
    ty, (tc, tr) = tmla.apply_mla(tcfg, tparams, _t(x[:, :S]), _t(pos),
                                  return_cache=True)
    for a, b in ((ty, jy), (tc, jc), (tr, jr)):
        assert_close(a.numpy(), b)
    jcache = {"c_kv": jL.ring_place(jc, total),
              "k_rope": jL.ring_place(jr, total)}
    tcache = {"c_kv": tL.ring_place(tc, total),
              "k_rope": tL.ring_place(tr, total)}
    j_decode = jax.jit(functools.partial(jmla.apply_mla_decode, cfg))
    for step in range(2):
        p = S + step
        xt = x[:, p:p + 1]
        jy, jcache = j_decode(jparams, jnp.asarray(xt), jcache,
                              jnp.int32(p), jnp.full((2, 1), p))
        ty, tcache = tmla.apply_mla_decode(
            tcfg, tparams, _t(xt), tcache, p,
            torch.full((2, 1), p, dtype=torch.int64))
        assert_close(ty.numpy(), jy)
        for key in ("c_kv", "k_rope"):
            assert_close(tcache[key].numpy(), jcache[key])


# ------------------------------------------------------- six configs
S, NEW = 8, 4


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_model_and_serving_match_jax(arch):
    """``lm_prefill`` / ``lm_decode_step`` logits and every cache leaf,
    then ``ServeRunner`` over two stages (one decode chain (0,1) -> (1,2),
    two requests a session) token for token against JAX's
    ``reference_generate`` on the same weights, one reference call per
    session batch (MoE capacity couples a batch's rows)."""
    cfg = get_reduced(arch)
    tcfg = port_cfg(cfg)
    jparams, tparams = _shared(jm.lm_specs(cfg))
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32)
    total = S + 2
    jl, jc = jax.jit(functools.partial(jm.lm_prefill, cfg, cache_len=total))(
        jparams, jnp.asarray(toks))
    with torch.inference_mode():
        tl, tc = tm.lm_prefill(tcfg, tparams, torch.as_tensor(toks),
                               cache_len=total)
    assert_close(tl.numpy(), jl)
    jleaves = jax.tree.leaves(jax.device_get(jc))
    tleaves = tree_leaves(to_numpy_tree(tc))
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        assert_close(a, b)
    tok = np.argmax(np.asarray(jl)[:, -1:], -1).astype(np.int32)
    j_decode = jax.jit(functools.partial(jm.lm_decode_step, cfg))
    for step in range(2):
        jl, jc = j_decode(jparams, jnp.asarray(tok), jc, jnp.int32(S + step))
        with torch.inference_mode():
            tl, tc = tm.lm_decode_step(tcfg, tparams, torch.as_tensor(tok),
                                       tc, S + step)
        assert_close(tl.numpy(), jl)
        for a, b in zip(tree_leaves(to_numpy_tree(tc)),
                        jax.tree.leaves(jax.device_get(jc))):
            assert_close(a, b)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)

    r = ServeRunner(tcfg, ServeConfig(n_stages=2, max_batch=2,
                                      max_sessions=1),
                    params=tparams, device="cpu")
    r.add_peer((0, 1), pool="decode", name="d0")
    r.add_peer((1, 2), pool="decode", name="d1")
    prompts = np.random.default_rng(8).integers(0, cfg.vocab_size, (4, S))
    reqs = [r.submit(p, NEW) for p in prompts]
    summary = r.run()
    assert summary["completed"] == 4 and summary["failed"] == 0
    ref = np.concatenate([j_reference(cfg, jparams, prompts[i:i + 2], NEW)
                          for i in (0, 2)])
    np.testing.assert_array_equal(np.stack([q.tokens for q in reqs]), ref)


# ------------------------------------------------------- stage programs
@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e",
                                  "deepseek-v2-236b"])
def test_moe_stage_programs_match_jax(arch):
    """A two-stage split of the ``moe`` and ``mla_moe`` kinds: stage 0's
    ``fwd`` (the boundary tensor), stage 1's ``fwd`` and ``bwd`` (the
    loss, the boundary's cotangent ``gx`` and every parameter gradient
    ``gp``: attention, the routed and shared experts and the f32
    router)."""
    cfg = get_reduced(arch)
    tcfg = port_cfg(cfg)
    jprogs, tprogs = j_build(cfg, 2, S), t_build(tcfg, 2, S)
    jps, tps = zip(*[_shared(p.specs, 10 + s)
                     for s, p in enumerate(jprogs)])
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    jx = jprogs[0].fwd(jps[0], jnp.asarray(toks))
    tx = tprogs[0].fwd(tps[0], torch.as_tensor(toks))
    assert_close(tx.numpy(), jx)
    wire = np.asarray(jx)                 # both get the same boundary
    tloss = tprogs[1].fwd(tps[1], _t(wire), torch.as_tensor(labels))
    jl, jgx, jgp1 = jprogs[1].bwd(jps[1], jnp.asarray(wire),
                                  jnp.asarray(labels))
    tl, tgx, tgp1 = tprogs[1].bwd(tps[1], _t(wire), torch.as_tensor(labels))
    assert_close(float(tl), float(jl))
    assert float(tloss) == float(tl)      # fwd and the bwd's recompute
    assert_close(tgx.numpy(), jgx)
    tleaves = tree_leaves(to_numpy_tree(tgp1))
    jleaves = jax.tree.leaves(jax.device_get(jgp1))
    assert len(tleaves) == len(jleaves)
    for a, b in zip(tleaves, jleaves):
        assert_close(a, b)


def test_mrope_stage_programs_refuse_as_the_reference_faults():
    """JAX's stage programs hand ``apply_mrope`` 1-D positions and raise;
    the port's refuse with an error that names that fault, rather than
    compute what the reference cannot."""
    cfg = get_reduced("qwen2-vl-2b")
    jprog = j_build(cfg, 2, S)[0]
    toks = np.zeros((1, S), np.int32)
    with pytest.raises(IndexError):
        jprog.fwd(_shared(jprog.specs)[0], jnp.asarray(toks))
    tprog = t_build(port_cfg(cfg), 2, S)[0]
    from repro_torch.models import params as tP
    tparams = tP.init(0, tprog.specs, "cpu")
    for call in (lambda: tprog.fwd(tparams, torch.as_tensor(toks)),
                 lambda: tprog.bwd(tparams, torch.as_tensor(toks),
                                   torch.zeros(1, S, cfg.d_model))):
        with pytest.raises(NotImplementedError, match="M-RoPE"):
            call()
