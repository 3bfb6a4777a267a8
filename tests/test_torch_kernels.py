"""The port's kernels, held against the JAX package's Pallas kernels
(interpret mode) and jnp oracles on the same numpy inputs.

On the CPU every wrapper of ``repro_torch.kernels`` runs its plain
PyTorch version, so these tests pin the arithmetic the CUDA kernels are
compared with on the card (``chip_smoke.py`` and the ``cuda``-marked
tests of ``tests/test_torch_cuda.py`` run the kernels themselves).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compression import quant8 as jq8
from repro.kernels.boundary import kernel as jbk
from repro.kernels.quant8 import kernel as jq8k
from repro.kernels.quant8 import ops as jq8ops
from repro.kernels.flash_attention.kernel import \
    flash_attention_fwd as j_flash
from repro.kernels.flash_attention.ref import attention_ref as j_attn_ref
from repro.kernels.rmsnorm.kernel import rmsnorm as j_rmsnorm
from repro.kernels.rmsnorm.ref import rmsnorm_ref as j_rmsnorm_ref
from repro.compression import codecs as jcodecs
from repro.models import attention as j_attention
from repro.models import flash as j_flash_lib

from repro_torch import kernels
from repro_torch.compression import quant8 as tq8
from repro_torch.kernels.boundary import kernel as tbk
from repro_torch.kernels.boundary.ref import qdq_ref
from repro_torch.kernels.quant8 import kernel as tq8k
from repro_torch.kernels.quant8 import ops as tq8ops
from repro_torch.kernels.flash_attention.kernel import \
    flash_attention_fwd as t_flash
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     flash_fwd_ref)
from repro_torch.kernels.rmsnorm import kernel as t_rms_kernel
from repro_torch.kernels.rmsnorm.kernel import rmsnorm as t_rmsnorm
from repro_torch.compression import codecs as tcodecs
from repro_torch.models import attention as t_attention
from repro_torch.models import flash as t_flash_lib

torch.set_num_threads(1)   # as tests/test_torch_train.py explains

FLASH_TOL = 1e-5      # f32, the bound of tests/test_kernels.py's oracle sweep
RMS_TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


FLASH_CASES = [
    # B, Sq, Sk, H, KV, D, causal, window, bq, bk
    (1, 64, 64, 4, 2, 16, True, 0, 32, 32),        # GQA, two tiles
    (2, 40, 40, 4, 4, 32, True, 0, 16, 32),        # ragged Sq/Sk vs tiles
    (1, 48, 48, 4, 1, 16, True, 12, 16, 16),       # MQA + sliding window
    (1, 24, 56, 4, 2, 16, True, 0, 16, 32),        # query offset Sk - Sq
    (1, 32, 48, 2, 2, 16, False, 0, 32, 32),       # bidirectional
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_pallas_and_oracle(case):
    B, Sq, Sk, H, KV, D, causal, win, bq, bk = case
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, Sq, H, D), np.float32)
    k = rng.standard_normal((B, Sk, KV, D), np.float32)
    v = rng.standard_normal((B, Sk, KV, D), np.float32)
    jo, jlse = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal, win, None, bq, bk, True, True)
    jref = j_attn_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal, window=win)
    to, tlse = flash_fwd_ref(_t(q), _t(k), _t(v), causal, win, Sk - Sq,
                             bq, bk)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=FLASH_TOL,
                               rtol=0)
    np.testing.assert_allclose(to.numpy(), np.asarray(jref),
                               atol=FLASH_TOL, rtol=0)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse),
                               atol=FLASH_TOL, rtol=0)
    # the kernel wrapper on CPU tensors is the plain version
    wo, wlse = t_flash(_t(q), _t(k), _t(v), causal, win, None, bq, bk,
                       with_lse=True)
    assert torch.equal(wo, to) and torch.equal(wlse, tlse)
    np.testing.assert_allclose(
        attention_ref(_t(q), _t(k), _t(v), causal=causal,
                      window=win).numpy(), np.asarray(jref),
        atol=FLASH_TOL, rtol=0)


FLASH_EDGE_CASES = [
    # B, Sq, Sk, H, KV, D, causal, window: edges of the CUDA kernel's
    # 64-row query and key tiles, which the plain version is chunked by
    (1, 1, 1, 2, 1, 16, True, 0),           # one query, one key
    (1, 63, 63, 2, 2, 16, True, 0),         # one row short of a tile
    (1, 65, 65, 2, 2, 16, True, 0),         # one row past a tile
    (1, 129, 129, 2, 1, 16, True, 0),       # two tiles and a row
    (1, 40, 100, 2, 1, 16, True, 0),        # offset 60: causal edge on key tile 0|1
    (1, 130, 130, 2, 2, 16, True, 70),      # window straddling two key tiles
    (1, 65, 65, 8, 1, 16, True, 0),         # G = 8 query heads per KV head
    (1, 1, 150, 8, 1, 32, True, 0),         # one query at offset 149, G = 8
]


@pytest.mark.parametrize("case", FLASH_EDGE_CASES)
def test_flash_plain_lse_at_tile_edges_matches_pallas(case):
    """The plain version the CUDA kernel is held to on the card, with its
    ``lse``, at the kernel's tile edges, chunked by its 64-row tiles,
    against the Pallas kernel in interpret mode and the oracle."""
    B, Sq, Sk, H, KV, D, causal, win = case
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, Sq, H, D), np.float32)
    k = rng.standard_normal((B, Sk, KV, D), np.float32)
    v = rng.standard_normal((B, Sk, KV, D), np.float32)
    jo, jlse = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal, win, None, 64, 64, True, True)
    jref = j_attn_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal, window=win)
    to, tlse = flash_fwd_ref(_t(q), _t(k), _t(v), causal, win, Sk - Sq,
                             64, 64)
    assert tlse.shape == (B, KV, H // KV, Sq)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=FLASH_TOL,
                               rtol=0)
    np.testing.assert_allclose(to.numpy(), np.asarray(jref),
                               atol=FLASH_TOL, rtol=0)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse),
                               atol=FLASH_TOL, rtol=0)


def _tiny_serving_cfg(**kw):
    from repro_torch.models.config import ArchConfig
    base = dict(name="tiny-layout", family="dense", n_layers=4, d_model=128,
                n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
                vocab_size=128, compute_dtype="bfloat16",
                param_dtype="float32")
    base.update(kw)
    return ArchConfig(**base)


def test_model_attention_calls_meet_the_bf16_kernel_layout(monkeypatch):
    """Every flash call of the serving path (a ServeRunner's prefills) and
    of the training path (a stage program's forward and its recompute
    with ``lse``) passes q, k, v whose storage offsets and batch, seq and
    head strides the bf16 tensor-core kernel takes (16-byte copies); on
    the card the wrapper raises otherwise.  The layout is checked on CPU
    tensors made by the same code."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.runtime import build_stage_programs, init_stage_params
    from repro_torch.serve import ServeConfig, ServeRunner
    seen = []
    orig = fk.flash_attention_fwd

    def recording(q, k, v, *args, **kw):
        for name, t in (("q", q), ("k", k), ("v", v)):
            assert fk.bf16_layout_problem(t) is None, (
                name, tuple(t.shape), t.stride(), t.storage_offset())
        seen.append(bool(kw.get("with_lse", False)))
        return orig(q, k, v, *args, **kw)

    monkeypatch.setattr(fk, "flash_attention_fwd", recording)
    r = ServeRunner(_tiny_serving_cfg(), ServeConfig(n_stages=4, max_batch=2,
                                                     max_sessions=2),
                    seed=0, device="cpu")
    r.build_pools(n_prefill=2, n_decode=2)
    for p in np.random.default_rng(0).integers(0, 128, size=(2, 24)):
        r.submit(p, 2)
    assert r.run()["completed"] == 2
    assert seen and not any(seen)                 # prefills, no lse
    n_serve = len(seen)
    cfg = _tiny_serving_cfg(n_layers=6, n_kv_heads=4, share_groups=3,
                            norm="layernorm", act="geglu",
                            boundary_compression="bottleneck",
                            bottleneck_dim=64, pipeline_stages=3)
    progs = build_stage_programs(cfg, 3, 64)
    params = init_stage_params(progs, 0, device="cpu")
    g = torch.Generator().manual_seed(0)
    tok = torch.randint(0, 128, (2, 64), generator=g)
    x1 = progs[0].fwd(params[0], tok)
    x2 = progs[1].fwd(params[1], x1)
    _, gx, _ = progs[2].bwd(params[2], x2, tok)
    gx, _ = progs[1].bwd(params[1], x1, gx)
    progs[0].bwd(params[0], tok, gx)
    train = seen[n_serve:]
    assert any(train) and not all(train)          # forwards and recomputes


FAMILY_ARCHS = ["gemma-2b", "qwen1.5-4b", "h2o-danube-3-4b", "qwen2-vl-2b",
                "llama4-scout-17b-a16e", "deepseek-v2-236b", "hymba-1.5b"]


def _family_serving_cfg(arch):
    """``repro.configs.get_reduced(arch)`` as the port's config, in bf16,
    with the full config's head dims (``head_dim``: 120 for danube, 256
    for gemma, 64 for hymba; MLA's qk nope/rope and v dims, 128 + 64
    against 128) and parameter dtype (bf16 for llama4-scout and
    deepseek-v2)."""
    import dataclasses
    from repro.configs import get_config, get_reduced
    from repro_torch.models import config as tconfig
    full, cfg = get_config(arch), get_reduced(arch)
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw.update(head_dim=full.head_dim, compute_dtype="bfloat16",
              param_dtype=full.param_dtype)
    if cfg.moe is not None:
        kw["moe"] = tconfig.MoEConfig(**dataclasses.asdict(cfg.moe))
    if cfg.mla is not None:
        kw["mla"] = tconfig.MLAConfig(**dict(
            dataclasses.asdict(full.mla), kv_lora_rank=32, q_lora_rank=0))
    if cfg.ssm is not None:
        kw["ssm"] = tconfig.SSMConfig(**dataclasses.asdict(cfg.ssm))
    return tconfig.ArchConfig(**kw)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_attention_calls_meet_the_kernel_rule(arch, monkeypatch):
    """Every flash call of each attention family's serving path (a
    two-stage ServeRunner's prefills, at the full config's head dims)
    meets the CUDA kernel's rule: a head-dim pair of ``HEAD_DIMS`` (q
    and k equal) and q, k, v the bf16 kernel reads with 16-byte copies;
    every rmsnorm call passes the f32 scale the kernel takes, also from
    a bf16 tree.  On the card the wrappers raise otherwise; here the
    tensors come from the same code on the CPU."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.serve import ServeConfig, ServeRunner
    cfg = _family_serving_cfg(arch)
    seen = []
    orig = fk.flash_attention_fwd

    def recording(q, k, v, *args, **kw):
        assert k.shape[-1] == q.shape[-1]
        assert (q.shape[-1], v.shape[-1]) in fk.HEAD_DIMS, (
            q.shape, v.shape)
        for name, t in (("q", q), ("k", k), ("v", v)):
            assert t.dtype == torch.bfloat16
            assert fk.bf16_layout_problem(t) is None, (
                name, tuple(t.shape), t.stride(), t.storage_offset())
        seen.append((q.shape[-1], v.shape[-1]))
        return orig(q, k, v, *args, **kw)

    norm_scales = []
    orig_rms = rops.rmsnorm

    def rms_recording(x, scale, *args, **kw):
        norm_scales.append(scale.dtype)
        return orig_rms(x, scale, *args, **kw)

    monkeypatch.setattr(fk, "flash_attention_fwd", recording)
    monkeypatch.setattr(rops, "rmsnorm", rms_recording)
    r = ServeRunner(cfg, ServeConfig(n_stages=2, max_batch=2,
                                     max_sessions=1), seed=0, device="cpu")
    r.add_peer((0, 1), pool="decode")
    r.add_peer((1, 2), pool="decode")
    for p in np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               size=(2, 24)):
        r.submit(p, 2)
    assert r.run()["completed"] == 2
    want = ((192, 128) if cfg.mla is not None
            else (cfg.head_dim, cfg.head_dim))
    assert seen == [want] * cfg.n_layers       # one prefill, every layer
    assert norm_scales and set(norm_scales) == {torch.float32}


def test_vector_layout_rule_on_cpu_tensors():
    """The rule the 16-byte vector kernels (qdq_flat, the codec's row
    passes) are refused by on the card, as a pure predicate of the
    tensor and the pass: a 16-byte-aligned start; rows of a width that is
    a multiple of 8 elements, at most 32768; a maxout pool of 1, 2, 4 or
    8; qb a multiple of 8 where blocks are asked for."""
    rule = tbk.vector_layout_problem
    flat = torch.zeros(8 + 4096, dtype=torch.bfloat16)
    assert flat.data_ptr() % 16 == 0
    assert rule(flat) is None and rule(flat[8:]) is None
    assert "2 bytes past a 16-byte" in rule(flat[1:])
    assert "8 bytes past a 16-byte" in rule(flat[4:])
    assert "4 bytes past a 16-byte" in rule(torch.zeros(9)[1:])
    assert rule(torch.zeros(9)[4:]) is None           # f32: 4 elements
    codes = torch.zeros(24, dtype=torch.int8)
    assert rule(codes[16:]) is None and "8 bytes" in rule(codes[8:])
    x = torch.zeros(3, 4096, dtype=torch.bfloat16)
    assert rule(x, 4096) is None
    assert rule(x, 4096, 2, 64) is None and rule(x, 4096, 8, 8) is None
    assert rule(x, 4096, 1, 0) is None                # no blocks: any qb
    assert "width 12" in rule(torch.zeros(2, 12), 12)
    assert "width 32776" in rule(torch.zeros(1, 32776), 32776)
    assert rule(torch.zeros(1, 32768), 32768) is None
    assert "width 0" in rule(torch.zeros(1, 0), 0)
    assert "k=3" in rule(torch.zeros(2, 96), 96, 3)
    assert "k=16" in rule(torch.zeros(2, 96), 96, 16)
    assert "qb=12" in rule(torch.zeros(2, 96), 96, 1, 12)
    assert "qb=4" in rule(torch.zeros(2, 96), 96, 2, 4)
    assert rule(torch.zeros(2, 96), 96, 1, 24) is None  # multiple of 8
    # the alignment of a view comes first
    assert "bytes past" in rule(flat[1:4097].view(4, 1024), 1024)


@pytest.mark.parametrize("mode", ["bottleneck", "maxout"])
def test_model_codec_calls_meet_the_vector_layout(monkeypatch, mode):
    """Every qdq_flat / encode / decode / encode_quantize call of the
    serving path with the int8 wire (a ServeRunner's prefills and decode
    steps) and of the training path with ``wire_quant`` (a stage
    program's forward and its recompute backward, the cotangent QDQ
    included) passes tensors and a pass that the vector kernels take, as
    the wrappers would hand them to the card: no model path makes an
    ``encode_quantize`` call, so it is called through the ops entry point
    a transport would use, on the boundary state of stage 0.  The rule
    is checked on CPU tensors made by the same code."""
    from repro_torch.kernels.boundary import ops as tops
    from repro_torch.kernels.boundary import ref as tref
    from repro_torch.runtime import build_stage_programs, init_stage_params
    from repro_torch.serve import ServeConfig, ServeRunner
    seen = {"qdq_flat": 0, "encode": 0, "decode": 0, "encode_quantize": 0}
    orig = {k: getattr(tbk, k) for k in seen}

    def rows(t):
        return t.reshape(-1, t.shape[-1]).contiguous()

    def check(name, t, width=None, k=1, qb=0):
        problem = tbk.vector_layout_problem(t, width, k, qb)
        assert problem is None, (name, tuple(t.shape), t.stride(),
                                 t.storage_offset(), problem)

    def qdq_flat(x, block, *args, **kw):
        check("qdq_flat", x)
        seen["qdq_flat"] += 1
        return orig["qdq_flat"](x, block, *args, **kw)

    def encode(x, w, mode_, k, qb, quantize):
        d, q = x.shape[-1], qb if quantize else 0
        check("encode", rows(x), d, k if mode_ == "maxout" else 1, 0
              if mode_ == "bottleneck" else q)
        if mode_ == "bottleneck":
            check("encode's second pass", rows(x), w.shape[1], 1, q)
        seen["encode"] += 1
        return orig["encode"](x, w, mode_, k, qb, quantize)

    def decode(z, w, mode_):
        check("decode", rows(z), z.shape[-1] if mode_ == "maxout" else None)
        seen["decode"] += 1
        return orig["decode"](z, w, mode_)

    def encode_quantize(x, w, mode_, k, qb):
        check("encode_quantize", rows(x), x.shape[-1],
              k if mode_ == "maxout" else 1, 0 if mode_ == "bottleneck"
              else qb)
        if mode_ == "bottleneck":
            check("encode_quantize's codes pass", rows(x), w.shape[1], 1,
                  qb)
        seen["encode_quantize"] += 1
        return orig["encode_quantize"](x, w, mode_, k, qb)

    for name, fn in (("qdq_flat", qdq_flat), ("encode", encode),
                     ("decode", decode),
                     ("encode_quantize", encode_quantize)):
        monkeypatch.setattr(tbk, name, fn)
    r = ServeRunner(_tiny_serving_cfg(), ServeConfig(
        n_stages=4, max_batch=2, max_sessions=2, codec="int8"),
        seed=0, device="cpu")
    r.build_pools(n_prefill=2, n_decode=2)
    for p in np.random.default_rng(0).integers(0, 128, size=(2, 24)):
        r.submit(p, 3)
    assert r.run()["completed"] == 2
    assert seen["qdq_flat"] > 0                   # the int8 wire
    n_serve = seen["qdq_flat"]
    cfg = _tiny_serving_cfg(n_layers=6, n_kv_heads=4, share_groups=3,
                            norm="layernorm", act="geglu",
                            boundary_compression=mode, bottleneck_dim=64,
                            maxout_k=2, pipeline_stages=3, wire_quant=True)
    progs = build_stage_programs(cfg, 3, 64)
    params = init_stage_params(progs, 0, device="cpu")
    g = torch.Generator().manual_seed(0)
    tok = torch.randint(0, 128, (2, 64), generator=g)
    x1 = progs[0].fwd(params[0], tok)
    x2 = progs[1].fwd(params[1], x1)
    _, gx, _ = progs[2].bwd(params[2], x2, tok)
    gx, _ = progs[1].bwd(params[1], x1, gx)
    progs[0].bwd(params[0], tok, gx)
    # stages 0 and 1 encode in the forward and again in the recompute of
    # their backward; stages 1 and 2 decode in theirs, stage 1 once more
    # in the forward; each sender's backward QDQs its cotangent
    assert seen["encode"] == 4 and seen["decode"] == 3
    assert seen["qdq_flat"] - n_serve == 2
    assert seen["encode_quantize"] == 0
    h = progs[0].fwd(params[0], tok)              # stage 0's wire state
    w_c = params[0]["boundary"].get("w_c") if mode == "bottleneck" else None
    k = 1 if mode == "bottleneck" else 2
    c = h.shape[-1]
    tops.encode_quantize(torch.randn(2, 64, 128), w_c, mode, k,
                         tref.wire_qblock(c))
    assert seen["encode_quantize"] == 1


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("q_offset", [None, 3])
def test_flash_router_matches_jax(impl, q_offset):
    """The router keeps the JAX rule: kernel only at q_offset == Sk - Sq
    and no soft-cap; every other call is the chunked plain path."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 20, 4, 16), np.float32)
    k = rng.standard_normal((2, 36, 2, 16), np.float32)
    v = rng.standard_normal((2, 36, 2, 16), np.float32)
    off = 36 - 20 if q_offset is None else q_offset
    jo = j_flash_lib.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=off,
        chunk_q=8, chunk_k=16, impl=impl)
    to = t_flash_lib.flash_attention(_t(q), _t(k), _t(v), q_offset=off,
                                     chunk_q=8, chunk_k=16, impl=impl)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=FLASH_TOL,
                               rtol=0)


@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("window", [0, 6])
def test_naive_attention_matches_jax(window, softcap):
    """The test oracle itself: GQA, a query offset, window and soft-cap."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 12, 4, 16), np.float32)
    k = rng.standard_normal((2, 20, 2, 16), np.float32)
    v = rng.standard_normal((2, 20, 2, 16), np.float32)
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=8)
    jo = j_attention.naive_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), **kw)
    to = t_attention.naive_attention(_t(q), _t(k), _t(v), **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=FLASH_TOL,
                               rtol=0)


@pytest.mark.parametrize("shape", [(4, 128), (2, 3, 64), (1, 256),
                                   # the families' widths, and widths
                                   # that are (1000) and are not (1001)
                                   # a whole number of 16-byte vectors
                                   (8, 1536), (8, 1600), (4, 5120),
                                   (3, 1000), (3, 1001)])
def test_rmsnorm_plain_matches_pallas_and_oracle(shape):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    s = (rng.standard_normal(shape[-1]) + 1.0).astype(np.float32)
    jp = np.asarray(j_rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-6, True))
    jr = np.asarray(j_rmsnorm_ref(jnp.asarray(x), jnp.asarray(s)))
    t = t_rmsnorm(_t(x), _t(s)).numpy()
    np.testing.assert_allclose(t, jp, atol=RMS_TOL, rtol=RMS_TOL)
    np.testing.assert_allclose(t, jr, atol=RMS_TOL, rtol=RMS_TOL)


# rmsnorm_rows_kernel's instantiations in csrc/rmsnorm.cu: (vectors a
# lane, warps a row)
RMS_INSTANTIATED = {(nv, 4) for nv in range(1, 9)} | {
    (nv, 8) for nv in range(5, 9)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rmsnorm_plan_takes_the_register_path_at_every_config(dtype):
    """Every registered RMSNorm width takes the register path: 4 warps a
    row, 8 where 4 would need more than 8 vectors a lane."""
    from repro_torch.configs import REGISTRY
    widths = {c.d_model for c in REGISTRY.values() if c.norm == "rmsnorm"}
    assert widths == {1536, 1600, 2048, 2560, 3840, 4096, 5120}
    per = 16 // dtype.itemsize
    for d in sorted(widths):
        plan = t_rms_kernel._plan(d, dtype, True)
        assert plan.path == "registers", (d, plan)
        assert (plan.vectors, plan.warps) in RMS_INSTANTIATED
        assert plan.vectors * 32 * plan.warps * per >= d
        assert (plan.vectors - 1) * 32 * plan.warps * per < d
        assert plan.warps == 4 or -(-d // (4 * 32 * per)) > 8


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rmsnorm_plan_general_path_and_instantiations(dtype):
    """Odd widths, unaligned starts and rows past 8 warps of 8 vectors
    take the general path; every other width's plan is one the kernel
    instantiates, and the choice is cached by its arguments."""
    per = 16 // dtype.itemsize
    most = 8 * 32 * 8 * per
    for d in (1, 7, 1001, 1536 + 2, most + per):
        assert t_rms_kernel._plan(d, dtype, True).path == "general", d
    for d in (1536, 1600, 4096):
        assert t_rms_kernel._plan(d, dtype, False) == (0, 0)
    for d in range(per, most + 1, per):
        plan = t_rms_kernel._plan(d, dtype, True)
        assert (plan.vectors, plan.warps) in RMS_INSTANTIATED, (d, plan)
    assert t_rms_kernel._plan(1600, dtype, True) is \
        t_rms_kernel._plan(1600, dtype, True)
    x = torch.zeros(4 * 1600 + 1, dtype=dtype)
    s = torch.ones(1600)
    assert t_rms_kernel.plan_for(x[:-1].view(4, 1600), s).path == "registers"
    assert t_rms_kernel.plan_for(x[1:].view(4, 1600), s).path == "general"


def _tie_input(n, dtype):
    """Flat input whose blocks hit exact .5 ties on the code grid: with a
    block absmax of 127, x / 127 * 127 == x, so x = k + 0.5 rounds half
    to even; the tail block is partial (zero-padded)."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(n) * 4).astype(np.float32)
    ties = np.arange(-31, 32, dtype=np.float32) + np.float32(0.5)
    x[:63] = ties
    x[63] = 127.0
    return x.astype(dtype)


@pytest.mark.parametrize("n", [64 * 5, 64 * 3 + 37])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qdq_flat_codes_identical(n, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x = _tie_input(n, np.float32)
    jx = jnp.asarray(x).astype(jdt)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    # the ties really are ties, so half-to-even rounding is exercised
    blk = np.asarray(jx.astype(jnp.float32))[:64]
    assert np.sum(np.abs(blk / np.float32(127) * np.float32(127) % 1)
                  == 0.5) >= 60
    jq, js, _ = jq8.blockwise_quantize(jx, 64)
    tq, ts, _ = tq8.blockwise_quantize(tx, 64)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))     # codes
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    tp = tbk.qdq_flat(tx, 64)
    # outputs: equal to JAX's round trip (q * s / 127 in IEEE order, as
    # the CUDA kernel computes it) ...
    np.testing.assert_array_equal(
        tp.float().numpy(),
        np.asarray(jq8._roundtrip(jx, 64).astype(jnp.float32)))
    # ... and within one f32 ulp of the Pallas kernel, whose dequantize
    # XLA may reassociate (the 1-ulp allowance of tests/test_kernels.py)
    jp = jbk.qdq_flat(jx, 64, interpret=True)
    np.testing.assert_allclose(tp.float().numpy(),
                               np.asarray(jp.astype(jnp.float32)),
                               rtol=np.finfo(np.float32).eps, atol=0)


# every kind of block the CUDA kernels take (``flat_block_path``): lane
# groups (bf16 8 ... 256, f32 4 ... 128), thread groups looping in
# vectors (48, 96, 4096) and in scalars (1, 3, 100)
FLAT_BLOCKS = [32, 64, 96, 128, 1, 3, 8, 16, 48, 100, 256, 4096]


def _ties_zero_block(n, block, seed):
    """randn * 4 with exact .5 ties in block 0 (the first min(block, 128)
    - 1 elements, then the block's absmax 127) and an all-zero block 1."""
    x = (np.random.default_rng(seed).standard_normal(n) * 4).astype(
        np.float32)
    m = min(block, 128) - 1
    x[:m] = np.arange(m, dtype=np.float32) - (m + 1) // 2 + np.float32(0.5)
    x[m] = 127.0
    x[block:2 * block] = 0.0
    return x, m


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", FLAT_BLOCKS)
def test_qdq_flat_zero_block_ties_and_ragged_tail_match_jax(block, dtype):
    """The edge cases of every kind of block the CUDA qdq takes: exact .5
    ties in block 0 (its absmax 127), an all-zero block (scale 0,
    divided by 1e-12), and a zero-padded tail whose length is not a
    multiple of the 8-element vector (at block 1 every length is
    whole).  The plain version equals JAX's round trip, its codes and
    scales JAX's quantize, and it is within one f32 ulp of the Pallas
    kernel in interpret mode."""
    n = block * 5 + (3 if block > 3 else block - 1)
    x, m = _ties_zero_block(n, block, block)
    assert n % 8 and (n % block or block == 1)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jx = jnp.asarray(x).astype(jdt)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    blk = np.asarray(jx.astype(jnp.float32))[:m]
    assert np.sum(np.abs(blk / np.float32(127) * np.float32(127) % 1)
                  == 0.5) >= m - 1                      # real ties
    jq, js, _ = jq8.blockwise_quantize(jx, block)
    tq, ts, _ = tq8.blockwise_quantize(tx, block)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[1, 0]) == 0.0 and not tq[1].any()   # the zero block
    tp = tbk.qdq_flat(tx, block)
    np.testing.assert_array_equal(
        tp.float().numpy(),
        np.asarray(jq8._roundtrip(jx, block).astype(jnp.float32)))
    np.testing.assert_allclose(
        tp.float().numpy(),
        np.asarray(jbk.qdq_flat(jx, block, interpret=True).astype(
            jnp.float32)), rtol=np.finfo(np.float32).eps, atol=0)


def _fma32_rem_corrected(p, r, y0):
    """f32 ``fma(fma(-y0, 127, p), r, y0)`` as the card computes it: the
    remainder ``p - 127 y0`` is exact in f64 (checked), and the second
    fma is rounded from f64 except where that could round twice, which
    exact rationals decide."""
    from fractions import Fraction
    rem64 = p.astype(np.float64) - 127.0 * y0.astype(np.float64)
    rem = rem64.astype(np.float32)
    assert np.array_equal(rem.astype(np.float64), rem64)
    s64 = rem.astype(np.float64) * np.float64(r) + y0.astype(np.float64)
    y = s64.astype(np.float32)
    lo = np.nextafter(y, np.float32(-np.inf))
    hi = np.nextafter(y, np.float32(np.inf))
    eps = np.abs(s64) * 2.0 ** -50
    near = (np.abs(s64 - (y.astype(np.float64) + lo) / 2) <= eps) | \
        (np.abs(s64 - (y.astype(np.float64) + hi) / 2) <= eps)
    for i in np.nonzero(near)[0]:
        exact = Fraction(float(rem[i])) * Fraction(float(r)) + \
            Fraction(float(y0[i]))
        cands = sorted((abs(Fraction(float(c)) - exact),
                        int(c.view(np.uint32)) & 1, c)
                       for c in (lo[i], y[i], hi[i]))
        y[i] = cands[0][2]
    return y


@pytest.mark.parametrize("binade", [-93, 0, 99])
def test_block_dequant_division_by_127_is_ieee_over_a_binade(binade):
    """The CUDA kernels' ``q s / 127`` (``block_dequant`` in
    ``csrc/common.cuh``): ``y0 = RN(p R)`` with ``R = RN(1/127)``, then
    one Markstein correction, equals the IEEE quotient for every f32 of
    a binade; scaling by powers of two maps the binades of [2^-93,
    2^100) onto each other exactly, so the ends and the middle stand for
    all of them."""
    r = np.float32(1) / np.float32(127)
    assert float(r).hex() == "0x1.0204080000000p-7"
    p = ((np.uint32(binade + 127) << np.uint32(23))
         | np.arange(2 ** 23, dtype=np.uint32)).view(np.float32)
    y0 = (p.astype(np.float64) * np.float64(r)).astype(np.float32)
    y = _fma32_rem_corrected(p, r, y0)
    np.testing.assert_array_equal(y, p / np.float32(127))
    np.testing.assert_array_equal(
        _fma32_rem_corrected(-p, r, -y0), -p / np.float32(127))


def test_block_codes_multiply_stays_inside_its_guard():
    """The CUDA kernels' codes (``block_codes``): with ``c = 127 / max(s,
    1e-12)``, ``v c`` lies within 3.1e-5 of ``RN(RN(v / max(s, 1e-12))
    127)`` for |v| <= s, so wherever ``v c`` is farther than 2^-12 from
    a half-integer (where the kernel keeps it) both round to the same
    code; nearer, the kernel takes the IEEE division."""
    rng = np.random.default_rng(0)
    n = 1 << 20
    s = np.exp2(rng.uniform(-60, 60, n)).astype(np.float32)
    s[:16] = 0.0
    v = (rng.uniform(-1, 1, n) * s).astype(np.float32)
    v[16:32] = s[16:32]                      # v = +-s: codes +-127
    v[32:48] = -s[32:48]
    d = np.maximum(s, np.float32(1e-12))
    t = v * (np.float32(127) / d)
    f = (v / d) * np.float32(127)
    assert float(np.abs(t.astype(np.float64) - f).max()) < 3.1e-5
    kept = np.abs(t - np.rint(t)) <= np.float32(0.5) - np.float32(2 ** -12)
    assert kept.mean() > 0.99
    np.testing.assert_array_equal(np.rint(t[kept]), np.rint(f[kept]))


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_int8_boundary_matches_jax(impl):
    """The ``int8`` boundary mode under either backend value: equal to
    JAX's jnp round trip, and within one f32 ulp of its Pallas one."""
    from conftest import tiny_dense_config
    from repro_torch.models.config import ArchConfig
    jcfg = tiny_dense_config(kernels=impl)
    tcfg = ArchConfig(**{f: getattr(jcfg, f)
                         for f in ArchConfig.__dataclass_fields__})
    x = _tie_input(2 * 64 + 17, np.float32).reshape(1, -1)
    t = tcodecs.int8_boundary(tcfg, _t(x)).numpy()
    np.testing.assert_array_equal(
        t, np.asarray(jcodecs.int8_boundary(jcfg.with_overrides(
            kernels="jnp"), jnp.asarray(x))))
    np.testing.assert_allclose(
        t, np.asarray(jcodecs.int8_boundary(jcfg, jnp.asarray(x))),
        rtol=np.finfo(np.float32).eps, atol=0)


def test_qdq_row_blocked_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 128)).astype(np.float32)
    from repro.kernels.boundary.ref import qdq_ref as j_qdq_ref
    jr = np.asarray(j_qdq_ref(jnp.asarray(x), 64))
    np.testing.assert_array_equal(tbk.qdq(_t(x), 64).numpy(), jr)
    np.testing.assert_array_equal(qdq_ref(_t(x), 64).numpy(), jr)
    jp = np.asarray(jbk.qdq(jnp.asarray(x), 64, interpret=True))
    np.testing.assert_allclose(tbk.qdq(_t(x), 64).numpy(), jp,
                               rtol=np.finfo(np.float32).eps, atol=0)


@pytest.mark.parametrize("shape", [(5, 64), (3, 77), (2, 4, 96)],
                         ids=["whole", "padded", "3d"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant8_pair_matches_jax(shape, dtype):
    """The quant8 pair's plain versions against JAX's ops (jnp oracle)
    and its Pallas kernels in interpret mode: codes and scales bit-equal,
    the zero padding of a ragged length dropped on the way back.  The
    dequantized values are bit-equal to the oracle; the Pallas f32
    dequantize may round ``q * s / 127`` one f32 ulp apart (XLA turns
    the division by 127 into a reciprocal multiply; ROADMAP queue 3), so
    it is held to one ulp; in bf16 the ulp vanishes in the cast."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(shape) * 5).astype(np.float32)
    x.reshape(-1)[:7] = [0.5, -1.5, 2.5, 127.0, 0.0, -127.0, 63.5]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jx = jnp.asarray(x).astype(jdt)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    q, s, meta = tq8ops.quantize(tx, 64)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert meta == (shape, tx.dtype, (-x.size) % 64)
    y = tq8ops.dequantize(q, s, meta)
    assert y.dtype == tx.dtype and tuple(y.shape) == shape
    assert torch.equal(tq8ops.roundtrip(tx, 64), y)
    for use_kernel in (False, True):
        jq, js, jmeta = jq8ops.quantize(jx, 64, use_kernel=use_kernel,
                                        interpret=True)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        jy = np.asarray(jq8ops.dequantize(jq, js, jmeta,
                                          use_kernel=use_kernel,
                                          interpret=True).astype(
                                              jnp.float32))
        if use_kernel and dtype == "float32":
            np.testing.assert_allclose(y.numpy(), jy, atol=0,
                                       rtol=np.finfo(np.float32).eps)
        else:
            np.testing.assert_array_equal(y.float().numpy(), jy)
    # the flat kernel entry points, as the Pallas kernels take them
    flat = tx.reshape(-1)[:64 * (tx.numel() // 64)]
    kq, ks = tq8k.quantize(flat, 64)
    pq, ps = jq8k.quantize(jnp.asarray(np.asarray(
        jx.reshape(-1)[:flat.numel()])), 64, True)
    np.testing.assert_array_equal(kq.numpy(), np.asarray(pq))
    np.testing.assert_array_equal(ks.numpy(), np.asarray(ps))
    assert tq8k.dequantize(kq, ks, torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", FLAT_BLOCKS)
def test_quant8_kernel_every_block_matches_jax(block, dtype):
    """The quant8 pair at every kind of block the CUDA kernels take, with
    exact .5 ties in block 0 and an all-zero block 1: the plain kernel
    entry points' codes and scales bit-equal to JAX's
    ``blockwise_quantize`` and to the Pallas ``quantize`` in interpret
    mode (six blocks: rows % min(128, rows) == 0), the dequantized
    values bit-equal to JAX's ``blockwise_dequantize`` (and to the Pallas
    ``dequantize`` within one f32 ulp, as in
    ``test_quant8_pair_matches_jax``); through the ops, a ragged length
    (zero-padded, 3 short of a block) quantizes and comes back as JAX's
    round trip does."""
    nb = 6
    x, _ = _ties_zero_block(nb * block, block, block + 1)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jx = jnp.asarray(x).astype(jdt)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    q, s = tq8k.quantize(tx, block)
    jq, js, jmeta = jq8.blockwise_quantize(jx, block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert float(s[1, 0]) == 0.0 and not q[1].any()      # the zero block
    pq, ps = jq8k.quantize(jx, block, True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(pq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ps))
    y = tq8k.dequantize(q, s, tx.dtype)
    np.testing.assert_array_equal(
        y.float().numpy().reshape(-1),
        np.asarray(jq8.blockwise_dequantize(jq, js, jmeta).astype(
            jnp.float32)))
    np.testing.assert_allclose(
        tq8k.dequantize(q, s, torch.float32).numpy(),
        np.asarray(jq8k.dequantize(pq, ps, jnp.float32, True)),
        rtol=np.finfo(np.float32).eps, atol=0)
    if block > 3:
        ragged = tx[:-3]
        rq, rs, meta = tq8ops.quantize(ragged, block)
        jrq, jrs, _ = jq8.blockwise_quantize(jx[:-3], block)
        np.testing.assert_array_equal(rq.numpy(), np.asarray(jrq))
        np.testing.assert_array_equal(rs.numpy(), np.asarray(jrs))
        np.testing.assert_array_equal(
            tq8ops.dequantize(rq, rs, meta).float().numpy(),
            np.asarray(jq8._roundtrip(jx[:-3], block).astype(jnp.float32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_block_path_takes_every_block(dtype):
    """The one rule of which CUDA kernel takes a flat blockwise call
    (``qdq_flat``, the quant8 pair), on CPU tensors: every block 1..4096
    has a path, aligned or not; the lane groups take exactly the powers
    of two of 1 to 32 16-byte vectors (bf16 8..256, f32 4..128) on
    16-byte-aligned tensors; the thread groups in vectors the other
    whole numbers of vectors; anything else, and any unaligned tensor
    (input, output or codes), the scalar path.  A block below 1 is
    refused, as in JAX."""
    rule = tbk.flat_block_path
    vec = 16 // dtype.itemsize
    buf = torch.zeros(8 + 64, dtype=dtype)
    codes = torch.zeros(32, dtype=torch.int8)
    assert buf.data_ptr() % 16 == 0 and codes.data_ptr() % 16 == 0
    aligned, off = buf[8:], buf[1:]
    lanes = {vec << k for k in range(6)}
    assert lanes == ({8, 16, 32, 64, 128, 256} if dtype == torch.bfloat16
                     else {4, 8, 16, 32, 64, 128})
    seen = {"lanes": 0, "units": 0, "scalar": 0}
    for block in range(1, 4097):
        got = rule(block, dtype, aligned, None, codes)
        want = ("lanes" if block in lanes else
                "units" if block % vec == 0 else "scalar")
        assert got == want, (block, got)
        seen[got] += 1
        assert rule(block, dtype, off) == "scalar"
        assert rule(block, dtype, aligned, codes[1:]) == "scalar"
    assert seen == {"lanes": 6, "units": 4096 // vec - 6,
                    "scalar": 4096 - 4096 // vec}
    for block in (0, -64):
        with pytest.raises(ValueError, match="block"):
            rule(block, dtype, aligned)


def test_quant8_kernel_checks_its_inputs():
    with pytest.raises(ValueError, match="block 0"):
        tq8k.quantize(torch.zeros(64), 0)
    with pytest.raises(ValueError, match="block 0"):
        tbk.qdq_flat(torch.zeros(64), 0)
    with pytest.raises(ValueError, match="flat"):
        tq8k.quantize(torch.zeros(2, 64), 64)
    with pytest.raises(ValueError, match="flat"):
        tq8k.quantize(torch.zeros(65), 64)
    with pytest.raises(ValueError, match="int8"):
        tq8k.dequantize(torch.zeros(2, 64), torch.zeros(2, 1))


def test_cpu_wrappers_launch_nothing():
    before = dict(kernels.LAUNCHES)
    x = torch.randn(4, 64)
    t_rmsnorm(x, torch.ones(64))
    tbk.qdq_flat(x, 64)
    tq8ops.roundtrip(x, 64)
    t_flash(torch.randn(1, 8, 2, 16), torch.randn(1, 8, 1, 16),
            torch.randn(1, 8, 1, 16))
    assert kernels.LAUNCHES == before
