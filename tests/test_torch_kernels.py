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
from repro_torch.kernels.rmsnorm.kernel import rmsnorm as t_rmsnorm
from repro_torch.compression import codecs as tcodecs
from repro_torch.models import attention as t_attention
from repro_torch.models import flash as t_flash_lib

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


@pytest.mark.parametrize("shape", [(4, 128), (2, 3, 64), (1, 256)])
def test_rmsnorm_plain_matches_pallas_and_oracle(shape):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    s = (rng.standard_normal(shape[-1]) + 1.0).astype(np.float32)
    jp = np.asarray(j_rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-6, True))
    jr = np.asarray(j_rmsnorm_ref(jnp.asarray(x), jnp.asarray(s)))
    t = t_rmsnorm(_t(x), _t(s)).numpy()
    np.testing.assert_allclose(t, jp, atol=RMS_TOL, rtol=RMS_TOL)
    np.testing.assert_allclose(t, jr, atol=RMS_TOL, rtol=RMS_TOL)


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


def test_quant8_kernel_checks_its_inputs():
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
