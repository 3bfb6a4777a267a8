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


def test_cpu_wrappers_launch_nothing():
    before = dict(kernels.LAUNCHES)
    x = torch.randn(4, 64)
    t_rmsnorm(x, torch.ones(64))
    tbk.qdq_flat(x, 64)
    t_flash(torch.randn(1, 8, 2, 16), torch.randn(1, 8, 1, 16),
            torch.randn(1, 8, 1, 16))
    assert kernels.LAUNCHES == before
