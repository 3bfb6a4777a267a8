"""The port's learned boundary codecs against the JAX package on the same
numpy inputs: ``encode`` / ``decode`` (bottleneck and maxout, with and
without the fused wire QDQ, f32 and bf16) against JAX's ``encode_ref`` /
``decode_ref`` and its Pallas ``encode`` / ``decode`` in interpret mode;
the true-wire-format pair ``encode_quantize`` / ``dequantize_decode``
against JAX's oracles and Pallas kernels; the gradients of the autograd
ops against JAX's custom VJPs; the straight-through int8 round trip; and
the device routing of every kernel wrapper.

On the CPU the wrappers run their plain versions; the CUDA kernels are
held against those on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from conftest import tiny_dense_config
from repro.compression import codecs as jcodecs
from repro.kernels.boundary import kernel as jbk
from repro.kernels.boundary import ops as jops
from repro.kernels.boundary import ref as jref

from repro_torch import kernels
from repro_torch.compression import codecs as tcodecs
from repro_torch.kernels.boundary import kernel as tbk
from repro_torch.kernels.boundary import ops as tops
from repro_torch.kernels.boundary import ref as tref
from repro_torch.models.config import ArchConfig

torch.set_num_threads(1)   # as tests/test_torch_train.py explains

F32_TOL = 2e-6        # f32 LN outputs of O(1): a few ulps of summation order
GRAD_RTOL = 1e-5      # f32 gradients, relative to the leaf's largest entry
D, C = 64, 16


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _inputs(seed=0, rows=(2, 12)):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((*rows, D)) * 3 + 0.5).astype(np.float32)
    w_c = (rng.standard_normal((D, C)) * 0.2).astype(np.float32)
    w_d = (rng.standard_normal((C, D)) * 0.2).astype(np.float32)
    return x, w_c, w_d


def _assert_close_or_code_step(got, want, tol, qb=None):
    """``|got - want| <= max(tol, 1 bf16 ulp of the larger of the two)``
    elementwise; with ``qb``, an element may instead differ by one int8
    code step (its block's absmax / 127) where the two sides' pre-QDQ
    values straddle a rounding boundary.  Returns the number of such
    one-step flips."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    # bf16 spacing (tol > 1e-4 marks a bf16 comparison)
    ulp = (np.exp2(np.floor(np.log2(np.maximum(np.abs(got), np.abs(want))
                                    + 1e-30)) - 7)
           if tol > 1e-4 else 0.0)
    err = np.abs(got - want)
    ok = err <= np.maximum(tol, ulp)
    flips = 0
    if qb is not None:
        blocks = np.abs(want).reshape(*want.shape[:-1], -1, qb)
        step = np.repeat(blocks.max(-1) / 127.0, qb, axis=-1).reshape(
            want.shape)
        flip = ~ok & (err <= step * 1.01 + np.maximum(tol, ulp))
        flips = int(flip.sum())
        ok |= flip
    assert ok.all(), (err.max(), np.argwhere(~ok)[:5])
    return flips


CASES = [("bottleneck", 1, False), ("bottleneck", 1, True),
         ("maxout", 2, False), ("maxout", 4, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,k,quantize", CASES)
def test_encode_decode_match_jax(mode, k, quantize, dtype):
    x, w_c, _ = _inputs()
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    # f32: orders of summation only; bf16: one bf16 ulp where the two
    # sides' f32 values straddle a rounding boundary
    tol = F32_TOL if dtype == "float32" else 2.0 ** -8
    jx = jnp.asarray(x).astype(jdt)
    tx = _t(np.asarray(jx.astype(jnp.float32)), tdt)
    w = w_c if mode == "bottleneck" else None
    c = C if mode == "bottleneck" else D // k
    qb = jref.wire_qblock(c)
    assert qb == tref.wire_qblock(c)
    jw = None if w is None else jnp.asarray(w)
    z_ref = jref.encode_ref(jx, jw, mode, k)
    if quantize:
        z_ref = jref.qdq_ref(z_ref, qb)
    z_pal = jbk.encode(jx, jw, mode, k, qb, quantize, interpret=True)
    z = tbk.encode(tx, None if w is None else _t(w), mode, k, qb, quantize)
    assert z.dtype == tdt and tuple(z.shape) == (2, 12, c)
    for want in (z_ref, z_pal):
        flips = _assert_close_or_code_step(
            _np(z), np.asarray(want.astype(jnp.float32)), tol,
            qb if quantize else None)
        # f32: the pre-QDQ values agree to a few ulps, so a flip needs a
        # value within ~1e-7 of a code boundary; a bf16 value one ulp off
        # (half a code step near the block max) flips often, by one step
        assert dtype == "bfloat16" or flips <= 2
    wd = (np.random.default_rng(9).standard_normal((c, D)) * 0.2).astype(
        np.float32)
    jz = jnp.asarray(_np(z)).astype(jdt)
    y_ref = jref.decode_ref(jz, jnp.asarray(wd), mode)
    y_pal = jbk.decode(jz, jnp.asarray(wd), mode, interpret=True)
    y = tbk.decode(_t(_np(z), tdt), _t(wd), mode)
    assert y.dtype == tdt and tuple(y.shape) == (2, 12, D)
    # the product sums c terms: f32 order within 1e-5; bf16 one ulp
    dtol = 1e-5 if dtype == "float32" else 2.0 ** -8
    for want in (y_ref, y_pal):
        _assert_close_or_code_step(_np(y), np.asarray(
            want.astype(jnp.float32)), dtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["bottleneck", "maxout"])
@pytest.mark.parametrize("rows", [1, 7, 200])
def test_decode_ref_ragged_rows_match_jax(rows, mode, dtype):
    """The plain decode the CUDA codec GEMM is held to on the card, at row
    counts that do not fill the kernel's 128-row tiles, against JAX's
    ``decode_ref`` and its Pallas ``decode`` in interpret mode."""
    rng = np.random.default_rng(rows)
    z = (rng.standard_normal((rows, C)) * 2).astype(np.float32)
    wd = (rng.standard_normal((C, D)) * 0.2).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jz = jnp.asarray(z).astype(jdt)
    y = tbk.decode(_t(np.asarray(jz.astype(jnp.float32)), tdt), _t(wd), mode)
    assert y.dtype == tdt and tuple(y.shape) == (rows, D)
    dtol = 1e-5 if dtype == "float32" else 2.0 ** -8
    for want in (jref.decode_ref(jz, jnp.asarray(wd), mode),
                 jbk.decode(jz, jnp.asarray(wd), mode, interpret=True)):
        _assert_close_or_code_step(_np(y), np.asarray(
            want.astype(jnp.float32)), dtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,k", [("bottleneck", 1), ("maxout", 2),
                                    ("maxout", 4)])
def test_wire_codes_pair_matches_jax(mode, k, dtype):
    """``encode_quantize`` (codes + scales of the encode output rounded to
    x's dtype) and ``dequantize_decode`` against JAX's ``ops`` oracles
    and its Pallas kernels (interpret mode), on ragged rows.  Tolerances:
    a scale is the absmax of its block of encode outputs, so it agrees
    as those do (f32: F32_TOL; bf16: one bf16 ulp, where the two
    sides' f32 values straddle a rounding boundary); a code may differ
    by one step only where the values straddle a code boundary (f32: at
    most 2 such flips).  The decode of the SAME codes and scales agrees
    to f32 summation order (1e-5) or one ulp of the output dtype."""
    x, w_c, _ = _inputs(4, rows=(3, 7))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jx = jnp.asarray(x).astype(jdt)
    tx = _t(np.asarray(jx.astype(jnp.float32)), tdt)
    w = w_c if mode == "bottleneck" else None
    jw = None if w is None else jnp.asarray(w)
    c = C if mode == "bottleneck" else D // k
    qb = tref.wire_qblock(c)
    q, s = tops.encode_quantize(tx, None if w is None else _t(w), mode, k,
                                qb)
    assert q.dtype == torch.int8 and tuple(q.shape) == (3, 7, c)
    assert s.dtype == torch.float32 and tuple(s.shape) == (3, 7, c // qb)
    stol = F32_TOL if dtype == "float32" else 2.0 ** -8
    for jq, js in (jops.encode_quantize(jx, jw, mode, k, qb,
                                        use_kernel=False),
                   jbk.encode_quantize(jx, jw, mode, k, qb,
                                       interpret=True)):
        _assert_close_or_code_step(s.numpy(), np.asarray(js), stol)
        dq = np.abs(q.numpy().astype(int) - np.asarray(jq).astype(int))
        assert dq.max() <= 1
        assert dtype == "bfloat16" or int((dq > 0).sum()) <= 2
    wd = (np.random.default_rng(9).standard_normal((c, D)) * 0.2).astype(
        np.float32)
    jq, js = jops.encode_quantize(jx, jw, mode, k, qb, use_kernel=False)
    tq = torch.from_numpy(np.array(jq))
    ts = torch.from_numpy(np.array(js))
    for out_dt, jout in ((None, jnp.float32), (tdt, jdt)):
        y = tops.dequantize_decode(tq, ts, _t(wd), mode, qb, out_dt)
        want_dt = torch.float32 if out_dt is None else out_dt
        assert y.dtype == want_dt and tuple(y.shape) == (3, 7, D)
        dtol = 1e-5 if want_dt == torch.float32 else 2.0 ** -8
        for want in (jops.dequantize_decode(jq, js, jnp.asarray(wd), mode,
                                            qb, jout, use_kernel=False),
                     jbk.dequantize_decode(jq, js, jnp.asarray(wd), mode,
                                           qb, jout, interpret=True)):
            _assert_close_or_code_step(
                _np(y), np.asarray(want.astype(jnp.float32)), dtol)


ROW_PASS_CASES = [(8, 8), (1024, 8), (1024, 64), (2048, 8), (2048, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width,qb", ROW_PASS_CASES)
def test_row_passes_at_kernel_widths_match_jax(width, qb, dtype):
    """The plain row passes the CUDA row kernels are held to on the card,
    at row widths 8, 1024 and 2048 with blocks of 8 and 64: LayerNorm +
    QDQ (maxout with k = 1 is the LayerNorm alone), LayerNorm + codes,
    and codes -> dequantize -> LayerNorm -> product, against JAX's plain
    references and its Pallas kernels in interpret mode.  Row 2 is
    constant, so its LayerNorm is all zeros: blocks of absmax 0, scaled
    by 1e-12, give codes 0 and outputs 0 on both sides.  Tolerances as
    in :func:`test_wire_codes_pair_matches_jax`."""
    rng = np.random.default_rng(width + qb)
    x = (rng.standard_normal((5, width)) * 3 + 0.5).astype(np.float32)
    x[2] = 1.25
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jx = jnp.asarray(x).astype(jdt)
    tx = _t(np.asarray(jx.astype(jnp.float32)), tdt)
    tol = F32_TOL if dtype == "float32" else 2.0 ** -8
    z = tbk.encode(tx, None, "maxout", 1, qb, True)
    assert z.dtype == tdt and tuple(z.shape) == (5, width)
    assert not z[2].any()
    for want in (jref.qdq_ref(jref.encode_ref(jx, None, "maxout", 1), qb),
                 jbk.encode(jx, None, "maxout", 1, qb, True,
                            interpret=True)):
        flips = _assert_close_or_code_step(
            _np(z), np.asarray(want.astype(jnp.float32)), tol, qb)
        assert dtype == "bfloat16" or flips <= 2
    q, s = tbk.encode_quantize(tx, None, "maxout", 1, qb)
    assert not q[2].any() and not s[2].any()
    for jq, js in (jref.encode_quantize_ref(jx, None, "maxout", 1, qb),
                   jbk.encode_quantize(jx, None, "maxout", 1, qb,
                                       interpret=True)):
        _assert_close_or_code_step(s.numpy(), np.asarray(js), tol)
        dq = np.abs(q.numpy().astype(int) - np.asarray(jq).astype(int))
        assert dq.max() <= 1
        assert dtype == "bfloat16" or int((dq > 0).sum()) <= 2
    jq, js = jref.encode_quantize_ref(jx, None, "maxout", 1, qb)
    wd = (rng.standard_normal((width, D)) * 0.2 / np.sqrt(width / 64)
          ).astype(np.float32)
    y = tbk.dequantize_decode(torch.from_numpy(np.array(jq)),
                              torch.from_numpy(np.array(js)), _t(wd),
                              "maxout", qb, tdt)
    assert y.dtype == tdt and tuple(y.shape) == (5, D)
    dtol = 1e-5 if dtype == "float32" else 2.0 ** -8
    for want in (jref.dequantize_decode_ref(jq, js, jnp.asarray(wd),
                                            "maxout", qb, jdt),
                 jbk.dequantize_decode(jq, js, jnp.asarray(wd), "maxout",
                                       qb, jdt, interpret=True)):
        _assert_close_or_code_step(_np(y), np.asarray(
            want.astype(jnp.float32)), dtol)


def test_wire_codes_pair_checks_its_inputs():
    x, w_c, w_d = _inputs(5)
    q, s = tbk.encode_quantize(_t(x), _t(w_c), "bottleneck", 1, 16)
    with pytest.raises(ValueError, match="int8"):
        tbk.dequantize_decode(q.float(), s, _t(w_d), "bottleneck", 16)
    with pytest.raises(ValueError, match="scales"):
        tbk.dequantize_decode(q, s[..., :0], _t(w_d), "bottleneck", 16)
    with pytest.raises(ValueError, match="learned"):
        tbk.encode_quantize(_t(x), _t(w_c), "int8", 1, 16)


def _grad_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, atol=GRAD_RTOL,
                               rtol=0)


@pytest.mark.parametrize("mode,k,quantized", CASES)
def test_encode_wire_grad_matches_jax_vjp(mode, k, quantized):
    x, w_c, _ = _inputs(1)
    c = C if mode == "bottleneck" else D // k
    qb = jref.wire_qblock(c)
    g = np.random.default_rng(2).standard_normal((2, 12, c)).astype(
        np.float32)
    jw = jnp.asarray(w_c) if mode == "bottleneck" else None

    def f(xx, ww):
        return jops.encode_wire(xx, ww, mode, k, qb, quantized, False)
    if jw is None:
        y, vjp = jax.vjp(lambda xx: f(xx, None), jnp.asarray(x))
        (jgx,), jgw = vjp(jnp.asarray(g)), None
    else:
        y, vjp = jax.vjp(f, jnp.asarray(x), jw)
        jgx, jgw = vjp(jnp.asarray(g))
    tx = _t(x).requires_grad_()
    tw = None if jw is None else _t(w_c).requires_grad_()
    z = tops.encode_wire(tx, tw, mode, k, qb, quantized)
    _assert_close_or_code_step(_np(z), np.asarray(y), F32_TOL,
                               qb if quantized else None)
    z.backward(_t(g))
    _grad_close(_np(tx.grad), jgx)
    if tw is not None:
        _grad_close(_np(tw.grad), jgw)


@pytest.mark.parametrize("mode", ["bottleneck", "maxout"])
def test_decode_wire_grad_matches_jax_vjp(mode):
    rng = np.random.default_rng(3)
    z = rng.standard_normal((2, 12, C)).astype(np.float32)
    w = (rng.standard_normal((C, D)) * 0.2).astype(np.float32)
    g = rng.standard_normal((2, 12, D)).astype(np.float32)
    y, vjp = jax.vjp(lambda zz, ww: jops.decode_wire(zz, ww, mode, False),
                     jnp.asarray(z), jnp.asarray(w))
    jgz, jgw = vjp(jnp.asarray(g))
    tz, tw = _t(z).requires_grad_(), _t(w).requires_grad_()
    out = tops.decode_wire(tz, tw, mode)
    np.testing.assert_allclose(_np(out), np.asarray(y), atol=1e-5, rtol=0)
    out.backward(_t(g))
    _grad_close(_np(tz.grad), jgz)
    _grad_close(_np(tw.grad), jgw)


def test_int8_roundtrip_straight_through_matches_jax():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 100)) * 2).astype(np.float32)
    g = rng.standard_normal((3, 100)).astype(np.float32)
    y, vjp = jax.vjp(lambda a: jops.int8_roundtrip(a, 64, 32, False),
                     jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(g))
    tx = _t(x).requires_grad_()
    out = tops.int8_roundtrip(tx, 64, 32)
    np.testing.assert_array_equal(_np(out), np.asarray(y))
    out.backward(_t(g))
    np.testing.assert_array_equal(_np(tx.grad), np.asarray(jg))
    ints = torch.arange(6, dtype=torch.int32)
    assert tops.int8_roundtrip(ints) is ints


def _configs(**kw):
    jcfg = tiny_dense_config(**kw)
    return jcfg, ArchConfig(**{f: getattr(jcfg, f)
                               for f in ArchConfig.__dataclass_fields__})


@pytest.mark.parametrize("mode,wire_quant", [("bottleneck", False),
                                             ("bottleneck", True),
                                             ("maxout", False),
                                             ("maxout", True)])
def test_codec_dispatch_matches_jax(mode, wire_quant):
    """``codecs.encode_wire`` / ``decode_wire`` through the config: specs,
    wire widths, blocks, FLOPs and values as JAX's."""
    jcfg, tcfg = _configs(boundary_compression=mode, bottleneck_dim=C,
                          maxout_k=4, wire_quant=wire_quant)
    assert tcodecs.wire_dim(tcfg) == jcodecs.wire_dim(jcfg)
    assert tcodecs.wire_qblock(tcfg) == jcodecs.wire_qblock(jcfg)
    assert tcodecs.maxout_k(tcfg) == jcodecs.maxout_k(jcfg)
    for side in ("sender_specs", "receiver_specs"):
        js, ts = getattr(jcodecs, side)(jcfg), getattr(tcodecs, side)(tcfg)
        assert {k: v.shape for k, v in js.items()} == \
            {k: v.shape for k, v in ts.items()}
    for snd, rcv in ((True, False), (False, True), (True, True)):
        assert tcodecs.codec_flops_per_token(
            tcfg, mode, sender=snd, receiver=rcv) == \
            jcodecs.codec_flops_per_token(jcfg, mode, sender=snd,
                                          receiver=rcv)
    x, w_c, _ = _inputs(5)
    w_d = np.random.default_rng(6).standard_normal(
        (tcodecs.wire_dim(tcfg), D)).astype(np.float32) * 0.2
    jp = {"w_c": jnp.asarray(w_c), "w_d": jnp.asarray(w_d)}
    tp = {"w_c": _t(w_c), "w_d": _t(w_d)}
    jz = jcodecs.encode_wire(jcfg, mode, jp, jnp.asarray(x))
    tz = tcodecs.encode_wire(tcfg, mode, tp, _t(x))
    _assert_close_or_code_step(_np(tz), np.asarray(jz), F32_TOL,
                               tcodecs.wire_qblock(tcfg)
                               if wire_quant else None)
    jy = jcodecs.decode_wire(jcfg, mode, jp, jz)
    ty = tcodecs.decode_wire(tcfg, mode, tp, _t(np.asarray(jz)))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=1e-5, rtol=0)
    # the plain layers of compression/bottleneck.py and maxout.py
    from repro.compression import bottleneck as jbn, maxout as jmx
    from repro_torch.compression import bottleneck as tbn, maxout as tmx
    if mode == "bottleneck":
        jz, tz = jbn.compress(jp, jnp.asarray(x)), tbn.compress(tp, _t(x))
        jy, ty = jbn.decompress(jp, jz), tbn.decompress(tp, _t(
            np.asarray(jz)))
    else:
        jz, tz = jmx.compress(jnp.asarray(x), 4), tmx.compress(_t(x), 4)
        jy, ty = jmx.decompress(jp, jz), tmx.decompress(tp, _t(
            np.asarray(jz)))
    np.testing.assert_allclose(_np(tz), np.asarray(jz), atol=F32_TOL,
                               rtol=0)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=1e-5, rtol=0)


def test_bf16_codes_cross_as_ml_dtypes():
    """A bf16 wire tensor converts to numpy as ml_dtypes.bfloat16 (what
    jax.device_get returns), bit for bit."""
    from repro_torch.models.params import tensor_from_numpy, \
        tensor_to_numpy
    x, w_c, _ = _inputs(7)
    z = tbk.encode(_t(x, torch.bfloat16), _t(w_c), "bottleneck", 1, 16,
                   True)
    a = tensor_to_numpy(z)
    assert a.dtype == ml_dtypes.bfloat16
    assert torch.equal(tensor_from_numpy(a, "cpu"), z)


def test_cpu_codec_wrappers_launch_nothing():
    before = dict(kernels.LAUNCHES)
    x, w_c, w_d = _inputs(8)
    z = tbk.encode(_t(x), _t(w_c), "bottleneck", 1, 16, True)
    tbk.decode(z, _t(w_d), "bottleneck")
    tbk.encode(_t(x), None, "maxout", 2, 32, False)
    q, s = tbk.encode_quantize(_t(x), _t(w_c), "bottleneck", 1, 16)
    tbk.dequantize_decode(q, s, _t(w_d), "bottleneck", 16)
    assert kernels.LAUNCHES == before
