"""The port's CUDA kernels and its serving path on an NVIDIA card.

Every test here is marked ``cuda`` and skips without a card. This file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed; ``tests/conftest.py`` imports JAX, so run it there with

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same card
and inputs (the plain versions are held against JAX on the CPU by the
other ``test_torch_*.py`` files).
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.compression import quant8
from repro_torch.kernels.boundary.kernel import qdq_flat
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
from repro_torch.kernels.rmsnorm.kernel import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.models.config import ArchConfig

# flash: f32 scores and sums in both versions, only the order differs
FLASH_BOUND = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _card() -> str:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


def _gen(device: str) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-equal: floats compared as their integer words (+0 != -0)."""
    words = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    if a.dtype in words and a.dtype == b.dtype:
        a, b = a.view(words[a.dtype]), b.view(words[b.dtype])
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(dtype):
    dev = _card()
    g = _gen(dev)
    q = torch.randn(2, 200, 8, 128, generator=g, device=dev).to(dtype)
    k = torch.randn(2, 200, 2, 128, generator=g, device=dev).to(dtype)
    v = torch.randn(2, 200, 2, 128, generator=g, device=dev).to(dtype)
    out = flash_attention_fwd(q, k, v, True)
    ref, _ = flash_fwd_ref(q, k, v, True, 0, 0, 512, 1024)
    assert float((out.float() - ref.float()).abs().max()) <= \
        FLASH_BOUND[dtype]
    x = torch.randn(64, 4096, generator=g, device=dev).to(dtype)
    s = torch.randn(4096, generator=g, device=dev) + 1
    assert torch.equal(rmsnorm(x, s), rmsnorm_ref(x, s))
    y = torch.randn(3, 1000, generator=g, device=dev).to(dtype)
    assert torch.equal(qdq_flat(y, 64), quant8._roundtrip(y, 64))


FLASH_CASES = [
    # B, Sq, Sk, H, KV, D, causal, window
    (1, 64, 64, 4, 2, 64, True, 0),         # GQA, one tile
    (2, 130, 130, 4, 4, 128, True, 0),      # ragged against the 64-row tiles
    (1, 200, 200, 8, 1, 64, True, 48),      # MQA + sliding window
    (1, 24, 150, 4, 2, 128, True, 0),       # query offset Sk - Sq
    (2, 70, 90, 2, 2, 64, False, 0),        # bidirectional
    # edges of the bf16 kernel's 64-row query and key tiles
    (1, 1, 1, 4, 2, 64, True, 0),           # one query, one key
    (2, 63, 63, 4, 2, 128, True, 0),        # one row short of a tile
    (2, 65, 65, 4, 2, 64, True, 0),         # one row past a tile
    (1, 129, 129, 4, 4, 128, True, 0),      # two tiles and a row
    (1, 40, 100, 4, 2, 128, True, 0),       # offset 60: causal edge on key tile 0|1
    (1, 130, 130, 4, 4, 64, True, 70),      # window straddling two key tiles
    (2, 100, 100, 16, 2, 64, True, 0),      # G = 8, D = 64
    (2, 100, 100, 16, 2, 128, True, 0),     # G = 8, D = 128
    (1, 1, 150, 8, 1, 128, True, 0),        # one query at offset 149, G = 8
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_cases_and_lse(case, dtype):
    dev = _card()
    B, Sq, Sk, H, KV, D, causal, window = case
    g = _gen(dev)
    q = torch.randn(B, Sq, H, D, generator=g, device=dev).to(dtype)
    k = torch.randn(B, Sk, KV, D, generator=g, device=dev).to(dtype)
    v = torch.randn(B, Sk, KV, D, generator=g, device=dev).to(dtype)
    before = kernels.LAUNCHES["flash_attention_fwd"]
    out, lse = flash_attention_fwd(q, k, v, causal, window, with_lse=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention_fwd"] == before + 1
    ref, ref_lse = flash_fwd_ref(q, k, v, causal, window, Sk - Sq, 64, 64)
    assert out.dtype == dtype and out.shape == (B, Sq, H, D)
    assert lse.shape == (B, KV, H // KV, Sq)
    assert float((out.float() - ref.float()).abs().max()) <= \
        FLASH_BOUND[dtype]
    assert float((lse - ref_lse).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_deterministic_and_row_independent(dtype):
    """Two calls agree to the bit, and each batch row alone equals that
    row of the batch-2 call (output and lse): a row's result depends only
    on its own q row, k, v and the masks."""
    dev = _card()
    g = _gen(dev)
    q = torch.randn(2, 300, 16, 128, generator=g, device=dev).to(dtype)
    k = torch.randn(2, 300, 2, 128, generator=g, device=dev).to(dtype)
    v = torch.randn(2, 300, 2, 128, generator=g, device=dev).to(dtype)
    out, lse = flash_attention_fwd(q, k, v, True, 100, with_lse=True)
    again = flash_attention_fwd(q, k, v, True, 100, with_lse=True)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    for b in range(2):
        one = flash_attention_fwd(q[b:b + 1], k[b:b + 1], v[b:b + 1], True,
                                  100, with_lse=True)
        assert torch.equal(one[0], out[b:b + 1])
        assert torch.equal(one[1], lse[b:b + 1])


@pytest.mark.cuda
def test_cuda_flash_reads_strided_views():
    """[B, S, H, D] views of a fused projection need no copies."""
    dev = _card()
    g = _gen(dev)
    qkv = torch.randn(2, 96, 4 + 2 + 2, 64, generator=g, device=dev)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    assert not q.is_contiguous()
    out = flash_attention_fwd(q, k, v, True)
    ref, _ = flash_fwd_ref(q, k, v, True, 0, 0, 64, 64)
    assert float((out - ref).abs().max()) <= FLASH_BOUND[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_qdq_ties_and_padded_tail(dtype):
    """Exact .5 ties on the code grid round half to even, and a partial
    tail block is padded with zeros: codes and scales identical to the
    plain version's, outputs equal."""
    dev = _card()
    n = 64 * 3 + 37
    x = (torch.randn(n, generator=_gen(dev), device=dev) * 4)
    # a block whose absmax is 127 has x / 127 * 127 == x, so k + 0.5
    # lands exactly on a tie
    x[:63] = torch.arange(-31, 32, device=dev, dtype=torch.float32) + 0.5
    x[63] = 127.0
    x = x.to(dtype)
    codes = torch.empty(n, dtype=torch.int8, device=dev)
    scales = torch.empty(-(-n // 64), dtype=torch.float32, device=dev)
    out = qdq_flat(x, 64, codes, scales)
    q_ref, s_ref, meta = quant8.blockwise_quantize(x, 64)
    assert torch.equal(codes, q_ref.reshape(-1)[:n])     # tail pad dropped
    assert torch.equal(scales, s_ref.reshape(-1))
    assert torch.equal(out, quant8.blockwise_dequantize(q_ref, s_ref, meta))


# every path of csrc/blockq.cuh (``flat_block_path``): lane groups (bf16
# 8 ... 256, f32 4 ... 128), thread groups looping in vectors (48, 96,
# 4096, and 256 in f32) and in scalars (1, 3, 100)
QDQ_BLOCKS = [32, 64, 96, 128, 1, 3, 8, 16, 48, 100, 256, 4096]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", QDQ_BLOCKS)
def test_cuda_qdq_blocks_and_ragged_tails(block, dtype):
    """qdq_flat at every kind of block (lane groups, thread groups in
    vectors and in scalars: ``flat_block_path``), with n ragged against
    the block and against the 8-element vector, and exact .5 ties:
    codes, scales and outputs bit-equal to the plain version (signed
    zeros included)."""
    dev = _card()
    for n in (block * 41, block * 40 + 3, block * 40 + 8, 5, 4099 * 3):
        x = torch.randn(n, generator=_gen(dev), device=dev) * 4
        m = min(block, n) - 1
        x[:m] = (torch.arange(m, device=dev, dtype=torch.float32)
                 - m // 2 + 0.5)
        x[m] = 127.0
        x = x.to(dtype)
        codes = torch.empty(n, dtype=torch.int8, device=dev)
        scales = torch.empty(-(-n // block), dtype=torch.float32,
                             device=dev)
        out = qdq_flat(x, block, codes, scales)
        q_ref, s_ref, meta = quant8.blockwise_quantize(x, block)
        assert torch.equal(codes, q_ref.reshape(-1)[:n]), n
        assert torch.equal(scales, s_ref.reshape(-1)), n
        assert _same_bits(out, quant8.blockwise_dequantize(q_ref, s_ref,
                                                           meta)), n
        assert torch.equal(qdq_flat(x, block), out), n      # deterministic
    # a part of a longer tensor equals that part of its round trip
    x = torch.randn(2, 512, 4096, generator=_gen(dev), device=dev).to(dtype)
    full = qdq_flat(x, block)
    part = x.reshape(-1)[300 * block:500 * block]
    assert torch.equal(qdq_flat(part, block),
                       full.reshape(-1)[300 * block:500 * block])
    # an unaligned view, and unaligned codes, take the scalar path
    n = block * 7 + 5
    buf = torch.randn(n + 1, generator=_gen(dev), device=dev).to(dtype)
    view = buf[1:]
    codes = torch.empty(n + 1, dtype=torch.int8, device=dev)[1:]
    scales = torch.empty(-(-n // block), dtype=torch.float32, device=dev)
    out = qdq_flat(view, block, codes, scales)
    q_ref, s_ref, meta = quant8.blockwise_quantize(view, block)
    assert torch.equal(codes, q_ref.reshape(-1)[:n])
    assert torch.equal(scales, s_ref.reshape(-1))
    assert _same_bits(out, quant8.blockwise_dequantize(q_ref, s_ref, meta))


# (width, pool k, qb): the training path's passes, the lane-group and
# shared-memory block reductions, and row layouts of 1 to 512 threads
ROW_CASES = [(1024, 1, 0), (1024, 1, 64), (2048, 1, 0), (2048, 2, 64),
             (4096, 1, 0), (4096, 2, 64), (16384, 1, 64), (16384, 2, 64),
             (8, 1, 8), (96, 1, 32), (96, 1, 24), (4104, 1, 8),
             (4096, 1, 512), (256, 4, 16), (256, 8, 8), (32768, 1, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width,k,qb", ROW_CASES)
def test_cuda_row_passes_match_plain(width, k, qb, dtype):
    """The codec's row passes (``ln_rows``, its codes pass, and
    ``dequant_rows`` with and without the LayerNorm) bit-equal to the
    plain versions (``ref._ln``, ``qdq_ref``, ``quantize_rows``); two
    calls bit-equal; rows 300-499 alone equal to those rows of the
    700-row call."""
    from repro_torch.compression.quant8 import div127
    from repro_torch.kernels import _lib
    from repro_torch.kernels.boundary import kernel as K
    from repro_torch.kernels.boundary import ref as R
    dev = _card()
    g = _gen(dev)
    code = _lib.DTYPE_CODES[dtype]
    x = (torch.randn(700, width, generator=g, device=dev) * 3 + 1).to(dtype)
    h = R._ln(x)
    if k > 1:
        h = h.reshape(700, width // k, k).amax(-1)

    def same(fn, want):
        got = fn(x)
        assert all(torch.equal(a, b) for a, b in zip(
            got if isinstance(got, tuple) else (got,),
            want if isinstance(want, tuple) else (want,)))
        again, part = fn(x), fn(x[300:500])
        for a, b, p in zip(*(t if isinstance(t, tuple) else (t,)
                             for t in (got, again, part))):
            assert torch.equal(a, b) and torch.equal(p, a[300:500])

    same(lambda a: K._ln_rows(a, k, qb, code),
         R.qdq_ref(h, qb) if qb else h)
    if not qb:
        return
    same(lambda a: K._ln_rows_codes(a, k, qb, code), R.quantize_rows(h, qb))
    q, s = R.quantize_rows(h, qb)
    c = width // k
    z = div127(q.float().reshape(700, c // qb, qb) * s[..., None]).reshape(
        700, c).to(dtype)
    for ln in (False, True):
        got = K._dequant_rows(q, s, qb, ln, dtype)
        assert torch.equal(got, R._ln(z) if ln else z)
        assert torch.equal(K._dequant_rows(q, s, qb, ln, dtype), got)
        assert torch.equal(K._dequant_rows(q[300:500], s[300:500], qb, ln,
                                           dtype), got[300:500])


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    from repro_torch.kernels.quant8 import kernel as q8k
    dev = _card()
    q = torch.randn(1, 8, 2, 96, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_fwd(q, q[:, :, :1], q[:, :, :1])
    h = torch.randn(1, 8, 2, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention_fwd(h, h, h)
    x = torch.randn(64, 8, device=dev).T            # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm(x, torch.ones(64, device=dev))
    # qdq_flat and the quant8 pair take every block >= 1 and any start
    # (tests below); they refuse what the JAX package refuses
    for block in (0, -64):
        with pytest.raises(ValueError, match="block"):
            qdq_flat(torch.randn(100, device=dev), block)
        with pytest.raises(ValueError, match="block"):
            q8k.quantize(torch.randn(128, device=dev), block)
    with pytest.raises(ValueError, match="divisible by 48"):
        q8k.quantize(torch.randn(100, device=dev), 48)
    # the bf16 flash kernel copies 16 bytes at a time: a seq stride of
    # 196 elements, or a start 2 bytes into the storage, is refused
    fused = torch.randn(1, 8, 196, device=dev, dtype=torch.bfloat16)
    qs = fused[:, :, :128].unflatten(-1, (2, 64))
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_attention_fwd(qs, qs, qs)
    flat = torch.randn(1 + 8 * 2 * 64, device=dev, dtype=torch.bfloat16)
    qo = flat[1:].view(1, 8, 2, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_fwd(qo, qo, qo)
    # the bf16 codec GEMM needs k and m multiples of 8
    from repro_torch.kernels.boundary import kernel as K
    a = torch.randn(4, 12, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        K._gemm(a, torch.randn(12, 16, device=dev), 1)
    with pytest.raises(ValueError, match="multiples of 8"):
        K._gemm(a[:, :8], torch.randn(8, 20, device=dev), 1)
    flat = torch.randn(1 + 4096, device=dev, dtype=torch.bfloat16)
    codes = torch.empty(8 + 4096, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="come together"):
        qdq_flat(flat[:4096], 64, codes[:4096])
    # the codec's row passes move 16-byte vectors: a base 2 bytes off, a
    # row width, pool or qb off the rule are refused
    rows = torch.randn(4, 1 + 1024, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bytes past a 16-byte"):
        K.encode(rows.reshape(-1)[1:4097].view(4, 1024), None, "maxout",
                 2, 64, True)
    with pytest.raises(ValueError, match="width 12"):
        K.encode(torch.randn(4, 12, device=dev), None, "maxout", 2, 6,
                 False)
    with pytest.raises(ValueError, match="qb=4"):
        K.encode(torch.randn(4, 24, device=dev), None, "maxout", 2, 4, True)
    with pytest.raises(ValueError, match="qb=12"):
        K.encode(torch.randn(4, 96, device=dev), None, "maxout", 2, 12, True)
    with pytest.raises(ValueError, match="k=3"):
        K.encode(torch.randn(4, 96, device=dev), None, "maxout", 3, 8, True)
    with pytest.raises(ValueError, match="width 32776"):
        K.decode(torch.randn(2, 32776, device=dev),
                 torch.randn(32776, 8, device=dev), "maxout")
    with pytest.raises(ValueError, match="qb=4"):
        K.encode_quantize(torch.randn(4, 64, device=dev),
                          torch.randn(64, 16, device=dev), "bottleneck", 1,
                          4)
    q8 = torch.zeros(8 + 4 * 64, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="8 bytes past a 16-byte"):
        K.dequantize_decode(q8[8:].view(4, 64), torch.ones(4, 1, device=dev),
                            torch.randn(64, 32, device=dev), "bottleneck", 64)


def _cuda_cfg(**kw) -> ArchConfig:
    """A small dense GQA config whose head dim (64) the flash kernel
    takes; f32 so the staged and single-process paths agree exactly."""
    base = dict(name="tiny-cuda", family="dense", n_layers=4, d_model=256,
                n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
                vocab_size=256, compute_dtype="float32",
                param_dtype="float32", kernels="pallas")
    base.update(kw)
    return ArchConfig(**base)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["none", "int8"])
def test_cuda_serve_runner_disaggregated(codec):
    """2 prefill + 2 decode peers on the card through the kernels: every
    kernel of the path launches (the QDQ once per span-edge crossing),
    KV hands off once per (stage, session), and with the plain wire the
    tokens equal the single-process reference."""
    from repro_torch.serve import ServeConfig, ServeRunner, \
        reference_generate
    dev = _card()
    cfg = _cuda_cfg()
    new, n_req, batch = 4, 4, 2
    r = ServeRunner(cfg, ServeConfig(n_stages=4, max_batch=batch,
                                     max_sessions=2, codec=codec),
                    seed=0, device=dev)
    layout = r.build_pools(n_prefill=2, n_decode=2)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                size=(n_req, 24))
    kernels.reset_launches()
    reqs = [r.submit(p, new) for p in prompts]
    summary = r.run()
    launches = dict(kernels.LAUNCHES)
    toks = np.stack([q.tokens for q in reqs])
    assert summary["failed"] == 0 and summary["completed"] == n_req
    assert summary["kv_transfers"] == 4 * (n_req // batch)
    assert all(c == 0 for c in r.kv.stage_counts())
    assert launches["flash_attention_fwd"] > 0 and launches["rmsnorm"] > 0
    if codec == "none":
        assert launches["qdq_flat"] == 0
        # one reference call per session batch: the same GEMM shapes
        ref = np.concatenate([
            reference_generate(cfg, r.params, prompts[i:i + batch], new)
            for i in range(0, n_req, batch)])
        np.testing.assert_array_equal(toks, ref)
    else:
        # span edges a session crosses: one fewer than the hops of its
        # prefill chain, and of its decode chain at every later token
        hops = {pool: len({lo for lo, _ in spans})
                for pool, spans in layout.items()}
        edges = hops["prefill"] - 1 + (new - 1) * (hops["decode"] - 1)
        assert launches["qdq_flat"] == (n_req // batch) * edges


@pytest.mark.cuda
def test_cuda_default_config_serve_path_launches_kernels():
    """Regression test of the routing by ``cfg.kernels``: an unmodified
    config (``kernels`` left at its default) on the card still goes
    through the CUDA kernels."""
    from repro_torch.serve import ServeConfig, ServeRunner
    dev = _card()
    cfg = _cuda_cfg(kernels=ArchConfig.__dataclass_fields__[
        "kernels"].default)
    assert cfg.kernels == "jnp"
    r = ServeRunner(cfg, ServeConfig(n_stages=4, max_batch=2,
                                     max_sessions=2, codec="int8"),
                    seed=0, device=dev)
    r.build_pools(n_prefill=2, n_decode=2)       # span edges: int8 QDQ
    kernels.reset_launches()
    reqs = [r.submit(p, 3) for p in np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 16))]
    summary = r.run()
    assert summary["completed"] == 2 and all(q.tokens is not None
                                             for q in reqs)
    for name in ("flash_attention_fwd", "rmsnorm", "qdq_flat"):
        assert kernels.LAUNCHES[name] > 0, name


@contextlib.contextmanager
def _plain_precision():
    """cuBLAS with f32 accumulation, as the plain versions define their
    products; set only around the plain versions' outputs."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, m.allow_bf16_reduced_precision_reduction)
    m.allow_tf32 = m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = saved


def _assert_faithful(p, a, w):
    """The codec product ``p`` is faithfully rounded against the f64
    product of ``a`` and ``w`` rounded to ``a``'s dtype, or within about
    ten standard deviations of an f32 running sum's rounding error (see
    ``chip_smoke._faithful``)."""
    wd = w.to(a.dtype).double()
    ad = a.double()
    e = ad @ wd
    err = (p.double() - e).abs()
    ulp = torch.exp2(torch.floor(torch.log2(e.abs() + 1e-300))) * \
        torch.finfo(a.dtype).eps
    floor = 4 * 2.0 ** -24 * a.shape[-1] ** 0.5 * \
        torch.sqrt((ad * ad) @ (wd * wd))
    assert bool(((err < ulp) | (err <= floor)).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,kdim,m", [
    (1, 1024, 4096), (200, 1024, 4096), (1023, 1024, 4096),  # ragged rows
    (1024, 1024, 4096), (1024, 2048, 4096),      # decode, maxout decode
    (1024, 4096, 1024),                          # encode: split k
    (70, 96, 256)])                              # k not a multiple of 32
def test_cuda_codec_gemm_shapes(n, kdim, m):
    """The bf16 codec GEMM (tensor cores) at ragged row counts and at
    swarm-1b's shapes: the product faithfully rounded against the f64
    product of the rounded operands (see ``_assert_faithful``)."""
    from repro_torch.kernels.boundary import kernel as K
    dev = _card()
    g = _gen(dev)
    a = torch.randn(n, kdim, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(kdim, m, generator=g, device=dev) / kdim ** 0.5
    c = K._gemm(a, w, 1)
    assert c.dtype == torch.bfloat16 and c.shape == (n, m)
    _assert_faithful(c, a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kdim,m", [(1024, 4096), (4096, 1024)])
def test_cuda_codec_gemm_deterministic_and_row_independent(kdim, m, dtype):
    """Two calls agree to the bit, and the rows of a 200-row call (at
    row 300, across the 128-row tiles) equal the same rows of the
    1024-row call: tiles and the split of k follow (k, m), never n."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.boundary import kernel as K
    dev = _card()
    g = _gen(dev)
    code = _lib.DTYPE_CODES[dtype]
    a = torch.randn(1024, kdim, generator=g, device=dev).to(dtype)
    w = torch.randn(kdim, m, generator=g, device=dev) / kdim ** 0.5
    c = K._gemm(a, w, code)
    assert torch.equal(K._gemm(a, w, code), c)
    assert torch.equal(K._gemm(a[300:500], w, code), c[300:500])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,k,quantize", [
    ("bottleneck", 1, False), ("bottleneck", 1, True),
    ("maxout", 2, False), ("maxout", 4, True)])
def test_cuda_codec_kernels_match_plain(mode, k, quantize, dtype):
    """Stage by stage on the kernels' own intermediates: LayerNorm passes
    (with pooling and QDQ) bit-equal to the plain version, the codec
    GEMM's product faithfully rounded; end to end against the plain
    version (cuBLAS's product) within the flash bound in f32."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.boundary import kernel as K
    from repro_torch.kernels.boundary import ref as R
    dev = _card()
    g = _gen(dev)
    d = 256
    c = 96 if mode == "bottleneck" else d // k
    x = (torch.randn(3, 70, d, generator=g, device=dev) * 2 + 1).to(dtype)
    w = (torch.randn(d, c, generator=g, device=dev) / 16
         if mode == "bottleneck" else None)
    qb = R.wire_qblock(c)
    code = _lib.DTYPE_CODES[dtype]
    before = dict(kernels.LAUNCHES)
    z = K.encode(x, w, mode, k, qb, quantize)
    assert kernels.LAUNCHES["encode"] == before["encode"] + 1
    if mode == "bottleneck":
        h = K._ln_rows(x.reshape(-1, d), 1, 0, code)
        assert torch.equal(h, R._ln(x.reshape(-1, d)))
        prod = K._gemm(h, w, code)
        _assert_faithful(prod, h, w)
        last = R._ln(prod).reshape(3, 70, c)
    else:
        last = R.encode_ref(x, None, mode, k)
    assert torch.equal(z, R.qdq_ref(last, qb) if quantize else last)
    if dtype == torch.float32 and not quantize:
        with _plain_precision():
            ref = R.encode_ref(x, w, mode, k)
        torch.testing.assert_close(z, ref, atol=FLASH_BOUND[dtype], rtol=0)
    w_d = torch.randn(c, d, generator=g, device=dev) / 10
    y = K.decode(z, w_d, mode)
    assert kernels.LAUNCHES["decode"] == before["decode"] + 1
    assert y.dtype == dtype and y.shape == (3, 70, d)
    a = z.reshape(-1, c)
    if mode == "maxout":
        a = K._ln_rows(a, 1, 0, code)
        assert torch.equal(a, R._ln(z.reshape(-1, c)))
    _assert_faithful(y.reshape(-1, d), a, w_d)


@pytest.mark.cuda
def test_cuda_swarm_training_matches_staged_reference():
    """A 3-stage ALBERT-shared bottleneck swarm (wire quantized) trains
    on the card through the flash, encode, decode and qdq kernels, with
    the staged reference's losses."""
    from repro_torch.core.swarm import SwarmConfig, SwarmRunner
    from repro_torch.optim import adamw
    from repro_torch.train.reference import reference_losses
    dev = _card()
    cfg = _cuda_cfg(n_layers=6, share_groups=3, norm="layernorm",
                    act="geglu", boundary_compression="bottleneck",
                    bottleneck_dim=64, pipeline_stages=3, wire_quant=True)
    opt = adamw(lr=1e-3)
    r = SwarmRunner(cfg, SwarmConfig(
        n_stages=3, microbatch_size=2, seq_len=64, global_batch=8,
        n_trainers=1, rebalance_period=0.0, codec="bottleneck",
        max_steps=3), opt, seed=0, device=dev)
    r.build(peers_per_stage=1)
    kernels.reset_launches()
    losses = r.run(until=1e6)["loss"]
    for name in ("flash_attention_fwd", "encode", "decode", "qdq_flat"):
        assert kernels.LAUNCHES[name] > 0, name
    ref = reference_losses(cfg, r.programs, opt, 0, 3, 64, 2, 8,
                           device=dev)
    # one trainer, one peer per stage: the reference's order of
    # accumulation, so the same f32 arithmetic on the same kernels
    np.testing.assert_allclose(losses, ref, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_quant8_pair_matches_plain(dtype):
    """The quant8 pair through its ops (a ragged length, zero-padded):
    codes, scales and dequantized values bit-equal to the plain
    versions, one launch of each kernel per call."""
    from repro_torch.kernels.quant8 import ops, ref
    dev = _card()
    g = _gen(dev)
    x = (torch.randn(3, 1000, generator=g, device=dev) * 5).to(dtype)
    x.view(-1)[:64] = torch.arange(64, device=dev).to(dtype) - 32.5
    x.view(-1)[63] = 127.0                   # exact .5 ties on the grid
    before = dict(kernels.LAUNCHES)
    q, s, meta = ops.quantize(x, 64)
    y = ops.dequantize(q, s, meta)
    assert kernels.LAUNCHES["quant8_quantize"] == \
        before["quant8_quantize"] + 1
    assert kernels.LAUNCHES["quant8_dequantize"] == \
        before["quant8_dequantize"] + 1
    flat = torch.nn.functional.pad(x.reshape(-1), (0, meta[2]))
    rq, rs = ref.quantize_ref(flat, 64)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    assert torch.equal(y, ref.dequantize_ref(
        rq, rs, dtype).reshape(-1)[:x.numel()].reshape(x.shape))
    assert torch.equal(y, quant8._roundtrip(x, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", QDQ_BLOCKS)
def test_cuda_quant8_kernels_every_block(block, dtype):
    """``quant8.kernel.quantize`` / ``dequantize`` at every kind of
    block: codes, scales and values (in bf16 and f32) bit-equal to the
    plain versions (signed zeros included), with exact .5 ties and an
    all-zero block; an unaligned view of x, and unaligned codes, equal
    to the aligned call; two calls bit-equal; blocks 10-29 alone equal
    to the same blocks of the whole call."""
    from repro_torch.kernels.quant8 import kernel as K
    from repro_torch.kernels.quant8 import ref as R
    dev = _card()
    nb = 40
    n = nb * block
    x = torch.randn(n, generator=_gen(dev), device=dev) * 4
    m = min(block, 64) - 1
    x[:m] = torch.arange(m, device=dev, dtype=torch.float32) - m // 2 + 0.5
    x[m] = 127.0                          # block 0's absmax: exact ties
    x[2 * block:3 * block] = 0.0          # an all-zero block (scale 0)
    x = x.to(dtype)
    q, s = K.quantize(x, block)
    rq, rs = R.quantize_ref(x, block)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    assert float(s[2, 0]) == 0.0
    ys = {}
    for out_dt in (torch.bfloat16, torch.float32):
        ys[out_dt] = K.dequantize(q, s, out_dt)
        assert _same_bits(ys[out_dt], R.dequantize_ref(rq, rs, out_dt))
    again = K.quantize(x, block)
    assert torch.equal(again[0], q) and torch.equal(again[1], s)
    assert _same_bits(K.dequantize(q, s, dtype), ys[dtype])
    buf = torch.empty(n + 1, dtype=dtype, device=dev)
    buf[1:] = x
    uq, us = K.quantize(buf[1:], block)
    assert torch.equal(uq, q) and torch.equal(us, s)
    qbuf = torch.empty(n + 1, dtype=torch.int8, device=dev)
    qbuf[1:] = q.reshape(-1)
    assert _same_bits(K.dequantize(qbuf[1:].view(nb, block), s, dtype),
                      ys[dtype])
    pq, ps = K.quantize(x[10 * block:30 * block], block)
    assert torch.equal(pq, q[10:30]) and torch.equal(ps, s[10:30])
    assert _same_bits(K.dequantize(q[10:30], s[10:30], dtype),
                      ys[dtype][10:30])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,k", [("bottleneck", 1), ("maxout", 2),
                                    ("maxout", 4)])
def test_cuda_wire_codes_pair_matches_plain(mode, k, dtype):
    """encode_quantize held on its own intermediate (codes and scales of
    the LN of the kernel's product bit-equal to the plain version's);
    dequantize_decode's product faithfully rounded against the f64
    product of the plain dequantized (maxout: LayerNorm'd) rows."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.boundary import kernel as K
    from repro_torch.kernels.boundary import ref as R
    dev = _card()
    g = _gen(dev)
    d = 256
    c = 128 if mode == "bottleneck" else d // k
    x = (torch.randn(3, 70, d, generator=g, device=dev) * 2 + 1).to(dtype)
    w = (torch.randn(d, c, generator=g, device=dev) / 16
         if mode == "bottleneck" else None)
    qb = R.wire_qblock(c)
    code = _lib.DTYPE_CODES[dtype]
    q, s = K.encode_quantize(x, w, mode, k, qb)
    assert q.shape == (3, 70, c) and s.shape == (3, 70, c // qb)
    if mode == "bottleneck":
        prod = K._gemm(K._ln_rows(x.reshape(-1, d), 1, 0, code), w, code)
        rq, rs = R.quantize_rows(R._ln(prod).reshape(3, 70, c), qb)
    else:
        rq, rs = R.encode_quantize_ref(x, None, mode, k, qb)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    w_d = torch.randn(c, d, generator=g, device=dev) / 10
    for out_dt in (torch.float32, dtype):
        y = K.dequantize_decode(q, s, w_d, mode, qb, out_dt)
        assert y.dtype == out_dt and y.shape == (3, 70, d)
        blocks = q.float().reshape(3, 70, c // qb, qb)
        a = quant8.div127(blocks * s[..., None]).reshape(-1, c).to(out_dt)
        if mode == "maxout":
            a = R._ln(a)
        _assert_faithful(y.reshape(-1, d), a, w_d)


@pytest.mark.cuda
def test_cuda_swarm_migration_and_rollback_equal_fault_free(tmp_path):
    """On the card, a run whose stage-1 peer migrates (Alg. 2) and a run
    whose only stage-1 peer dies past the step-2 checkpoint (global
    rollback, then a cold resume) give the fault-free losses bit for
    bit."""
    from repro_torch.core.peer import MBPS, DeviceProfile
    from repro_torch.core.sim import Sleep
    from repro_torch.core.swarm import SwarmConfig, SwarmRunner
    from repro_torch.optim import adamw
    dev = _card()
    cfg = _cuda_cfg(n_layers=6, share_groups=3, norm="layernorm",
                    act="geglu", boundary_compression="bottleneck",
                    bottleneck_dim=64, pipeline_stages=3)
    slow = DeviceProfile("slow", 1e8, 400 * MBPS, 400 * MBPS, 0.005)

    def run(peers, gb, steps, trainers, period=0.0, kill=False, **kw):
        r = SwarmRunner(cfg, SwarmConfig(
            n_stages=3, microbatch_size=2, seq_len=32, global_batch=gb,
            n_trainers=trainers, rebalance_period=period,
            codec="bottleneck", max_steps=steps, **kw), adamw(lr=1e-3),
            seed=0, device=dev, profile_fn=lambda i: slow)
        r.build(peers)

        def strand():
            while not r.stopped:
                if r.step == 3 and r.ledger.stage_counts()[1] > 0:
                    r._fail_peer(r._covering(1)[0])
                    yield from r._join_new_peer(span=range(1, 2))
                    return
                yield Sleep(0.01)
        if kill:
            r.sim.spawn(strand())
        return r, r.run(until=1e6)
    _, base = run([1, 2, 1], 16, 3, 4)
    _, mig = run([1, 2, 1], 16, 3, 4, period=0.31)
    assert mig["migrations"] >= 1
    assert mig["loss"] == base["loss"]
    _, base = run([1, 1, 1], 8, 5, 2)
    ckpt = str(tmp_path / "ckpt")
    r, rb = run([1, 1, 1], 8, 4, 2, kill=True, ckpt_dir=ckpt,
                ckpt_period=2)
    assert rb["rollbacks"] == [(3, 2)]
    assert rb["loss"] == base["loss"][:4]
    del r
    _, resumed = run([1, 1, 1], 8, 5, 2, ckpt_dir=ckpt, ckpt_period=2)
    assert resumed["loss"] == base["loss"][4:]
