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
from repro_torch.configs import REGISTRY
from repro_torch.kernels.rmsnorm.kernel import plan_for, rmsnorm
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


# every registered RMSNorm width (the register path) and one that is no
# whole number of 16-byte vectors (the general path)
RMS_WIDTHS = sorted({c.d_model for c in REGISTRY.values()
                     if c.norm == "rmsnorm"}) + [1001]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 2, 1024, 4608])
@pytest.mark.parametrize("d", RMS_WIDTHS)
def test_cuda_rmsnorm_both_paths_bit_equal_one_launch(d, rows, dtype):
    """rmsnorm equals its plain version on an aligned tensor (the register
    path at the registered widths) and on a view one element past it (the
    general path), one launch a call."""
    dev = _card()
    g = _gen(dev)
    full = torch.randn(rows * d + 1, generator=g, device=dev).to(dtype)
    s = torch.randn(d, generator=g, device=dev) + 1
    aligned = "general" if d == 1001 else "registers"
    for x, path in ((full[:-1].view(rows, d), aligned),
                    (full[1:].view(rows, d), "general")):
        assert plan_for(x, s).path == path
        before = kernels.LAUNCHES["rmsnorm"]
        out = rmsnorm(x, s)
        assert kernels.LAUNCHES["rmsnorm"] == before + 1
        assert torch.equal(out, rmsnorm_ref(x, s))


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


def _span_cfg(**kw) -> ArchConfig:
    """swarm-1b's structure at small width, bf16 compute: 3 stages of one
    ALBERT-shared LayerNorm/GeGLU layer applied twice, a bottleneck
    codec at each stage edge."""
    return _cuda_cfg(n_layers=6, share_groups=3, norm="layernorm",
                     act="geglu", boundary_compression="bottleneck",
                     bottleneck_dim=64, pipeline_stages=3,
                     compute_dtype="bfloat16", **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("wire_quant", [False, True])
def test_cuda_span_equals_chain_to_the_bit(wire_quant):
    """Spans [0,2), [1,3) and [0,3) of a bf16 swarm: output or loss,
    inbound cotangent and every covered stage's gradients bit-equal to
    the chain of single-stage programs, with the launches of the
    chain's backwards.  Under ``wire_quant`` the learned codec's QDQ is
    part of each stage program, so it runs at fused boundaries too."""
    from repro_torch.runtime import build_span_program, \
        build_stage_programs, init_stage_params
    from repro_torch.tree import tree_leaves
    dev = _card()
    cfg = _span_cfg(wire_quant=wire_quant)
    progs = build_stage_programs(cfg, 3, 64)
    params = init_stage_params(progs, 0, dev)
    g = _gen(dev)
    tok = torch.randint(0, 256, (2, 64), generator=g, device=dev)
    lab = torch.randint(0, 256, (2, 64), generator=g, device=dev)
    xs = [tok, progs[0].fwd(params[0], tok)]
    xs.append(progs[1].fwd(params[1], xs[1]))
    kernels.reset_launches()
    loss, gx2, gp2 = progs[2].bwd(params[2], xs[2], lab)
    gx1, gp1 = progs[1].bwd(params[1], xs[1], gx2)
    _, gp0 = progs[0].bwd(params[0], tok, gx1)
    chain = dict(kernels.LAUNCHES)
    gxs, gps = {1: gx1, 2: gx2}, {0: gp0, 1: gp1, 2: gp2}
    for lo, hi in ((0, 2), (1, 3), (0, 3)):
        prog = build_span_program(cfg, 3, 64, (lo, hi))
        ps = tuple(params[lo:hi])
        if hi == 3:
            assert _same_bits(prog.fwd(ps, xs[lo], lab), loss)
            kernels.reset_launches()
            got_loss, gx, got = prog.bwd(ps, xs[lo], lab)
            assert _same_bits(got_loss, loss)
        else:
            assert _same_bits(prog.fwd(ps, xs[lo]), xs[hi])
            kernels.reset_launches()
            gx, got = prog.bwd(ps, xs[lo], gxs[hi])
        launches = dict(kernels.LAUNCHES)
        assert (gx is None) == (lo == 0)
        if lo:
            assert _same_bits(gx, gxs[lo])
        for s, tree in zip(range(lo, hi), got):
            for a, b in zip(tree_leaves(tree), tree_leaves(gps[s])):
                assert _same_bits(a, b)
        if (lo, hi) == (0, 3):
            assert launches == chain
        for name in ("flash_attention_fwd", "encode", "decode"):
            assert launches[name] > 0, name
        # one cotangent QDQ per covered sending stage's encode backward
        assert launches["qdq_flat"] == (
            len([s for s in range(lo, hi) if s < 2]) if wire_quant else 0)


@pytest.mark.cuda
def test_cuda_span_int8_wire_at_span_edges_only():
    """The int8 wire codec (``codec="int8"``) on a [0, 2) span of a
    4-stage bf16 pipeline: no QDQ at the fused boundary (the span's
    output equals the raw two-stage chain), one ``qdq_flat`` launch per
    edge crossing, bit-equal to the plain round trip."""
    from repro_torch.runtime import PipelineExecutor, \
        build_numeric_executors
    dev = _card()
    cfg = _cuda_cfg(compute_dtype="bfloat16")
    num = build_numeric_executors(cfg, 4, 64, compress="int8", device=dev)
    pex = PipelineExecutor(cfg, 4, 64, (0, 2), compress="int8", device=dev)
    sts = [e.init_state(s) for s, e in enumerate(num)]
    pst = pex.init_state(7)
    for s in range(2):
        pex.restore(pst, num[s].snapshot(sts[s]), stage=s)
    tok = torch.randint(0, 256, (2, 64), generator=_gen(dev), device=dev)
    kernels.reset_launches()
    y = pex.run_fwd(pst, tok)
    assert kernels.LAUNCHES["qdq_flat"] == 0
    assert _same_bits(y, num[1].run_fwd(sts[1], num[0].run_fwd(sts[0],
                                                                tok)))
    w = pex.wire_fwd(y)
    gw = pex.wire_bwd(torch.randn(y.shape, generator=_gen(dev),
                                  device=dev).to(y.dtype))
    assert kernels.LAUNCHES["qdq_flat"] == 2
    assert _same_bits(w, quant8._roundtrip(y, 64))
    assert gw.dtype == y.dtype and gw.shape == y.shape


@pytest.mark.cuda
def test_cuda_span_swarm_equals_single_stage_swarm():
    """A swarm of one [0, 2) span peer and a stage-2 peer trains the
    single-stage swarm's losses to the bit on the card, through the
    flash, encode and decode kernels, with half its host wire bytes."""
    from repro_torch.core.swarm import SwarmConfig, SwarmRunner
    from repro_torch.optim import adamw
    dev = _card()
    cfg = _span_cfg()

    def run(span):
        r = SwarmRunner(cfg, SwarmConfig(
            n_stages=3, microbatch_size=2, seq_len=64, global_batch=8,
            n_trainers=2, rebalance_period=0.0, codec="bottleneck",
            max_steps=3), adamw(lr=1e-3), seed=0, device=dev)
        r.build([0, 0, 1] if span else 1)
        if span:
            r.add_peer(range(0, 2))
        kernels.reset_launches()
        m = r.run(until=1e6)
        return m, dict(kernels.LAUNCHES)

    single, _ = run(False)
    span, launches = run(True)
    assert span["loss"] == single["loss"]
    assert span["wire_bytes"] * 2 == single["wire_bytes"]
    for name in ("flash_attention_fwd", "encode", "decode"):
        assert launches[name] > 0, name


def _dispatch_executors(dev, span: bool):
    """Single-stage executors of a bf16 swarm-1b-shaped pipeline with
    their states, or one [0, 3) ``PipelineExecutor`` holding the same
    three stages."""
    from repro_torch.runtime import PipelineExecutor, \
        build_numeric_executors
    cfg = _span_cfg()
    num = build_numeric_executors(cfg, 3, 64, device=dev)
    sts = [e.init_state(s) for s, e in enumerate(num)]
    if not span:
        return list(zip(num, sts))
    pex = PipelineExecutor(cfg, 3, 64, (0, 3), device=dev)
    pst = pex.init_state(7)
    for s in range(3):
        pex.restore(pst, num[s].snapshot(sts[s]), stage=s)
    return [(pex, pst)]


@pytest.mark.cuda
@pytest.mark.parametrize("span", [False, True], ids=["numeric", "span"])
def test_cuda_dispatch_equals_run_to_the_bit(span):
    """``dispatch_fwd`` / ``dispatch_bwd`` then collect: the values of
    ``run_fwd`` / ``run_bwd`` to the bit, with the same kernel launches,
    for single-stage executors and a fused span."""
    from repro_torch.tree import tree_leaves
    dev = _card()
    hops = _dispatch_executors(dev, span)
    g = _gen(dev)
    tok = torch.randint(0, 256, (2, 64), generator=g, device=dev)
    lab = torch.randint(0, 256, (2, 64), generator=g, device=dev)
    outs = {}
    for mode in ("run", "dispatch"):
        kernels.reset_launches()
        x, inputs, res = tok, [], []
        for ex, st in hops:
            last = ex.stages.stop == 3
            args = (st, x, lab) if last else (st, x)
            y = (ex.run_fwd(*args) if mode == "run"
                 else ex.dispatch_fwd(*args)())
            inputs.append(x)
            res.append(y)
            x = y if last else ex.wire_fwd(y)
        dy = None
        for (ex, st), inp in zip(reversed(hops), reversed(inputs)):
            kw = {"labels": lab} if ex.stages.stop == 3 else {"dy": dy}
            out = (ex.run_bwd(st, inp, **kw) if mode == "run"
                   else ex.dispatch_bwd(st, inp, **kw)())
            res.append(out)
            dy = out[1]
        outs[mode] = (res, dict(kernels.LAUNCHES))
    assert outs["run"][1] == outs["dispatch"][1]
    got, want = tree_leaves(outs["dispatch"][0]), tree_leaves(outs["run"][0])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert _same_bits(a, b)


@pytest.mark.cuda
def test_cuda_collect_waits_on_an_event_not_the_host(monkeypatch):
    """The collect thunk holds a CUDA event recorded behind the
    program's launches and orders the consumer's stream on it: it runs
    under ``torch.cuda.set_sync_debug_mode("error")`` (any synchronising
    call raises) and never calls ``torch.cuda.synchronize``."""
    dev = _card()
    (ex, st), = _dispatch_executors(dev, span=True)
    g = _gen(dev)
    tok = torch.randint(0, 256, (2, 64), generator=g, device=dev)
    lab = torch.randint(0, 256, (2, 64), generator=g, device=dev)
    calls = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: (calls.append(a), real(*a, **k)))
    for collect in (ex.dispatch_fwd(st, tok, lab),
                    ex.dispatch_bwd(st, tok, labels=lab)):
        assert isinstance(collect.event, torch.cuda.Event)
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = collect()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert out is not None
    assert calls == []
    collect.event.synchronize()
    assert collect.event.query()


# ------------------------------------------------ the attention families
FAMILY_FLASH_CASES = [
    # B, Sq, Sk, H, KV, Dqk, Dv, window: each new head-dim pair at the
    # edges of the kernel's query and key tiles, causal and windowed
    (2, 130, 130, 4, 1, 120, 120, 0),        # danube's 120 (pad columns)
    (1, 200, 200, 8, 2, 120, 120, 70),       # window straddling key tiles
    (2, 65, 65, 8, 1, 256, 256, 0),          # gemma's 256, MQA, 32-key tiles
    (1, 24, 150, 4, 1, 256, 256, 40),        # query offset + window
    (2, 129, 129, 4, 4, 192, 128, 0),        # MLA: qk 192 against v 128
    (1, 100, 100, 4, 4, 192, 128, 33),       # MLA with a window
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FAMILY_FLASH_CASES)
def test_cuda_flash_family_head_dims(case, dtype):
    """Every new (Dqk, Dv) pair against the plain version with its lse,
    at MLA's explicit scale where Dv differs; two calls bit-equal and
    each batch row alone equal to that row of the batch call."""
    dev = _card()
    B, Sq, Sk, H, KV, D, Dv, window = case
    g = _gen(dev)
    q = torch.randn(B, Sq, H, D, generator=g, device=dev).to(dtype)
    k = torch.randn(B, Sk, KV, D, generator=g, device=dev).to(dtype)
    v = torch.randn(B, Sk, KV, Dv, generator=g, device=dev).to(dtype)
    scale = D ** -0.5 if D == Dv else 192 ** -0.5
    out, lse = flash_attention_fwd(q, k, v, True, window, scale,
                                   with_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = flash_fwd_ref(q, k, v, True, window, Sk - Sq, 64, 64,
                                 scale)
    assert out.dtype == dtype and out.shape == (B, Sq, H, Dv)
    assert float((out.float() - ref.float()).abs().max()) <= \
        FLASH_BOUND[dtype]
    assert float((lse - ref_lse).abs().max()) <= 1e-4
    again = flash_attention_fwd(q, k, v, True, window, scale, with_lse=True)
    assert _same_bits(again[0], out) and _same_bits(again[1], lse)
    for b in range(B):
        one = flash_attention_fwd(q[b:b + 1], k[b:b + 1], v[b:b + 1], True,
                                  window, scale, with_lse=True)
        assert _same_bits(one[0], out[b:b + 1])
        assert _same_bits(one[1], lse[b:b + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("dqk,dv", [(96, 96), (128, 64), (192, 192),
                                    (256, 128), (32, 32)])
def test_cuda_flash_refuses_other_head_dim_pairs(dqk, dv):
    dev = _card()
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(1, 8, 2, dqk, device=dev).to(dtype)
        v = torch.randn(1, 8, 2, dv, device=dev).to(dtype)
        before = kernels.LAUNCHES["flash_attention_fwd"]
        with pytest.raises(ValueError, match="head dims"):
            flash_attention_fwd(q, q, v)
        assert kernels.LAUNCHES["flash_attention_fwd"] == before


def _family_cfg(kind: str, dtype: str) -> ArchConfig:
    """A small MoE (top-2 of 4 experts + a shared expert; attention head
    dim 64) or MLA + MoE (qk 128 + 64 against v 128: the kernel's
    (192, 128) pair) config."""
    from repro_torch.models.config import MLAConfig, MoEConfig
    moe = MoEConfig(num_experts=4, num_shared=1, top_k=2, d_ff_expert=128,
                    capacity_factor=1.25)
    if kind == "moe":
        return _cuda_cfg(name="tiny-moe", family="moe", moe=moe,
                         compute_dtype=dtype, param_dtype=dtype)
    return _cuda_cfg(name="tiny-mla", family="moe", n_layers=2,
                     n_kv_heads=4, block_pattern=("mla_moe",) * 2, moe=moe,
                     mla=MLAConfig(kv_lora_rank=64, q_lora_rank=96,
                                   qk_nope_dim=128, qk_rope_dim=64,
                                   v_head_dim=128),
                     compute_dtype=dtype, param_dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_moe_repeats_to_the_bit(dtype):
    """``apply_moe`` on the card: two calls bit-equal (one kept row a
    slot, so no order of scatter changes a bit), the router f32."""
    from repro_torch.models import layers as L
    from repro_torch.models import params as P
    dev = _card()
    cfg = _family_cfg("moe", dtype)
    p = P.init(0, L.moe_specs(cfg), dev)
    assert p["router"].dtype == torch.float32
    x = torch.randn(2, 300, cfg.d_model, generator=_gen(dev),
                    device=dev).to(cfg.compute_jdtype)
    y, aux = L.apply_moe(cfg, p, x)
    y2, aux2 = L.apply_moe(cfg, p, x)
    assert _same_bits(y, y2) and _same_bits(aux, aux2)
    assert bool(torch.isfinite(y.float()).all())


@pytest.mark.cuda
def test_cuda_moe_never_syncs_the_host():
    """``apply_moe`` with its aux loss runs under
    ``torch.cuda.set_sync_debug_mode("error")``: no routing count, slot
    or capacity is read back to the host, at prefill or decode width."""
    from repro_torch.models import layers as L
    from repro_torch.models import params as P
    dev = _card()
    cfg = _family_cfg("moe", "bfloat16")
    p = P.init(0, L.moe_specs(cfg), dev)
    for seq in (300, 1):
        x = torch.randn(2, seq, cfg.d_model, generator=_gen(dev),
                        device=dev).to(cfg.compute_jdtype)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, aux = L.apply_moe(cfg, p, x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert y.shape == x.shape and bool(torch.isfinite(aux))
    # a microbatch split over two data shards: the shards' route counts
    # cross as int tensors and the capacity comes from host integers
    x = torch.randn(2, 300, cfg.d_model, generator=_gen(dev),
                    device=dev).to(cfg.compute_jdtype)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ys, auxs = _moe_split(cfg, p, x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ys.shape == x.shape and bool(torch.isfinite(auxs))


def _moe_split(cfg, p, x, n: int = 2):
    """``apply_moe`` over ``n`` row shards of ``x`` with the split context
    of the whole microbatch: (outputs joined, aux shares summed)."""
    from repro_torch.models import layers as L
    ys, auxs = L.apply_moe_shards(cfg, [p] * n, list(x.chunk(n)))
    return torch.cat(ys), torch.stack(auxs).sum()


@pytest.mark.cuda
def test_cuda_moe_split_is_bit_equal_on_repeat_and_near_whole():
    """The split MoE on the card: bit-equal on repeat, and within the
    families' bf16 bound (2e-2) of the whole microbatch's layer; the aux
    shares add up to the whole layer's aux."""
    from repro_torch.models import layers as L
    from repro_torch.models import params as P
    dev = _card()
    cfg = _family_cfg("moe", "bfloat16")
    p = P.init(0, L.moe_specs(cfg), dev)
    x = torch.randn(4, 64, cfg.d_model, generator=_gen(dev),
                    device=dev).to(cfg.compute_jdtype)
    y1, a1 = _moe_split(cfg, p, x)
    y2, a2 = _moe_split(cfg, p, x)
    assert _same_bits(y1, y2) and _same_bits(a1, a2)
    y, a = L.apply_moe(cfg, p, x)
    scale = float(y.float().abs().max())
    assert float((y1.float() - y.float()).abs().max()) <= 2e-2 * scale
    assert abs(float(a1) - float(a)) <= 1e-5 * abs(float(a))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["moe", "mla"])
def test_cuda_family_serve_matches_reference(kind):
    """A tiny MoE and a tiny MLA + MoE config served over two stages on
    the card, token for token against the single-process reference on
    the same weights (one reference call per session batch); flash and
    rmsnorm launch."""
    from repro_torch.serve import ServeConfig, ServeRunner, \
        reference_generate
    dev = _card()
    cfg = _family_cfg(kind, "float32")
    new, batch = 4, 2
    r = ServeRunner(cfg, ServeConfig(n_stages=2, max_batch=batch,
                                     max_sessions=1), seed=0, device=dev)
    r.add_peer((0, 1), pool="decode")
    r.add_peer((1, 2), pool="decode")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                size=(4, 40))
    kernels.reset_launches()
    reqs = [r.submit(p, new) for p in prompts]
    summary = r.run()
    assert summary["completed"] == 4 and summary["failed"] == 0
    assert kernels.LAUNCHES["flash_attention_fwd"] > 0
    assert kernels.LAUNCHES["rmsnorm"] > 0
    ref = np.concatenate([reference_generate(cfg, r.params,
                                             prompts[i:i + batch], new)
                          for i in range(0, 4, batch)])
    np.testing.assert_array_equal(np.stack([q.tokens for q in reqs]), ref)


def _recurrent_cfg(kind: str) -> ArchConfig:
    """Tiny recurrent configs: four mamba layers, the xLSTM pair twice
    (mLSTM and sLSTM, LayerNorm, no attention), or hymba (attention at
    head dim 64 beside mamba heads, window 32); chunks of 16."""
    from repro_torch.models.config import SSMConfig
    ssm = SSMConfig(state_dim=16, chunk=16)
    if kind == "mamba":
        return _cuda_cfg(name="tiny-mamba", block_pattern=("mamba",) * 4,
                         ssm=ssm)
    if kind == "xlstm":
        return _cuda_cfg(name="tiny-xlstm", norm="layernorm", d_ff=0,
                         block_pattern=("mlstm", "slstm") * 2, ssm=ssm)
    return _cuda_cfg(name="tiny-hymba", family="hybrid", sliding_window=32,
                     ssm=ssm)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mamba", "xlstm", "hymba"])
def test_cuda_recurrent_serve_matches_reference(kind):
    """A tiny mamba, xLSTM and hymba config served over two stages on the
    card (prompts of 40: two chunks and a ragged one of 8; hymba past its
    window), token for token against the single-process reference on the
    same weights; the prefill's logits and every cache leaf bit-equal on
    a second call; hymba's flash and rmsnorm launch."""
    from repro_torch.models import model as model_lib
    from repro_torch.serve import ServeConfig, ServeRunner, \
        reference_generate
    from repro_torch.tree import tree_leaves
    dev = _card()
    cfg = _recurrent_cfg(kind)
    new, batch = 4, 2
    r = ServeRunner(cfg, ServeConfig(n_stages=2, max_batch=batch,
                                     max_sessions=1), seed=0, device=dev)
    r.add_peer((0, 1), pool="decode")
    r.add_peer((1, 2), pool="decode")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                size=(4, 40))
    kernels.reset_launches()
    reqs = [r.submit(p, new) for p in prompts]
    summary = r.run()
    assert summary["completed"] == 4 and summary["failed"] == 0
    assert all(c == 0 for c in r.kv.stage_counts())
    if kind == "hymba":
        assert kernels.LAUNCHES["flash_attention_fwd"] > 0
        assert kernels.LAUNCHES["rmsnorm"] > 0
    ref = np.concatenate([reference_generate(cfg, r.params,
                                             prompts[i:i + batch], new)
                          for i in range(0, 4, batch)])
    np.testing.assert_array_equal(np.stack([q.tokens for q in reqs]), ref)
    toks = torch.as_tensor(prompts[:batch], device=dev)
    with torch.inference_mode():
        runs = [model_lib.lm_prefill(cfg, r.params, toks, cache_len=44)
                for _ in range(2)]
    (la, ca), (lb, cb) = runs
    assert _same_bits(la, lb)
    for a, b in zip(tree_leaves(ca), tree_leaves(cb)):
        assert _same_bits(a, b)


# whisper-large-v3's bidirectional flash calls, q_offset 0 (B, Sq, Sk):
# the training cross-attention (448 decoder tokens against 1,500 frames)
# and the encoder's self-attention over the frames
WHISPER_FLASH = [(2, 448, 1500), (2, 1500, 1500)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk", WHISPER_FLASH)
def test_cuda_whisper_flash_reaches_the_kernel(B, Sq, Sk, dtype,
                                               monkeypatch):
    """``models/flash.py::flash_attention`` at whisper's bidirectional
    shapes and query offset 0 launches the kernel once and never calls
    the plain forward, forward-only and under autograd (with ``lse``),
    each output within FLASH_BOUND of ``flash_fwd_ref``."""
    from repro_torch.models import flash as flash_lib
    dev = _card()
    plain = []
    orig = flash_lib.flash_fwd_ref
    monkeypatch.setattr(flash_lib, "flash_fwd_ref",
                        lambda *a, **k: plain.append(1) or orig(*a, **k))
    g = _gen(dev)
    q = torch.randn(B, Sq, 20, 64, generator=g, device=dev).to(dtype)
    k = torch.randn(B, Sk, 20, 64, generator=g, device=dev).to(dtype)
    v = torch.randn(B, Sk, 20, 64, generator=g, device=dev).to(dtype)
    ref, _ = orig(q, k, v, False, 0, 0, 512, 1024)
    before = kernels.LAUNCHES["flash_attention_fwd"]
    out = flash_lib.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention_fwd"] == before + 1
    qg = q.detach().clone().requires_grad_()
    out_g = flash_lib.flash_attention(qg, k, v, causal=False)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention_fwd"] == before + 2
    assert not plain
    for o in (out, out_g.detach()):
        assert o.shape == (B, Sq, 20, 64) and o.dtype == dtype
        assert float((o.float() - ref.float()).abs().max()) <= \
            FLASH_BOUND[dtype]


@pytest.mark.cuda
def test_cuda_whisper_prefill_matches_cpu(monkeypatch):
    """A tiny bf16 whisper (head dim 64) ``whisper_prefill`` on the card:
    one flash launch per encoder layer and two per decoder layer, no
    plain flash call, and its logits and caches within bf16 bounds (5e-2
    of each tensor's scale) of the same prefill on the CPU, from the same
    weights (``wq`` / ``wk`` scaled by 0.1)."""
    from repro_torch.models import flash as flash_lib
    from repro_torch.models import params as P
    from repro_torch.models import whisper as W
    from repro_torch.tree import tree_leaves, tree_map
    dev = _card()
    plain = []
    orig = flash_lib.flash_fwd_ref
    monkeypatch.setattr(flash_lib, "flash_fwd_ref",
                        lambda *a, **k: plain.append(1) or orig(*a, **k))
    cfg = ArchConfig(name="tiny-whisper", family="audio", n_layers=2,
                     d_model=128, n_heads=2, n_kv_heads=2, d_ff=256,
                     vocab_size=256, head_dim=64, rope="none", act="gelu",
                     norm="layernorm", encoder_layers=2, encoder_max_len=100,
                     frontend="audio_stub")
    params = P.init(0, W.whisper_specs(cfg), "cpu")
    # the init draws wq / wk at std 1/sqrt(n_heads): scaled down, so that
    # no softmax is saturated enough for bf16 rounding to pick another key
    for blk in ("enc_blocks", "dec_blocks"):
        for att in ("attn", "xattn"):
            for key in ("wq", "wk"):
                if att in params[blk]:
                    params[blk][att][key].mul_(0.1)
    g = torch.Generator().manual_seed(0)
    batch = {"audio_embed": torch.randn(2, 100, 128, generator=g).to(
                 torch.bfloat16),
             "tokens": torch.randint(0, 256, (2, 30), generator=g,
                                     dtype=torch.int32)}
    with torch.inference_mode():
        want = W.whisper_prefill(cfg, params, batch, cache_len=40,
                                 last_only=False)
        kernels.reset_launches()
        got = W.whisper_prefill(cfg, tree_map(lambda a: a.to(dev), params),
                                tree_map(lambda a: a.to(dev), batch),
                                cache_len=40, last_only=False)
        torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention_fwd"] == 2 + 2 * 2
    assert not plain
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a, b = a.cpu().float(), b.float()
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 5e-2 * float(b.abs().max())


# ------------------------------------------------- single-process training
def _tiny_train_cfg():
    """Attention with M-RoPE and RMSNorm, bf16 compute, f32 params: both
    kernels of the training path at a head dim the flash kernel takes."""
    return ArchConfig(name="tiny-train", family="vlm", n_layers=4,
                      d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                      vocab_size=512, head_dim=64, rope="mrope",
                      qkv_bias=True, tie_embeddings=True)


@pytest.mark.cuda
def test_cuda_make_state_defaults_to_the_card():
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_state
    from repro_torch.tree import tree_leaves
    _card()
    state = make_state(_tiny_train_cfg(), adamw(), 0)
    assert all(a.is_cuda for a in tree_leaves(state))


@pytest.mark.cuda
def test_cuda_train_step_remat_modes(monkeypatch):
    """Two steps of ``make_train_step`` (accum 2) under each remat mode
    from one state and batches: losses and params equal to the bit;
    flash and rmsnorm launches a step one forward a layer (``none``),
    two (``block``), and under ``2level`` (2 groups of 2) also each
    group's first layer again; no plain flash call."""
    from repro_torch.models import flash as flash_lib
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_state, make_train_step
    from repro_torch.tree import tree_leaves
    dev = _card()
    plain = []
    orig = flash_lib.flash_fwd_ref
    monkeypatch.setattr(flash_lib, "flash_fwd_ref",
                        lambda *a, **k: plain.append(1) or orig(*a, **k))
    cfg, opt = _tiny_train_cfg(), adamw(lr=1e-3)
    g = _gen(dev)
    batches = [{"tokens": torch.randint(0, 512, (4, 64), generator=g,
                                        device=dev, dtype=torch.int32),
                "labels": torch.randint(0, 512, (4, 64), generator=g,
                                        device=dev, dtype=torch.int32),
                "positions": torch.arange(64, device=dev).expand(3, 4, 64)}
               for _ in range(2)]
    want_flash = {"none": 4, "block": 8, "2level": 10}
    runs = {}
    for mode in ("none", "block", "2level"):
        state = make_state(cfg, opt, 0)
        step = make_train_step(cfg, opt, remat=mode, accum=2)
        kernels.reset_launches()
        losses = []
        for b in batches:
            state, m = step(state, b)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["flash_attention_fwd"] == \
            2 * 2 * want_flash[mode]
        assert kernels.LAUNCHES["rmsnorm"] == \
            2 * 2 * (2 * want_flash[mode] + 1)
        runs[mode] = (losses, tree_leaves(state["params"]))
    assert not plain
    losses0, params0 = runs["none"]
    assert all(np.isfinite(float(v)) for v in losses0)
    for mode in ("block", "2level"):
        losses, params = runs[mode]
        assert all(_same_bits(a, b) for a, b in zip(losses, losses0))
        assert all(_same_bits(a, b) for a, b in zip(params, params0))


# ------------------------------------------------------- meshes
def _virtual(shape, axes):
    from repro_torch.launch.mesh import make_debug_mesh
    dev = torch.device(_card(), 0)
    n = int(np.prod(shape))
    return make_debug_mesh(shape, axes, devices=[dev] * n)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [(), ("data",), (None, "data"),
                                  (("data", "model"),), ("model", "data")])
def test_cuda_place_gather_reduce_scatter_to_the_bit(spec):
    """On a virtual (2, 2) mesh of the card: placement then gathering
    gives the tensor back to the bit, and reduce-scattering two parts
    gives their f64 sum, block for block."""
    from repro_torch.dist.mesh import NamedSharding, gather, place, \
        reduce_scatter_tree
    mesh = _virtual((2, 2), ("data", "model"))
    g = _gen("cuda")
    x = torch.randn(8, 12, generator=g, device="cuda")
    y = torch.randn(8, 12, generator=g, device="cuda")
    p = place(x, mesh, spec)
    assert _same_bits(gather(p, "cuda"), x)
    assert _same_bits(gather(p, "cuda", rows=(2, 6)), x[2:6])
    acc = reduce_scatter_tree(iter([x, y]), NamedSharding(mesh, spec))
    assert _same_bits(gather(acc, "cuda"), x.double() + y.double())


def _mesh_cfg():
    """The bottleneck codec at a width the codec kernels take, bf16
    compute, flash at head dim 64."""
    return ArchConfig(name="tiny-mesh", family="dense", n_layers=4,
                      d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                      vocab_size=512, head_dim=64, norm="layernorm",
                      boundary_compression="bottleneck", bottleneck_dim=64,
                      pipeline_stages=2)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
def test_cuda_mesh_executor_launches_the_kernels(n):
    """A ``MeshExecutor`` step on the card (one device, and the card
    listed twice with the microbatch split 1 + 1) launches flash, encode
    and decode; one device is the numeric step to the bit, two within
    bf16 rounding of it."""
    from repro_torch.launch.mesh import make_peer_mesh
    from repro_torch.runtime import MeshExecutor, build_numeric_executors
    from repro_torch.dist.mesh import gather
    from repro_torch.tree import tree_leaves
    dev = torch.device(_card(), 0)
    cfg = _mesh_cfg()
    num = build_numeric_executors(cfg, 2, 64)
    st = [e.init_state(i) for i, e in enumerate(num)]
    mesh = make_peer_mesh(devices=[dev] * n)
    mex = [MeshExecutor(cfg, 2, 64, s, mesh) for s in range(2)]
    mst = [m.init_state(7) for m in mex]
    for s in range(2):
        mex[s].restore(mst[s], num[s].snapshot(st[s]))
    g = _gen("cuda")
    tok = torch.randint(0, 512, (2, 64), generator=g, device="cuda")
    lab = torch.randint(0, 512, (2, 64), generator=g, device="cuda")
    kernels.reset_launches()
    w = mex[0].wire_fwd(mex[0].run_fwd(mst[0], tok))
    loss, gx, gp = mex[1].run_bwd(mst[1], w, labels=lab)
    _, gp0 = mex[0].run_bwd(mst[0], tok, dy=mex[1].wire_bwd(gx))[1:]
    torch.cuda.synchronize()
    for k in ("flash_attention_fwd", "encode", "decode"):
        assert kernels.LAUNCHES[k] > 0, k
    w_n = num[0].wire_fwd(num[0].run_fwd(st[0], tok))
    loss_n, _, gp_n = num[1].run_bwd(st[1], w_n, labels=lab)
    if n == 1:
        assert _same_bits(w, w_n) and float(loss) == float(loss_n)
        for a, b in zip(tree_leaves(gp), tree_leaves(gp_n)):
            assert _same_bits(gather(a, dev), b.double())
    else:
        assert abs(float(loss) - float(loss_n)) < 1e-2 * abs(float(loss_n))
    assert all(torch.isfinite(gather(a, dev)).all()
               for a in tree_leaves(gp0))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_cuda_tensor_parallel_mesh_executor(shape):
    """Mesh peers computing tensor-parallel over the ``model`` axis of a
    virtual ``("data", "model")`` mesh of the card (RMSNorm, heads and
    FFN split, vocab split): flash and rmsnorm launch on every model
    shard, the loss within bf16 rounding of one device's, the
    gradients finite."""
    from repro_torch.dist.mesh import current_coord, gather
    from repro_torch.launch.mesh import make_debug_mesh, make_peer_mesh
    from repro_torch.runtime import MeshExecutor
    from repro_torch.tree import tree_leaves
    dev = torch.device(_card(), 0)
    cfg = ArchConfig(name="tiny-tp", family="dense", n_layers=4,
                     d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
                     vocab_size=512, head_dim=64, boundary_compression="none")
    one = [MeshExecutor(cfg, 2, 64, s, make_peer_mesh(devices=[dev]))
           for s in range(2)]
    mesh = make_debug_mesh(shape, ("data", "model"),
                           devices=[dev] * (shape[0] * shape[1]))
    tpx = [MeshExecutor(cfg, 2, 64, s, mesh) for s in range(2)]
    assert [e.compute_path for e in tpx] == ["tensor_parallel"] * 2
    st1 = [e.init_state(s) for s, e in enumerate(one)]
    stp = [e.init_state(9) for e in tpx]
    for s in range(2):
        tpx[s].restore(stp[s], one[s].snapshot(st1[s]))
    g = _gen("cuda")
    tok = torch.randint(0, 512, (2, 64), generator=g, device="cuda")
    lab = torch.randint(0, 512, (2, 64), generator=g, device="cuda")
    per: dict = {}
    orig = kernels.LAUNCHES

    class ByCoord(dict):
        def __setitem__(self, k, v):
            c = current_coord()
            if c is not None:
                per.setdefault(c, dict.fromkeys(orig, 0))[k] += \
                    v - self.get(k, 0)
            super().__setitem__(k, v)
    kernels.LAUNCHES = ByCoord(orig)
    try:
        w = tpx[0].run_fwd(stp[0], tok)
        loss, gx, gp = tpx[1].run_bwd(stp[1], w, labels=lab)
        _, _, gp0 = tpx[0].run_bwd(stp[0], tok, dy=gx)
        torch.cuda.synchronize()
    finally:
        orig.update(kernels.LAUNCHES)
        kernels.LAUNCHES = orig
    for c in mesh.coords():
        assert per[c]["flash_attention_fwd"] > 0 and per[c]["rmsnorm"] > 0
    w1 = one[0].run_fwd(st1[0], tok)
    loss1 = one[1].run_bwd(st1[1], w1, labels=lab)[0]
    assert abs(float(loss) - float(loss1)) < 1e-2 * abs(float(loss1))
    assert all(torch.isfinite(gather(a, dev)).all()
               for a in tree_leaves(gp) + tree_leaves(gp0))


@pytest.mark.cuda
def test_cuda_pipeline_step_launches_match_reckoning():
    """``make_pipeline_train_step`` over (``pod`` 2, ``data`` 1) of the
    card, M-RoPE + RMSNorm + tied embeddings on the int8 wire, 4
    microbatches, remat per tick: flash, rmsnorm and qdq launches a step
    as reckoned (forward and recompute: 2 M L flash, 2 M (2 L + 1)
    rmsnorm; qdq 3 M (S - 1) less the S - 1 warm-up ticks' last
    crossing, which the recompute stops before), no plain flash call,
    the loss within bf16 rounding of the staged reference's."""
    from repro_torch.dist.pipeline import make_pipeline_train_step, \
        make_reference_loss_fn
    from repro_torch.models import flash as flash_lib
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_state
    _card()
    plain = []
    orig = flash_lib.flash_fwd_ref
    flash_lib.flash_fwd_ref = lambda *a, **k: plain.append(1) or orig(*a,
                                                                      **k)
    try:
        cfg, opt = _tiny_train_cfg(), adamw(lr=1e-3)
        S, M, L = 2, 4, cfg.n_layers
        state = make_state(cfg, opt, 0)
        g = _gen("cuda")
        batch = {"tokens": torch.randint(0, 512, (M, 64), generator=g,
                                         device="cuda", dtype=torch.int32),
                 "labels": torch.randint(0, 512, (M, 64), generator=g,
                                         device="cuda", dtype=torch.int32),
                 "positions": torch.arange(64, device="cuda").expand(3, M,
                                                                     64)}
        with torch.no_grad():
            want = float(make_reference_loss_fn(cfg, S, M, compress="int8")(
                state["params"], batch)[0])
        step = make_pipeline_train_step(cfg, opt, S, M, compress="int8")
        kernels.reset_launches()
        with _virtual((2, 1), ("pod", "data")):
            state, m = step(state, batch)
        torch.cuda.synchronize()
    finally:
        flash_lib.flash_fwd_ref = orig
    assert kernels.LAUNCHES["flash_attention_fwd"] == 2 * M * L
    assert kernels.LAUNCHES["rmsnorm"] == 2 * M * (2 * L + 1)
    assert kernels.LAUNCHES["qdq_flat"] == 3 * M * (S - 1) - (S - 1)
    assert not plain
    assert abs(float(m["loss"]) - want) < 1e-2 * abs(want)


@pytest.mark.cuda
def test_cuda_mesh_across_distinct_cards():
    """Where the machine has two cards or more (the one-card machines
    skip): placement, gathering and reduce-scattering across distinct
    cards give the one-card tensors to the bit; a 2-way mesh executor
    over ``cuda:0`` and ``cuda:1`` equals the numeric program run on each
    half of the microbatch on ``cuda:0`` to the bit; and the pipeline
    over ``pod`` 2 on two cards gives the one-card pipeline's loss to the
    bit and its gradients within 1e-6 of each leaf's largest entry (the
    gradients of the two cards' uses add in another order)."""
    from repro_torch.dist.mesh import NamedSharding, gather, place, \
        reduce_scatter_tree
    from repro_torch.dist.pipeline import make_pipeline_train_step
    from repro_torch.launch.mesh import make_debug_mesh, make_peer_mesh
    from repro_torch.optim import adamw
    from repro_torch.runtime import MeshExecutor, build_numeric_executors
    from repro_torch.train.steps import _value_and_grad, make_state
    from repro_torch.tree import tree_leaves
    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    cards = [torch.device("cuda", i) for i in range(2)]
    mesh = make_debug_mesh((2, 1), ("data", "model"), devices=cards)
    g = _gen("cuda")
    x = torch.randn(8, 12, generator=g, device="cuda")
    p = place(x, mesh, ("data",))
    assert p.shards[1, 0].device == cards[1]
    assert _same_bits(gather(p, cards[0]), x)
    acc = reduce_scatter_tree(iter([x, 2 * x]), NamedSharding(mesh, ("data",)))
    assert _same_bits(gather(acc, cards[0]), x.double() + (2 * x).double())

    cfg = _mesh_cfg()
    num = build_numeric_executors(cfg, 2, 64)
    st = num[1].init_state(1)
    mex = MeshExecutor(cfg, 2, 64, 1, make_peer_mesh(2))
    mst = mex.init_state(2)
    mex.restore(mst, num[1].snapshot(st))
    w = torch.randn(2, 64, cfg.bottleneck_dim, generator=g,
                    device="cuda").to(torch.bfloat16)
    lab = torch.randint(0, 512, (2, 64), generator=g, device="cuda")
    loss, gx, gp = mex.run_bwd(mst, w, labels=lab)
    halves = [num[1].run_bwd(st, w[i:i + 1], labels=lab[i:i + 1])
              for i in range(2)]
    assert float(loss) == float(halves[0][0]) + float(halves[1][0])
    assert _same_bits(gx, torch.cat([h[1] for h in halves]))
    for a, h0, h1 in zip(tree_leaves(gp), tree_leaves(halves[0][2]),
                         tree_leaves(halves[1][2])):
        assert _same_bits(gather(a, cards[0]), h0.double() + h1.double())

    tcfg, opt = _tiny_train_cfg(), adamw(lr=1e-3)
    state = make_state(tcfg, opt, 0)
    batch = {"tokens": torch.randint(0, 512, (4, 64), generator=g,
                                     device="cuda", dtype=torch.int32),
             "labels": torch.randint(0, 512, (4, 64), generator=g,
                                     device="cuda", dtype=torch.int32)}
    loss_fn = make_pipeline_train_step(tcfg, opt, 2, 4).loss_fn
    runs = []
    for devs in ([cards[0]] * 2, cards):
        with make_debug_mesh((2, 1), ("pod", "data"), devices=devs):
            runs.append(_value_and_grad(loss_fn, state["params"], batch))
    (l1, _, g1), (l2, _, g2) = runs
    assert _same_bits(l1, l2)
    for a, b in zip(tree_leaves(g2), tree_leaves(g1)):
        scale = float(b.abs().max()) or 1.0
        assert float((a - b).abs().max()) <= 1e-6 * scale


def _wrapper_calls(dev: str, dt: torch.dtype) -> list:
    """(kernel, call) of every wrapper at one shape a path on ``dev``
    (random from a seed on the card, shapes alone on meta)."""
    from repro_torch.kernels.boundary import kernel as BK
    from repro_torch.kernels.quant8 import kernel as QK

    def r(*shape, d=dt):
        if dev == "meta":
            return torch.empty(shape, dtype=d, device="meta")
        return torch.randn(shape, generator=_gen(dev), device=dev).to(d)
    x, s = r(1024, 4096), r(4096, d=torch.float32)
    q, kv = r(2, 512, 8, 128), r(2, 512, 2, 128)
    w_c, w_d = r(4096, 1024, d=torch.float32), r(1024, 4096,
                                                 d=torch.float32)
    codes = torch.zeros((1024, 1024), dtype=torch.int8, device=dev)
    scales = torch.ones((1024, 16), dtype=torch.float32, device=dev)
    return [
        ("flash_attention_fwd", lambda: flash_attention_fwd(
            q, kv, kv, with_lse=True)),
        ("rmsnorm", lambda: rmsnorm(x, s)),
        ("qdq_flat", lambda: qdq_flat(x, 64)),
        ("encode", lambda: BK.encode(x, w_c, "bottleneck", 1, 64, True)),
        ("decode", lambda: BK.decode(x[:, :1024], w_d, "bottleneck")),
        ("encode_quantize", lambda: BK.encode_quantize(
            x, w_c, "bottleneck", 1, 64)),
        ("dequantize_decode", lambda: BK.dequantize_decode(
            codes, scales, w_d, "bottleneck", 64, dt)),
        ("quant8_quantize", lambda: QK.quantize(x.reshape(-1), 64)),
        ("quant8_dequantize", lambda: QK.dequantize(
            codes, scales[:, :1], dt)),
    ]


def _allocated(out) -> list:
    if isinstance(out, torch.Tensor):
        return [(tuple(out.shape), out.dtype)]
    return [m for o in out for m in _allocated(o)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_meta_routes_allocate_what_the_card_allocates(dtype):
    """Every wrapper's meta route gives the CUDA route's outputs (shapes,
    dtypes), and the dry run's ledger sees the same live-bytes peak on
    meta as on the card (the same tensors: outputs and, for the bf16
    codec GEMM, its scratch)."""
    from repro_torch.launch.hlo_analysis import DeviceLedger
    dev = _card()
    for (name, on_card), (_, on_meta) in zip(_wrapper_calls(dev, dtype),
                                             _wrapper_calls("meta", dtype)):
        meta_ledger, card_ledger = DeviceLedger(), DeviceLedger()
        with meta_ledger:
            meta_out = on_meta()
        with card_ledger:
            card_out = on_card()
        assert _allocated(meta_out) == _allocated(card_out), name
        assert meta_ledger.peak["meta"] == \
            card_ledger.peak[f"cuda:{torch.cuda.current_device()}"], name


@pytest.mark.cuda
def test_cuda_meta_calls_equal_launches_on_a_yi6b_layer():
    """One yi-6b attn layer (B 2, S 1,024), forward and backward: the
    kernels' meta calls on meta equal their launches on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.models import params as P
    from repro_torch.models.blocks import REGISTRY
    from repro_torch.tree import tree_leaves
    dev = _card()
    cfg = get_config("yi-6b")

    def run(device):
        specs = REGISTRY["attn"][0](cfg)
        p = P.abstract(specs) if device == "meta" else P.init(0, specs,
                                                              device)
        leaves = [a.requires_grad_() for a in tree_leaves(p)]
        x = torch.zeros((2, 1024, cfg.d_model), dtype=cfg.compute_jdtype,
                        device=device, requires_grad=True)
        pos = model_lib.default_positions(cfg, 2, 1024, device=device)
        y, _ = REGISTRY["attn"][1](cfg, p, x, pos)
        torch.autograd.grad(y.to(torch.float32).sum(), [x] + leaves)

    kernels.reset_meta_calls()
    run("meta")
    meta_calls = dict(kernels.META_CALLS)
    before = dict(kernels.LAUNCHES)
    run(dev)
    launches = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    assert launches == meta_calls
    assert launches["flash_attention_fwd"] > 0 and launches["rmsnorm"] > 0


@pytest.mark.cuda
def test_cuda_gemm_scratch_reckoning_equals_the_library():
    """The meta route's scratch size equals ``repro_codec_gemm_scratch``
    at the codec's shapes."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.boundary.kernel import gemm_scratch_bytes
    _card()
    lib = _lib.lib()
    for n, k, m in ((1024, 4096, 1024), (1024, 1024, 4096), (8, 64, 512),
                    (3000, 8192, 256)):
        for dt, code in _lib.DTYPE_CODES.items():
            assert gemm_scratch_bytes(n, k, m, dt) == \
                lib.repro_codec_gemm_scratch(n, k, m, code), (n, k, m, dt)
