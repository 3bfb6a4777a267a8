"""The port's CUDA kernels and its serving path on an NVIDIA card.

Every test here is marked ``cuda`` and skips without a card. This file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed; ``tests/conftest.py`` imports JAX, so run it there with

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same card
and inputs (the plain versions are held against JAX on the CPU by the
other ``test_torch_*.py`` files).
"""
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


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
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
    with pytest.raises(ValueError, match="block"):
        qdq_flat(torch.randn(100, device=dev), 48)


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
