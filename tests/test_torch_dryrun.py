"""The port's dry run and what it stands on, against the JAX package on
the same inputs: the five ``flops`` functions and ``ASSIGNED`` /
``cell_supported`` exactly, ``probe_mode`` leaving flash and the SSM
outputs unchanged, every kernel wrapper's meta route (the plain
version's shapes and dtypes, ``META_CALLS`` counting, ``LAUNCHES``
still), the collective recorder and the live-bytes ledger against hand
reckonings, ``layer_flop_probe`` against ``per_token_layer_flops``, the
satellite helpers (``compress_boundary``, ``quantization_error``,
``compressed_bytes``, ``codecs.compress`` / ``decompress``,
``logical_axes``, ``cast_tree``) against JAX's, and one dry-run cell a
kind against JAX's dry run (run in a subprocess: its 512 forced host
devices must not reach this process), ``argument_bytes`` to the byte.
Serial time ≈ 60 s on one CPU core, most of it the two dry runs.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.compression import codecs as jcodecs, quant8 as jq8
from repro.models import flops as jflops, params as jparams

from repro_torch import configs as tconfigs, kernels
from repro_torch.compression import codecs as tcodecs, quant8 as tq8
from repro_torch.dist import mesh as M
from repro_torch.kernels.boundary import kernel as BK
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.quant8 import kernel as QK
from repro_torch.kernels.rmsnorm import kernel as RK
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import flops as tflops, params as tparams
from repro_torch.models.config import MLAConfig, reduced
from repro_torch.models.probe import probe_enabled, probe_mode
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)   # as tests/test_torch_train.py explains

ROOT = pathlib.Path(__file__).resolve().parent.parent
SHAPE_NAMES = sorted(tconfigs.SHAPES)
ARCHS = sorted(tconfigs.REGISTRY)


# ------------------------------------------------------------- flops/configs
@pytest.mark.parametrize("arch", ARCHS)
def test_flops_functions_equal_jax(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for kv in (1, 4096, 32768, 524288):
        assert tflops.decode_flops_per_token(t, kv) == \
            jflops.decode_flops_per_token(j, kv)
    for seq, gb in ((4096, 256), (32768, 32), (512, 8)):
        assert tflops.train_step_flops(t, seq, gb) == \
            jflops.train_step_flops(j, seq, gb)
    assert tflops.model_flops_6nd(1.5e9, 1e6) == \
        jflops.model_flops_6nd(1.5e9, 1e6)
    assert tflops.active_params(t) == jflops.active_params(j)
    for n in (1, 2, 3, 4):
        try:
            want = [jflops.stage_flops_per_token(j, n, s, 4096)
                    for s in range(n)]
        except ValueError:
            with pytest.raises(ValueError):
                tflops.stage_flops_per_token(t, n, 0, 4096)
            continue
        assert [tflops.stage_flops_per_token(t, n, s, 4096)
                for s in range(n)] == want


def test_assigned_and_cell_supported_equal_jax():
    assert tconfigs.ASSIGNED == jconfigs.ASSIGNED
    for arch in ARCHS:
        for name in SHAPE_NAMES:
            assert tconfigs.cell_supported(
                tconfigs.get_config(arch), tconfigs.SHAPES[name]) == \
                jconfigs.cell_supported(jconfigs.get_config(arch),
                                        jconfigs.SHAPES[name])


# ------------------------------------------------------------------ probe
def test_probe_mode_is_scoped():
    assert not probe_enabled()
    with probe_mode():
        assert probe_enabled()
    assert not probe_enabled()


def test_probe_mode_leaves_flash_unchanged():
    """One block under the probe, 16 x 32 chunks without it: the same
    outputs and gradients within f32 rounding."""
    from repro_torch.models.flash import flash_attention
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 64, 4, 16, generator=g, requires_grad=True)
    k = torch.randn(2, 64, 2, 16, generator=g, requires_grad=True)
    v = torch.randn(2, 64, 2, 16, generator=g, requires_grad=True)

    def run():
        out = flash_attention(q, k, v, causal=True, chunk_q=16, chunk_k=32)
        return (out, *torch.autograd.grad(out.square().sum(), (q, k, v)))
    base = run()
    with probe_mode():
        probed = run()
    for a, b in zip(probed, base):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-125m"])
def test_probe_mode_leaves_ssm_unchanged(arch):
    """Mamba's scan and mLSTM as one chunk (the probe) against chunks of
    16: Mamba's outputs within f32 rounding; mLSTM's state and last
    output (its earlier outputs are normalised at each chunk end's
    stabiliser, as JAX's are: ``models/ssm.py``)."""
    from repro_torch.models import ssm
    cfg = reduced(tconfigs.get_config(arch))
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 48, cfg.d_model, generator=g)
    if arch == "hymba-1.5b":
        specs, apply = ssm.mamba_specs(cfg), ssm.apply_mamba
    else:
        specs, apply = ssm.mlstm_specs(cfg), ssm.apply_mlstm
    p = tparams.init(2, specs, "cpu")
    if arch == "xlstm-125m":
        p["w_if"] = p["w_if"] / cfg.d_model
    y, st = apply(cfg, p, x, return_state=True)
    with probe_mode():
        y1, st1 = apply(cfg, p, x, return_state=True)
    if arch == "hymba-1.5b":
        torch.testing.assert_close(y1, y, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(y1[:, -1], y[:, -1], rtol=1e-5,
                                   atol=1e-5)
    for key in st:
        torch.testing.assert_close(st1[key], st[key], rtol=1e-5, atol=1e-5)


# -------------------------------------------------------------- meta routes
def _wrapper_calls(dev, dt):
    """(kernel, call) of every wrapper at one shape per path, on ``dev``
    (inputs made on the CPU from one seed, then moved)."""
    g = torch.Generator().manual_seed(3)
    r = lambda *s, d=dt: torch.randn(*s, generator=g).to(d).to(dev)
    x, s, q, kv = r(4, 256), r(256, d=torch.float32), r(2, 64, 4, 64), \
        r(2, 64, 2, 64)
    w_c, w_d = r(256, 64, d=torch.float32), r(64, 256, d=torch.float32)
    w_m = r(128, 256, d=torch.float32)
    flat = r(512)
    codes = torch.randint(-127, 128, (4, 64), generator=g,
                          dtype=torch.int8).to(dev)
    scales = (torch.rand(4, 8, generator=g) + 0.5).to(dev)
    return [
        ("flash_attention_fwd", lambda: FK.flash_attention_fwd(
            q, kv, kv, with_lse=True)),
        ("flash_attention_fwd", lambda: FK.flash_attention_fwd(
            q, kv, kv, causal=False, window=16)),
        ("rmsnorm", lambda: RK.rmsnorm(x, s)),
        ("qdq_flat", lambda: BK.qdq_flat(flat, 64)),
        ("encode", lambda: BK.encode(x, w_c, "bottleneck", 1, 8, True)),
        ("encode", lambda: BK.encode(x, None, "maxout", 2, 8, False)),
        ("decode", lambda: BK.decode(x[:, :64], w_d, "bottleneck")),
        ("decode", lambda: BK.decode(x[:, :128], w_m, "maxout")),
        ("encode_quantize", lambda: BK.encode_quantize(
            x, w_c, "bottleneck", 1, 8)),
        ("dequantize_decode", lambda: BK.dequantize_decode(
            codes, scales, w_d, "bottleneck", 8, dt)),
        ("quant8_quantize", lambda: QK.quantize(flat, 64)),
        ("quant8_dequantize", lambda: QK.dequantize(codes, scales[:, :1],
                                                    dt)),
    ]


def _meta_of(out):
    if isinstance(out, torch.Tensor):
        return [(tuple(out.shape), out.dtype)]
    return [m for o in out for m in _meta_of(o)]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_meta_routes_match_plain_outputs_and_count(dt):
    """Each wrapper's meta route gives its plain version's output shapes
    and dtypes, counts one ``META_CALLS`` a call, hands its work to the
    active counters, and never moves ``LAUNCHES``."""
    kernels.reset_meta_calls()
    launches = dict(kernels.LAUNCHES)
    work = []
    kernels.WORK_COUNTERS.append(lambda *a: work.append(a))
    try:
        plain = [(n, _meta_of(c())) for n, c in _wrapper_calls("cpu", dt)]
        assert kernels.META_CALLS == dict.fromkeys(kernels.LAUNCHES, 0)
        meta = [(n, _meta_of(c())) for n, c in _wrapper_calls("meta", dt)]
    finally:
        kernels.WORK_COUNTERS.pop()
    assert meta == plain
    want = {}
    for name, _ in plain:
        want[name] = want.get(name, 0) + 1
    assert kernels.META_CALLS == {k: want.get(k, 0)
                                  for k in kernels.LAUNCHES}
    assert [w[0] for w in work] == [n for n, _ in plain]
    assert all(f > 0 and b > 0 for _, f, b in work)
    assert kernels.LAUNCHES == launches
    kernels.reset_meta_calls()


def test_meta_routes_run_the_cuda_checks():
    """The meta route refuses what the card refuses: a head-dim pair the
    flash kernel does not take, a bf16 view off 16-byte alignment, a
    codec row width off the vector layout."""
    m = lambda *s, d=torch.bfloat16: torch.empty(*s, dtype=d, device="meta")
    with pytest.raises(ValueError, match="head dims"):
        FK.flash_attention_fwd(m(1, 8, 2, 16), m(1, 8, 2, 16),
                               m(1, 8, 2, 16))
    q = m(1, 8, 2, 72)[..., 1:65]
    with pytest.raises(ValueError, match="16-byte"):
        FK.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="width"):
        BK.encode(m(4, 100), None, "maxout", 2, 0, False)
    elsewhere = type("T", (), {"device": torch.device("xpu")})()
    with pytest.raises(ValueError, match="unsupported device xpu"):
        kernels.route(elsewhere, "rmsnorm")


def test_flash_work_pairs_match_the_masks():
    """The bound's pair count equals the masks' kept pairs."""
    from repro_torch.kernels.flash_attention.ref import _ok_mask
    for Sq, Sk, causal, window in ((8, 8, True, 0), (3, 11, True, 0),
                                   (8, 8, True, 3), (5, 9, False, 4),
                                   (6, 4, False, 0)):
        qpos = torch.arange(Sq) + (Sk - Sq)
        want = int(_ok_mask(qpos, torch.arange(Sk), causal, window,
                            Sk).sum())
        assert FK.attended_pairs(Sq, Sk, causal, window) == want


def test_meta_codec_gemm_allocates_its_scratch():
    """bf16 encode on meta allocates what the card's route allocates:
    the two row passes' outputs, the GEMM's output and its scratch (the
    bf16 weight and 4 split-K f32 partials at [1024, 4096] x [4096,
    1024])."""
    x = torch.empty(1024, 4096, dtype=torch.bfloat16, device="meta")
    w = torch.empty(4096, 1024, device="meta")
    assert BK.gemm_splits(4096, 1024) == 4
    scratch = BK.gemm_scratch_bytes(1024, 4096, 1024, torch.bfloat16)
    assert scratch == 4096 * 1024 * 2 + 4 * 1024 * 1024 * 4
    ledger = H.DeviceLedger()
    with ledger:
        z = BK.encode(x, w, "bottleneck", 1, 64, True)
    # peak: ln_rows [1024, 4096] + scratch + gemm out, then the second
    # pass's output beside the gemm's (the first pass's freed by then)
    es = 2
    first, gemm_out, out = 1024 * 4096 * es, 1024 * 1024 * es, \
        1024 * 1024 * es
    assert ledger.peak["meta"] == first + scratch + gemm_out
    assert ledger.live["meta"] == out
    assert ledger.kernel_flops["meta"] == BK.codec_work(
        "encode", "bottleneck", 1024, 4096, 1024, es, True, 64)[0]
    del z


# ---------------------------------------------------------------- recorder
def _virtual(shape, axes):
    return make_debug_mesh(shape, axes, devices=[torch.device("cpu")] *
                           int(np.prod(shape)))


def test_recorder_place_gather_reduce_scatter_hand_reckoning():
    mesh = _virtual((2, 2), ("data", "model"))
    x = torch.arange(48.0).reshape(4, 12)
    blk = 2 * 6 * 4                          # one [2, 6] f32 block
    with M.record_collectives() as rec:
        p = M.place(x, mesh, ("data", "model"))
        assert rec.bytes[(0, 1)]["collective-permute"] == blk
        assert (0, 0) not in rec.bytes      # the source's own block
        with M.at((1, 1)):
            full = M.gather(p, "cpu")
        torch.testing.assert_close(full, x)
        assert rec.bytes[(1, 1)]["all-gather"] == 3 * blk
        assert rec.counts[(1, 1)]["all-gather"] == 3
        with M.at((1, 0)):
            rows = M.gather(p, "cpu", where={"data": 1})
        torch.testing.assert_close(rows, x[2:])
        assert rec.bytes[(1, 0)]["all-gather"] == blk   # (1, 1)'s block
        sh = M.NamedSharding(mesh, ("data", "model"))
        parts = [torch.ones(4, 12), 2 * torch.ones(4, 12)]
        acc = M.reduce_scatter_tree(parts, sh, sources=[(0, 0), (1, 0)])
        assert float(acc.shards[(1, 1)].sum()) == 3 * 12
        rs = {c: rec.bytes[c]["reduce-scatter"] for c in mesh.coords()}
        assert rs == {(0, 0): blk, (0, 1): 2 * blk, (1, 0): blk,
                      (1, 1): 2 * blk}
        moved = M.send(x, mesh, (0, 1))
        assert moved is x or torch.equal(moved, x)
        M.log_collective("all-reduce", mesh.coords(), 4)
    assert rec.bytes[(0, 1)]["collective-permute"] == blk + 48 * 4
    got = H.collective_bytes(rec)
    assert got["device"] == [0, 1]
    assert got["total_bytes"] == sum(rec.bytes[(0, 1)].values())
    assert got["n_ops"] == sum(rec.counts[(0, 1)].values())
    # without a recorder the helpers log nothing anywhere
    before = json.dumps({str(k): v for k, v in rec.bytes.items()})
    M.gather(M.place(x, mesh, ("data", "model")), "cpu")
    M.reduce_scatter_tree(parts, sh)
    M.send(x, mesh, (1, 1))
    assert json.dumps({str(k): v for k, v in rec.bytes.items()}) == before
    assert M._recorder() is None


def test_recorder_pipeline_shift_hand_reckoning():
    """The pipeline on a (2, 2, 2) virtual mesh: stage 1's data shard 0
    coordinate receives, by ``collective-permute``, its block of every
    param placed from home and one wire tensor plus one f32 aux a
    microbatch from stage 0."""
    from repro_torch.dist import pipeline as pipe
    from repro_torch.dist.sharding import state_shardings
    from repro_torch.optim.adamw import adamw
    from repro_torch.train import steps as ts
    cfg = reduced(tconfigs.get_config("yi-6b")).with_overrides(n_layers=2)
    mesh = _virtual((2, 2, 2), ("pod", "data", "model"))
    state = ts.make_state(cfg, adamw(), 0, "cpu")
    B, S, Mb = 8, 8, 2
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=g),
             "labels": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=g)}
    step = pipe.make_pipeline_train_step(cfg, adamw(), 2, Mb)
    with M.record_collectives() as rec, mesh:
        step.loss_fn(state["params"], batch)
    c = (1, 0, 0)
    shard = state_shardings(cfg, mesh, pipeline=True)["params"]
    placed = sum(int(np.prod([sl.stop - sl.start for sl in M.shard_slices(
        a.shape, mesh, tuple(s.spec), c)])) * a.element_size()
        for a, s in zip(tree_leaves(state["params"]),
                        tree_leaves(shard)))
    rows = B // Mb // 2
    wire = Mb * (rows * S * cfg.d_model * 4 + 4)
    assert rec.bytes[c]["collective-permute"] == placed + wire
    assert rec.counts[c]["collective-permute"] == \
        len(tree_leaves(state["params"])) + 2 * Mb


# ------------------------------------------------------------------ ledger
def test_ledger_peak_and_flops_hand_reckoning():
    ledger = H.DeviceLedger()
    with ledger:
        a = torch.empty(1000)                 # 4,000 B -> 4,096
        b = torch.empty(100)                  # 400 B -> 512
        del a
        c = torch.empty(3000)                 # 12,000 B -> 12,288
        v = c[:10]                            # a view: nothing new
        m = torch.ones(8, 16) @ torch.ones(16, 4)
    assert ledger.peak["cpu"] == 512 + 12288 + 512 + 512 + 512
    assert ledger.flops["cpu"] == 2 * 8 * 16 * 4
    del b, c, v, m
    assert ledger.live["cpu"] == 0
    with M.at((1, 0)):
        ledger2 = H.DeviceLedger()
        with ledger2:
            t = torch.empty(10, device="meta")
    assert dict(ledger2.peak) == {(1, 0): 512}
    del t


# ------------------------------------------------------------------- probe
def _probe_cfg(arch):
    """The reduced config at head dims the flash kernel takes (its meta
    route runs the card's checks)."""
    cfg = reduced(tconfigs.get_config(arch))
    kw = {"head_dim": 64}
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_dim=128,
                              qk_rope_dim=64, v_head_dim=128)
    return cfg.with_overrides(**kw)


# bounds of the probe against the analytic count (``per_token_layer_flops``
# x tokens, x 3 for train), by shape kind.  The probe counts matmuls
# (aten) and the flash kernel's kept pairs; the analytic count's causal
# context is S / 2 where the kernel keeps S (S + 1) / 2 pairs, and it
# adds element-wise terms the aten table does not price (Mamba's 10 di N
# scan: hymba at 0.96).  mLSTM is held at its probe chunk, T (one chunk,
# as JAX's probe runs it).  Training: the backward is the plain chunked
# recompute, one [S, S] block under the probe, which prices every pair,
# masked and out-of-window ones included (10 D a pair against the
# forward's 4 D a kept pair): 1.2x (mLSTM) to 2.4x (a sliding window)
# of the analytic 3x forward.  Decode: MLA attends in its latent space
# (below the analytic count's expanded K/V, 0.58x) and mLSTM's step is
# the state update alone (0.84x).
PROBE_BOUNDS = {"prefill": (0.95, 1.05), "train": (1.0, 2.6),
                "decode": (0.55, 1.05)}


@pytest.mark.parametrize("arch", ["yi-6b", "h2o-danube-3-4b",
                                  "deepseek-v2-236b",
                                  "llama4-scout-17b-a16e", "hymba-1.5b",
                                  "xlstm-125m"])
@pytest.mark.parametrize("kind", ["prefill_32k", "train_4k", "decode_32k"])
def test_layer_flop_probe_against_analytic(arch, kind):
    import dataclasses
    cfg = _probe_cfg(arch)
    shape = tconfigs.SHAPES[kind]
    shape = type(shape)(shape.name, 256, 2, shape.kind)
    probe = H.layer_flop_probe(cfg, shape)
    B, S = shape.global_batch, shape.seq_len
    lo, hi = PROBE_BOUNDS[shape.kind]
    assert probe["runs"] and probe["n_layers"] == cfg.n_layers
    for k, got in probe["kinds"].items():
        at = cfg
        if shape.kind == "decode":
            ctx, tokens, mult = tflops._ctx_for(cfg, S, False), B, 1.0
        else:
            ctx = tflops._ctx_for(cfg, S, True)
            tokens, mult = B * S, 3.0 if shape.kind == "train" else 1.0
            if k == "mlstm":
                at = cfg.with_overrides(ssm=dataclasses.replace(cfg.ssm,
                                                                chunk=S))
        want = tflops.per_token_layer_flops(at, k, ctx) * tokens * mult
        if k == "slstm":
            assert got == tflops._slstm_flops(cfg) * tokens * mult
            continue
        assert lo * want <= got <= hi * want, (k, got / want)


# ----------------------------------------------------------- satellites
def test_compress_boundary_and_helpers_equal_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 100)).astype(np.float32) * 3
    g = rng.standard_normal((3, 100)).astype(np.float32)
    jy, vjp = jax.vjp(lambda a: jq8.compress_boundary(a, 64, 32),
                      jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    ty = tq8.compress_boundary(tx, 64, 32)
    (tg,) = torch.autograd.grad(ty, tx, torch.tensor(g))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_allclose(
        float(tq8.quantization_error(torch.tensor(x))),
        float(jq8.quantization_error(jnp.asarray(x))), rtol=1e-6)
    assert tq8.compressed_bytes(torch.tensor(x)) == \
        jq8.compressed_bytes(jnp.asarray(x))
    import repro_torch.compression as tc
    assert tc.compress_boundary is tq8.compress_boundary
    assert tc.quantization_error is tq8.quantization_error


@pytest.mark.parametrize("mode", ["bottleneck", "maxout", "int8", "none"])
def test_codecs_compress_decompress_equal_jax(mode):
    from test_torch_families import _numpy_init, port_cfg
    jcfg = jconfigs.get_reduced("swarm-1b-bottleneck").with_overrides(
        boundary_compression=mode, maxout_k=2 if mode == "maxout" else 0)
    tcfg = port_cfg(jcfg)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    p = {}
    if mode in jcodecs.LEARNED:
        p = _numpy_init({**jcodecs.sender_specs(jcfg),
                         **jcodecs.receiver_specs(jcfg)}, 6)
    jz = jcodecs.compress(jcfg, mode, jax.tree.map(jnp.asarray, p),
                          jnp.asarray(x))
    tz = tcodecs.compress(tcfg, mode, {k: torch.tensor(v) for k, v in
                                       p.items()}, torch.tensor(x))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-5,
                               atol=1e-5)
    jy = jcodecs.decompress(jcfg, mode, jax.tree.map(jnp.asarray, p), jz)
    ty = tcodecs.decompress(tcfg, mode, {k: torch.tensor(v) for k, v in
                                         p.items()}, tz)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)


def test_logical_axes_and_cast_tree_equal_jax():
    from repro.train import steps as js
    from repro_torch.train import steps as ts
    arch = "deepseek-v2-236b"
    jt = jparams.logical_axes(js.model_specs(jconfigs.get_config(arch)))
    tt = tparams.logical_axes(ts.model_specs(tconfigs.get_config(arch)))
    assert jax.tree.leaves(jt, is_leaf=lambda a: isinstance(a, tuple)) == \
        tree_leaves(tt, is_leaf=lambda a: isinstance(a, tuple))
    tree = {"a": np.ones(3, np.float32), "b": [np.arange(3, dtype=np.int32),
                                              np.ones(2, np.float64)]}
    jc = jparams.cast_tree(jax.tree.map(jnp.asarray, tree), jnp.bfloat16)
    tc = tparams.cast_tree({"a": torch.ones(3), "b": [
        torch.arange(3, dtype=torch.int32), torch.ones(2, dtype=torch.float64)]},
        torch.bfloat16)
    assert [str(a.dtype) for a in jax.tree.leaves(jc)] == \
        ["bfloat16", "int32", "bfloat16"]
    assert [a.dtype for a in tree_leaves(tc)] == \
        [torch.bfloat16, torch.int32, torch.bfloat16]


# ----------------------------------------------- the dry run against JAX's
PARITY_CELLS = [("yi-6b", "prefill_32k"), ("xlstm-125m", "decode_32k"),
                ("yi-6b", "long_500k")]


@pytest.fixture(scope="module")
def jax_records():
    """JAX's dry-run records of ``PARITY_CELLS``, from one subprocess (the
    JAX dry run forces 512 host devices at import)."""
    code = ("import json, sys\n"
            "from repro.launch import dryrun as d\n"
            "cells = json.loads(sys.argv[1])\n"
            "print(json.dumps([d.run_cell(a, s, 'single', skip_probe=True)"
            " for a, s in cells]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code,
                        json.dumps(PARITY_CELLS)], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", PARITY_CELLS, ids=lambda c: "-".join(c))
def test_dryrun_matches_jax_dryrun(cell, jax_records):
    from repro_torch.launch import dryrun
    want = jax_records[PARITY_CELLS.index(cell)]
    got = dryrun.run_cell(*cell, "single", skip_probe=True)
    assert got["status"] == want["status"]
    if want["status"] == "skipped":
        assert got["reason"] == want["reason"]
        return
    assert got["n_devices"] == want["n_devices"] == 256
    assert got["memory"]["argument_bytes"] == \
        want["memory"]["argument_bytes"]
    # the schemes differ (the port's model axis shards storage only, the
    # kernels' memory is the port's): shown side by side, unbounded
    print(json.dumps({
        "cell": cell,
        "flops_per_device": [got["flops_per_device"],
                             want["hlo_flops_per_device_raw"]],
        "temp_bytes": [got["memory"]["temp_bytes"],
                       want["memory"]["temp_bytes"]],
        "peak_per_device": [got["memory"]["peak_per_device"],
                            want["memory"]["peak_per_device"]],
        "collective_bytes": [got["collectives"]["total_bytes"],
                             want["collectives"]["total_bytes"]]}))
    assert got["flops_per_device"] > 0
    assert got["memory"]["peak_per_device"] >= got["memory"][
        "argument_bytes"]


def test_dryrun_cli_runs_without_jax(tmp_path):
    """The CLI in a process where ``jax`` and ``repro`` cannot be
    imported writes an ``ok`` record with the probe."""
    code = ("import sys, pathlib\n"
            "sys.modules['jax'] = sys.modules['repro'] = None\n"
            "import repro_torch.launch.dryrun as d\n"
            f"d.ARTIFACT_DIR = pathlib.Path({str(tmp_path)!r})\n"
            "sys.argv = ['dryrun', '--arch', 'xlstm-125m', '--shape', "
            "'decode_32k', '--mesh', 'single']\n"
            "d.main()\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads((tmp_path / "single__xlstm-125m__decode_32k.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert set(rec["probe"]["kinds"]) == {"mlstm", "slstm"}
    assert rec["memory"]["peak_per_device"] == (
        rec["memory"]["argument_bytes"] + rec["memory"]["output_bytes"]
        + rec["memory"]["temp_bytes"] - rec["memory"]["alias_bytes"])
