#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package.  Phases (each prints a
JSON line; any failure raises and exits non-zero):

1. build   — compile the CUDA kernels of ``src/repro_torch/csrc`` with
             nvcc; where ``cuobjdump`` exists, count the tensor-core
             instructions of the bf16 flash forward (HMMA) and codec
             GEMM (HGMMA), and the 16-byte global loads (LDG.E.128) of
             every instantiation of the codec's row passes and qdq;
             print the card's name and power limit.
2. kernels — each kernel against its plain PyTorch version on the card at
             the shapes of its paths (serving for rmsnorm and qdq,
             serving and training for flash with its ``lse``, training
             swarm-1b-bottleneck for the codec's encode and decode and
             its true-wire pair encode_quantize / dequantize_decode,
             held stage by stage on their own intermediates, the int8
             wire's shape for the quant8 pair, qdq and the pair also at
             every kind of block and on unaligned views), in bf16 and
             f32; the flash forward, the codec GEMM and row passes, qdq
             and the quant8 pair also run twice (bit-equal) and on a
             subset of their rows (bit-equal to the same rows of the
             full call); the codec's row pass also runs and is timed
             alone (``ln_rows``).
             Times: device time per call (the kernels' CUPTI durations
             under ``torch.profiler``, and ``cold_ms``, the L2 evicted
             before each call) beside
             the plain version's, the one-call PyTorch library
             equivalent's where there is one, and the card's lower
             bound; each kernel's row also keeps ``eager_ms``, CUDA
             events around back-to-back calls, which includes the
             Python wrapper's host time when that is the longer.  cuBLAS
             accumulates in f32 only around the plain versions'
             comparison outputs; every timed call and phase runs under
             PyTorch's defaults.
3. serve   — ``ServeRunner`` serving yi-6b at full width and depth
             (random weights from a seed) through one decode chain
             (0,2)->(2,4), tokens identical to the port's single-process
             reference, every kernel's launch counter above zero.
4. int8    — the same with the int8 boundary wire: one QDQ launch per
             span-edge crossing; then again with blocks of 256
             (``ServeConfig.quant_block``).
5. churn   — a spare (2,4) peer; the chain's (2,4) peer dies mid-decode;
             exactly-once KV recovery.
6. train   — ``SwarmRunner`` training swarm-1b-bottleneck at full width
             and depth (48 layer applications, random weights from a
             seed), 3 stages, one peer each, seq 512, microbatch 2, global
             batch 8, adamw, 3 steps; per-step losses against the staged
             reference (``repro_torch.train.reference``) on the same card
             and weights; wall-clock tokens/s, peak memory, launches of
             flash, encode and decode.
7. train_q — the same with ``wire_quant=True`` for 2 steps: the encode
             kernel's fused QDQ and the cotangent ``qdq_flat`` launch.
8. train_churn — a second stage-1 peer; one stage-1 peer dies mid-step;
             each (stage, microbatch) admitted exactly once, the ledger
             drained, losses equal to the fault-free ``train`` losses.
9. train_rebalance — peers [1, 1, 2], stages 0 and 1 on a T4 profile
             at 1/16 of its compute (``slow_front``), four trainers,
             Alg. 2 every 5.0 virtual seconds: a stage-2 peer migrates
             while it holds gradients, its ledger rows are released and
             recomputed; every (stage, microbatch) admitted once per
             round, losses equal to ``train``'s to the bit.
10. train_rollback — checkpoints every 2 steps under ``build/``; stage
             1's only peer dies during step 4 and its replacement finds
             no donor: global rollback to the step-2 cut and replay; a
             new runner cold-starts on the directory and trains step 5.
             Losses equal to the staged reference's to the bit; bytes and
             seconds per save and for the resume's restore.  Fails early
             when the disk or the host memory is short of two cuts.
11. wire_codes — the true wire format (int8 codes + f32 scales) through
             the ops entry points of ``encode_quantize`` /
             ``dequantize_decode`` and the quant8 pair, on swarm-1b's
             boundary: the priced payload, and the decoded state equal
             to the fused QDQ wire's to the bit.
12. train_profile — one training microbatch under ``torch.profiler``:
             device time per kernel, grouped, and the device's idle
             share.

The next-to-last line is the ``{"kernels": [...]}`` summary, the last
``{"ok": true, "device": {...}}``.  ``--kernels-only`` runs phases 1 and
2 alone and prints neither.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12        # dense tensor-core peak
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def setup():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, src)
    return torch


@contextlib.contextmanager
def plain_precision(torch):
    """cuBLAS matmuls with f32 accumulation (no TF32, no reduced-precision
    bf16 reduction), as the plain versions define them and as the
    kernels and the JAX package compute.  Set only around the plain
    versions' comparison outputs: every timed call and every phase of
    the main path runs under PyTorch's defaults, as a user's would."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, m.allow_bf16_reduced_precision_reduction)
    m.allow_tf32 = False
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = saved


# ------------------------------------------------------------------ timing
def _device_us(ev) -> float:
    """Device time of one ``key_averages()`` entry (0 for host events)."""
    if getattr(ev, "device_type", None) is not None and \
            "CUDA" not in str(ev.device_type):
        return 0.0
    return getattr(ev, "self_device_time_total",
                   getattr(ev, "self_cuda_time_total", 0.0))


FLUSH_BYTES = 256 * 2 ** 20      # five times the H100's 50 MB L2
_FLUSH: dict = {}


def _profiled(torch, fn, iters: int) -> dict:
    """Per kernel name, (calls, device ms) of ``iters`` calls of ``fn``
    under ``torch.profiler`` (CUPTI).  A session now and then loses some
    or all of its events, so a result stands only when two of up to ten
    sessions agree on the calls of every name."""
    from torch.profiler import ProfilerActivity, profile
    seen = []
    for _ in range(10):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        got = {ev.key: (ev.count, _device_us(ev) / 1e3)
               for ev in prof.key_averages() if _device_us(ev) > 0}
        calls = {k: c for k, (c, _) in got.items()}
        if got and calls in seen:
            return got
        seen.append(calls)
    raise RuntimeError(f"the profiler's sessions disagree on the kernels "
                       f"launched: {seen}")


def time_ms(torch, fn, iters: int = 20, warmup: int = 3,
            cold: bool = False) -> float:
    """Device time of one call of ``fn``: the durations of the kernels
    (and memsets) it launches, as CUPTI reports them under
    ``torch.profiler``, summed over ``iters`` calls and divided by
    ``iters``.  Host time between launches does not count, so a fast
    kernel behind a Python wrapper is timed, not its wrapper.  Warm
    (default), back-to-back calls find their inputs in the 50 MB L2 where
    they fit; ``cold`` evicts the L2 before each call with a read of a
    256 MiB buffer (a reduction: no kernel of a timed call is one) and
    leaves the read's kernels out of the sum."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    skip = set()
    call = fn
    if cold:
        if not _FLUSH:
            buf = torch.ones(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
            _FLUSH["fn"] = lambda: buf.amax()
            _FLUSH["keys"] = set(_profiled(torch, _FLUSH["fn"], 1))
        skip = _FLUSH["keys"]

        def call():
            _FLUSH["fn"]()
            fn()
    got = _profiled(torch, call, iters)
    return sum(ms for k, (_, ms) in got.items() if k not in skip) / iters


def eager_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """CUDA events around ``iters`` back-to-back calls of ``fn``, over
    ``iters``: the device time when the device is the bottleneck, the
    host's enqueue time (the Python wrapper) when the host is."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _counted(torch, fn):
    """Run ``fn`` without moving the launch counters (comparison and
    timing launches are not main-path launches)."""
    from repro_torch import kernels
    saved = dict(kernels.LAUNCHES)
    try:
        return fn()
    finally:
        kernels.LAUNCHES.update(saved)


# ------------------------------------------------------------------ phase 1
TENSOR_CORE_KERNELS = ("flash_fwd_mma_kernel", "codec_gemm_wgmma_kernel")
VECTOR_KERNELS = ("ln_rows_kernel", "dequant_rows_kernel", "blockq_vec_kernel",
                  "blockdq_vec_kernel")
# instantiations of the vector kernels: ln_rows 2 dtypes x 4 x 5, its
# dequant pass 2 x 7; blockq.cuh's lane-group quantize 2 x 6 lane counts
# x 3 (qdq with and without codes, quant8's codes alone) and its
# dequantize, one a dtype
VECTOR_INSTANTIATIONS = 2 * (4 * 5 + 7) + 2 * 6 * 3 + 2
LOADS = ("LDG.E.128", "LDG.E.64", "LDG.E")     # first match counts


def vector_load(inst: str) -> str:
    """The global load a vector kernel instantiation must have: 16 bytes
    a lane, except where a lane reads the codes of one 16-byte output
    vector or unit: 8 bytes (dequant_rows on widths that are not a
    multiple of 16, quant8's bf16 dequantize) or 4 (its f32 one)."""
    if inst.startswith("dequant_rows_kernel") and inst.endswith(",8>") \
            or inst == "blockdq_vec_kernel<bf16>":
        return "LDG.E.64"
    if inst == "blockdq_vec_kernel<f32>":
        return "LDG.E"
    return "LDG.E.128"


def _instantiation(name: str, kernel: str) -> str:
    """``kernel<dtype,ints>`` from a mangled name such as
    ``..._7rowpass14ln_rows_kernelI13__nv_bfloat16Li4ELb1EEEv...``
    (a bool argument as 0 or 1)."""
    import re
    m = re.search(kernel + r"I(13__nv_bfloat16|f)((?:L[ib]\d+E)*)E", name)
    if m is None:
        return kernel
    args = ["bf16" if m.group(1) != "f" else "f32"]
    args += re.findall(r"L[ib](\d+)E", m.group(2))
    return f"{kernel}<{','.join(args)}>"


def sass_counts(path):
    """Per kernel instantiation, from ``cuobjdump -sass``: the HMMA /
    HGMMA instructions of the tensor-core kernels, and the 128-, 64- and
    32-bit global loads (``LDG.E.128`` / ``LDG.E.64`` / other ``LDG.E``)
    of the vector kernels (the codec's row passes, the lane-group
    kernels of qdq and the quant8 pair).  None without ``cuobjdump``."""
    import shutil
    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(exe):
        return None
    sass = subprocess.run([exe, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    counts, cur, ops = {}, None, ()
    for ln in sass.splitlines():
        if "Function : " in ln:
            name = ln.split("Function : ", 1)[1].strip()
            cur = None
            for k in TENSOR_CORE_KERNELS + VECTOR_KERNELS:
                if k in name:
                    cur, ops = _instantiation(name, k), (
                        ("HGMMA", "HMMA") if k in TENSOR_CORE_KERNELS
                        else LOADS)
                    if k == "flash_fwd_mma_kernel":
                        cur = k + ("<64>" if "ILi64E" in name else "<128>")
                    counts[cur] = dict.fromkeys(ops, 0)
                    break
        elif cur is not None:
            op = next((o for o in ops if o in ln), None)
            if op is not None:
                counts[cur][op] += 1
    return counts


def phase_build(torch) -> None:
    from repro_torch.kernels import _lib
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.time()
    path = _lib.build()
    secs = time.time() - t0
    ptxas = [ln.strip() for ln in _lib.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln]
    sass = sass_counts(path)
    emit({"phase": "build", "library": os.path.relpath(path),
          "seconds": secs, "ptxas": ptxas[:24], "sass": sass})
    if sass is not None:
        want = {"flash_fwd_mma_kernel<64>", "flash_fwd_mma_kernel<128>",
                "codec_gemm_wgmma_kernel"}
        idle = sorted(k for k in want
                      if sum(sass.get(k, {}).values()) == 0)
        if idle:
            raise AssertionError(f"no tensor-core instructions in {idle}")
        vec = {k: v for k, v in sass.items() if k.split("<")[0] in
               VECTOR_KERNELS}
        narrow = [k for k, v in vec.items() if v[vector_load(k)] == 0]
        if len(vec) < VECTOR_INSTANTIATIONS or narrow:
            raise AssertionError(f"vector loads missing: {len(vec)} "
                                 f"instantiations, none in {narrow}")
    _lib.lib()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)


# ------------------------------------------------------------------ phase 2
def _ulps(torch, a, b):
    """Largest |a - b| in units of the output dtype's spacing at |b|."""
    eps = torch.finfo(b.dtype).eps
    a32, b32 = a.float(), b.float()
    tiny = torch.finfo(b.dtype).tiny
    spacing = torch.clamp(b32.abs(), min=tiny) * eps
    return float(((a32 - b32).abs() / spacing).max())


def check_flash(torch, gen, rows: list) -> dict:
    """The flash forward with its ``lse`` output against the plain
    version at the serving path's GQA shapes (yi-6b: 32 heads on 4 KV
    heads, prompt 512 and a ragged 200) and the training path's MHA
    shape (swarm-1b: 32 heads, microbatch 2, seq 512), where the
    backward reuses ``lse``.  Each call also runs again (output and
    ``lse`` bit-equal: deterministic) and on each batch row alone (equal
    to that row of the batch-2 call: a row's result does not depend on
    the rest of the grid)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
    H, D, B = 32, 128, 2
    main = None
    for path, KV, S in (("serve", 4, 512), ("serve", 4, 200),
                        ("train", 32, 512)):
        for dt, bound, peak in ((torch.bfloat16, 2e-2, H100_BF16_FLOPS),
                                (torch.float32, 1e-4, H100_F32_FLOPS)):
            q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dt)
            k = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dt)
            v = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dt)
            out, lse = _counted(torch, lambda: flash_attention_fwd(
                q, k, v, True, 0, None, 512, 1024, with_lse=True))
            torch.cuda.synchronize()
            with plain_precision(torch):
                ref, ref_lse = flash_fwd_ref(q, k, v, True, 0, 0, 512, 1024)
            err = float((out.float() - ref.float()).abs().max())
            lse_err = float((lse - ref_lse).abs().max())
            if not (err <= bound and lse_err <= 1e-4):
                raise AssertionError(f"flash {path} S={S} KV={KV} {dt}: max "
                                     f"err {err} (bound {bound}), lse "
                                     f"{lse_err} (bound 1e-4)")
            again = _counted(torch, lambda: flash_attention_fwd(
                q, k, v, True, with_lse=True))
            if not (torch.equal(again[0], out) and torch.equal(again[1], lse)):
                raise AssertionError(f"flash {path} S={S} KV={KV} {dt}: two "
                                     f"calls differ")
            for b in range(B):
                one = _counted(torch, lambda: flash_attention_fwd(
                    q[b:b + 1], k[b:b + 1], v[b:b + 1], True, with_lse=True))
                if not (torch.equal(one[0], out[b:b + 1])
                        and torch.equal(one[1], lse[b:b + 1])):
                    raise AssertionError(f"flash {path} S={S} KV={KV} {dt}: "
                                         f"batch row {b} alone differs")
            fwd = lambda: flash_attention_fwd(q, k, v, True)
            ms = _counted(torch, lambda: time_ms(torch, fwd))
            cold = _counted(torch, lambda: time_ms(torch, fwd, cold=True))
            eager = _counted(torch, lambda: eager_ms(torch, fwd))
            plain = time_ms(torch, lambda: flash_fwd_ref(
                q, k, v, True, 0, 0, 512, 1024), iters=5)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
            pairs = S * (S + 1) // 2                 # causal (q, k) pairs
            flops = 4.0 * D * pairs * B * H
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
            b_ms, b_by = bound_ms(nbytes, flops, peak)
            row = {"kernel": "flash_attention_fwd", "path": path, "shape":
                   f"B={B} S={S} H={H} KV={KV} D={D}", "dtype": str(dt),
                   "max_abs_err": err, "lse_max_abs_err": lse_err,
                   "bound": bound, "lse_bound": 1e-4,
                   "deterministic": True, "row_independent": True,
                   "ms": ms, "cold_ms": cold, "eager_ms": eager,
                   "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
                   "bound_by": b_by, "cold_share_of_bound": b_ms / cold}
            emit(row)
            rows.append(row)
            if (path, S, dt) == ("serve", 512, torch.bfloat16):
                main = row
    return main


def check_rmsnorm(torch, gen, rows: list) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    R, d = 1024, 4096
    main = None
    scale = torch.randn(d, generator=gen, device="cuda") + 1.0
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn(R, d, generator=gen, device="cuda").to(dt)
        out = _counted(torch, lambda: rmsnorm(x, scale))
        torch.cuda.synchronize()
        ref = rmsnorm_ref(x, scale)
        err = float((out.float() - ref.float()).abs().max())
        ulps = _ulps(torch, out, ref)
        if ulps > 1.0:
            raise AssertionError(f"rmsnorm {dt}: {ulps} ulps (bound 1)")
        ms = _counted(torch, lambda: time_ms(torch, lambda: rmsnorm(x, scale)))
        cold = _counted(torch, lambda: time_ms(
            torch, lambda: rmsnorm(x, scale), cold=True))
        eager = _counted(torch, lambda: eager_ms(
            torch, lambda: rmsnorm(x, scale)))
        plain = time_ms(torch, lambda: rmsnorm_ref(x, scale))
        w = scale.to(dt)
        lib = time_ms(torch, lambda: F.rms_norm(x, (d,), w, 1e-6))
        nbytes = 2 * x.numel() * x.element_size() + d * 4
        b_ms, b_by = bound_ms(nbytes, 4.0 * x.numel(), H100_F32_FLOPS)
        row = {"kernel": "rmsnorm", "shape": f"[{R}, {d}]", "dtype": str(dt),
               "max_abs_err": err, "max_ulps": ulps, "bound": "1 ulp",
               "ms": ms, "cold_ms": cold, "eager_ms": eager,
               "plain_ms": plain, "library_ms": lib,
               "bound_ms": b_ms, "bound_by": b_by,
               "cold_share_of_bound": b_ms / cold}
        emit(row)
        rows.append(row)
        if dt == torch.bfloat16:
            main = row
    return main


def _equal(torch, name, got, want) -> None:
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: {int((got != want).sum())} "
                             f"elements differ from the plain version")


def _bits_equal(torch, name, got, want) -> None:
    """``got`` and ``want`` equal bit for bit: floats as their integer
    words, so +0 and -0 differ."""
    words = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    if got.dtype in words and got.dtype == want.dtype:
        got, want = got.view(words[got.dtype]), want.view(words[want.dtype])
    _equal(torch, name, got, want)


def _stable(torch, name, fn, a, out) -> None:
    """``fn(a)`` again equals ``out``, and ``fn`` of rows 300-499 of ``a``
    equals those rows of ``out``, to the bit (``a`` may be a tuple of
    arguments, and ``out`` and ``fn``'s result tuples, of tensors with
    rows first)."""
    args = a if isinstance(a, tuple) else (a,)
    again = _counted(torch, lambda: fn(*args))
    part = _counted(torch, lambda: fn(*(t[300:500] for t in args)))
    outs = out if isinstance(out, tuple) else (out,)
    agains = again if isinstance(again, tuple) else (again,)
    parts = part if isinstance(part, tuple) else (part,)
    if not all(torch.equal(x, y) for x, y in zip(agains, outs)):
        raise AssertionError(f"{name}: two calls differ")
    if not all(torch.equal(x, y[300:500]) for x, y in zip(parts, outs)):
        raise AssertionError(f"{name}: rows 300-499 alone differ")


# every path of csrc/blockq.cuh (``flat_block_path``): lane groups (bf16
# 8 ... 256, f32 4 ... 128), thread groups looping in vectors (48, 96,
# 4096, and 256 in f32) and in scalars (1, 3, 100)
FLAT_BLOCKS = (1, 3, 8, 16, 32, 48, 64, 96, 100, 128, 256, 4096)
GENERAL_TIMED = (96, 256, 4096)      # timed beside the wire's 64


def _tied(torch, gen, shape, dt):
    """randn * 5 with exact ``.5`` ties on the code grid in the first 64
    elements (their block's absmax 127 makes x / s * 127 == x, so k + 0.5
    rounds half to even) and an all-zero run of 4096 at element 8192."""
    x = torch.randn(*shape, generator=gen, device="cuda") * 5
    x.view(-1)[:64] = torch.arange(64, device="cuda") - 32.5
    x.view(-1)[63] = 127.0
    x.view(-1)[8192:12288] = 0.0
    return x.to(dt)


def _timed_flat(torch, row, fn, nbytes, ops):
    """Warm, cold and eager device times of ``fn`` into ``row`` beside
    the bytes bound (f32 operations)."""
    b_ms, b_by = bound_ms(nbytes, ops, H100_F32_FLOPS)
    ms = _counted(torch, lambda: time_ms(torch, fn))
    cold = _counted(torch, lambda: time_ms(torch, fn, cold=True))
    row.update({"ms": ms, "cold_ms": cold,
                "eager_ms": _counted(torch, lambda: eager_ms(torch, fn)),
                "bound_ms": b_ms, "bound_by": b_by,
                "cold_share_of_bound": b_ms / cold})
    return row


def check_qdq(torch, gen, rows: list) -> dict:
    """qdq_flat at the int8 wire's shape ``[2, 512, 4096]`` and every
    block of ``FLAT_BLOCKS``, whole and with a tail 27 elements short of
    a block, and on a view one element off a 16-byte boundary, with
    exact ``.5`` ties and an all-zero block: codes, scales and outputs
    bit-equal to the plain version (signed zeros included); at 64 (the
    wire's block) also two calls bit-equal, and rows 300-499 of the
    tensor seen as [1024, 4096] alone equal to those rows of the whole
    call.  Timed at 64 and at ``GENERAL_TIMED``."""
    from repro_torch.compression import quant8
    from repro_torch.kernels.boundary.kernel import flat_block_path, qdq_flat
    shape = (2, 512, 4096)
    main = None
    for dt in (torch.bfloat16, torch.float32):
        x = _tied(torch, gen, shape, dt)
        flat = x.reshape(-1)
        off = torch.empty(flat.numel() + 1, dtype=dt, device="cuda")
        off[1:] = flat
        paths = {}
        for block in FLAT_BLOCKS:
            for name, t in (("whole", flat), ("tail", flat[:-27]),
                            ("unaligned", off[1:])):
                n = t.numel()
                codes = torch.empty(n, dtype=torch.int8, device="cuda")
                scales = torch.empty(-(-n // block), dtype=torch.float32,
                                     device="cuda")
                out = _counted(torch, lambda: qdq_flat(t, block, codes,
                                                       scales))
                torch.cuda.synchronize()
                q_ref, s_ref, meta = quant8.blockwise_quantize(t, block)
                ref = quant8.blockwise_dequantize(q_ref, s_ref, meta)
                what = f"qdq {dt} block {block} {name} n {n}"
                _bits_equal(torch, f"{what}: codes", codes,
                            q_ref.reshape(-1)[:n])
                _bits_equal(torch, f"{what}: scales", scales,
                            s_ref.reshape(-1))
                _bits_equal(torch, f"{what}: outputs", out, ref)
            paths[block] = flat_block_path(block, dt, flat)
        block = 64
        out = _counted(torch, lambda: qdq_flat(x, block))
        _stable(torch, f"qdq_flat {dt}", lambda a: qdq_flat(a, block),
                x.reshape(1024, 4096), out.reshape(1024, 4096))
        n = x.numel()
        for block in (64,) + GENERAL_TIMED:
            row = {"kernel": "qdq_flat", "shape": str(list(shape)),
                   "dtype": str(dt), "block": block, "path": paths[block],
                   "max_abs_err": 0.0, "codes_identical": True,
                   "blocks_checked": list(FLAT_BLOCKS),
                   "views_checked": ["whole", "tail", "unaligned"],
                   "bound": "codes, scales and outputs bit-equal"}
            if block == 64:
                row.update({"deterministic": True, "row_independent": True})
            _timed_flat(torch, row, lambda: qdq_flat(x, block),
                        2 * n * x.element_size(), 5.0 * n)
            if block == 64:
                row.update({"plain_ms": time_ms(
                    torch, lambda: quant8._roundtrip(x, block)),
                    "library_ms": None})
            emit(row)
            rows.append(row)
            if (dt, block) == (torch.bfloat16, 64):
                main = row
    return main


def _faithful(torch, name, p, a, w):
    """Hold a codec product ``p`` (``a @ w`` with ``w`` rounded to
    ``a``'s dtype, f32 accumulation, rounded to that dtype) against the
    f64 product ``e`` of the same operands.  Each element must be
    faithfully rounded (``|p - e|`` below one ulp of ``e`` in the output
    dtype, so ``p`` is one of the two values around ``e``) or within
    ``4 u sqrt(n) ||a_i w_i||_2`` (u = 2^-24, n terms), about ten
    standard deviations of the rounding error of an f32 running sum of
    those terms: that floor decides only where the sum nearly cancels in
    bf16, and everywhere in f32.  Returns (elements not correctly
    rounded, elements only the floor admits)."""
    wd = w.to(a.dtype).double()
    ad = a.double()
    e = ad @ wd
    err = (p.double() - e).abs()
    ulp = torch.exp2(torch.floor(torch.log2(e.abs() + 1e-300))) * \
        torch.finfo(a.dtype).eps
    floor = 4 * 2.0 ** -24 * math.sqrt(a.shape[-1]) * \
        torch.sqrt((ad * ad) @ (wd * wd))
    faithful = err < ulp
    bad = ~(faithful | (err <= floor))
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements of the "
                             f"product off by up to "
                             f"{float(err[bad].max())}")
    return int((err > 0.5 * ulp).sum()), int((~faithful).sum())


def check_codec(torch, gen, rows: list) -> dict:
    """encode (bottleneck / maxout k 2, QDQ off and on) and decode
    (bottleneck / maxout) at the training path's shapes: N = 2 x 512
    rows, d 4096, c 1024 (maxout 2048).

    Each launch is held stage by stage against the plain version on the
    kernel's own intermediate, so that a rounding step that one stage
    skipped would show: the LayerNorm passes (with maxout pooling and
    QDQ) bit-equal to ``ref._ln`` / ``qdq_ref``, and the codec GEMM's
    product faithfully rounded against the f64 product (:func:`_faithful`).
    The end-to-end error against the plain version (whose product is
    cuBLAS's) is reported beside them: where cuBLAS and the kernel sum a
    product in another order, each may round it to the other bf16
    neighbour, which the second LayerNorm carries into the output.  The
    GEMM at both shapes (encode's product, decode) also runs again
    (bit-equal) and on rows 300-499 alone (bit-equal to those rows of
    the 1024-row call), and so do the row passes (``ln_rows``); encode's
    GEMM stage and its two row passes are timed alone (``gemm_ms``,
    ``rows_ms``, each with its own bound), and every call also cold
    (``cold_ms``: the L2 flushed before each call)."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.boundary import kernel as K
    from repro_torch.kernels.boundary import ref as R
    N, d = 1024, 4096
    main = {}

    for dt, tol, peak in ((torch.bfloat16, 2e-2, H100_BF16_FLOPS),
                          (torch.float32, 1e-4, H100_F32_FLOPS)):
        es = torch.finfo(dt).bits // 8
        code = _lib.DTYPE_CODES[dt]
        x = (torch.randn(N, d, generator=gen, device="cuda") * 3
             + 1).to(dt)
        w_c = torch.randn(d, 1024, generator=gen, device="cuda") / 64
        h = _counted(torch, lambda: K._ln_rows(x, 1, 0, code))
        _equal(torch, f"encode LN pass {dt}", h, R._ln(x))
        _stable(torch, f"encode LN pass {dt}",
                lambda a: K._ln_rows(a, 1, 0, code), x, h)
        prod = _counted(torch, lambda: K._gemm(h, w_c, code))
        _stable(torch, f"encode's GEMM {dt}",
                lambda a: K._gemm(a, w_c, code), h, prod)
        gemm_ms = _counted(torch, lambda: time_ms(
            torch, lambda: K._gemm(h, w_c, code)))
        gemm_bound = bound_ms((N * d + N * 1024) * es + w_c.numel() * 4,
                              2.0 * N * d * 1024, peak)
        with plain_precision(torch):
            prod_lib = h @ w_c.to(dt)
        not_cr, floor_only = _faithful(torch, f"encode {dt}", prod, h, w_c)
        lib_not_cr, _ = _faithful(torch, f"encode's plain version {dt}",
                                  prod_lib, h, w_c)
        rows_differ = (prod != prod_lib).any(-1, keepdim=True)
        for mode, w, k, c in (("bottleneck", w_c, 1, 1024),
                              ("maxout", None, 2, 2048)):
            for quantize in (False, True):
                qb = R.wire_qblock(c)
                out = _counted(torch, lambda: K.encode(x, w, mode, k, qb,
                                                       quantize))
                torch.cuda.synchronize()
                # the kernel's last pass on its own intermediate
                last = R._ln(prod) if mode == "bottleneck" else \
                    R.encode_ref(x, None, mode, k)
                _equal(torch, f"encode {mode} last pass {dt}", out,
                       R.qdq_ref(last, qb) if quantize else last)
                q = qb if quantize else 0
                src = prod if mode == "bottleneck" else x
                _stable(torch, f"encode {mode} last pass {dt}",
                        lambda a: K._ln_rows(a, k, q, code), src, out)
                with plain_precision(torch):
                    z = R.encode_ref(x, w, mode, k)
                ref = R.qdq_ref(z, qb) if quantize else z
                err = (out.double() - ref.double()).abs()
                past = err > tol
                # past the bound only in a row whose kernel and cuBLAS
                # products round apart (a QDQ'd element there may take
                # the other code, or its block another scale), and never
                # in f32 without QDQ
                if bool((past & ~rows_differ).any()) or (
                        dt == torch.float32 and not quantize
                        and bool(past.any())):
                    raise AssertionError(f"encode {mode} {dt}: max error "
                                         f"{float(err.max())} (bound {tol})")
                enc = lambda: K.encode(x, w, mode, k, qb,
                                       quantize)
                ms = _counted(torch, lambda: time_ms(torch, enc))
                cold = _counted(torch, lambda: time_ms(torch, enc,
                                                       cold=True))
                eager = _counted(torch, lambda: eager_ms(torch, enc))
                plain = time_ms(torch, lambda: R.encode_ref(x, w, mode, k))
                nbytes = (N * d + N * c) * es + (0 if w is None else
                                                 w.numel() * 4)
                ops = 8.0 * N * d + (2.0 * N * d * c + 8.0 * N * c
                                     if mode == "bottleneck" else 0.0)
                ops += 5.0 * N * c if quantize else 0.0
                b_ms, b_by = bound_ms(nbytes, ops, peak if mode ==
                                      "bottleneck" else H100_F32_FLOPS)
                row = {"kernel": "encode", "mode": mode,
                       "quantize": quantize, "shape": f"[{N}, {d}] -> "
                       f"[{N}, {c}]", "dtype": str(dt),
                       "max_abs_err": float(err.max()),
                       "elements_past_bound": int(past.sum()),
                       "bound": "bit-equal" if mode == "maxout" else
                       "LN passes bit-equal; product faithfully rounded; "
                       f"{tol} end to end" + (
                           ", except in rows whose products round apart"
                           if dt == torch.bfloat16 or quantize else ""),
                       "ms": ms, "cold_ms": cold, "eager_ms": eager,
                       "plain_ms": plain, "library_ms": None,
                       "bound_ms": b_ms, "bound_by": b_by}
                if mode == "bottleneck":
                    passes = lambda: (K._ln_rows(x, 1, 0, code),
                                      K._ln_rows(prod, 1, q, code))
                    row["gemm_ms"] = gemm_ms
                    row["gemm_bound_ms"], row["gemm_bound_by"] = gemm_bound
                    row["rows_ms"] = time_ms(torch, passes)
                    row["rows_cold_ms"] = time_ms(torch, passes, cold=True)
                    row["rows_bound_ms"], row["rows_bound_by"] = bound_ms(
                        2 * (N * d + N * c) * es,
                        8.0 * N * d + 8.0 * N * c
                        + (5.0 * N * c if quantize else 0.0),
                        H100_F32_FLOPS)
                    row["product"] = {
                        "not_correctly_rounded": not_cr,
                        "cublas_not_correctly_rounded": lib_not_cr,
                        "only_f32_floor": floor_only,
                        "elements_differing_from_cublas":
                            int((prod != prod_lib).sum()),
                        "rows_differing_from_cublas":
                            int(rows_differ.sum())}
                emit(row)
                rows.append(row)
                if (dt, mode, quantize) == (torch.bfloat16, "bottleneck",
                                            False):
                    main["encode"] = row
        for mode, c in (("bottleneck", 1024), ("maxout", 2048)):
            z = torch.randn(N, c, generator=gen, device="cuda").to(dt)
            w_d = torch.randn(c, d, generator=gen, device="cuda") / c ** 0.5
            out = _counted(torch, lambda: K.decode(z, w_d, mode))
            torch.cuda.synchronize()
            _stable(torch, f"decode {mode} {dt}",
                    lambda a: K.decode(a, w_d, mode), z, out)
            a = z
            if mode == "maxout":
                a = _counted(torch, lambda: K._ln_rows(z, 1, 0, code))
                _equal(torch, f"decode maxout LN pass {dt}", a, R._ln(z))
                _stable(torch, f"decode maxout LN pass {dt}",
                        lambda t: K._ln_rows(t, 1, 0, code), z, a)
            not_cr, floor_only = _faithful(torch, f"decode {mode} {dt}", out,
                                           a, w_d)
            with plain_precision(torch):
                ref = R.decode_ref(z, w_d, mode)
            lib_not_cr, _ = _faithful(torch, f"decode's plain version "
                                      f"{mode} {dt}", ref, a, w_d)
            err = (out.double() - ref.double()).abs()
            if dt == torch.float32 and bool((err > tol).any()):
                raise AssertionError(f"decode {mode} f32: max error "
                                     f"{float(err.max())} (bound {tol})")
            dec = lambda: K.decode(z, w_d, mode)
            ms = _counted(torch, lambda: time_ms(torch, dec))
            cold = _counted(torch, lambda: time_ms(torch, dec, cold=True))
            eager = _counted(torch, lambda: eager_ms(torch, dec))
            plain = time_ms(torch, lambda: R.decode_ref(z, w_d, mode))
            # bottleneck decode is one product: its library yardstick is
            # torch.matmul on the weight already in the activation dtype
            w_dt = w_d.to(dt)
            lib = (time_ms(torch, lambda: torch.matmul(z, w_dt))
                   if mode == "bottleneck" else None)
            nbytes = (N * c + N * d) * es + w_d.numel() * 4
            ops = 2.0 * N * c * d + (8.0 * N * c if mode == "maxout"
                                     else 0.0)
            b_ms, b_by = bound_ms(nbytes, ops, peak)
            row = {"kernel": "decode", "mode": mode, "shape":
                   f"[{N}, {c}] -> [{N}, {d}]", "dtype": str(dt),
                   "max_abs_err": float(err.max()),
                   "elements_past_bound": int((err > tol).sum()),
                   "bound": "product faithfully rounded"
                   + ("; LN pass bit-equal" if mode == "maxout" else "")
                   + (f"; {tol} end to end" if dt == torch.float32
                      else ""),
                   "product": {"not_correctly_rounded": not_cr,
                               "cublas_not_correctly_rounded": lib_not_cr,
                               "only_f32_floor": floor_only},
                   "deterministic": True, "row_independent": True,
                   "ms": ms, "cold_ms": cold, "eager_ms": eager,
                   "plain_ms": plain, "library_ms": lib,
                   "bound_ms": b_ms, "bound_by": b_by}
            emit(row)
            rows.append(row)
            if (dt, mode) == (torch.bfloat16, "bottleneck"):
                main["decode"] = row
    return main


def check_ln_rows(torch, gen, rows: list) -> None:
    """The codec's row pass on its own (``K._ln_rows``) at the training
    path's shapes: encode's first pass ``[1024, 4096]``, its second
    ``[1024, 1024]``, and maxout's ``[1024, 4096] -> [1024, 2048]`` with
    QDQ in blocks of 64, bf16 and f32: bit-equal to the plain version
    (``ref._ln``, the pool, ``qdq_ref``), two calls bit-equal, rows
    300-499 alone equal to those rows of the whole call.  Timed warm and
    cold beside the plain version and ``F.layer_norm`` (no affine, eps
    1e-6; for the maxout pass it computes the LayerNorm only); the bound
    is the bytes (each input read once, each output written once)."""
    import torch.nn.functional as F
    from repro_torch.kernels import _lib
    from repro_torch.kernels.boundary import kernel as K
    from repro_torch.kernels.boundary import ref as R
    N = 1024
    for dt in (torch.bfloat16, torch.float32):
        es = torch.finfo(dt).bits // 8
        code = _lib.DTYPE_CODES[dt]
        for width, k, qb in ((4096, 1, 0), (1024, 1, 0), (4096, 2, 64)):
            x = (torch.randn(N, width, generator=gen, device="cuda") * 3
                 + 1).to(dt)
            run = lambda a: K._ln_rows(a, k, qb, code)

            def plain(a):
                z = R.encode_ref(a, None, "maxout", k) if k > 1 else R._ln(a)
                return R.qdq_ref(z, qb) if qb else z

            out = run(x)
            torch.cuda.synchronize()
            name = f"ln_rows [{N}, {width}] k {k} qb {qb} {dt}"
            _equal(torch, name, out, plain(x))
            _stable(torch, name, run, x, out)
            layer_norm = lambda: F.layer_norm(x, (width,), eps=1e-6)
            nbytes = N * width * es + N * (width // k) * es
            b_ms, b_by = bound_ms(nbytes, 8.0 * N * width + (
                5.0 * N * width / k if qb else 0.0), H100_F32_FLOPS)
            cold = time_ms(torch, lambda: run(x), cold=True)
            row = {"kernel": "ln_rows", "shape": f"[{N}, {width}] -> "
                   f"[{N}, {width // k}]", "pool": k, "qb": qb,
                   "dtype": str(dt), "max_abs_err": 0.0,
                   "bound": "bit-equal", "deterministic": True,
                   "row_independent": True,
                   "ms": time_ms(torch, lambda: run(x)), "cold_ms": cold,
                   "eager_ms": eager_ms(torch, lambda: run(x)),
                   "plain_ms": time_ms(torch, lambda: plain(x)),
                   "library": "F.layer_norm" + (
                       " (the LayerNorm only)" if k > 1 or qb else ""),
                   "library_ms": time_ms(torch, layer_norm),
                   "library_cold_ms": time_ms(torch, layer_norm,
                                              cold=True),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "cold_share_of_bound": b_ms / cold}
            emit(row)
            rows.append(row)


def check_quant8(torch, gen, rows: list) -> dict:
    """The quant8 pair at the int8 wire's shape ``[2, 512, 4096]`` and
    every block of ``FLAT_BLOCKS``, on the flat tensor and on a view one
    element off a 16-byte boundary (codes dequantized from a view one
    byte off too), with exact ``.5`` ties and an all-zero block: codes,
    scales and dequantized values (bf16 and f32) bit-equal to the plain
    versions (signed zeros included).  At 64 also two calls bit-equal,
    and blocks 300-499 alone equal to those blocks of the whole call.
    Timed at 64 and at ``GENERAL_TIMED``."""
    from repro_torch.kernels.boundary.kernel import flat_block_path
    from repro_torch.kernels.quant8 import kernel as K
    from repro_torch.kernels.quant8 import ref as R
    shape = (2, 512, 4096)
    main = {}
    for dt in (torch.bfloat16, torch.float32):
        flat = _tied(torch, gen, shape, dt).reshape(-1)
        n, es = flat.numel(), flat.element_size()
        off = torch.empty(n + 1, dtype=dt, device="cuda")
        off[1:] = flat
        qoff = torch.empty(n + 1, dtype=torch.int8, device="cuda")
        paths = {}
        for block in FLAT_BLOCKS:
            nb = n // block
            t = flat[:nb * block]
            q, sc = _counted(torch, lambda: K.quantize(t, block))
            torch.cuda.synchronize()
            rq, rs = R.quantize_ref(t, block)
            what = f"quant8 {dt} block {block}"
            _bits_equal(torch, f"{what}: codes", q, rq)
            _bits_equal(torch, f"{what}: scales", sc, rs)
            uq, us = _counted(torch, lambda: K.quantize(off[1:nb * block + 1],
                                                        block))
            _bits_equal(torch, f"{what} unaligned: codes", uq, rq)
            _bits_equal(torch, f"{what} unaligned: scales", us, rs)
            qoff[1:nb * block + 1] = q.reshape(-1)
            qv = qoff[1:nb * block + 1].view(nb, block)
            for out_dt in (torch.bfloat16, torch.float32):
                ry = R.dequantize_ref(rq, rs, out_dt)
                y = _counted(torch, lambda: K.dequantize(q, sc, out_dt))
                _bits_equal(torch, f"{what} -> {out_dt}: values", y, ry)
                y = _counted(torch, lambda: K.dequantize(qv, sc, out_dt))
                _bits_equal(torch, f"{what} -> {out_dt} unaligned: values",
                            y, ry)
            paths[block] = flat_block_path(block, dt, t)
        block = 64
        nb = n // block
        q, sc = _counted(torch, lambda: K.quantize(flat, block))
        _stable(torch, f"quant8.quantize {dt}",
                lambda a: K.quantize(a.reshape(-1), block),
                flat.reshape(nb, block), (q, sc))
        y = _counted(torch, lambda: K.dequantize(q, sc, dt))
        _stable(torch, f"quant8.dequantize {dt}",
                lambda a, b: K.dequantize(a, b, dt), (q, sc), y)
        for block in (64,) + GENERAL_TIMED:
            nb = n // block
            t = flat[:nb * block]
            m = t.numel()
            qb, sb = _counted(torch, lambda: K.quantize(t, block))
            for name, fn, plain, nbytes, ops in (
                    ("quant8_quantize", lambda: K.quantize(t, block),
                     lambda: R.quantize_ref(t, block),
                     m * es + m + nb * 4, 5.0 * m),
                    ("quant8_dequantize", lambda: K.dequantize(qb, sb, dt),
                     lambda: R.dequantize_ref(qb, sb, dt),
                     m + nb * 4 + m * es, 2.0 * m)):
                row = {"kernel": name, "shape": str(list(shape)),
                       "elements": m, "dtype": str(dt), "block": block,
                       "path": paths[block], "max_abs_err": 0.0,
                       "blocks_checked": list(FLAT_BLOCKS),
                       "views_checked": ["whole", "unaligned"],
                       "bound": "codes, scales and values bit-equal"}
                if block == 64:
                    row.update({"deterministic": True,
                                "row_independent": True})
                _timed_flat(torch, row, fn, nbytes, ops)
                if block == 64:
                    row.update({"plain_ms": time_ms(torch, plain),
                                "library_ms": None})
                emit(row)
                rows.append(row)
                if (dt, block) == (torch.bfloat16, 64):
                    main[name] = row
    return main


def check_wire_codes(torch, gen, rows: list) -> dict:
    """encode_quantize ``[1024, 4096] -> [1024, c]`` codes + scales and
    dequantize_decode back to ``[1024, 4096]`` (bottleneck c 1024, maxout
    k 2 c 2048), bf16 and f32, held stage by stage as ``check_codec``
    holds encode: the LN pass bit-equal, the product faithfully rounded,
    the codes and scales of the last pass bit-equal to the plain
    version's on the kernel's own product.  Against the plain version end
    to end (cuBLAS's product), a code may differ by one step, and a scale
    at all, only in rows whose two products round apart; their counts are
    reported.  dequantize_decode's product is faithfully rounded against
    the f64 product of the plain dequantized (maxout: LayerNorm'd) rows
    and, in f32, within 1e-4 of the plain version."""
    from repro_torch.kernels import _lib
    from repro_torch.compression.quant8 import div127
    from repro_torch.kernels.boundary import kernel as K
    from repro_torch.kernels.boundary import ref as R
    N, d = 1024, 4096
    main = {}
    for dt, peak in ((torch.bfloat16, H100_BF16_FLOPS),
                     (torch.float32, H100_F32_FLOPS)):
        es = torch.finfo(dt).bits // 8
        code = _lib.DTYPE_CODES[dt]
        x = (torch.randn(N, d, generator=gen, device="cuda") * 3
             + 1).to(dt)
        w_c = torch.randn(d, 1024, generator=gen, device="cuda") / 64
        for mode, w, k, c in (("bottleneck", w_c, 1, 1024),
                              ("maxout", None, 2, 2048)):
            qb = R.wire_qblock(c)
            q, sc = _counted(torch, lambda: K.encode_quantize(x, w, mode, k,
                                                              qb))
            torch.cuda.synchronize()
            rows_apart = None
            if mode == "bottleneck":
                h = _counted(torch, lambda: K._ln_rows(x, 1, 0, code))
                if not torch.equal(h, R._ln(x)):
                    raise AssertionError(f"encode_quantize LN pass {dt}")
                prod = _counted(torch, lambda: K._gemm(h, w, code))
                _faithful(torch, f"encode_quantize {dt}", prod, h, w)
                last_q, last_s = R.quantize_rows(R._ln(prod), qb)
                with plain_precision(torch):
                    prod_lib = h @ w.to(dt)
                rows_apart = (prod != prod_lib).any(-1)
            else:
                last_q, last_s = R.encode_quantize_ref(x, None, mode, k, qb)
            if not (torch.equal(q, last_q) and torch.equal(sc, last_s)):
                raise AssertionError(
                    f"encode_quantize {mode} {dt}: last pass: "
                    f"{int((q != last_q).sum())} codes, "
                    f"{int((sc != last_s).sum())} scales differ")
            kk = 1 if mode == "bottleneck" else k
            _stable(torch, f"encode_quantize {mode} codes pass {dt}",
                    lambda a: K._ln_rows_codes(a, kk, qb, code),
                    prod if mode == "bottleneck" else x, (q, sc))
            with plain_precision(torch):
                pq, ps = R.encode_quantize_ref(x, w, mode, k, qb)
            dq = (q.int() - pq.int()).abs()
            bad_rows = (dq > 0).any(-1) | (sc != ps).any(-1)
            if bool((dq > 1).any()) or (
                    rows_apart is None and bool(bad_rows.any())) or (
                    rows_apart is not None
                    and bool((bad_rows & ~rows_apart).any())):
                raise AssertionError(f"encode_quantize {mode} {dt}: codes "
                                     f"off by up to {int(dq.max())} in "
                                     f"{int(bad_rows.sum())} rows")
            enq = lambda: K.encode_quantize(x, w, mode, k, qb)
            ms = _counted(torch, lambda: time_ms(torch, enq))
            cold = _counted(torch, lambda: time_ms(torch, enq, cold=True))
            eager = _counted(torch, lambda: eager_ms(torch, enq))
            plain = time_ms(torch, lambda: R.encode_quantize_ref(
                x, w, mode, k, qb))
            nbytes = N * d * es + N * c + N * (c // qb) * 4 + (
                0 if w is None else w.numel() * 4)
            ops = 8.0 * N * d + 5.0 * N * c + (
                2.0 * N * d * c + 8.0 * N * c if mode == "bottleneck"
                else 0.0)
            b_ms, b_by = bound_ms(nbytes, ops, peak if mode ==
                                  "bottleneck" else H100_F32_FLOPS)
            row = {"kernel": "encode_quantize", "mode": mode,
                   "shape": f"[{N}, {d}] -> [{N}, {c}] int8 + "
                   f"[{N}, {c // qb}] f32", "dtype": str(dt),
                   "max_abs_err": float(dq.max()),
                   "codes_differing_from_plain": int((dq > 0).sum()),
                   "scales_differing_from_plain": int((sc != ps).sum()),
                   "rows_differing_from_plain": int(bad_rows.sum()),
                   "bound": "LN pass bit-equal; product faithfully "
                   "rounded; codes and scales of the last pass bit-equal; "
                   "end to end one code step, only in rows whose products "
                   "round apart" if mode == "bottleneck" else "bit-equal",
                   "ms": ms, "cold_ms": cold, "eager_ms": eager,
                   "plain_ms": plain, "library_ms": None,
                   "bound_ms": b_ms, "bound_by": b_by}
            if rows_apart is not None:
                row["rows_whose_products_round_apart"] = \
                    int(rows_apart.sum())
            emit(row)
            rows.append(row)
            if (dt, mode) == (torch.bfloat16, "bottleneck"):
                main["encode_quantize"] = row
            # ... and back, in x's dtype
            w_d = torch.randn(c, d, generator=gen, device="cuda") / c ** 0.5
            y = _counted(torch, lambda: K.dequantize_decode(q, sc, w_d, mode,
                                                            qb, dt))
            torch.cuda.synchronize()
            blocks = q.float().reshape(N, c // qb, qb)
            a = div127(blocks * sc[..., None]).reshape(N, c).to(dt)
            if mode == "maxout":
                a = R._ln(a)
            ln = mode == "maxout"
            deq = _counted(torch, lambda: K._dequant_rows(q, sc, qb, ln, dt))
            _equal(torch, f"dequantize_decode {mode} dequant pass {dt}", deq,
                   a)
            _stable(torch, f"dequantize_decode {mode} dequant pass {dt}",
                    lambda t, s_: K._dequant_rows(t, s_, qb, ln, dt),
                    (q, sc), deq)
            not_cr, floor_only = _faithful(torch, f"dequantize_decode {mode}"
                                           f" {dt}", y, a, w_d)
            with plain_precision(torch):
                ref = R.dequantize_decode_ref(q, sc, w_d, mode, qb, dt)
            err = (y.double() - ref.double()).abs()
            if dt == torch.float32 and bool((err > 1e-4).any()):
                raise AssertionError(f"dequantize_decode {mode} f32: max "
                                     f"error {float(err.max())}")
            dqd = lambda: K.dequantize_decode(
                q, sc, w_d, mode, qb, dt)
            ms = _counted(torch, lambda: time_ms(torch, dqd))
            cold = _counted(torch, lambda: time_ms(torch, dqd, cold=True))
            eager = _counted(torch, lambda: eager_ms(torch, dqd))
            plain = time_ms(torch, lambda: R.dequantize_decode_ref(
                q, sc, w_d, mode, qb, dt))
            nbytes = N * c + N * (c // qb) * 4 + w_d.numel() * 4 + N * d * es
            ops = 2.0 * N * c * d + 3.0 * N * c + (
                8.0 * N * c if mode == "maxout" else 0.0)
            b_ms, b_by = bound_ms(nbytes, ops, peak)
            row = {"kernel": "dequantize_decode", "mode": mode,
                   "shape": f"[{N}, {c}] int8 + [{N}, {c // qb}] f32 -> "
                   f"[{N}, {d}]", "dtype": str(dt),
                   "max_abs_err": float(err.max()),
                   "bound": "product faithfully rounded against the plain "
                   "dequantized rows" + ("; 1e-4 end to end"
                                         if dt == torch.float32 else ""),
                   "product": {"not_correctly_rounded": not_cr,
                               "only_f32_floor": floor_only},
                   "ms": ms, "cold_ms": cold, "eager_ms": eager,
                   "plain_ms": plain, "library_ms": None,
                   "bound_ms": b_ms, "bound_by": b_by}
            emit(row)
            rows.append(row)
            if (dt, mode) == (torch.bfloat16, "bottleneck"):
                main["dequantize_decode"] = row
    return main


def phase_kernels(torch) -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows: list = []
    main = {"flash_attention_fwd": check_flash(torch, gen, rows),
            "rmsnorm": check_rmsnorm(torch, gen, rows),
            "qdq_flat": check_qdq(torch, gen, rows),
            **check_codec(torch, gen, rows),
            **check_wire_codes(torch, gen, rows),
            **check_quant8(torch, gen, rows)}
    check_ln_rows(torch, gen, rows)      # encode's row pass on its own
    return main


# ------------------------------------------------------------ phases 3-5
N_REQ, PROMPT, NEW = 4, 512, 16
MAX_BATCH = 2           # requests per session slot


def yi6b(torch):
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.models import params as P
    cfg = get_config("yi-6b")
    t0 = time.time()
    params = P.init(0, model_lib.lm_specs(cfg), "cuda")
    torch.cuda.synchronize()
    emit({"phase": "init", "arch": cfg.name,
          "params": P.n_params(model_lib.lm_specs(cfg)),
          "param_gb": torch.cuda.memory_allocated() / 1e9,
          "seconds": time.time() - t0})
    return cfg, params


def prompts_for(cfg):
    import numpy as np
    rng = np.random.default_rng(1)
    return rng.integers(0, cfg.vocab_size, size=(N_REQ, PROMPT))


def make_runner(torch, cfg, params, codec: str, spare: bool,
                quant_block: int = 64):
    from repro_torch.serve import ServeConfig, ServeRunner
    r = ServeRunner(cfg, ServeConfig(n_stages=4, max_batch=MAX_BATCH,
                                     max_sessions=1 if spare else 2,
                                     codec=codec, quant_block=quant_block),
                    params=params, device="cuda")
    r.add_peer((0, 2), pool="decode", name="d0")
    r.add_peer((2, 4), pool="decode", name="d1")
    if spare:
        r.add_peer((2, 4), pool="decode", name="d1spare")
    return r


def serve(torch, r, prompts, fail_at=None):
    """Serve the prompts; returns (tokens [N, NEW], requests, summary,
    seconds)."""
    import numpy as np
    reqs = [r.submit(p, NEW) for p in prompts]
    if fail_at is not None:
        r.schedule_fail(fail_at, "d1")
    torch.cuda.synchronize()
    t0 = time.time()
    summary = r.run()
    torch.cuda.synchronize()
    secs = time.time() - t0
    if any(q.tokens is None for q in reqs):
        raise AssertionError(f"unfinished requests: {summary}")
    return np.stack([q.tokens for q in reqs]), reqs, summary, secs


def chain_generate(torch, r, batch, wire):
    """Greedy-generate ``batch`` through the chain's two session programs
    called directly (no sim, no ledger), with ``wire`` applied at the
    span edge.  Returns (tokens [B, NEW], prefill s, decode s) on the
    host clock around synchronized work."""
    import numpy as np
    from repro_torch import kernels
    saved = dict(kernels.LAUNCHES)
    total = PROMPT + NEW
    peers = r.decode_peers[:2]
    progs = [p.executor.session_program(total) for p in peers]
    params = [tuple(p.state.stage_view(s).params for s in prog.stages)
              for p, prog in zip(peers, progs)]
    x0 = torch.as_tensor(np.asarray(batch, np.int32), device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    w, kv0 = progs[0].prefill(params[0], x0)
    tok, kv1 = progs[1].prefill(params[1], wire(w))
    torch.cuda.synchronize()
    t_pre = time.time() - t0
    out = [tok]
    t0 = time.time()
    for i in range(NEW - 1):
        w, kv0 = progs[0].decode(params[0], kv0, tok, PROMPT + i)
        tok, kv1 = progs[1].decode(params[1], kv1, wire(w), PROMPT + i)
        out.append(tok)
    torch.cuda.synchronize()
    t_dec = time.time() - t0
    kernels.LAUNCHES.update(saved)
    return torch.cat(out, dim=1).cpu().numpy(), t_pre, t_dec


RATE_RUNS = 3


def chain_rates(torch, r, prompts) -> dict:
    """Prefill and decode rates of the chain's programs alone, for one
    batch of max_batch prompts, wire codec as the runner's: the median
    of ``RATE_RUNS`` runs, each run's times kept.  Both are host-clock
    times of host-bound work, and one run of the same work on the same
    card varied from 39 to 60 ms of prefill between runs of this script
    (PERF.md)."""
    import statistics
    B = r.scfg.max_batch
    runs = [chain_generate(torch, r, prompts[:B],
                           r.decode_peers[0].executor.wire_fwd)[1:]
            for _ in range(RATE_RUNS)]
    t_pre = statistics.median(p for p, _ in runs)
    t_dec = statistics.median(d for _, d in runs)
    return {"prefill_tokens_per_s": B * PROMPT / t_pre,
            "prefill_s": t_pre,
            "decode_ms_per_token": t_dec / (NEW - 1) * 1e3,
            "decode_batch": B,
            "prefill_s_runs": [p for p, _ in runs],
            "decode_ms_per_token_runs": [d / (NEW - 1) * 1e3
                                         for _, d in runs]}


def free(torch) -> None:
    """Return what the caller has just dropped (``del``) to the card:
    runners hold reference cycles (peers, executors, sim processes)."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve(torch, cfg, params, prompts, ref, codec: str,
                quant_block: int = 64) -> dict:
    """Serve the prompts through the chain; tokens identical to ``ref``
    (plain wire), or with the int8 wire of blocks of ``quant_block`` to
    the chain's programs with the plain int8 round trip at the edge."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.compression import quant8
    from repro_torch.models.stage_plan import get_stage_plan
    torch.cuda.reset_peak_memory_stats()
    r = make_runner(torch, cfg, params, codec, spare=False,
                    quant_block=quant_block)
    kernels.reset_launches()
    toks, reqs, summary, secs = serve(torch, r, prompts)
    launches = dict(kernels.LAUNCHES)
    if codec == "int8":
        # the lossy wire changes the tokens: hold the swarm against the
        # chain's programs called directly with the PLAIN int8 round trip
        # at the edge (same codes as the kernel, so the same tokens)
        from repro_torch.compression.quant8 import _roundtrip
        B = r.scfg.max_batch
        ref = np.concatenate([
            chain_generate(torch, r, prompts[i:i + B],
                           lambda w: _roundtrip(w, quant_block))[0]
            for i in range(0, N_REQ, B)])
    if not (toks == ref).all():
        raise AssertionError(
            f"{codec}: staged tokens differ from the reference first at "
            f"(request, token) {np.argwhere(toks != ref)[0].tolist()}")
    if summary["failed"] or summary["completed"] != N_REQ:
        raise AssertionError(f"{codec}: {summary}")
    # the serving path's kernels (the codec's are the training path's)
    for name in ("flash_attention_fwd", "rmsnorm") + (
            ("qdq_flat",) if codec == "int8" else ()):
        if launches[name] <= 0:
            raise AssertionError(f"{codec}: kernel {name} never launched")
    sessions = N_REQ // r.scfg.max_batch
    crossings = sessions * NEW          # prefill + NEW-1 decode hops
    B = r.scfg.max_batch
    row = {"phase": "serve" if codec == "none" else "int8" if
           quant_block == quant8.BLOCK else f"int8_block{quant_block}",
           "codec": codec, "quant_block": quant_block,
           "tokens_identical": True,
           "reference": ("single-process model" if codec == "none" else
                         "chain programs with the plain int8 round trip"),
           "launches": launches, "wall_s": secs,
           "summary": {k: summary[k] for k in
                       ("completed", "failed", "tokens", "elapsed_s",
                        "kv_transfers", "wire_bytes")}}
    if codec == "int8":
        if launches["qdq_flat"] != crossings:
            raise AssertionError(f"int8: {launches['qdq_flat']} QDQ launches"
                                 f" for {crossings} span-edge crossings")
        d = cfg.d_model
        # what the runner counts: int32 tokens into stage 0 and the
        # (dequantized) bf16 wire into stage 2, per hop
        runner_bytes = sessions * (B * PROMPT * 4 + B * PROMPT * d * 2
                                   + (NEW - 1) * (B * 4 + B * d * 2))
        if summary["wire_bytes"] != runner_bytes:
            raise AssertionError(f"int8: wire_bytes {summary['wire_bytes']}"
                                 f" != {runner_bytes}")
        # what the int8 wire puts on a link at boundary 1: codes + scales
        # (the stage plan prices the default block)
        plan = get_stage_plan(cfg, 4)
        packed = sessions * (
            quant8.compressed_nbytes(B * PROMPT * d, quant_block)
            + (NEW - 1) * quant8.compressed_nbytes(B * d, quant_block))
        priced = sessions * (plan.boundary_bytes(1, B, PROMPT, "int8")
                             + (NEW - 1) * plan.boundary_bytes(1, B, 1,
                                                               "int8"))
        if quant_block == quant8.BLOCK and packed != priced:
            raise AssertionError(f"int8: compressed bytes {packed} != "
                                 f"plan {priced}")
        row["int8_wire"] = {"crossings": crossings,
                            "runner_wire_bytes": runner_bytes,
                            "compressed_nbytes": packed}
    row.update(chain_rates(torch, r, prompts))
    row["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit(row)
    del r
    free(torch)
    return row


def phase_churn(torch, cfg, params, prompts, ref) -> dict:
    import numpy as np
    from repro_torch.core.peer import T4
    torch.cuda.reset_peak_memory_stats()
    # probe: the same layout without a failure gives the virtual time the
    # first session finishes; the kill lands 0.05 s (about four decode
    # steps of two hops) before it
    r = make_runner(torch, cfg, params, "none", spare=True)
    toks0, reqs0, _, _ = serve(torch, r, prompts)
    if not (toks0 == ref).all():
        raise AssertionError("churn probe: tokens differ from the reference")
    first_done = min(q.done_at for q in reqs0)
    prog = r.decode_peers[1].executor.session_program(PROMPT + NEW)
    B, d = r.scfg.max_batch, cfg.d_model
    step = (T4.recv_time(B * 4) + T4.recv_time(B * d * 2)
            + T4.compute_time(r.decode_peers[0].executor
                              .session_program(PROMPT + NEW)
                              .flops_per_token * B)
            + T4.compute_time(prog.flops_per_token * B))
    del r, prog
    free(torch)
    fail_at = first_done - 0.05
    n_before = NEW - 1 - math.ceil(0.05 / step)   # tokens out before it
    r = make_runner(torch, cfg, params, "none", spare=True)
    toks, reqs, summary, secs = serve(torch, r, prompts, fail_at=fail_at)
    if summary["failed"] != 0:
        raise AssertionError(f"churn: {summary}")
    if not (summary["reprefills"] >= 1 and summary["reprefilled_stages"]
            == 2 * summary["reprefills"]):
        raise AssertionError(f"churn: re-prefill accounting {summary}")
    if any(c != 0 for c in r.kv.stage_counts()):
        raise AssertionError(f"churn: ledger not drained "
                             f"{r.kv.stage_counts()}")
    hit = [i for i, q in enumerate(reqs) if q.done_at == min(
        q2.done_at for q2 in reqs)]
    if not (toks[hit, :n_before] == ref[hit, :n_before]).all():
        raise AssertionError("churn: tokens before the kill differ")
    mism = np.argwhere(toks != ref)
    row = {"phase": "churn", "fail_at": fail_at,
           "tokens_checked_before_kill": n_before,
           "first_mismatch": (None if mism.size == 0
                              else [int(v) for v in mism[0]]),
           "summary": {k: summary[k] for k in
                       ("completed", "failed", "hop_failures", "reprefills",
                        "reprefilled_stages", "elapsed_s")},
           "ledger_counts": r.kv.stage_counts(), "wall_s": secs,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9}
    emit(row)
    del r
    free(torch)
    return row


# ------------------------------------------------------------ phases 6-8
TRAIN_SEQ, TRAIN_MB, TRAIN_GB, TRAIN_STEPS = 512, 2, 8, 3
STEP1_RTOL, LATER_ATOL = 1e-5, 1e-3
REBALANCE_PERIOD = 5.0           # virtual seconds, train_rebalance's Alg. 2


def swarm1b(wire_quant: bool = False):
    from repro_torch.configs import get_config
    return get_config("swarm-1b-bottleneck").with_overrides(
        wire_quant=wire_quant)


def train_opt():
    from repro_torch.optim import adamw
    return adamw(lr=1e-4)


def train_reference(torch, cfg, steps: int, device="cuda") -> list:
    """The staged reference's per-step losses from the same seed (the
    same stage params a ``SwarmRunner(seed=0)`` installs)."""
    from repro_torch.runtime import build_stage_programs
    from repro_torch.train.reference import reference_losses
    progs = build_stage_programs(cfg, 3, TRAIN_SEQ)
    losses = _counted(torch, lambda: reference_losses(
        cfg, progs, train_opt(), 0, steps, TRAIN_SEQ, TRAIN_MB, TRAIN_GB,
        device=device))
    del progs
    free(torch)
    return losses


def _kill_holder(runner, stage: int):
    """Sim process: once a peer of ``stage`` holds gradients of the
    current round and another peer of the stage is alive, preempt the
    holder (its gradients die with it and must be recomputed)."""
    from repro_torch.core.sim import Sleep
    while not runner.stopped:
        group = runner._covering(stage)
        held = {p.id: sum(1 for pid in runner.ledger.acc[stage].values()
                          if pid == p.id) for p in group}
        victim = max(group, key=lambda p: held[p.id], default=None)
        if len(group) > 1 and held[victim.id] > 0 and \
                not runner.ledger.complete():
            runner._fail_peer(victim)
            return
        yield Sleep(0.01)


def _exactly_once(runner) -> int:
    """Replay the runner's audit trail: a (round, stage, index) is never
    held twice and every barrier sees each stage hold exactly the
    round's microbatches.  Returns the number of barriers checked."""
    K = runner.scfg.global_batch // runner.scfg.microbatch_size
    held, barriers = set(), 0
    for kind, step, stage, idx, _attempt, pid in runner.ledger_log:
        key = (step, stage, idx)
        if kind == "acc":
            if key in held:
                raise AssertionError(f"double accumulation {key} ({pid})")
            held.add(key)
        elif kind == "rel":
            held.discard(key)
        else:
            barriers += 1
            for s in range(runner.n_stages):
                n = sum(1 for (t, sg, _i) in held if t == step and sg == s)
                if n != K:
                    raise AssertionError(f"step {step} stage {s}: {n} of "
                                         f"{K} microbatches")
    return barriers


def _strand_stage_1(runner, at_step: int):
    """Sim process: once stage 1's only peer holds gradients of the round
    after ``at_step``, preempt it and warm-join a replacement, which
    finds no donor (the stranded-stage path: restore or rollback)."""
    from repro_torch.core.sim import Sleep
    while not runner.stopped:
        if runner.step == at_step and runner.ledger.stage_counts()[1] > 0:
            runner._fail_peer(runner._covering(1)[0])
            yield from runner._join_new_peer(span=range(1, 2))
            return
        yield Sleep(0.01)


def slow_front(i: int):
    """Device profile of peer ``i`` (build order): the first two peers
    (stages 0 and 1) are T4s at 1/16 of the compute, the rest T4s."""
    import dataclasses
    from repro_torch.core.peer import T4
    if i < 2:
        return dataclasses.replace(T4, name="T4/16",
                                   flops_per_s=T4.flops_per_s / 16)
    return T4


def make_swarm(torch, cfg, steps: int, peers, profile_fn=None, **scfg):
    """A ``SwarmRunner`` of the training phases, built; ``scfg`` overrides
    its ``SwarmConfig`` fields and ``profile_fn`` its peers' device
    profiles (the virtual clock's compute and link speeds)."""
    from repro_torch.core.swarm import SwarmConfig, SwarmRunner
    kw = dict(n_stages=3, microbatch_size=TRAIN_MB, seq_len=TRAIN_SEQ,
              global_batch=TRAIN_GB, n_trainers=2, rebalance_period=0.0,
              codec="bottleneck", max_steps=steps)
    kw.update(scfg)
    extra = {} if profile_fn is None else {"profile_fn": profile_fn}
    runner = SwarmRunner(cfg, SwarmConfig(**kw), train_opt(), seed=0,
                         record_accumulation=True, device="cuda", **extra)
    runner.build(peers)
    return runner


def run_swarm(torch, cfg, steps: int, peers, kill: bool = False,
              setup=None, profile_fn=None, **scfg):
    """Train ``steps`` steps of ``SwarmRunner`` (counters zeroed just
    before; ``setup(runner)`` runs first); returns (metrics, runner,
    launches, wall seconds, peak GB)."""
    from repro_torch import kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runner = make_swarm(torch, cfg, steps, peers, profile_fn, **scfg)
    if kill:
        runner.sim.spawn(_kill_holder(runner, 1))
    if setup is not None:
        setup(runner)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.time()
    m = runner.run(until=1e9)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    return m, runner, launches, wall, \
        torch.cuda.max_memory_allocated() / 1e9


def _check_losses(name: str, got: list, want: list) -> float:
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} steps, want {len(want)}")
    if abs(got[0] - want[0]) > STEP1_RTOL * abs(want[0]):
        raise AssertionError(f"{name}: step 1 loss {got[0]} vs {want[0]}")
    diff = max(abs(a - b) for a, b in zip(got, want))
    if diff > LATER_ATOL:
        raise AssertionError(f"{name}: losses {got} vs {want}")
    return diff


def phase_train(torch, name: str, cfg, steps: int, want: list,
                peers=1, kill: bool = False, exact: bool = False,
                profile_fn=None, **scfg) -> dict:
    """``exact``: the losses must equal ``want`` to the bit."""
    m, runner, launches, wall, peak = run_swarm(
        torch, cfg, steps, peers, kill, profile_fn=profile_fn, **scfg)
    got = m["loss"]
    diff = _check_losses(name, got, want)
    if exact and got != want:
        raise AssertionError(f"{name}: losses {got} differ from {want}")
    if not all(math.isfinite(v) for v in got):
        raise AssertionError(f"{name}: non-finite losses {got}")
    must = ["flash_attention_fwd", "encode", "decode"]
    if cfg.wire_quant:
        must.append("qdq_flat")
    for k in must:
        if launches[k] <= 0:
            raise AssertionError(f"{name}: kernel {k} never launched")
    barriers = _exactly_once(runner)
    if barriers != steps or runner._inflight or any(
            runner.ledger.stage_counts()):
        raise AssertionError(f"{name}: ledger not drained "
                             f"({barriers} barriers, "
                             f"{runner.ledger.stage_counts()})")
    tokens = steps * TRAIN_GB * TRAIN_SEQ
    row = {"phase": name, "arch": cfg.name, "wire_quant": cfg.wire_quant,
           "steps": steps, "losses": got, "reference_losses": want,
           "max_abs_loss_diff": diff,
           "step1_rel_diff": abs(got[0] - want[0]) / abs(want[0]),
           "launches": launches, "wall_s": wall,
           "tokens_per_s": tokens / wall, "max_memory_allocated_gb": peak,
           "failures": m["failures"],
           "recomputed_microbatches": m["recomputed_microbatches"],
           "migrations": m["migrations"],
           "released_rows": sum(1 for e in runner.ledger_log
                                if e[0] == "rel"),
           "barriers_exactly_once": barriers,
           "virtual_s": runner._t_stopped,
           "peers_per_stage": [len(runner._covering(s))
                               for s in range(runner.n_stages)]}
    if kill and not (m["failures"] == 1
                     and m["recomputed_microbatches"] >= 1):
        raise AssertionError(f"{name}: no peer died mid-step: {row}")
    if scfg.get("rebalance_period", 0.0) > 0:
        row["rebalance_period"] = scfg["rebalance_period"]
        # a migration must land mid-round on a peer holding gradients:
        # its ledger rows are released and survivors recompute them
        if m["migrations"] < 1 or row["released_rows"] < 1 \
                or m["recomputed_microbatches"] < 1:
            raise AssertionError(f"{name}: no migration released held "
                                 f"gradients: {row}")
    emit(row)
    del runner, m
    free(torch)
    return row


def _cut_bytes(root: str, step: int) -> int:
    """Bytes on disk of checkpoint ``step`` over every stage dir."""
    total = 0
    for stage in sorted(os.listdir(root)):
        d = os.path.join(root, stage, f"step_{step:08d}")
        if os.path.isdir(d):
            total += sum(os.path.getsize(os.path.join(d, f))
                         for f in os.listdir(d))
    return total


def _mem_available() -> int:
    with open("/proc/meminfo") as f:
        for ln in f:
            if ln.startswith("MemAvailable:"):
                return int(ln.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def phase_train_rollback(torch, ref: list) -> dict:
    """Checkpoints every 2 steps, 4 steps: during step 4 stage 1's only
    peer dies and its replacement finds no donor, so the whole pipeline
    rolls back to the step-2 cut and replays steps 3 and 4; then a new
    runner cold-starts on the same directory (step 4) and trains step 5.
    Losses equal the staged reference's, bit for bit.  The directory is
    a fresh one under ``build/`` (gitignored), removed at the end."""
    import shutil
    import tempfile
    from repro_torch.models import flops as F
    cfg = swarm1b()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build")
    os.makedirs(root, exist_ok=True)
    # a cut: f32 params and AdamW's two f32 moments of the whole model
    cut = 12.0 * F.total_params(cfg)
    disk, host = shutil.disk_usage(root).free, _mem_available()
    emit({"phase": "train_rollback_resources", "cut_gb": cut / 1e9,
          "free_disk_gb": disk / 1e9, "mem_available_gb": host / 1e9})
    if disk < 2.2 * cut:          # keep=2 cuts on disk during a save
        raise RuntimeError(f"train_rollback: {disk / 1e9:.1f} GB free "
                           f"under {root}, need {2.2 * cut / 1e9:.1f}")
    if host < 0.8 * cut:          # one stage's snapshot and its copies
        raise RuntimeError(f"train_rollback: {host / 1e9:.1f} GB of host "
                           f"memory available, need {0.8 * cut / 1e9:.1f}")
    ckpt = tempfile.mkdtemp(prefix="ckpt_", dir=root)
    try:
        saves: list = []

        def setup(runner):
            save = runner._maybe_checkpoint

            def timed():
                t0 = time.time()
                save()
                if runner._common_ckpt_step() == runner.step:
                    saves.append({"step": runner.step,
                                  "seconds": time.time() - t0,
                                  "bytes": _cut_bytes(ckpt, runner.step)})
            runner._maybe_checkpoint = timed
            runner.sim.spawn(_strand_stage_1(runner, 3))

        m, runner, launches, wall, peak = run_swarm(
            torch, cfg, 4, 1, setup=setup, ckpt_dir=ckpt, ckpt_period=2)
        got = m["loss"]
        if m["rollbacks"] != [(3, 2)] or m["failures"] != 1 or \
                (1, 2) not in m["ckpt_restores"]:
            raise AssertionError(f"train_rollback: rollbacks "
                                 f"{m['rollbacks']}, restores "
                                 f"{m['ckpt_restores']}")
        if got != ref[:4]:
            raise AssertionError(f"train_rollback: losses {got} vs the "
                                 f"reference {ref[:4]}")
        if [sv["step"] for sv in saves] != [2, 4]:
            raise AssertionError(f"train_rollback: cuts saved {saves}")
        restores = m["ckpt_restores"]
        del runner, m
        free(torch)
        # cold start on the same directory: resumes at the step-4 cut
        from repro_torch.core.swarm import SwarmConfig, SwarmRunner
        torch.cuda.reset_peak_memory_stats()
        resumed = SwarmRunner(cfg, SwarmConfig(
            n_stages=3, microbatch_size=TRAIN_MB, seq_len=TRAIN_SEQ,
            global_batch=TRAIN_GB, n_trainers=2, rebalance_period=0.0,
            codec="bottleneck", max_steps=5, ckpt_dir=ckpt, ckpt_period=2),
            train_opt(), seed=0, device="cuda")
        if resumed.step != 4:
            raise AssertionError(f"cold start at step {resumed.step}")
        torch.cuda.synchronize()
        t0 = time.time()
        resumed.build(1)
        torch.cuda.synchronize()
        restore_s = time.time() - t0
        resumed_loss = resumed.run(until=1e9)["loss"]
        if resumed_loss != ref[4:5]:
            raise AssertionError(f"cold resume: loss {resumed_loss} vs the "
                                 f"reference {ref[4:5]}")
        row = {"phase": "train_rollback", "arch": cfg.name, "steps": 4,
               "ckpt_period": 2, "losses": got, "reference_losses": ref[:4],
               "rollbacks": [(3, 2)], "ckpt_restores": restores,
               "cold_resume": {"step": 4, "loss": resumed_loss,
                               "reference_loss": ref[4],
                               "restore_s": restore_s,
                               "restore_bytes": _cut_bytes(ckpt, 4),
                               "ckpt_restores":
                                   resumed.metrics["ckpt_restores"]},
               "saves": saves, "wall_s": wall, "launches": launches,
               "max_memory_allocated_gb": peak,
               "resume_max_memory_allocated_gb":
                   torch.cuda.max_memory_allocated() / 1e9}
        emit(row)
        del resumed
        free(torch)
        return row
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def phase_wire_codes(torch) -> dict:
    """The true wire format through the ops entry points a transport
    calls (no model path of either package calls them): a [2, 512, 4096]
    bf16 boundary state of swarm-1b-bottleneck is encoded to int8 codes
    + f32 scales with stage 0's step-0 ``w_c`` and decoded with stage
    1's ``w_d``, and the same state round-trips through the quant8 pair.
    Counters are zeroed just before.  Checks: the payload is the bytes
    the stage plan prices for ``wire_quant``, and the decoded state
    equals the fused QDQ wire's (encode with QDQ, then decode) bit for
    bit, as the quant8 round trip equals ``qdq_flat``."""
    from repro_torch import kernels
    from repro_torch.kernels.boundary import kernel as K
    from repro_torch.kernels.boundary import ops as bops
    from repro_torch.kernels.boundary import ref as R
    from repro_torch.kernels.quant8 import ops as q8
    from repro_torch.models.stage_plan import get_stage_plan
    from repro_torch.runtime import build_stage_programs, init_stage_params
    cfg = swarm1b()
    progs = build_stage_programs(cfg, 3, TRAIN_SEQ)
    params = init_stage_params(progs[:2], 0)
    w_c, w_d = params[0]["boundary"]["w_c"], params[1]["boundary"]["w_d"]
    qb = R.wire_qblock(w_c.shape[1])
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = (torch.randn(TRAIN_MB, TRAIN_SEQ, cfg.d_model, generator=gen,
                     device="cuda") * 3 + 1).to(torch.bfloat16)
    torch.cuda.synchronize()
    kernels.reset_launches()
    q, sc = bops.encode_quantize(x, w_c, "bottleneck", 1, qb)
    y = bops.dequantize_decode(q, sc, w_d, "bottleneck", qb,
                               torch.bfloat16)
    xq = q8.roundtrip(x, 64)
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in (
        "encode_quantize", "dequantize_decode", "quant8_quantize",
        "quant8_dequantize")}
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"wire_codes: kernel {k} never launched")
    payload = q.numel() + sc.numel() * 4
    priced = get_stage_plan(swarm1b(wire_quant=True), 3).boundary_bytes(
        0, TRAIN_MB, TRAIN_SEQ, "bottleneck")
    if payload != priced:
        raise AssertionError(f"wire_codes: payload {payload} B, priced "
                             f"{priced}")
    fused = _counted(torch, lambda: K.decode(
        K.encode(x, w_c, "bottleneck", 1, qb, True), w_d, "bottleneck"))
    if not torch.equal(y, fused):
        raise AssertionError(f"wire_codes: {int((y != fused).sum())} decoded"
                             " values differ from the fused QDQ wire's")
    if not torch.equal(xq, _counted(torch, lambda: K.qdq_flat(x, 64))):
        raise AssertionError("wire_codes: quant8 round trip != qdq_flat")
    if not bool(torch.isfinite(y).all()):
        raise AssertionError("wire_codes: non-finite decoded state")
    row = {"phase": "wire_codes", "arch": cfg.name,
           "shape": [TRAIN_MB, TRAIN_SEQ, cfg.d_model],
           "payload_bytes": payload, "bf16_bytes": x.numel() // 4 * 2,
           "launches": launches, "equal_to_fused_qdq_wire": True}
    emit(row)
    del progs, params
    free(torch)
    return row


def phase_train_profile(torch) -> dict:
    """Where a training microbatch's device time goes: one microbatch of
    swarm-1b-bottleneck (forward through the three stage programs, then
    the three recompute backwards, as the trainer runs it) under
    ``torch.profiler``, after a warm-up microbatch.  Device time is
    summed per kernel name and grouped; the host clock around the
    synchronised microbatch gives the device's idle share."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime import build_stage_programs, init_stage_params
    cfg = swarm1b()
    progs = build_stage_programs(cfg, 3, TRAIN_SEQ)
    params = init_stage_params(progs, 0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (TRAIN_MB, TRAIN_SEQ),
                        generator=gen, device="cuda")
    lab = torch.randint(0, cfg.vocab_size, (TRAIN_MB, TRAIN_SEQ),
                        generator=gen, device="cuda")

    def microbatch():
        x1 = progs[0].fwd(params[0], tok)
        x2 = progs[1].fwd(params[1], x1)
        _, gx, _ = progs[2].bwd(params[2], x2, lab)
        gx, _ = progs[1].bwd(params[1], x1, gx)
        progs[0].bwd(params[0], tok, gx)

    _counted(torch, microbatch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        _counted(torch, microbatch)
        torch.cuda.synchronize()
        wall = time.time() - t0
    per_kernel: dict = {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) is not None and \
                "CUDA" not in str(ev.device_type):
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + us / 1e3
    groups = {"flash_fwd (kernel)": "flash_fwd",
              "codec (kernels)": ("ln_rows_kernel", "gemm_kernel<",
                                  "codec_gemm_wgmma_kernel",
                                  "round_wt_kernel", "splitk_sum_kernel"),
              "matmul (library)": ("gemm", "nvjet", "Kernel2", "cutlass",
                                   "xmma", "sm90"),
              "elementwise and reductions": ""}
    grouped = {g: 0.0 for g in groups}
    for name, ms in per_kernel.items():
        for g, pat in groups.items():
            pats = (pat,) if isinstance(pat, str) else pat
            if any(p in name for p in pats):
                grouped[g] += ms
                break
    device_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    row = {"phase": "train_profile", "arch": cfg.name,
           "tokens": TRAIN_MB * TRAIN_SEQ, "wall_ms": wall * 1e3,
           "device_ms": device_ms,
           "device_idle_share": max(0.0, 1.0 - device_ms / (wall * 1e3)),
           "grouped_ms": grouped,
           "top_kernels_ms": [[k[:90], v] for k, v in top]}
    emit(row)
    del progs, params
    free(torch)
    return row


# -------------------------------------------------------------------- main
def main() -> None:
    import numpy as np
    if sys.argv[1:] not in ([], ["--kernels-only"]):
        sys.exit(f"usage: {sys.argv[0]} [--kernels-only]")
    torch = setup()
    from repro_torch import kernels
    t_start = time.time()
    phase_build(torch)
    main_rows = phase_kernels(torch)
    if sys.argv[1:]:
        emit({"phase": "done", "seconds": time.time() - t_start})
        return
    cfg, params = yi6b(torch)
    prompts = prompts_for(cfg)
    from repro_torch.serve import reference_generate
    # one reference call per session batch: the staged and single-process
    # programs then run the same ops at the same shapes, and equal tokens
    # hold the swarm path (a batch of 4 would take other GEMM kernels, and
    # bf16 argmax over random-weight logits flips on their rounding)
    ref = _counted(torch, lambda: np.concatenate([
        reference_generate(cfg, params, prompts[i:i + MAX_BATCH], NEW)
        for i in range(0, N_REQ, MAX_BATCH)]))
    # each kernel's count comes from the run of its path: flash and
    # rmsnorm from the plain-wire serve, the QDQ from the int8 wire
    launches = dict(phase_serve(torch, cfg, params, prompts, ref,
                                "none")["launches"])
    launches["qdq_flat"] = phase_serve(torch, cfg, params, prompts, ref,
                                       "int8")["launches"]["qdq_flat"]
    # a block a user may set (ServeConfig.quant_block): 256, which the
    # lane-group kernel takes on 32 lanes in bf16
    phase_serve(torch, cfg, params, prompts, ref, "int8", quant_block=256)
    phase_churn(torch, cfg, params, prompts, ref)
    del params, ref
    free(torch)
    # five reference steps: train holds the first three, train_rollback
    # four and its cold resume the fifth
    ref_losses = train_reference(torch, swarm1b(), 5)
    train = phase_train(torch, "train", swarm1b(), TRAIN_STEPS,
                        ref_losses[:TRAIN_STEPS])
    for k in ("encode", "decode"):
        launches[k] = train["launches"][k]
    ref_q = train_reference(torch, swarm1b(wire_quant=True), 2)
    phase_train(torch, "train_q", swarm1b(wire_quant=True), 2, ref_q)
    # the churn run is held to the fault-free train run's losses
    phase_train(torch, "train_churn", swarm1b(), TRAIN_STEPS,
                train["losses"], peers=[1, 2, 1], kill=True)
    # Alg. 2 on a heterogeneous swarm: stages 0 and 1 run on slower
    # devices (the T4 profile at 1/16 of its compute), stage 2 on two
    # T4s.  While stages 0 and 1 work through the backward passes,
    # stage 2 idles with gradients held, so the planner (every 5 virtual
    # seconds) moves one of its peers mid-round: the ledger releases
    # that peer's rows and a survivor recomputes them
    phase_train(torch, "train_rebalance", swarm1b(), TRAIN_STEPS,
                train["losses"], peers=[1, 1, 2], exact=True,
                profile_fn=slow_front, n_trainers=4,
                rebalance_period=REBALANCE_PERIOD)
    phase_train_rollback(torch, ref_losses)
    launches.update(phase_wire_codes(torch)["launches"])
    phase_train_profile(torch)
    replaces = {
        "flash_attention_fwd":
            ("src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:89"),
        "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm/kernel.py:27"),
        "qdq_flat": ("src/repro_torch/csrc/qdq.cu",
                     "src/repro/kernels/boundary/kernel.py:168"),
        "encode": ("src/repro_torch/csrc/codec.cu",
                   "src/repro/kernels/boundary/kernel.py:183"),
        "decode": ("src/repro_torch/csrc/codec.cu",
                   "src/repro/kernels/boundary/kernel.py:222"),
        "encode_quantize": ("src/repro_torch/csrc/codec.cu",
                            "src/repro/kernels/boundary/kernel.py:202"),
        "dequantize_decode": ("src/repro_torch/csrc/codec.cu",
                              "src/repro/kernels/boundary/kernel.py:233"),
        "quant8_quantize": ("src/repro_torch/csrc/quant8.cu",
                            "src/repro/kernels/quant8/kernel.py:38"),
        "quant8_dequantize": ("src/repro_torch/csrc/quant8.cu",
                              "src/repro/kernels/quant8/kernel.py:59"),
    }
    summary = []
    for name, (source, rep) in replaces.items():
        row = main_rows[name]
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": rep, "launches": launches[name],
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}})
    emit({"phase": "done", "seconds": time.time() - t_start})
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
