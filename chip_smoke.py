#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package.  Phases (each prints a
JSON line; any failure raises and exits non-zero):

1. build   — compile the CUDA kernels of ``src/repro_torch/csrc`` with
             nvcc; print the card's name and power limit.
2. kernels — each kernel against its plain PyTorch version on the card at
             the serving shapes, in bf16 and f32, with times (CUDA events)
             beside the plain version, the one-call PyTorch library
             equivalent where there is one, and the card's lower bound.
3. serve   — ``ServeRunner`` serving yi-6b at full width and depth
             (random weights from a seed) through one decode chain
             (0,2)->(2,4), tokens identical to the port's single-process
             reference, every kernel's launch counter above zero.
4. int8    — the same with the int8 boundary wire: one QDQ launch per
             span-edge crossing.
5. churn   — a spare (2,4) peer; the chain's (2,4) peer dies mid-decode;
             exactly-once KV recovery.

The next-to-last line is the ``{"kernels": [...]}`` summary, the last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch


# ------------------------------------------------------------------ timing
def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
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
def phase_build(torch) -> None:
    from repro_torch.kernels import _lib
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.time()
    path = _lib.build()
    secs = time.time() - t0
    ptxas = [ln.strip() for ln in _lib.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "library": os.path.relpath(path),
          "seconds": secs, "ptxas": ptxas[:24]})
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
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
    H, KV, D, B = 32, 4, 128, 2
    main = None
    for S in (512, 200):
        for dt, bound, peak in ((torch.bfloat16, 2e-2, H100_BF16_FLOPS),
                                (torch.float32, 1e-4, H100_F32_FLOPS)):
            q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dt)
            k = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dt)
            v = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dt)
            out, lse = _counted(torch, lambda: flash_attention_fwd(
                q, k, v, True, 0, None, 512, 1024, with_lse=True))
            torch.cuda.synchronize()
            ref, ref_lse = flash_fwd_ref(q, k, v, True, 0, 0, 512, 1024)
            err = float((out.float() - ref.float()).abs().max())
            lse_err = float((lse - ref_lse).abs().max())
            if not (err <= bound and lse_err <= 1e-4):
                raise AssertionError(f"flash S={S} {dt}: max err {err} "
                                     f"(bound {bound}), lse {lse_err}")
            ms = _counted(torch, lambda: time_ms(
                torch, lambda: flash_attention_fwd(q, k, v, True)))
            plain = time_ms(torch, lambda: flash_fwd_ref(
                q, k, v, True, 0, 0, 512, 1024), iters=5)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
            pairs = S * (S + 1) // 2                 # causal (q, k) pairs
            flops = 4.0 * D * pairs * B * H
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
            b_ms, b_by = bound_ms(nbytes, flops, peak)
            row = {"kernel": "flash_attention_fwd", "shape":
                   f"B={B} S={S} H={H} KV={KV} D={D}", "dtype": str(dt),
                   "max_abs_err": err, "lse_max_abs_err": lse_err,
                   "bound": bound, "ms": ms, "plain_ms": plain,
                   "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by}
            emit(row)
            rows.append(row)
            if S == 512 and dt == torch.bfloat16:
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
        plain = time_ms(torch, lambda: rmsnorm_ref(x, scale))
        w = scale.to(dt)
        lib = time_ms(torch, lambda: F.rms_norm(x, (d,), w, 1e-6))
        nbytes = 2 * x.numel() * x.element_size() + d * 4
        b_ms, b_by = bound_ms(nbytes, 4.0 * x.numel(), H100_F32_FLOPS)
        row = {"kernel": "rmsnorm", "shape": f"[{R}, {d}]", "dtype": str(dt),
               "max_abs_err": err, "max_ulps": ulps, "bound": "1 ulp",
               "ms": ms, "plain_ms": plain, "library_ms": lib,
               "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        rows.append(row)
        if dt == torch.bfloat16:
            main = row
    return main


def check_qdq(torch, gen, rows: list) -> dict:
    from repro_torch.compression import quant8
    from repro_torch.kernels.boundary.kernel import qdq_flat
    shape, block = (2, 512, 4096), 64
    main = None
    for dt in (torch.bfloat16, torch.float32):
        x = (torch.randn(*shape, generator=gen, device="cuda") * 5).to(dt)
        # exact .5 ties on the code grid: a block whose absmax is 127 makes
        # x/s*127 == x, so x = k + 0.5 rounds half to even
        x.view(-1)[:64] = torch.arange(64, device="cuda").to(dt) - 32.5
        x.view(-1)[63] = 127.0
        n = x.numel()
        codes = torch.empty(n, dtype=torch.int8, device="cuda")
        scales = torch.empty(-(-n // block), dtype=torch.float32,
                             device="cuda")
        out = _counted(torch, lambda: qdq_flat(x, block, codes, scales))
        torch.cuda.synchronize()
        q_ref, s_ref, meta = quant8.blockwise_quantize(x, block)
        ref = quant8.blockwise_dequantize(q_ref, s_ref, meta)
        if not torch.equal(codes, q_ref.reshape(-1)):
            bad = int((codes != q_ref.reshape(-1)).sum())
            raise AssertionError(f"qdq {dt}: {bad} int8 codes differ")
        if not torch.equal(scales, s_ref.reshape(-1)):
            raise AssertionError(f"qdq {dt}: block scales differ")
        err = float((out.float() - ref.float()).abs().max())
        if err != 0.0:
            raise AssertionError(f"qdq {dt}: outputs differ by {err}")
        ms = _counted(torch, lambda: time_ms(
            torch, lambda: qdq_flat(x, block)))
        plain = time_ms(torch, lambda: quant8._roundtrip(x, block))
        nbytes = 2 * n * x.element_size()
        b_ms, b_by = bound_ms(nbytes, 5.0 * n, H100_F32_FLOPS)
        row = {"kernel": "qdq_flat", "shape": str(list(shape)),
               "dtype": str(dt), "max_abs_err": err, "codes_identical": True,
               "bound": "codes identical", "ms": ms, "plain_ms": plain,
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        rows.append(row)
        if dt == torch.bfloat16:
            main = row
    return main


def phase_kernels(torch) -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows: list = []
    return {"flash_attention_fwd": check_flash(torch, gen, rows),
            "rmsnorm": check_rmsnorm(torch, gen, rows),
            "qdq_flat": check_qdq(torch, gen, rows)}


# ------------------------------------------------------------ phases 3-5
N_REQ, PROMPT, NEW = 4, 512, 16
MAX_BATCH = 2           # requests per session slot


def yi6b(torch):
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.models import params as P
    cfg = get_config("yi-6b").with_overrides(kernels="pallas")
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


def make_runner(torch, cfg, params, codec: str, spare: bool):
    from repro_torch.serve import ServeConfig, ServeRunner
    r = ServeRunner(cfg, ServeConfig(n_stages=4, max_batch=MAX_BATCH,
                                     max_sessions=1 if spare else 2,
                                     codec=codec),
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


def chain_rates(torch, r, prompts) -> dict:
    """Prefill and decode rates of the chain's programs alone, for one
    batch of max_batch prompts, wire codec as the runner's."""
    B = r.scfg.max_batch
    _, t_pre, t_dec = chain_generate(torch, r, prompts[:B],
                                     r.decode_peers[0].executor.wire_fwd)
    return {"prefill_tokens_per_s": B * PROMPT / t_pre,
            "prefill_s": t_pre,
            "decode_ms_per_token": t_dec / (NEW - 1) * 1e3,
            "decode_batch": B}


def free(torch) -> None:
    """Return what the caller has just dropped (``del``) to the card:
    runners hold reference cycles (peers, executors, sim processes)."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve(torch, cfg, params, prompts, ref, codec: str) -> dict:
    import numpy as np
    from repro_torch import kernels
    from repro_torch.compression import quant8
    from repro_torch.models.stage_plan import get_stage_plan
    torch.cuda.reset_peak_memory_stats()
    r = make_runner(torch, cfg, params, codec, spare=False)
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
                           lambda w: _roundtrip(w, quant8.BLOCK))[0]
            for i in range(0, N_REQ, B)])
    if not (toks == ref).all():
        raise AssertionError(
            f"{codec}: staged tokens differ from the reference first at "
            f"(request, token) {np.argwhere(toks != ref)[0].tolist()}")
    if summary["failed"] or summary["completed"] != N_REQ:
        raise AssertionError(f"{codec}: {summary}")
    for name, n in launches.items():
        if name == "qdq_flat" and codec == "none":
            continue
        if n <= 0:
            raise AssertionError(f"{codec}: kernel {name} never launched")
    sessions = N_REQ // r.scfg.max_batch
    crossings = sessions * NEW          # prefill + NEW-1 decode hops
    B = r.scfg.max_batch
    row = {"phase": "serve" if codec == "none" else "int8",
           "codec": codec, "tokens_identical": True,
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
        plan = get_stage_plan(cfg, 4)
        packed = sessions * (quant8.compressed_nbytes(B * PROMPT * d)
                             + (NEW - 1) * quant8.compressed_nbytes(B * d))
        priced = sessions * (plan.boundary_bytes(1, B, PROMPT, "int8")
                             + (NEW - 1) * plan.boundary_bytes(1, B, 1,
                                                               "int8"))
        if packed != priced:
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


# -------------------------------------------------------------------- main
def main() -> None:
    import numpy as np
    torch = setup()
    from repro_torch import kernels
    t_start = time.time()
    phase_build(torch)
    main_rows = phase_kernels(torch)
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
    phase_churn(torch, cfg, params, prompts, ref)
    del params, ref
    free(torch)
    replaces = {
        "flash_attention_fwd":
            ("src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:89"),
        "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm/kernel.py:27"),
        "qdq_flat": ("src/repro_torch/csrc/qdq.cu",
                     "src/repro/kernels/boundary/kernel.py:168"),
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
