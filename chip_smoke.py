#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package.  Phases (each prints a
JSON line; any failure raises and exits non-zero):

1. build   — compile the CUDA kernels of ``src/repro_torch/csrc`` with
             nvcc; where ``cuobjdump`` exists, count the tensor-core
             instructions of the bf16 flash forward (HMMA, at every
             head-dim pair) and codec GEMM (HGMMA), and the 16-byte
             global loads (LDG.E.128) of every instantiation of the
             codec's row passes, qdq and rmsnorm's register path;
             ptxas's registers of every flash instantiation and of every
             rmsnorm register-path instantiation, none spilling; print the
             card's name and power limit.
2. kernels — each kernel against its plain PyTorch version on the card at
             the shapes of its paths (serving for qdq; the serving
             prefill of yi-6b and of every family that runs attention
             or RMSNorm, their shapes taken from the registered
             configs, hymba-1.5b's included, for rmsnorm and for flash
             with its ``lse``, flash also at training's shape and at
             whisper-large-v3's bidirectional encoder and cross-attention
             shapes, and timed beside SDPA; rmsnorm also at each config's
             decode row and on two rows of its general path, each row's
             path checked and every row timed beside ``F.rms_norm``;
             training
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
6. serve_families — ``ServeRunner`` serving the families at full width
             with random weights from a seed, yi-6b's requests, one
             decode chain each, tokens identical to the single-process
             reference: gemma-2b (6 of 18 layers, 3 stages), qwen1.5-4b
             (8 of 40), h2o-danube-3-4b (8 of 24; also one 4,608-token
             prompt past its 4,096-token window at batch 1), qwen2-vl-2b
             (8 of 28, M-RoPE), hymba-1.5b (32, attention beside mamba
             heads; also the
             4,608-token prompt past its 2,048-token window), each over
             4 stages; xlstm-125m (12 mLSTM / sLSTM layers, 2 stages);
             llama4-scout (4 of 48 layers, 4 stages) and deepseek-v2 (2
             of 60, 2 stages; also on the int8 wire) cut in depth to fit
             the card.  Flash and rmsnorm launch in each that runs them;
             prefill and decode times (the median of three), peak
             memory.  xlstm-125m and hymba-1.5b also run ``churn``
             (``churn_families``): the re-prefill at 512 + k tokens, no
             multiple of the chunk; the carry the spare installed, read
             from its slot, held layer by layer to the probe peer's at
             the same position, and the span's next logits to the
             probe's, in bf16 and an f32 twin; each bound shown to
             reject a carry one step stale planted through the runner,
             a one-ulp witness reported beside them.
6b. serve_whisper — whisper-large-v3 at full width and depth (32
             encoder and 32 decoder layers, f32 weights from a seed)
             through ``make_prefill_step`` / ``make_serve_step``: 2
             requests of 1,500 audio frames, a 224-token prompt, 32
             greedy tokens; 96 flash launches a prefill (encoder self,
             decoder self and cross-attention a layer), none a decode
             step, no plain flash call; every decode step's logits
             against the no-cache recompute, bounded in an f32 twin at 2
             decoder layers and shown to reject a swapped cross K/V and
             a zeroed self-KV row, bf16 and full depth reported; prefill
             and decode times (the median of three), peak memory.
6c. train_whisper — ``SwarmRunner`` on whisper-large-v3, 3 stages (the
             encoder pod, 2 decoder stages of 16 layers), seq 448,
             microbatch 2, global batch 8, adamw, 3 steps: losses against
             the staged reference, 768 flash launches a step; then a
             second stage-1 peer killed mid-step and a warm join, losses
             equal to the bit, exactly once; then the int8 wire, one QDQ
             launch per float leaf of each boundary tree crossed.
6d. train_single — the one-process training step through
             ``python -m repro_torch.launch.train``'s entry point:
             qwen2-vl-2b at full width and depth (28 layers, 1.54 B f32
             parameters, tied embeddings, M-RoPE), seq 512, global batch
             8, ``--accum 4``: four steps, finite losses, flash and
             rmsnorm launches a step per remat mode against their
             reckoning, no plain flash call, tokens/s and peak memory;
             ``none``, ``block`` and ``2level`` two steps each, losses
             and params equal to the bit; cut to 4 layers, a run cut
             after step 2 and resumed from its checkpoint equal to the
             uninterrupted run to the bit; ``--accum 1`` against ``--accum 4``: step 1
             within 1e-6, step 2 reported beside an ``--accum 2``
             witness, both steps within 1e-6 / 1e-4 in an f32 twin at 2
             layers; then swarm-1b (3 groups x 16 applications) through
             ``make_train_step`` against the staged reference on the same
             params and microbatches, ``train``'s bounds with every
             wq / wk scaled by 0.3, reported at JAX's init, the step-1
             gradients' gap, both tokens/s.
7. train   — ``SwarmRunner`` training swarm-1b-bottleneck at full width
             and depth (48 layer applications, random weights from a
             seed), 3 stages, one peer each, seq 512, microbatch 2, global
             batch 8, adamw, 3 steps; per-step losses against the staged
             reference (``repro_torch.train.reference``) on the same card
             and weights; wall-clock tokens/s, peak memory, launches of
             flash, encode and decode.
8. train_q — the same with ``wire_quant=True`` for 2 steps: the encode
             kernel's fused QDQ and the cotangent ``qdq_flat`` launch.
9. train_churn — a second stage-1 peer; one stage-1 peer dies mid-step;
             each (stage, microbatch) admitted exactly once, the ledger
             drained, losses equal to the fault-free ``train`` losses.
10. train_rebalance — peers [1, 1, 2], stages 0 and 1 on a T4 profile
             at 1/16 of its compute (``slow_front``), four trainers,
             Alg. 2 every 5.0 virtual seconds: a stage-2 peer migrates
             while it holds gradients, its ledger rows are released and
             recomputed; every (stage, microbatch) admitted once per
             round, losses equal to ``train``'s to the bit.
11. train_span — swarm-1b-span (swarm-1b-bottleneck's shapes and
             weights): one span peer on stages [0, 2)
             (``PipelineExecutor``, the two stages fused in one program)
             and one peer on stage 2; losses equal to ``train``'s to the
             bit, the span peer accumulating under both of its stages,
             exactly once; host wire bytes beside ``train``'s (one
             boundary of two is fused).
12. train_span_resize — the same layout with every peer on the T4/16
             profile; mid-step 1 the span splits at stage 1 (a fresh
             peer warm-joins [1, 2), downloading stage 1 from the span
             peer, which then shrinks to [0, 1)), mid-step 2 it merges
             back to [0, 2), and the [1, 2) peer dies: two span
             changes, one join, one failure, losses equal to ``train``'s
             to the bit, exactly once.
13. train_span_rebalance — ``spans=True``, Alg. 2 every 5.0 virtual
             seconds, the WAN link table pricing
             boundaries by the regions of four zones: single peers on
             stages 0, 1, 2 (stage 1's on T4/16, the others T4s) and an
             A100 span peer on [0, 2); Alg. 2's span branch shrinks the
             span peer onto stage 1, the layout still routes, losses
             equal to ``train``'s to the bit, exactly once.
13b. train_mesh — mesh-backed peers (``MeshExecutor``,
             ``MeshSpanExecutor``) in ``train``'s layout: stage 1's peer
             on a one-device mesh (``make_peer_mesh(1)``), losses equal
             to ``train``'s to the bit; then 2-way virtual meshes of the
             card (the microbatch split 1 + 1, params FSDP-placed) beside
             a numeric peer at every stage and a mesh span peer on [0,
             2): a mesh peer killed mid-step and revived, the span peer
             moved to [1, 3), both still mesh-backed, exactly once,
             losses against the staged reference (step 1 within 1e-5,
             later steps reported under a 5e-2 gross-error bound), the
             mesh code held in an f32 twin at 2 applications a group and
             wq / wk x 0.3 (equal within 1e-6 to the numeric programs
             run on the same halves; the split against the whole
             microbatch reported); then one int8-wire step with a 2-way mesh peer on
             stage 1, two QDQ launches of its own a microbatch.  Launches
             made inside the mesh executors are counted apart (flash,
             encode, decode above zero); no plain flash or codec call.
13b'. train_mesh_tp — tensor-parallel compute over the ``model`` axis
             of virtual ("data", "model") meshes of the card: swarm-1b-
             bottleneck in ``train``'s layout, stage 1 held by a mesh
             peer on (1, 2) and a span peer on [0, 2) over (2, 2), 2
             steps, losses against the staged reference
             (``MESH_BOUNDS``), and an f32 twin of the three stages at 2
             applications a group against one-device mesh peers within
             1e-5 of each leaf's largest entry; yi-6b at full width, one
             layer a stage over 3 stages (reduced from 32 layers), on
             (1, 8): one microbatch's forward and backward, f32 bounded
             so, bf16 reported.  The path each peer ran; flash (and
             rmsnorm for yi-6b) launched on every model shard; no plain
             flash or codec call; each coordinate's gathered parameter
             bytes equal to the reckoned block bytes; the layers'
             all-reduces against the plan (two a layer forward).
13c. train_pipeline — ``make_pipeline_train_step`` at full width and
             depth over a (``pod`` S, ``data`` 1) virtual mesh of the
             card, 8 microbatches of 1 x 512 a step, AdamW, 2 steps:
             swarm-1b-bottleneck over 3 stages (its learned codec on the
             wire), then one step on the int8 wire; qwen2-vl-2b over 4
             stages on the int8 wire with vision-language M-RoPE
             positions.  Launches a step against ``pipe_reckoning`` (T =
             M + S - 1 ticks, each live slot run and recomputed), no
             plain call, tokens/s, peak memory; loss and gradients
             against ``make_reference_loss_fn`` on the same params and
             batch, reported in bf16 at full depth and bounded (1e-5 /
             1e-4) in f32 twins at wq / wk x 0.3 (swarm-1b at 2
             applications a group, qwen2-vl-2b at one layer a stage).
13d. train_mesh_moe — llama4-scout-17b-a16e at full width (d 5120, 16
             experts x 8192, 40 / 8 heads of 128, bf16), one layer a
             stage over 2 stages: each stage as ``MeshExecutor`` s on
             ``[cuda:0] x 2`` (a microbatch of 2 x 512 split 1 + 1, the
             MoE layers in lockstep), expert-parallel on ("data",
             "model") (1, 2) and (2, 2), and on one device, from the
             same weights and inputs.  Per layer every split's routes
             equal the whole-microbatch routing of the same router
             inputs exactly; route and kept flips against the one-device
             run and the pairs the shards' own capacity would have kept
             or dropped otherwise (above zero: the check bites) are
             reported; the bf16 losses within 2e-2, the gradients' gap
             per leaf reported, peak memory per backward beside its meta
             reckoning, tokens/s; on the expert-parallel meshes each
             coordinate's gathered bytes equal to the reckoned blocks,
             flash and rmsnorm launches and flash's head dims on every
             coordinate against the plan, no plain flash call, the MoE
             collectives (router gather, rows back, shared expert) and
             the rest against the plan; an f32 twin of the MoE layer
             alone, split against unsplit, within 1e-5 of each leaf's
             largest entry, and one of the last stage expert-parallel
             against one device (loss 1e-5, gradients 1e-2).  Then the
             same for deepseek-v2-236b at full width (128 heads of (192,
             128), 160 experts x 1536 top-6, 2 shared), one mla_moe
             layer a stage, tensor-parallel over (1, 2) and (2, 2) (MLA
             by heads, flash at (64, 192, 128) on every coordinate), and
             an f32 twin of its mla kind's last stage.  On (2, 2) the
             expert stacks hold their data slice and each expert's
             slots are computed once per microbatch (buffers
             [E / 2, C, d / 2] by coordinate and the exchanges over
             data against the plan); llama4-scout runs once more on
             (2, 2) with the weights replicated over data (no FSDP):
             there each data shard holds the stacks whole and the
             shards run in lockstep under their split contexts, checked
             the same way against one device.
13e. train_pipeline_moe — ``make_pipeline_train_step``'s loss and
             gradients for the same config over (``pod`` 2, ``data`` 2)
             of the card, 2 microbatches of 2 x 512 each split 1 + 1,
             against ``make_reference_loss_fn``: the loss within 2e-2,
             the gradients' gap reported; flash, rmsnorm and the int8
             wire's QDQ launch.
14. train_overlap — ``train``'s setup under the async tick
             (``overlap=True, staleness=0``): boundary tensors in flight
             on the peers' links, stage programs through the executors'
             dispatch/collect pair; losses equal to ``train``'s to the
             bit, in-flight bytes and a hidden wire fraction above zero,
             the virtual makespan no longer than ``train``'s.
15. train_async — the same with ``staleness=1``: delayed parameter
             updates behind the bounded-staleness barrier; losses
             against the staged reference driven by
             ``delayed_parameter_updates(adamw, 1)`` under ``train``'s
             bounds.
16. train_async_churn — ``train_churn``'s layout and kill under the
             async tick: losses equal to ``train_async``'s to the bit,
             exactly once.
17. serve_shared — ``ServeRunner`` serving swarm-1b (three shared
             groups, each applied 16 times) at full width and depth over
             3 stages, one decode chain (0,2)->(2,3): tokens identical to
             the single-process reference; then with the int8 wire, one
             QDQ launch per span-edge crossing.
18. serve_codec — swarm-1b-bottleneck session programs (the learned
             codec at both stage edges) over (0,2)+(2,3) against one
             (0,3) program, token for token, two encode and two decode
             launches a prefill and a decode step; every stage's decode
             steps against its no-cache recompute at two applications
             per group, bounded in bf16 (the served path) and in an f32
             twin, each bound shown to see two planted cache faults;
             reported in bf16 at full depth, beside the f32 rounding
             spread of the full depth's logits.
19. train_rollback — swarm-1b-bottleneck's three shared groups applied
             twice each (6 of 48 layers; the cuts keep their full
             size); checkpoints every 2 steps under ``build/``; stage
             1's only peer dies during step 4 and its replacement finds
             no donor: global rollback to the step-2 cut and replay; a
             new runner cold-starts on the directory and trains step 5.
             Losses equal to its staged reference's to the bit; bytes and
             seconds per save and for the resume's restore.  Fails early
             when the disk or the host memory is short of two cuts.
20. wire_codes — the true wire format (int8 codes + f32 scales) through
             the ops entry points of ``encode_quantize`` /
             ``dequantize_decode`` and the quant8 pair, on swarm-1b's
             boundary: the priced payload, and the decoded state equal
             to the fused QDQ wire's to the bit.
21. train_profile — one training microbatch under ``torch.profiler``:
             device time per kernel, grouped, and the device's idle
             share.
21b. examples — ``repro_torch.examples`` on the card: quickstart (the
             loss falls through a preemption), serve_pipeline on yi-6b's
             reduced config (heads widened to 64 for the flash kernel)
             with tokens equal to ``reference_generate``'s, and
             train_swarm_lm at ``--model 100m --steps 12`` (Fig. 4):
             parity ``OK``, both curves falling, f32 flash and the int8
             wire's QDQ launching; the JAX example's optimizer (a clip
             of 1.0) reported beside it.
22. dryrun — the dry run (``repro_torch.launch.dryrun``) against the
             card: yi-6b's attn layer at the train shape (forward and
             backward), swarm-1b-bottleneck's boundary (encode, decode)
             and swarm-1b's int8 wire, each once on meta under the dry
             run's ledger and once on the card: launches equal to the
             meta calls kernel for kernel, the meta peak and the ledger
             on the card's call against the allocator's peak within 5 %
             + 64 MiB; then the pipeline cell yi-6b train_4k on the
             multi-pod mesh, its record's memory, FLOPs and collectives
             (a reckoning on meta), computed by a background process
             that the script starts first (``start_dryrun_cell``).

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
import zlib

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
RMSNORM_ROWS = "rmsnorm_rows_kernel"
# rmsnorm's register path: NV 1-8 vectors a lane at 4 warps a row, 5-8 at
# 8 warps (kernels/rmsnorm/kernel.py::_plan), in two dtypes
RMSNORM_INSTANTIATIONS = 2 * (8 + 4)
VECTOR_KERNELS = ("ln_rows_kernel", "dequant_rows_kernel", "blockq_vec_kernel",
                  "blockdq_vec_kernel", RMSNORM_ROWS)
# instantiations of the vector kernels: ln_rows 2 dtypes x 4 x 5, its
# dequant pass 2 x 7; blockq.cuh's lane-group quantize 2 x 6 lane counts
# x 3 (qdq with and without codes, quant8's codes alone) and its
# dequantize, one a dtype; rmsnorm's register path
VECTOR_INSTANTIATIONS = (2 * (4 * 5 + 7) + 2 * 6 * 3 + 2
                         + RMSNORM_INSTANTIATIONS)
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
    import re
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
                        m = re.search(k + r"ILi(\d+)ELi(\d+)E", name)
                        cur = f"{k}<{m.group(1)},{m.group(2)}>"
                    counts[cur] = dict.fromkeys(ops, 0)
                    break
        elif cur is not None:
            op = next((o for o in ops if o in ln), None)
            if op is not None:
                counts[cur][op] += 1
    return counts


def _ptxas(log: str, key) -> dict:
    """ptxas's registers and spill bytes from the build log, per kernel
    instantiation ``key(mangled name)`` (None: not wanted)."""
    import re
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\S+?)'?(?: for|$)", ln)
        if m:
            cur = key(m.group(1))
            if cur is not None:
                out.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out[cur]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


def flash_ptxas(log: str) -> dict:
    """Per flash instantiation (``kernel<Dqk,Dv>`` of the bf16 kernel,
    ``kernel<dtype,Dqk,Dv>`` of the SIMT one), ptxas's registers and
    spill bytes."""
    import re

    def key(name):
        f = re.search(r"(flash_fwd_mma_kernel|flash_fwd_kernel)I"
                      r"(f|13__nv_bfloat16)?L?i?(\d+)ELi(\d+)E", name)
        if f is None:
            return None
        dt = {"f": "f32,", "13__nv_bfloat16": "bf16,"}.get(f.group(2), "")
        return f"{f.group(1)}<{dt}{f.group(3)},{f.group(4)}>"
    return _ptxas(log, key)


def rmsnorm_ptxas(log: str) -> dict:
    """Per instantiation ``rmsnorm_rows_kernel<dtype,NV,W>`` of the
    register path, ptxas's registers and spill bytes."""
    return _ptxas(log, lambda name: _instantiation(name, RMSNORM_ROWS)
                  if RMSNORM_ROWS in name else None)


def phase_build(torch) -> None:
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.time()
    path = _lib.build()
    secs = time.time() - t0
    ptxas = [ln.strip() for ln in _lib.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln]
    sass = sass_counts(path)
    flash = flash_ptxas(_lib.BUILD_LOG)
    rms = rmsnorm_ptxas(_lib.BUILD_LOG)
    emit({"phase": "build", "library": os.path.relpath(path),
          "seconds": secs, "ptxas": ptxas[:24], "flash_ptxas": flash,
          "rmsnorm_ptxas": rms, "sass": sass})
    # every head-dim pair of both flash kernels built, and every
    # instantiation of rmsnorm's register path, none spilling
    if len(flash) != 2 * len(HEAD_DIMS) or any(
            v.get("spill_bytes", 1) for v in flash.values()):
        raise AssertionError(f"flash instantiations or spills: {flash}")
    if len(rms) < RMSNORM_INSTANTIATIONS or any(
            v.get("spill_bytes", 1) for v in rms.values()):
        raise AssertionError(f"rmsnorm instantiations or spills: {rms}")
    if sass is not None:
        want = {f"flash_fwd_mma_kernel<{a},{b}>" for a, b in HEAD_DIMS}
        want.add("codec_gemm_wgmma_kernel")
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


# The families served at full width (ROADMAP queue 1 items 6a and 6b):
# (name, layers served (None: the full depth), n_stages, chain split).
# The two MoE models fit the card only at a cut depth: llama4-scout's 48
# layers are 211 GB of bf16 weights, deepseek-v2's 60 are 470 GB.  The
# four dense attention families are cut to two layers a stage to keep the
# script inside its time limit: their serving is host-bound, so its time
# grows with the layers, while the check (tokens equal to the
# single-process model's) reads the same code at any depth; yi-6b is
# served at its full 32 layers, and the recurrent families stay whole,
# their carries' bounds being set at full depth.
FAMILY_SERVING = (
    ("gemma-2b", 6, 3, 2),
    ("qwen1.5-4b", 8, 4, 2),
    ("h2o-danube-3-4b", 8, 4, 2),
    ("qwen2-vl-2b", 8, 4, 2),
    ("llama4-scout-17b-a16e", 4, 4, 2),
    ("deepseek-v2-236b", 2, 2, 1),
    ("xlstm-125m", None, 2, 1),
    ("hymba-1.5b", None, 4, 2),
)
# past the windows of h2o-danube-3 (4096 tokens) and hymba-1.5b (2048)
LONG_PROMPT = 4608


def family_config(name: str, n_layers):
    """The registered config, its depth cut to ``n_layers`` (None: kept);
    widths untouched."""
    from repro_torch.configs import get_config
    cfg = get_config(name)
    if n_layers is None:
        return cfg
    kw = {"n_layers": n_layers}
    if cfg.block_pattern is not None:
        kw["block_pattern"] = cfg.block_pattern[:n_layers]
    return cfg.with_overrides(**kw)


def _head_dims(cfg) -> list:
    """The flash kernel's (Dqk, Dv) pair on the config's prefill."""
    if cfg.mla is not None:
        return [cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim,
                cfg.mla.v_head_dim]
    return [cfg.hd, cfg.hd]


def _long_prompt(cfg) -> bool:
    """Whether the config also serves ``LONG_PROMPT``: past its window."""
    return 0 < cfg.sliding_window < LONG_PROMPT


def _has_attention(cfg) -> bool:
    """Whether the config's layers run attention (the flash forward): a
    block kind whose specs hold an attention subtree (``attn``, ``mla``
    or any other key naming attention)."""
    from repro_torch.models.blocks import REGISTRY
    return any(key == "mla" or "attn" in key
               for kind in set(cfg.block_kinds)
               for key in REGISTRY[kind][0](cfg))


def flash_shapes() -> list:
    """The flash forward's shapes on the card's paths, as (arch, path, B,
    Sq, Sk, H, KV, Dqk, Dv, window, causal): yi-6b's serving GQA (prompt
    512 and a ragged 200), swarm-1b's training MHA, the prefill of each
    family that runs attention at the serving batch and prompt with the
    head counts, head dims and window of its registered config (MLA's
    keys expanded to every head), past the window at ``LONG_PROMPT``
    where it serves that, and whisper-large-v3's three attentions
    (``whisper_shapes``)."""
    shapes = [("yi-6b", "serve", 2, 512, 512, 32, 4, 128, 128, 0, True),
              ("yi-6b", "serve", 2, 200, 200, 32, 4, 128, 128, 0, True),
              ("swarm-1b", "train", 2, 512, 512, 32, 32, 128, 128, 0,
               True)]
    for name, _, _, _ in FAMILY_SERVING:
        cfg = family_config(name, None)
        if not _has_attention(cfg):
            continue
        kv = cfg.n_heads if cfg.mla is not None else cfg.n_kv_heads
        heads = (cfg.n_heads, kv, *_head_dims(cfg), cfg.sliding_window,
                 True)
        shapes.append((name, "serve_families", MAX_BATCH, PROMPT, PROMPT)
                      + heads)
        if _long_prompt(cfg):
            shapes.append((name, "serve_families", 1, LONG_PROMPT,
                           LONG_PROMPT) + heads)
    return shapes + whisper_shapes()


def whisper_shapes() -> list:
    """whisper-large-v3's flash calls (``flash_shapes``' rows) at batch
    2: the encoder's bidirectional self-attention over its 1,500
    frames, the decoder's causal self-attention and its cross-attention
    (queries against the frames, offset 0) at the serving prompt
    (``WHISPER_PROMPT``) and the training length (``WHISPER_SEQ``)."""
    from repro_torch.configs import get_config
    cfg = get_config("whisper-large-v3")
    F, H, D = cfg.encoder_max_len, cfg.n_heads, cfg.hd
    row = lambda path, Sq, Sk, causal: (  # noqa: E731
        "whisper-large-v3", path, WHISPER_BATCH, Sq, Sk, H, H, D, D, 0,
        causal)
    return [row("serve_whisper train_whisper", F, F, False),
            row("serve_whisper", WHISPER_PROMPT, WHISPER_PROMPT, True),
            row("serve_whisper", WHISPER_PROMPT, F, False),
            row("train_whisper", WHISPER_SEQ, WHISPER_SEQ, True),
            row("train_whisper", WHISPER_SEQ, F, False)]


def _sdpa_backend(torch, fn) -> str:
    """Which of SDPA's backends ``fn`` ran, read off its kernels' names."""
    names = " ".join(_profiled(torch, fn, 1)).lower()
    for key, backend in (("cudnn", "cudnn"), ("flash", "flash"),
                         ("fmha", "efficient"), ("efficient", "efficient"),
                         ("mem_eff", "efficient")):
        if key in names:
            return backend
    return "math"


def check_flash(torch, gen, rows: list) -> dict:
    """The flash forward with its ``lse`` output against the plain
    version at every shape of ``flash_shapes`` (the training path's
    backward reuses ``lse``), in bf16 and f32, at Dqk ** -0.5 (MLA's
    explicit scale is that of its concatenated dims), causal or
    bidirectional as the path calls it (the plain version at the
    kernel's query offset Sk - Sq, which no bidirectional mask reads).  Each call also
    runs again (output and ``lse`` bit-equal: deterministic) and on each
    batch row alone (equal to that row of the batch call: a row's result
    does not depend on the rest of the grid).  Timed beside the bound,
    the plain version and SDPA with the same mask and scale (a boolean
    mask where the window is shorter than the sequence), naming the
    backend SDPA took; f32, which no model path runs, with 3 calls a
    time.  Returns yi-6b's prompt-512 bf16 row."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
    main = None
    for arch, path, B, Sq, Sk, H, KV, D, Dv, win, causal in flash_shapes():
        sc = D ** -0.5
        for dt, bound, peak, iters in (
                (torch.bfloat16, 2e-2, H100_BF16_FLOPS, 20),
                (torch.float32, 1e-4, H100_F32_FLOPS, 3)):
            q = torch.randn(B, Sq, H, D, generator=gen,
                            device="cuda").to(dt)
            k = torch.randn(B, Sk, KV, D, generator=gen,
                            device="cuda").to(dt)
            v = torch.randn(B, Sk, KV, Dv, generator=gen,
                            device="cuda").to(dt)
            call = lambda: flash_attention_fwd(q, k, v, causal, win, sc,
                                               with_lse=True)
            out, lse = _counted(torch, call)
            torch.cuda.synchronize()
            with plain_precision(torch):
                ref, ref_lse = flash_fwd_ref(q, k, v, causal, win, Sk - Sq,
                                             512, 1024, sc)
            err = float((out.float() - ref.float()).abs().max())
            lse_err = float((lse - ref_lse).abs().max())
            tag = (f"flash {arch} {path} B={B} Sq={Sq} Sk={Sk} H={H} "
                   f"KV={KV} D={D}/{Dv} window={win} causal={causal} {dt}")
            if not (err <= bound and lse_err <= 1e-4):
                raise AssertionError(f"{tag}: max err {err} (bound {bound})"
                                     f", lse {lse_err} (bound 1e-4)")
            again = _counted(torch, call)
            if not (torch.equal(again[0], out) and torch.equal(again[1], lse)):
                raise AssertionError(f"{tag}: two calls differ")
            for b in range(B if B > 1 else 0):
                one = _counted(torch, lambda: flash_attention_fwd(
                    q[b:b + 1], k[b:b + 1], v[b:b + 1], causal, win, sc,
                    with_lse=True))
                if not (torch.equal(one[0], out[b:b + 1])
                        and torch.equal(one[1], lse[b:b + 1])):
                    raise AssertionError(f"{tag}: batch row {b} alone "
                                         f"differs")
            fwd = lambda: flash_attention_fwd(q, k, v, causal, win, sc)
            warm = min(3, iters)
            ms = _counted(torch, lambda: time_ms(torch, fwd, iters, warm))
            cold = _counted(torch, lambda: time_ms(torch, fwd, iters, warm,
                                                   cold=True))
            eager = _counted(torch, lambda: eager_ms(torch, fwd, iters,
                                                     warm))
            plain = time_ms(torch, lambda: flash_fwd_ref(
                q, k, v, causal, win, Sk - Sq, 512, 1024, sc), iters=3,
                warmup=1)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            if 0 < win < Sk:
                pos = torch.arange(Sk, device="cuda")
                mask = (pos[:, None] >= pos[None, :]) & \
                    (pos[:, None] - pos[None, :] < win)
                sdpa = lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, scale=sc, enable_gqa=True)
                pairs = int(mask.sum())
            elif causal:              # Sq = Sk on every causal path
                sdpa = lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, scale=sc, enable_gqa=True)
                pairs = Sq * (Sq + 1) // 2           # causal (q, k) pairs
            else:
                sdpa = lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, scale=sc, enable_gqa=True)
                pairs = Sq * Sk
            lib = time_ms(torch, sdpa, iters, warm)
            backend = _sdpa_backend(torch, sdpa)
            flops = 2.0 * (D + Dv) * pairs * B * H
            nbytes = (q.numel() + k.numel() + v.numel()
                      + B * Sq * H * Dv) * q.element_size()
            b_ms, b_by = bound_ms(nbytes, flops, peak)
            row = {"kernel": "flash_attention_fwd", "path": path,
                   "arch": arch, "shape": f"B={B} Sq={Sq} Sk={Sk} H={H} "
                   f"KV={KV} D={D} Dv={Dv} window={win}", "causal": causal,
                   "dtype": str(dt),
                   "max_abs_err": err, "lse_max_abs_err": lse_err,
                   "bound": bound, "lse_bound": 1e-4,
                   "deterministic": True, "row_independent": B > 1,
                   "timed_calls": iters, "ms": ms, "cold_ms": cold,
                   "eager_ms": eager, "plain_ms": plain,
                   "library_ms": lib, "library": f"SDPA ({backend})",
                   "bound_ms": b_ms, "bound_by": b_by,
                   "cold_share_of_bound": b_ms / cold}
            emit(row)
            rows.append(row)
            if main is None and dt == torch.bfloat16:
                main = row
            del q, k, v, qt, kt, vt, out, lse, ref, ref_lse, again
    return main


# rows the general path of csrc/rmsnorm.cu must take: a width that is no
# whole number of 16-byte vectors in either dtype, and yi-6b's width on a
# view that starts one element past a 16-byte boundary
RMSNORM_GENERAL = (("odd width", 1024, 1001, 0),
                   ("unaligned view", 1024, 4096, 1))


def rmsnorm_shapes() -> list:
    """The rmsnorm kernel's shapes on the serving and training paths, as
    (arch, rows, d, offset): yi-6b's prefill, the prefill of each family
    that normalises with RMSNorm at the serving batch and prompt
    (``LONG_PROMPT`` rows where it serves that), each config's decode row
    ``[MAX_BATCH, d]``, once a shape, then ``RMSNORM_GENERAL``.  ``offset``
    is the elements the row's view starts past an aligned storage."""
    from repro_torch.configs import get_config
    cfgs = [("yi-6b", get_config("yi-6b"))] + [
        (name, family_config(name, None))
        for name, _, _, _ in FAMILY_SERVING]
    cfgs = [(name, cfg) for name, cfg in cfgs if cfg.norm == "rmsnorm"]
    shapes = []
    for name, cfg in cfgs:
        shapes.append((name, MAX_BATCH * PROMPT, cfg.d_model, 0))
        if _long_prompt(cfg):
            shapes.append((name, LONG_PROMPT, cfg.d_model, 0))
    shapes += [(name, MAX_BATCH, cfg.d_model, 0) for name, cfg in cfgs]
    seen = set()
    return [s for s in shapes if s[1:] not in seen
            and not seen.add(s[1:])] + list(RMSNORM_GENERAL)


def check_rmsnorm(torch, gen, rows: list) -> dict:
    """rmsnorm against its plain version within 1 ulp (0 expected) at
    every shape of ``rmsnorm_shapes``, in bf16 and f32 with an f32 scale
    (as the models call it), each row timed in full: warm, cold, eager,
    plain, and ``F.rms_norm`` (a bf16 weight in bf16: the library's one
    call on the same input) warm and eager.  Each row names the path
    ``_plan`` gave it: the registered configs' widths must take the
    register path, ``RMSNORM_GENERAL``'s rows the general one.  Returns
    yi-6b's bf16 prefill row."""
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm.kernel import plan_for, rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    general = {s[0] for s in RMSNORM_GENERAL}
    main = None
    for arch, R, d, off in rmsnorm_shapes():
        scale = torch.randn(d, generator=gen, device="cuda") + 1.0
        for dt in (torch.bfloat16, torch.float32):
            full = torch.randn(R * d + off, generator=gen, device="cuda")
            x = full.to(dt)[off:].view(R, d)
            plan = plan_for(x, scale)
            if plan.path != ("general" if arch in general else "registers"):
                raise AssertionError(f"rmsnorm {arch} [{R}, {d}] {dt}: "
                                     f"{plan} takes the {plan.path} path")
            out = _counted(torch, lambda: rmsnorm(x, scale))
            torch.cuda.synchronize()
            ref = rmsnorm_ref(x, scale)
            err = float((out.float() - ref.float()).abs().max())
            ulps = _ulps(torch, out, ref)
            if ulps > 1.0:
                raise AssertionError(f"rmsnorm {arch} [{R}, {d}] {dt}: "
                                     f"{ulps} ulps (bound 1)")
            fn = lambda: rmsnorm(x, scale)
            w = scale.to(dt)
            lib = lambda: F.rms_norm(x, (d,), w, 1e-6)
            nbytes = 2 * x.numel() * x.element_size() + d * 4
            b_ms, b_by = bound_ms(nbytes, 4.0 * x.numel(), H100_F32_FLOPS)
            ms = _counted(torch, lambda: time_ms(torch, fn))
            cold = _counted(torch, lambda: time_ms(torch, fn, cold=True))
            row = {"kernel": "rmsnorm", "arch": arch, "shape": f"[{R}, {d}]",
                   "offset": off, "dtype": str(dt), "path": plan.path,
                   "vectors": plan.vectors, "warps": plan.warps,
                   "max_abs_err": err, "max_ulps": ulps, "bound": "1 ulp",
                   "ms": ms, "cold_ms": cold,
                   "eager_ms": _counted(torch, lambda: eager_ms(torch, fn)),
                   "plain_ms": time_ms(torch, lambda: rmsnorm_ref(x, scale)),
                   "library_ms": time_ms(torch, lib),
                   "library_eager_ms": eager_ms(torch, lib),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "share_of_bound": b_ms / ms,
                   "cold_share_of_bound": b_ms / cold}
            emit(row)
            rows.append(row)
            if main is None and dt == torch.bfloat16:
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


def _sequential_fma(torch, a, w):
    """``a @ w`` (f32) as the port's f32 codec GEMM sums it: per output,
    ``acc = fmaf(a[k], w[k], acc)`` for k = 0, 1, ... from +0, each step
    rounded once to f32.  Emulated exactly in f64: the product of two
    f32 values is exact there, TwoSum keeps the addition's error, and a
    sum that f64 rounded onto an f32 midpoint goes to the side its error
    lies on (the only case where rounding twice differs from once)."""
    inf = torch.full((), float("inf"), device=a.device)
    ad, wd = a.double(), w.double()
    acc = torch.zeros(a.shape[0], w.shape[1], device=a.device)
    for k in range(a.shape[1]):
        p = ad[:, k, None] * wd[None, k, :]
        c = acc.double()
        t = p + c
        bp = t - c
        e = (p - bp) + (c - (t - bp))            # t + e == p + c exactly
        r = t.float()
        d = t - r.double()                       # exact
        nb = torch.nextafter(r, torch.where(d > 0, inf, -inf))
        mid = (d != 0) & (2 * d == nb.double() - r.double())
        acc = torch.where(mid & (e * d > 0), nb, r)
    return acc


def _faithful(torch, name, p, a, w, kernel: bool = True):
    """Hold a codec product ``p`` (``a @ w`` with ``w`` rounded to
    ``a``'s dtype, f32 accumulation, rounded to that dtype) against the
    f64 product ``e`` of the same operands.  Each element must be
    faithfully rounded (``|p - e|`` below one ulp of ``e`` in the output
    dtype, so ``p`` is one of the two values around ``e``) or within a
    floor for the f32 sum's rounding error, which decides only where the
    sum nearly cancels in bf16, and everywhere in f32.  In bf16 the floor
    is ``4 u sqrt(n) ||a_i w_i||_2`` (u = 2^-24, n terms), about ten
    standard deviations of the rounding error of an f32 running sum
    whose partial sums stay near their typical size.  In f32 that is too
    tight: an element whose partial sums wander (RMS 1.85 times the
    typical) came out 1.014 floors from ``e``, in the kernel and in
    cuBLAS alike, each bit-equal to the sequential FMA sum.  So in f32
    the floor is the bound for any order of summation, ``n u / (1 - n u)
    sum_k |a_ik w_kj|``, and a ``kernel`` product must also equal
    :func:`_sequential_fma` bit for bit.  Returns (elements not
    correctly rounded, elements only the floor admits)."""
    wd = w.to(a.dtype).double()
    ad = a.double()
    e = ad @ wd
    err = (p.double() - e).abs()
    ulp = torch.exp2(torch.floor(torch.log2(e.abs() + 1e-300))) * \
        torch.finfo(a.dtype).eps
    n = a.shape[-1]
    if a.dtype == torch.float32:
        nu = n * 2.0 ** -24
        floor = nu / (1 - nu) * (ad.abs() @ wd.abs())
        if kernel:
            _bits_equal(torch, f"{name} against the sequential f32 FMA sum",
                        p, _sequential_fma(torch, a, w))
    else:
        floor = 4 * 2.0 ** -24 * math.sqrt(n) * \
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
    product faithfully rounded against the f64 product, in f32 also equal
    to the sequential FMA sum bit for bit (:func:`_faithful`).
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
                                  prod_lib, h, w_c, kernel=False)
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
                                      f"{mode} {dt}", ref, a, w_d,
                                      kernel=False)
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
    to end (cuBLAS's product), a code may differ by one step (in bf16 two
    in a block whose scales differ), and a scale at all, only in rows
    whose two products round apart; their counts are reported.
    dequantize_decode's product is faithfully rounded against
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
            # a code is round(127 z / s) of the encode output z and its
            # block's scale s (the block's largest |z|), both rounded to
            # x's dtype: in bf16 one ulp of z moves it by up to 127 / 128
            # of a step and one ulp of s by up to 127 / 128 more, so the
            # plain version's code lies within one step where the block's
            # scales agree and within two where they differ; in f32 an
            # ulp of either moves it by about 127 * 2^-24 of a step
            step_limit = 1 + ((sc != ps).repeat_interleave(qb, -1).int()
                              if dt == torch.bfloat16 else 0)
            if bool((dq > step_limit).any()) or (
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
                   "end to end one code step (in bf16 two where the "
                   "block's scales differ), only in rows whose products "
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


def _gen(torch, check):
    """A generator for ``check`` alone, seeded from its name: a shape added
    to one check leaves every other check's data as it was."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(zlib.crc32(check.__name__.encode()))
    return gen


def phase_kernels(torch) -> dict:
    rows: list = []
    seconds: dict = {}

    def run(check):
        t0 = time.time()
        got = check(torch, _gen(torch, check), rows)
        seconds[check.__name__] = time.time() - t0
        return got
    main = {"flash_attention_fwd": run(check_flash),
            "rmsnorm": run(check_rmsnorm),
            "qdq_flat": run(check_qdq),
            **run(check_codec),
            **run(check_wire_codes),
            **run(check_quant8)}
    run(check_ln_rows)                   # encode's row pass on its own
    emit({"phase": "kernels", "seconds": seconds})
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
                quant_block: int = 64, n_stages: int = 4, split: int = 2,
                max_batch: int = MAX_BATCH):
    """A ``ServeRunner`` over ``n_stages`` with one decode chain
    (0,split) -> (split,n_stages) (and a spare second peer with
    ``spare``)."""
    from repro_torch.serve import ServeConfig, ServeRunner
    r = ServeRunner(cfg, ServeConfig(n_stages=n_stages, max_batch=max_batch,
                                     max_sessions=1 if spare else 2,
                                     codec=codec, quant_block=quant_block),
                    params=params, device="cuda")
    r.add_peer((0, split), pool="decode", name="d0")
    r.add_peer((split, n_stages), pool="decode", name="d1")
    if spare:
        r.add_peer((split, n_stages), pool="decode", name="d1spare")
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
    prompt = len(batch[0])
    total = prompt + NEW
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
        w, kv0 = progs[0].decode(params[0], kv0, tok, prompt + i)
        tok, kv1 = progs[1].decode(params[1], kv1, wire(w), prompt + i)
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
    return {"prefill_tokens_per_s": B * len(prompts[0]) / t_pre,
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
                quant_block: int = 64, n_stages: int = 4,
                name: str = None, split: int = 2,
                max_batch: int = MAX_BATCH, extra: dict = None) -> dict:
    """Serve the prompts [n, prompt] through the chain (0,split) ->
    (split,n_stages), ``max_batch`` requests a session; tokens identical
    to ``ref`` (plain wire), or with the int8 wire of blocks of
    ``quant_block`` to the chain's programs with the plain int8 round
    trip at the edge.  ``extra`` joins the phase's row."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.compression import quant8
    from repro_torch.models.stage_plan import get_stage_plan
    torch.cuda.reset_peak_memory_stats()
    r = make_runner(torch, cfg, params, codec, spare=False,
                    quant_block=quant_block, n_stages=n_stages, split=split,
                    max_batch=max_batch)
    n_req, prompt = len(prompts), len(prompts[0])
    B = max_batch
    kernels.reset_launches()
    toks, reqs, summary, secs = serve(torch, r, prompts)
    launches = dict(kernels.LAUNCHES)
    if codec == "int8":
        # the lossy wire changes the tokens: hold the swarm against the
        # chain's programs called directly with the PLAIN int8 round trip
        # at the edge (same codes as the kernel, so the same tokens)
        from repro_torch.compression.quant8 import _roundtrip
        ref = np.concatenate([
            chain_generate(torch, r, prompts[i:i + B],
                           lambda w: _roundtrip(w, quant_block))[0]
            for i in range(0, n_req, B)])
    if not (toks == ref).all():
        raise AssertionError(
            f"{codec}: staged tokens differ from the reference first at "
            f"(request, token) {np.argwhere(toks != ref)[0].tolist()}")
    if summary["failed"] or summary["completed"] != n_req:
        raise AssertionError(f"{codec}: {summary}")
    # the serving path's kernels (the codec's are the training path's;
    # flash and rmsnorm only where the model runs attention and
    # normalises with RMSNorm: xlstm-125m does neither)
    for k in (("flash_attention_fwd",) if _has_attention(cfg) else ()) + (
            ("rmsnorm",) if cfg.norm == "rmsnorm" else ()) + (
            ("qdq_flat",) if codec == "int8" else ()):
        if launches[k] <= 0:
            raise AssertionError(f"{codec}: kernel {k} never launched")
    sessions = n_req // B
    crossings = sessions * NEW          # prefill + NEW-1 decode hops
    if name is None:
        name = "serve" if codec == "none" else "int8" if \
            quant_block == quant8.BLOCK else f"int8_block{quant_block}"
    row = {"phase": name, "arch": cfg.name, "n_stages": n_stages,
           "chain": [[0, split], [split, n_stages]], "codec": codec,
           "quant_block": quant_block, "requests": n_req, "prompt": prompt,
           "batch": B, "tokens_identical": True,
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
        esz = torch.finfo(cfg.compute_jdtype).bits // 8
        # what the runner counts: int32 tokens into stage 0 and the
        # (dequantized) wire in the compute dtype into the chain's second
        # span, per hop
        runner_bytes = sessions * (B * prompt * 4 + B * prompt * d * esz
                                   + (NEW - 1) * (B * 4 + B * d * esz))
        if summary["wire_bytes"] != runner_bytes:
            raise AssertionError(f"int8: wire_bytes {summary['wire_bytes']}"
                                 f" != {runner_bytes}")
        # what the int8 wire puts on a link at boundary 1: codes + scales
        # (the stage plan prices the default block)
        plan = get_stage_plan(cfg, n_stages)
        packed = sessions * (
            quant8.compressed_nbytes(B * prompt * d, quant_block)
            + (NEW - 1) * quant8.compressed_nbytes(B * d, quant_block))
        edge = split - 1                # the boundary the chain crosses
        priced = sessions * (plan.boundary_bytes(edge, B, prompt, "int8")
                             + (NEW - 1) * plan.boundary_bytes(edge, B, 1,
                                                               "int8"))
        if quant_block == quant8.BLOCK and packed != priced:
            raise AssertionError(f"int8: compressed bytes {packed} != "
                                 f"plan {priced}")
        row["int8_wire"] = {"crossings": crossings,
                            "runner_wire_bytes": runner_bytes,
                            "compressed_nbytes": packed}
    row.update(chain_rates(torch, r, prompts))
    row["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    row.update(extra or {})
    emit(row)
    del r
    free(torch)
    return row


def phase_serve_families(torch) -> dict:
    """``ServeRunner`` serving each family at full width (random weights
    from a seed, ``FAMILY_SERVING``'s depths and chains), yi-6b's
    requests, tokens identical to the single-process reference; danube
    and hymba also past their windows, deepseek-v2 also on the int8
    wire; the recurrent configs (xlstm-125m, hymba-1.5b) also through
    ``phase_churn``, their carry rebuilt by a re-prefill.  Returns each
    config's row."""
    import numpy as np
    from repro_torch.models import model as model_lib
    from repro_torch.models import params as P
    from repro_torch.models.stage_plan import RECURRENT_KINDS
    from repro_torch.serve import reference_generate
    t0 = time.time()
    rows = {}
    for name, depth, n_stages, split in FAMILY_SERVING:
        cfg = family_config(name, depth)
        free(torch)
        params = P.init(0, model_lib.lm_specs(cfg), "cuda")
        prompts = prompts_for(cfg)
        ref = _counted(torch, lambda: np.concatenate([
            reference_generate(cfg, params, prompts[i:i + MAX_BATCH], NEW)
            for i in range(0, N_REQ, MAX_BATCH)]))
        full = family_config(name, None).n_layers
        extra = {"n_layers": cfg.n_layers, "n_layers_full": full,
                 "depth_cut": cfg.n_layers < full,
                 "param_dtype": cfg.param_dtype,
                 "params": P.n_params(model_lib.lm_specs(cfg)),
                 "head_dims": _head_dims(cfg)}
        row = phase_serve(torch, cfg, params, prompts, ref, "none",
                          n_stages=n_stages, split=split,
                          name="serve_families", extra=extra)
        rows[name] = row
        if _long_prompt(cfg):
            # one request past the window at batch 1: the window mask in
            # the flash kernel and the ring cache at full width
            long = np.random.default_rng(2).integers(
                0, cfg.vocab_size, size=(1, LONG_PROMPT))
            long_ref = _counted(torch, lambda: reference_generate(
                cfg, params, long, NEW))
            rows[name + " long"] = phase_serve(
                torch, cfg, params, long, long_ref, "none", n_stages=n_stages,
                split=split, name="serve_families_long", max_batch=1,
                extra={**extra, "window": cfg.sliding_window})
        if name == "deepseek-v2-236b":
            rows[name + " int8"] = phase_serve(
                torch, cfg, params, prompts, ref, "int8", n_stages=n_stages,
                split=split, name="serve_families_int8", extra=extra)
        if any(k in RECURRENT_KINDS for k in cfg.block_kinds):
            rows[name + " churn"] = phase_churn(
                torch, cfg, params, prompts, ref, n_stages=n_stages,
                split=split, name="churn_families")
        del params, ref
        free(torch)
    emit({"phase": "serve_families_done", "seconds": time.time() - t0})
    return rows


# A recurrent config's churn reads the carry the runner itself installs
# on the spare after its re-prefill and holds it, layer by layer over the
# span (every cache leaf of the layer: max |difference| over max |probe
# leaf|), to the carry the no-kill probe run's peer held before decoding
# the same position; and the span's next logits, as the runner computes
# them, to the probe's.  In the served bf16 path and an f32 twin of it.
# Two more runs through the runner frame each reading: a planted fault
# (the spare re-prefills one step short: a carry one step stale), which
# every bound must reject, and a witness without a kill whose span is fed
# the probe's own inputs moved by one ulp (rounding alone, no rebuild).
# The span's first layer sees the same wire in every run, so its carry is
# bounded tightly in both dtypes.  Deeper layers amplify rounding with
# random weights (on the card the witness and the rebuilt carry grow
# alike, about twofold a hymba layer and some 40-fold at xlstm's sLSTM
# layer), so every layer and the logits are bounded in f32 only, and in
# bf16 reported beside the witness.
CARRY_FIRST_RTOL = {"bfloat16": 0.1, "float32": 1e-4}
CARRY_LAYERS_RTOL = {"bfloat16": None, "float32": 0.5}
CARRY_LOGITS_RTOL = {"bfloat16": None, "float32": 0.3}


def _slot_carries(torch, peer, key, stages) -> list:
    """The caches ``peer`` holds for session ``key`` on ``stages``, cloned
    (a decode writes them in place)."""
    from repro_torch.serve.programs import KV_SLOT
    from repro_torch.tree import tree_map
    return [tree_map(torch.clone, peer.state.stage_view(s).slot(KV_SLOT)[key])
            for s in stages]


def _layer_errs(got: list, want: list) -> list:
    """One number a layer of the span (stages, their runs and each run's
    stacked layers in order): the largest relative difference over the
    layer's cache leaves."""
    from repro_torch.tree import tree_leaves
    errs = []
    for g_stage, w_stage in zip(got, want):
        for g, w in zip(g_stage, w_stage):
            gl, wl = tree_leaves(g), tree_leaves(w)
            errs += [max(_rel(a[i], b[i]) for a, b in zip(gl, wl))
                     for i in range(wl[0].shape[0])]
    return errs


def _nudged(torch, x):
    """``x`` moved one ulp away from zero in every element."""
    ints = {2: torch.int16, 4: torch.int32}[x.element_size()]
    return (x.contiguous().view(ints) + 1).view(x.dtype)


def _churn_serve(torch, cfg, params, prompts, n_stages: int, split: int,
                 fail_at=None, stale: bool = False, nudge_from=None,
                 keep=()) -> dict:
    """One serve in ``phase_churn``'s layout (chain (0, split) -> (split,
    n_stages), a spare for the second span), ``d1`` killed at
    ``fail_at``, tapped on the span ``(split, n_stages)``: each decode's
    input and the f32 logits it computes, the carry its peer holds
    before each decode at a ``(session, pos)`` of ``keep`` (None: every
    one), and the carry each re-prefill installs.  ``stale`` plants a
    fault: the spare re-prefills the history one step short.
    ``nudge_from`` (an earlier run's inputs) feeds the span those inputs
    moved by one ulp in place of its own."""
    from repro_torch.core.peer import T4
    from repro_torch.serve import programs
    r = make_runner(torch, cfg, params, "none", spare=True,
                    n_stages=n_stages, split=split)
    span = (split, n_stages)
    out = {"carries": {}, "logits": {}, "inputs": {}, "rebuilt": []}
    tap = {"at": None}
    head, decode_thunk, reprefill = (programs._head_logits, r._decode_thunk,
                                     r._reprefill)

    def logits(c, p, x):
        y = head(c, p, x)
        if tap["at"] is not None:
            out["logits"][tap["at"]] = y.float().clone()
        return y

    def decoding(sess, peer, prog, x, pos):
        if prog.span != span:
            return decode_thunk(sess, peer, prog, x, pos)
        at = (sess.key, pos)
        if nudge_from is not None:
            x = _nudged(torch, nudge_from[at])
        out["inputs"][at] = x
        thunk = decode_thunk(sess, peer, prog, x, pos)

        def run():
            if keep is None or at in keep:
                out["carries"][at] = _slot_carries(torch, peer, sess.key,
                                                   prog.stages)
            tap["at"] = at
            try:
                return thunk()
            finally:
                tap["at"] = None
        return run

    def reprefilling(sess, peer, prog, missing):
        lo = prog.span[0]
        hist = sess.edges[lo]
        pos = sum(h.shape[1] for h in hist[:-1])
        if stale:
            assert len(hist) > 2, "a stale carry needs two decode steps"
            sess.edges[lo] = hist[:-2] + hist[-1:]
        try:
            yield from reprefill(sess, peer, prog, missing)
        finally:
            sess.edges[lo] = hist
        out["rebuilt"].append({"key": sess.key, "pos": pos,
                               "carries": _slot_carries(
                                   torch, peer, sess.key, prog.stages)})
        out["logits"].pop((sess.key, pos), None)

    r._decode_thunk, r._reprefill = decoding, reprefilling
    programs._head_logits = logits
    try:
        toks, reqs, summary, secs = serve(torch, r, prompts, fail_at=fail_at)
    finally:
        programs._head_logits = head
    B = r.scfg.max_batch
    # a decode step of the chain's two hops in virtual time
    out["step"] = (T4.recv_time(B * 4) + T4.recv_time(B * cfg.d_model * 2)
                   + sum(T4.compute_time(
                       p.executor.session_program(PROMPT + NEW)
                       .flops_per_token * B) for p in r.decode_peers[:2]))
    out.update(toks=toks, reqs=reqs, summary=summary, secs=secs,
               ledger=r.kv.stage_counts())
    # the runner sits in reference cycles: drop every handle to it
    # (the bound methods too) before collecting
    del r, decoding, reprefilling, decode_thunk, reprefill
    free(torch)
    return out


def _carry_check(torch, cfg, params, prompts, n_stages: int, split: int,
                 served: dict) -> dict:
    """The carry the spare rebuilt, held to the one the dead peer would
    have held.  ``served`` holds the served path's probe (every carry
    kept) and kill runs; the f32 twin runs both anew.  In each dtype the
    planted stale fault and the one-ulp witness run too.  Each bound
    (``CARRY_FIRST_RTOL``: the span's first layer, ``CARRY_LAYERS_RTOL``:
    every layer, ``CARRY_LOGITS_RTOL``: the next logits) must hold for
    the rebuilt carry and reject the stale one (in every layer it
    covers)."""
    row = {}
    for dt in ("bfloat16", "float32"):
        if dt == cfg.compute_dtype:
            c, probe, kill, fail_at = cfg, served["probe"], served["kill"], \
                served["fail_at"]
        else:
            c = cfg.with_overrides(compute_dtype=dt)
            probe = _churn_serve(torch, c, params, prompts, n_stages, split,
                                 keep=None)
            fail_at = min(q.done_at for q in probe["reqs"]) - 0.05
            kill = _churn_serve(torch, c, params, prompts, n_stages, split,
                                fail_at=fail_at)
        rb = kill["rebuilt"][0]
        at = (rb["key"], rb["pos"])
        stale = _churn_serve(torch, c, params, prompts, n_stages, split,
                             fail_at=fail_at, stale=True)
        witness = _churn_serve(torch, c, params, prompts, n_stages, split,
                               nudge_from=probe["inputs"], keep={at})
        if stale["rebuilt"][0]["pos"] != at[1]:
            raise AssertionError(f"carry {cfg.name} {dt}: the stale run "
                                 f"re-prefilled at {stale['rebuilt'][0]}")
        want = probe["carries"][at]
        e = {"pos": at[1], "ragged": at[1] % cfg.ssm.chunk != 0,
             "first_layer_bound": CARRY_FIRST_RTOL[dt],
             "layers_bound": CARRY_LAYERS_RTOL[dt],
             "logits_bound": CARRY_LOGITS_RTOL[dt]}
        for what, run, carries in (
                ("rebuilt", kill, rb["carries"]),
                ("stale", stale, stale["rebuilt"][0]["carries"]),
                ("witness", witness, witness["carries"][at])):
            e[f"state_{what}"] = _layer_errs(carries, want)
            e[f"logits_{what}"] = _rel(run["logits"][at],
                                       probe["logits"][at])
        e["layers"] = len(e["state_rebuilt"])
        row[dt] = e
        del probe, kill, stale, witness, want
        free(torch)
    emit({"phase": "carry", "arch": cfg.name, **row})
    for dt, e in row.items():
        if not e["ragged"]:
            raise AssertionError(f"carry {cfg.name} {dt}: re-prefill at "
                                 f"{e['pos']}, a multiple of the chunk")
        for what, n, bound in (
                ("state", 1, e["first_layer_bound"]),
                ("state", None, e["layers_bound"]),
                ("logits", None, e["logits_bound"])):
            got, bad = e[f"{what}_rebuilt"], e[f"{what}_stale"]
            got, bad = ([got], [bad]) if what == "logits" else \
                (got[:n], bad[:n])
            if bound is not None and not max(got) <= bound < min(bad):
                raise AssertionError(f"carry {cfg.name} {dt} {what} over "
                                     f"{len(got)} layer(s): {e}")
    return row


def phase_churn(torch, cfg, params, prompts, ref, n_stages: int = 4,
                split: int = 2, name: str = "churn") -> dict:
    """The chain (0,split) -> (split,n_stages) and a spare (split,n_stages)
    peer; the chain's second peer dies mid-decode and the spare
    re-prefills its span from the recorded boundary history.  No request
    fails, every re-prefill rebuilds the span's stages, the ledger
    drains, the tokens before the kill equal the reference; a recurrent
    config's rebuilt carry (re-prefilled at a length no multiple of its
    chunk) also passes ``_carry_check``."""
    import numpy as np
    from repro_torch.models.stage_plan import RECURRENT_KINDS
    recurrent = any(k in RECURRENT_KINDS for k in cfg.block_kinds)
    torch.cuda.reset_peak_memory_stats()
    # probe: the same layout without a failure gives the virtual time the
    # first session finishes; the kill lands 0.05 s (about four decode
    # steps of two hops) before it
    probe = _churn_serve(torch, cfg, params, prompts, n_stages, split,
                         keep=None if recurrent else ())
    if not (probe["toks"] == ref).all():
        raise AssertionError(f"{name} probe: tokens differ from the "
                             f"reference")
    first_done = min(q.done_at for q in probe["reqs"])
    fail_at = first_done - 0.05
    n_before = NEW - 1 - math.ceil(0.05 / probe["step"])  # out before it
    kill = _churn_serve(torch, cfg, params, prompts, n_stages, split,
                        fail_at=fail_at)
    toks, reqs, summary = kill["toks"], kill["reqs"], kill["summary"]
    if summary["failed"] != 0:
        raise AssertionError(f"{name}: {summary}")
    if not (summary["reprefills"] >= 1 and summary["reprefilled_stages"]
            == (n_stages - split) * summary["reprefills"]):
        raise AssertionError(f"{name}: re-prefill accounting {summary}")
    if any(c != 0 for c in kill["ledger"]):
        raise AssertionError(f"{name}: ledger not drained {kill['ledger']}")
    hit = [i for i, q in enumerate(reqs) if q.done_at == min(
        q2.done_at for q2 in reqs)]
    if not (toks[hit, :n_before] == ref[hit, :n_before]).all():
        raise AssertionError(f"{name}: tokens before the kill differ")
    mism = np.argwhere(toks != ref)
    row = {"phase": name, "arch": cfg.name, "n_stages": n_stages,
           "chain": [[0, split], [split, n_stages]], "fail_at": fail_at,
           "tokens_checked_before_kill": n_before,
           "reprefill_lengths": [b["pos"] for b in kill["rebuilt"]],
           "first_mismatch": (None if mism.size == 0
                              else [int(v) for v in mism[0]]),
           "summary": {k: summary[k] for k in
                       ("completed", "failed", "hop_failures", "reprefills",
                        "reprefilled_stages", "elapsed_s")},
           "ledger_counts": kill["ledger"], "wall_s": kill["secs"],
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9}
    if recurrent:
        row["carry"] = _carry_check(
            torch, cfg, params, prompts, n_stages, split,
            {"probe": probe, "kill": kill, "fail_at": fail_at})
    emit(row)
    del probe, kill
    free(torch)
    return row


# ------------------------------------------------------------ phases 6-8
TRAIN_SEQ, TRAIN_MB, TRAIN_GB, TRAIN_STEPS = 512, 2, 8, 3
STEP1_RTOL, LATER_ATOL = 1e-5, 1e-3
REBALANCE_PERIOD = 5.0           # virtual seconds, train_rebalance's Alg. 2


def swarm1b(wire_quant: bool = False, name: str = "swarm-1b-bottleneck"):
    from repro_torch.configs import get_config
    return get_config(name).with_overrides(wire_quant=wire_quant)


def train_opt():
    from repro_torch.optim import adamw
    return adamw(lr=1e-4)


def train_reference(torch, cfg, steps: int, device="cuda",
                    opt=None) -> list:
    """The staged reference's per-step losses from the same seed (the
    same stage params a ``SwarmRunner(seed=0)`` installs), driven by
    ``opt`` (default ``train_opt()``)."""
    from repro_torch.runtime import build_stage_programs
    from repro_torch.train.reference import reference_losses
    progs = build_stage_programs(cfg, 3, TRAIN_SEQ)
    opt = train_opt() if opt is None else opt
    losses = _counted(torch, lambda: reference_losses(
        cfg, progs, opt, 0, steps, TRAIN_SEQ, TRAIN_MB, TRAIN_GB,
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


def span_fleet(i: int):
    """Device profile of peer ``i`` (join order) in train_span_rebalance:
    stage 1's single peer (the second) is a T4 at 1/16 of the compute,
    the span peer (the fourth) an A100, the rest T4s."""
    from repro_torch.core.peer import A100, T4
    return slow_front(0) if i == 1 else A100 if i == 3 else T4


def slow_all(i: int):
    """Device profile of every peer: a T4 at 1/16 of its compute, so a
    step lasts longer on the virtual clock than a stage download."""
    return slow_front(0)


ZONES = ("us-east", "eu", "ap", "us-west")


def make_swarm(torch, cfg, steps: int, peers, profile_fn=None,
               region_fn=None, **scfg):
    """A ``SwarmRunner`` of the training phases, built; ``scfg`` overrides
    its ``SwarmConfig`` fields, ``profile_fn`` its peers' device profiles
    (the virtual clock's compute and link speeds) and ``region_fn``
    their zones."""
    from repro_torch.core.swarm import SwarmConfig, SwarmRunner
    kw = dict(n_stages=3, microbatch_size=TRAIN_MB, seq_len=TRAIN_SEQ,
              global_batch=TRAIN_GB, n_trainers=2, rebalance_period=0.0,
              codec="bottleneck", max_steps=steps)
    kw.update(scfg)
    extra = {k: v for k, v in (("profile_fn", profile_fn),
                               ("region_fn", region_fn)) if v is not None}
    runner = SwarmRunner(cfg, SwarmConfig(**kw), train_opt(), seed=0,
                         record_accumulation=True, device="cuda", **extra)
    runner.build(peers)
    return runner


def run_swarm(torch, cfg, steps: int, peers, kill: bool = False,
              setup=None, profile_fn=None, region_fn=None, **scfg):
    """Train ``steps`` steps of ``SwarmRunner`` (counters zeroed just
    before; ``setup(runner)`` runs first); returns (metrics, runner,
    launches, wall seconds, peak GB)."""
    from repro_torch import kernels
    free(torch)                     # the last phase's runner, if unfreed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runner = make_swarm(torch, cfg, steps, peers, profile_fn, region_fn,
                        **scfg)
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


def _check_losses(name: str, got: list, want: list,
                  bounds: tuple = (STEP1_RTOL, LATER_ATOL)) -> float:
    """``bounds``: step 1's relative bound and every step's absolute
    one."""
    step1_rtol, later_atol = bounds
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} steps, want {len(want)}")
    if abs(got[0] - want[0]) > step1_rtol * abs(want[0]):
        raise AssertionError(f"{name}: step 1 loss {got[0]} vs {want[0]}")
    diff = max(abs(a - b) for a, b in zip(got, want))
    if diff > later_atol:
        raise AssertionError(f"{name}: losses {got} vs {want}")
    return diff


def phase_train(torch, name: str, cfg, steps: int, want: list,
                peers=1, kill: bool = False, exact: bool = False,
                profile_fn=None, region_fn=None, setup=None, check=None,
                bounds: tuple = (STEP1_RTOL, LATER_ATOL),
                must: tuple = ("flash_attention_fwd", "encode", "decode"),
                **scfg) -> dict:
    """``exact``: the losses must equal ``want`` to the bit; ``bounds``
    (see ``_check_losses``) otherwise; ``must``: the kernels that must
    launch.  ``setup`` runs on the built runner before training;
    ``check(runner, metrics)`` after it, raising on a failed check and
    returning extra row fields."""
    m, runner, launches, wall, peak = run_swarm(
        torch, cfg, steps, peers, kill, setup=setup, profile_fn=profile_fn,
        region_fn=region_fn, **scfg)
    got = m["loss"]
    diff = _check_losses(name, got, want, bounds)
    if exact and got != want:
        raise AssertionError(f"{name}: losses {got} differ from {want}")
    if not all(math.isfinite(v) for v in got):
        raise AssertionError(f"{name}: non-finite losses {got}")
    must = list(must)
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
           "failures": m["failures"], "joins": m["joins"],
           "recomputed_microbatches": m["recomputed_microbatches"],
           "migrations": m["migrations"],
           "span_changes": m["span_changes"],
           "wire_bytes": m["wire_bytes"],
           "released_rows": sum(1 for e in runner.ledger_log
                                if e[0] == "rel"),
           "barriers_exactly_once": barriers,
           "virtual_s": runner._t_stopped,
           "peers_per_stage": [len(runner._covering(s))
                               for s in range(runner.n_stages)],
           "spans": sorted((p.stages.start, p.stages.stop)
                           for p in runner.peers.values()
                           if p.alive and p.serving)}
    if kill and not (m["failures"] == 1
                     and m["recomputed_microbatches"] >= 1):
        raise AssertionError(f"{name}: no peer died mid-step: {row}")
    if scfg.get("rebalance_period", 0.0) > 0:
        row["rebalance_period"] = scfg["rebalance_period"]
    if check is not None:
        row.update(check(runner, m))
    elif scfg.get("rebalance_period", 0.0) > 0:
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


# ------------------------------------------------------ phases 10-12
def _span_accs(runner, peer) -> list:
    """The stages ``peer`` accumulated gradients under."""
    return sorted({s for kind, _t, s, _i, _a, pid in runner.ledger_log
                   if kind == "acc" and pid == peer.id})


def _first_peer_names():
    """Restart the peer-name counter: Alg. 2 breaks ties between equal
    queues by peer name, so a span phase's decisions then do not depend
    on how many peers the phases before it built."""
    from repro_torch.core.peer import Peer
    Peer._ids = 0


def _serving_spans(runner) -> list:
    return sorted((p.stages.start, p.stages.stop)
                  for p in runner.peers.values() if p.alive and p.serving)


def phase_train_span(torch, train: dict) -> dict:
    """One span peer on stages [0, 2) (the runner's shared
    ``PipelineExecutor``: both stages in one fused program) and one peer
    on stage 2, held to ``train``'s losses to the bit."""
    from repro_torch.runtime import PipelineExecutor
    peers = {}      # names only: a Peer would keep its runner alive

    def setup(runner):
        peers["span"] = runner.add_peer(range(0, 2)).id

    def check(runner, m):
        span = runner.peers[peers["span"]]
        accs = _span_accs(runner, span)
        if not isinstance(span.executor, PipelineExecutor) or accs != [0, 1]:
            raise AssertionError(f"train_span: the span peer "
                                 f"({type(span.executor).__name__}) "
                                 f"accumulated under stages {accs}")
        if not 0 < m["wire_bytes"] < train["wire_bytes"]:
            raise AssertionError(f"train_span: {m['wire_bytes']} wire "
                                 f"bytes, train {train['wire_bytes']}")
        return {"span_peer_stages": accs,
                "train_wire_bytes": train["wire_bytes"],
                "wire_bytes_over_train": m["wire_bytes"]
                / train["wire_bytes"]}

    _first_peer_names()
    return phase_train(torch, "train_span", swarm1b(name="swarm-1b-span"),
                       TRAIN_STEPS, train["losses"], peers=[0, 0, 1],
                       exact=True, setup=setup, check=check)


def _split_merge_kill(runner, log: list):
    """Sim process: mid-step 1 split the span peer at stage 1 (a fresh
    peer warm-joins [1, 2), downloading stage 1 from it; then it shrinks
    to [0, 1)), mid-step 2 merge it back to [0, 2) (downloading stage 1
    from the [1, 2) peer), then kill the [1, 2) peer."""
    from repro_torch.core.sim import Sleep
    span = next(p for p in runner.peers.values() if len(p.stages) == 2)
    for step, act in ((1, "split"), (2, "merge")):
        while runner.step < step or not runner.ledger.stage_counts()[0]:
            if runner.stopped:
                return
            yield Sleep(0.1)
        if act == "split":
            yield from runner.split_span(span, at=1)
        else:
            joiner = next(p for p in runner.peers.values()
                          if p.alive and p.serving
                          and p.stages == range(1, 2))
            yield from runner.merge_spans(span, range(0, 2))
        log.append((act, runner.step, (span.stages.start, span.stages.stop),
                    _serving_spans(runner)))
    runner._fail_peer(joiner)
    log.append(("kill", runner.step, (joiner.stages.start,
                                      joiner.stages.stop),
                _serving_spans(runner)))


def phase_train_span_resize(torch, train: dict) -> dict:
    """Span split, merge and a peer's death on the train_span layout,
    every peer on the T4/16 profile (a step then outlasts a stage
    download on the virtual clock)."""
    log: list = []

    def setup(runner):
        runner.add_peer(range(0, 2))
        runner.sim.spawn(_split_merge_kill(runner, log))

    def check(runner, m):
        acts = [(a, span) for a, _step, span, _layout in log]
        if acts != [("split", (0, 1)), ("merge", (0, 2)), ("kill", (1, 2))] \
                or (m["span_changes"], m["joins"], m["failures"]) != \
                (2, 1, 1) or _serving_spans(runner) != [(0, 2), (2, 3)]:
            raise AssertionError(f"train_span_resize: events {log}, "
                                 f"span changes {m['span_changes']}, joins "
                                 f"{m['joins']}, failures {m['failures']}")
        return {"events": log}

    _first_peer_names()
    return phase_train(torch, "train_span_resize",
                       swarm1b(name="swarm-1b-span"), TRAIN_STEPS,
                       train["losses"], peers=[0, 0, 1], exact=True,
                       profile_fn=slow_all, setup=setup, check=check)


def phase_train_span_rebalance(torch, train: dict) -> dict:
    """Alg. 2's span branch on the card: single peers on stages 0, 1 and
    2 (stage 1's on T4/16, the others T4s) and an A100 span peer on
    [0, 2), four zones priced by the WAN link table; the planner shrinks
    the span peer onto the bottleneck stage 1 mid-run."""
    from repro_torch.core import rebalance as rb
    from repro_torch.core.square_cube import default_wan_table
    resizes: list = []
    peers = {}      # names only: a Peer would keep its runner alive

    def setup(runner):
        resize = runner._resize_span

        def logged(peer, new_span):
            old = peer.stages
            ok = yield from resize(peer, new_span)
            resizes.append((peer.id, (old.start, old.stop),
                            (new_span.start, new_span.stop), ok,
                            runner.step))
            return ok
        runner._resize_span = logged
        peers["span"] = runner.add_peer(range(0, 2)).id

    def check(runner, m):
        span = peers["span"]
        shrunk = [r for r in resizes
                  if r[0] == span and r[3] and r[2] == (1, 2)]
        layout = _serving_spans(runner)
        if m["span_changes"] < 1 or not shrunk or \
                not rb.spans_route(runner.n_stages, layout):
            raise AssertionError(f"train_span_rebalance: resizes "
                                 f"{resizes}, layout {layout}")
        return {"resizes": resizes,
                "stage_regions": runner._stage_regions()}

    _first_peer_names()
    return phase_train(torch, "train_span_rebalance",
                       swarm1b(name="swarm-1b-span"), TRAIN_STEPS,
                       train["losses"], peers=1, exact=True,
                       profile_fn=span_fleet,
                       region_fn=lambda i: ZONES[i % len(ZONES)],
                       rebalance_period=REBALANCE_PERIOD,
                       spans=True, link_table=default_wan_table(),
                       setup=setup, check=check)


# ------------------------------------------------------ phases 13-17
# the async tick, then serving shared layers and a learned codec
def phase_train_overlap(torch, train: dict) -> dict:
    """``train``'s setup under the async tick's in-flight transfers and
    dispatch/collect (``overlap=True, staleness=0``): only the virtual
    clock moves, so the losses equal ``train``'s to the bit; edges ride
    in flight and the virtual makespan is no longer than ``train``'s."""
    def check(runner, m):
        if not (m["inflight_bytes"] > 0 and m["overlap_fraction"] > 0):
            raise AssertionError(f"train_overlap: in-flight bytes "
                                 f"{m['inflight_bytes']}, overlap "
                                 f"fraction {m['overlap_fraction']}")
        if runner._t_stopped > train["virtual_s"] + 1e-9:
            raise AssertionError(f"train_overlap: virtual makespan "
                                 f"{runner._t_stopped} > train's "
                                 f"{train['virtual_s']}")
        return {k: m[k] for k in ("inflight_bytes", "overlap_fraction",
                                  "wire_serial_s", "wire_inflight_s")} | {
            "train_virtual_s": train["virtual_s"]}

    return phase_train(torch, "train_overlap", swarm1b(), TRAIN_STEPS,
                       train["losses"], exact=True, check=check,
                       overlap=True, staleness=0)


def _dpu_state_check(name: str):
    """A ``check`` for the staleness=1 phases: every live peer holds the
    DPU-wrapped optimizer state, its 0-d flag set after the first step."""
    def check(runner, m):
        for p in runner.peers.values():
            if not p.alive:
                continue
            for s in p.stages:
                opt = p.state.stage_view(s).opt
                if "have_banked" not in opt or not bool(opt["have_banked"]):
                    raise AssertionError(f"{name}: peer {p.id} stage {s} "
                                         f"holds no banked DPU state")
        return {k: m[k] for k in ("inflight_bytes", "overlap_fraction")} | {
            "step_time": m["step_time"]}
    return check


def phase_train_async(torch) -> dict:
    """``train_overlap`` with ``staleness=1``: the runner wraps AdamW in
    delayed parameter updates and the All-Reduce window runs beside the
    next round; losses held to the staged reference driven by
    ``delayed_parameter_updates(train_opt(), 1)`` on the same card and
    weights, under ``train``'s bounds."""
    from repro_torch.optim import delayed_parameter_updates
    ref = train_reference(torch, swarm1b(), TRAIN_STEPS,
                          opt=delayed_parameter_updates(train_opt(), 1))
    return phase_train(torch, "train_async", swarm1b(), TRAIN_STEPS, ref,
                       check=_dpu_state_check("train_async"),
                       overlap=True, staleness=1)


def phase_train_async_churn(torch, train_async: dict) -> dict:
    """``train_churn``'s layout and kill under the async tick with
    staleness=1: each (stage, microbatch) admitted exactly once, the
    ledger drained, losses equal to ``train_async``'s to the bit."""
    return phase_train(torch, "train_async_churn", swarm1b(), TRAIN_STEPS,
                       train_async["losses"], peers=[1, 2, 1], kill=True,
                       exact=True, check=_dpu_state_check(
                           "train_async_churn"),
                       overlap=True, staleness=1)


def phase_serve_shared(torch) -> list:
    """``ServeRunner`` serving swarm-1b (three ALBERT-shared groups, each
    applied 16 times) at full width and depth over 3 stages, one decode
    chain (0,2) -> (2,3): tokens identical to the single-process
    reference, then with the int8 wire (one QDQ launch per span-edge
    crossing)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.models import params as P
    from repro_torch.serve import reference_generate
    cfg = get_config("swarm-1b")
    free(torch)
    params = P.init(0, model_lib.lm_specs(cfg), "cuda")
    prompts = prompts_for(cfg)
    ref = _counted(torch, lambda: np.concatenate([
        reference_generate(cfg, params, prompts[i:i + MAX_BATCH], NEW)
        for i in range(0, N_REQ, MAX_BATCH)]))
    rows = [phase_serve(torch, cfg, params, prompts, ref, codec,
                        n_stages=3, name=name)
            for codec, name in (("none", "serve_shared"),
                                ("int8", "serve_shared_int8"))]
    del params, ref
    free(torch)
    return rows


# A decode step against the no-cache recompute: with causal attention a
# stage's prefill over a sequence gives, row for row, what a prefill of
# each prefix gives, so one prefill per stage recomputes every step.
# Each stage is fed the same input sequence on both paths (the previous
# stage's recompute), so one stage's error does not compound into the
# next.  With random weights the full 48 applications are ill-conditioned:
# rounding alone (the same f32 prefill at batch 2 against batch 1, the
# row's ``rounding_spread_f32``) moves the logits by several per cent of
# their scale, so the bounds hold swarm-1b-bottleneck's widths and
# weights at two applications per group (n_layers 6): the served bf16
# path within ``CODEC_RTOL_BF16`` and an f32 twin within
# ``CODEC_RTOL_F32``.  Each bound is shown to see two planted faults,
# every application reading its neighbour's cache (the group-major index
# off by one) and the newest prompt row of every cache zeroed: each
# stage's planted error must exceed the bound.  The full depth's bf16
# errors are reported beside them.
CODEC_RTOL_BF16 = 0.1
CODEC_RTOL_F32 = 5e-3


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max())


def _plant(cache: list, kind: str) -> None:
    """Plant a fault in a stage's stacked caches ``[n * reps, B, T, KV,
    hd]`` in place: ``"apps"`` rolls the applications by one, ``"row"``
    zeroes the newest prompt row."""
    from repro_torch.tree import tree_leaves
    for leaf in tree_leaves(cache):
        if kind == "apps":
            leaf.copy_(leaf.roll(1, 0))
        else:
            leaf[:, :, PROMPT - 1] = 0


def phase_serve_codec(torch) -> dict:
    """swarm-1b-bottleneck served through session programs (its learned
    4096 -> 1024 codec at both stage edges), stage weights from
    ``init_stage_params``: the chain (0,2) -> (2,3) against one (0,3)
    program, token for token, with two encode and two decode launches a
    prefill and a decode step (boundaries 0-1 and 1-2); then every
    stage's decode steps against its no-cache recompute at two
    applications per group, bounded by ``CODEC_RTOL_BF16`` in bf16 and
    ``CODEC_RTOL_F32`` in an f32 twin, each bound shown to see a planted
    fault; reported in bf16 at full depth."""
    from repro_torch import kernels
    from repro_torch.runtime import build_stage_programs, init_stage_params
    from repro_torch.runtime.stage_model import _head_logits
    from repro_torch.serve.programs import _make_stage_decode, \
        _make_stage_prefill, build_session_program
    cfg = swarm1b()
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    params = init_stage_params(build_stage_programs(cfg, 3, TRAIN_SEQ), 0)
    total = PROMPT + NEW
    progs = {sp: build_session_program(cfg, 3, sp, total)
             for sp in ((0, 2), (2, 3), (0, 3))}
    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (MAX_BATCH, PROMPT),
                         generator=gen, device="cuda", dtype=torch.int32)

    def generate(chain):
        """Greedy tokens [B, NEW] through the chain's programs, the
        kernel launches of each call, prefill s and decode s."""
        ps = [tuple(params[lo:hi]) for lo, hi in chain]
        calls = []
        torch.cuda.synchronize()
        t0 = time.time()
        kernels.reset_launches()
        x, kvs = toks, []
        for sp, p in zip(chain, ps):
            x, kv = progs[sp].prefill(p, x)
            kvs.append(kv)
        calls.append(dict(kernels.LAUNCHES))
        torch.cuda.synchronize()
        t_pre, out = time.time() - t0, [x]
        t0 = time.time()
        for i in range(NEW - 1):
            kernels.reset_launches()
            for j, (sp, p) in enumerate(zip(chain, ps)):
                x, kvs[j] = progs[sp].decode(p, kvs[j], x, PROMPT + i)
            calls.append(dict(kernels.LAUNCHES))
            out.append(x)
        torch.cuda.synchronize()
        return torch.cat(out, 1), calls, t_pre, time.time() - t0

    # the first run warms the programs up; the second is timed
    warm = generate(((0, 2), (2, 3)))[0]
    chain, calls, t_pre, t_dec = generate(((0, 2), (2, 3)))
    fused, fused_calls, _, _ = generate(((0, 3),))
    if not (torch.equal(chain, fused) and torch.equal(chain, warm)):
        raise AssertionError("serve_codec: the (0,2)+(2,3) chain's tokens "
                             "differ from the (0,3) program's or its own")
    for name, cs in (("chain", calls), ("fused", fused_calls)):
        bad = [(i, c["encode"], c["decode"]) for i, c in enumerate(cs)
               if (c["encode"], c["decode"]) != (2, 2)]
        if bad:
            raise AssertionError(f"serve_codec: {name} (call, encode, "
                                 f"decode) launches {bad}, want 2 and 2")
    seq = torch.cat([toks, chain[:, :NEW - 1]], 1)

    def stage_errors(c, plant=None):
        """Per stage, the relative error of each decode step's output
        (the wire, or the last stage's hidden state and logits) against
        its recompute, the stages fed the same input sequence; with
        ``plant``, a fault planted in every stage's caches (:func:`_plant`)
        after its prompt's prefill."""
        out = {"stages": [], "logits": []}
        with torch.inference_mode():
            X = seq
            for s in range(3):
                pre = _make_stage_prefill(c, s, 3, "bottleneck", True)
                dec = _make_stage_decode(c, s, 3, "bottleneck", True)
                Y, _ = pre(params[s], X, total)
                _, cache = pre(params[s], X[:, :PROMPT], total)
                if plant:
                    _plant(cache, plant)
                errs = []
                for i in range(NEW - 1):
                    t = PROMPT + i
                    y, _ = dec(params[s], cache, X[:, t:t + 1], t)
                    errs.append(_rel(y, Y[:, t:t + 1]))
                    if s == 2:
                        out["logits"].append(_rel(
                            _head_logits(c, params[2], y),
                            _head_logits(c, params[2], Y[:, t:t + 1])))
                out["stages"].append(errs)
                del cache
                X = Y
        return out

    def worst(errs) -> list:
        """Each stage's largest error (the logits' with the last's)."""
        w = [max(e) for e in errs["stages"]]
        w[-1] = max(w[-1], max(errs["logits"]))
        return w

    errs16 = stage_errors(cfg)
    c16 = cfg.with_overrides(n_layers=6)
    c32 = cfg.with_overrides(compute_dtype="float32")
    c32_6 = c32.with_overrides(n_layers=6)
    checks = {}
    for name, c, rtol in (("bf16", c16, CODEC_RTOL_BF16),
                          ("f32", c32_6, CODEC_RTOL_F32)):
        sound = stage_errors(c)
        checks[name] = {"rtol": rtol, "sound": sound,
                        "sound_worst": worst(sound),
                        "apps_planted_worst": worst(stage_errors(c, "apps")),
                        "row_planted_worst": worst(stage_errors(c, "row"))}
        if max(worst(sound)) > rtol:
            raise AssertionError(f"serve_codec: {name} decode steps vs "
                                 f"recompute {sound}, bound {rtol}")
        for plant in ("apps", "row"):
            got = checks[name][f"{plant}_planted_worst"]
            if min(got) <= rtol:
                raise AssertionError(f"serve_codec: the {name} bound {rtol} "
                                     f"misses a planted fault ({plant}): "
                                     f"{got}")
    # the conditioning of the full depth: the same f32 prefill, batch 2
    # against batch 1 (the library picks other GEMM kernels)
    with torch.inference_mode():
        a, b = seq, seq[:1]
        for s in range(3):
            pre = _make_stage_prefill(c32, s, 3, "bottleneck", True)
            a, _ = pre(params[s], a, total)
            b, _ = pre(params[s], b, total)
        spread = _rel(_head_logits(c32, params[2], a[:1, -1:]),
                      _head_logits(c32, params[2], b[:, -1:]))
    B = MAX_BATCH
    row = {"phase": "serve_codec", "arch": cfg.name, "codec": "bottleneck",
           "spans": [[0, 2], [2, 3]], "tokens_identical_to": "(0,3)",
           "launches_per_call": {"encode": 2, "decode": 2},
           "launches": calls[1],
           "rtol_bf16": CODEC_RTOL_BF16, "rtol_f32": CODEC_RTOL_F32,
           "two_applications": checks,
           "bf16_full_depth_stage_rel_err": errs16["stages"],
           "bf16_full_depth_logits_rel_err": errs16["logits"],
           "rounding_spread_f32": spread,
           "prefill_tokens_per_s": B * PROMPT / t_pre, "prefill_s": t_pre,
           "decode_ms_per_token": t_dec / (NEW - 1) * 1e3,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9}
    emit(row)
    del params, progs, a, b, warm
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


# train_rollback's depth: swarm-1b-bottleneck's three shared groups
# applied twice each, not 16 times.  The groups hold every parameter, so
# the checkpoint cuts keep their full size (14.8 GB); only the compute
# between them shrinks, to keep chip_smoke.py inside its time limit.
ROLLBACK_LAYERS = 6


def phase_train_rollback(torch) -> dict:
    """Checkpoints every 2 steps, 4 steps: during step 4 stage 1's only
    peer dies and its replacement finds no donor, so the whole pipeline
    rolls back to the step-2 cut and replays steps 3 and 4; then a new
    runner cold-starts on the same directory (step 4) and trains step 5.
    Losses equal the staged reference's (five steps of the same config),
    bit for bit.  The directory is a fresh one under ``build/``
    (gitignored), removed at the end."""
    import shutil
    import tempfile
    from repro_torch.models import flops as F
    cfg = swarm1b().with_overrides(n_layers=ROLLBACK_LAYERS)
    ref = train_reference(torch, cfg, 5)
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
        row = {"phase": "train_rollback", "arch": cfg.name,
               "layers": cfg.n_layers, "steps": 4,
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
# ------------------------------------------------------ whisper phases
# whisper-large-v3 at full width and depth (32 encoder and 32 decoder
# layers, d 1280, 20 heads of 64), f32 weights from seed 0: served at
# batch 2 of 1,500 audio frames (a 30 s window from the stub frontend)
# with a 224-token decoder prompt (previous-text conditioning at half of
# the 448-token text context) and 32 greedy tokens; trained at seq 448
# over 3 stages (the encoder pod, 2 decoder stages of 16 layers)
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_NEW = 2, 224, 32
WHISPER_SEQ, WHISPER_GB, WHISPER_STEPS, WHISPER_INT8_STEPS = 448, 8, 3, 2
# a decode step's logits against the no-cache recompute, relative to the
# recompute's largest logit, with the first WHISPER_CHECK_LAYERS decoder
# layers (every encoder layer; full width, the same weights), bounded in
# the f32 twin: a run's worst step within the bound, and a run with
# either planted cache fault beyond it.  The served bf16 path is
# reported beside it, not bounded.  The random weights' attention is
# saturated (JAX's init draws wq / wk at std 1/sqrt(n_heads): logits of
# std ~60), so one rounding difference can pick another argmax key: two
# f32 prefills of 224 and 255 tokens disagree at the same position by
# O(1) at full depth, and bf16 rounding alone moves two decoder layers'
# logits 0.35 where a zeroed self-KV row moves them 0.90 (PERF.md, §6)
WHISPER_RTOL = 1e-3
WHISPER_CHECK_LAYERS = 2
# the int8 wire's first loss beside the plain wire's, relative
WHISPER_INT8_STEP1_RTOL = 1e-2


@contextlib.contextmanager
def plain_flash_calls():
    """Count the calls of the plain flash forward made from
    ``models/flash.py``: on the card each is a call the kernel should
    have taken."""
    from repro_torch.models import flash as flash_lib
    calls: list = []
    orig = flash_lib.flash_fwd_ref

    def counted(q, k, *args, **kw):
        calls.append((tuple(q.shape), tuple(k.shape)))
        return orig(q, k, *args, **kw)
    flash_lib.flash_fwd_ref = counted
    try:
        yield calls
    finally:
        flash_lib.flash_fwd_ref = orig


def _plant_whisper(caches, kind: str) -> None:
    """Plant a fault in whisper's decode caches in place: ``"cross"``
    swaps the two requests' cross K/V, ``"row"`` zeroes the newest
    prompt row of the self-KV ring in every layer."""
    from repro_torch.tree import tree_leaves
    if kind == "cross":
        for leaf in tree_leaves(caches["cross"]):       # [L, B, F, H, hd]
            leaf.copy_(leaf.roll(1, 1))
    else:
        for leaf in tree_leaves(caches["self"]):        # [L, B, T, H, hd]
            leaf[:, :, WHISPER_PROMPT - 1] = 0


def phase_serve_whisper(torch) -> dict:
    """whisper-large-v3 served through ``make_prefill_step`` /
    ``make_serve_step``: greedy tokens, prefill and decode times (the
    median of ``RATE_RUNS``), 3 x 32 flash launches a prefill and none a
    decode step, no plain flash call; every decode step's logits against
    the no-cache recompute (``whisper_prefill`` over prompt + generated,
    every position), teacher-forced with the served tokens, in bf16 and
    an f32 twin, with the first ``WHISPER_CHECK_LAYERS`` decoder layers:
    the f32 twin within ``WHISPER_RTOL`` and the bound shown to reject
    two planted cache faults (``_plant_whisper``); bf16, and both at
    full depth, reported."""
    import statistics
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import params as P
    from repro_torch.models import whisper as W
    from repro_torch.train.steps import make_prefill_step, make_serve_step
    from repro_torch.tree import tree_map
    cfg = get_config("whisper-large-v3")
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.time()
    params = P.init(0, W.whisper_specs(cfg), "cuda")
    B, T, N = WHISPER_BATCH, WHISPER_PROMPT, WHISPER_NEW
    total = T + N
    gen = torch.Generator(device="cuda").manual_seed(3)
    audio = torch.randn(B, cfg.encoder_max_len, cfg.d_model, generator=gen,
                        device="cuda").to(cfg.compute_jdtype)
    prompt = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                           device="cuda", dtype=torch.int32)

    def generate():
        """(tokens [B, N], prefill s, decode s, launches of the prefill,
        of the decode steps, plain flash calls)."""
        pre = make_prefill_step(cfg, cache_len=total)
        step = make_serve_step(cfg)
        with torch.inference_mode(), plain_flash_calls() as plain:
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.time()
            nxt, caches = pre(params, {"audio_embed": audio,
                                       "tokens": prompt})
            torch.cuda.synchronize()
            t_pre, l_pre = time.time() - t0, dict(kernels.LAUNCHES)
            kernels.reset_launches()
            out = [nxt]
            t0 = time.time()
            for i in range(N - 1):
                nxt, caches = step(params, caches, nxt, T + i)
                out.append(nxt)
            torch.cuda.synchronize()
            return (torch.cat(out, 1), t_pre, time.time() - t0, l_pre,
                    dict(kernels.LAUNCHES), len(plain))

    # per prefill: the encoder's self-attention a layer, the decoder's
    # self- and cross-attention a layer (3 x 32)
    per_prefill = cfg.encoder_layers + 2 * cfg.n_layers
    runs = [generate() for _ in range(RATE_RUNS)]
    toks = runs[0][0]
    for i, r in enumerate(runs):
        if not torch.equal(r[0], toks):
            raise AssertionError(f"serve_whisper: run {i}'s tokens differ")
        if r[3]["flash_attention_fwd"] != per_prefill or \
                r[4]["flash_attention_fwd"] != 0 or r[5]:
            raise AssertionError(
                f"serve_whisper: flash launches {r[3]['flash_attention_fwd']}"
                f" a prefill (want {per_prefill}), "
                f"{r[4]['flash_attention_fwd']} in the decode steps (want "
                f"0), {r[5]} plain calls (want 0)")
    if toks.shape != (B, N) or int(toks.min()) < 0 or \
            int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"serve_whisper: tokens {toks.shape}")
    peak_served = torch.cuda.max_memory_allocated() / 1e9

    def errors(c, aud, plant=None, depth=None) -> list:
        """The relative error of the prefill's logits and of each decode
        step's against the recompute, the steps fed the served tokens,
        with the first ``depth`` decoder layers (None: all); with
        ``plant``, a fault planted after the prefill."""
        p = params
        if depth is not None:
            c = c.with_overrides(n_layers=depth)
            p = {**params, "dec_blocks": tree_map(lambda a: a[:depth],
                                                  params["dec_blocks"])}
        seq = torch.cat([prompt, toks[:, :N - 1]], 1)
        with torch.inference_mode(), plain_flash_calls() as plain:
            ref, _ = W.whisper_prefill(c, p, {"audio_embed": aud,
                                              "tokens": seq},
                                       last_only=False)
            logits, caches = W.whisper_prefill(
                c, p, {"audio_embed": aud, "tokens": prompt},
                cache_len=total)
            if not bool(torch.isfinite(ref).all()):
                raise AssertionError("serve_whisper: non-finite logits")
            errs = [_rel(logits[:, -1], ref[:, T - 1])]
            if plant:
                _plant_whisper(caches, plant)
            for i in range(N - 1):
                lg, caches = W.whisper_decode_step(
                    c, p, toks[:, i:i + 1], caches, T + i)
                errs.append(_rel(lg[:, 0], ref[:, T + i]))
        if plain:
            raise AssertionError(f"serve_whisper: plain flash calls {plain}")
        return errs

    checks, failed = {}, []
    depth = WHISPER_CHECK_LAYERS
    for name, c, aud in (
            ("bfloat16", cfg, audio),
            ("float32", cfg.with_overrides(compute_dtype="float32"),
             audio.float())):
        sound = errors(c, aud, depth=depth)
        planted = {k: errors(c, aud, k, depth)[1:] for k in ("cross", "row")}
        full = errors(c, aud)
        checks[name] = {"decoder_layers": depth,
                        "sound": sound, "sound_worst": max(sound),
                        **{f"{k}_planted": v for k, v in planted.items()},
                        **{f"{k}_planted_worst": max(v)
                           for k, v in planted.items()},
                        "full_depth_sound": full,
                        "full_depth_prefill_vs_recompute": full[0]}
    f32 = checks["float32"]
    f32["rtol"] = WHISPER_RTOL
    if f32["sound_worst"] > WHISPER_RTOL:
        failed.append(f"f32 decode steps vs recompute {f32['sound_worst']}"
                      f" > bound {WHISPER_RTOL}")
    failed += [f"the f32 bound {WHISPER_RTOL} misses a planted fault ({k}):"
               f" {f32[f'{k}_planted_worst']}" for k in ("cross", "row")
               if f32[f"{k}_planted_worst"] <= WHISPER_RTOL]
    row = {"phase": "serve_whisper", "arch": cfg.name,
           "n_layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
           "params": P.n_params(W.whisper_specs(cfg)),
           "param_dtype": cfg.param_dtype, "batch": B,
           "audio_frames": cfg.encoder_max_len, "prompt": T, "new": N,
           "tokens": toks.tolist(),
           "launches_per_prefill": runs[0][3],
           "launches_per_decode_run": runs[0][4],
           "plain_flash_calls": 0, "checks": checks,
           "prefill_ms": statistics.median(r[1] for r in runs) * 1e3,
           "prefill_ms_runs": [r[1] * 1e3 for r in runs],
           "decode_ms_per_step": statistics.median(r[2] for r in runs)
           / (N - 1) * 1e3,
           "decode_ms_per_step_runs": [r[2] / (N - 1) * 1e3 for r in runs],
           "max_memory_allocated_gb_served": peak_served,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9,
           "seconds": time.time() - t_phase, "failed": failed}
    emit(row)
    del params, audio, prompt, runs
    free(torch)
    if failed:
        raise AssertionError(f"serve_whisper: {failed}")
    return row


def whisper_data(torch, cfg):
    """The whisper training phases' ``data_fn``: microbatch ``i``'s audio
    frames (the compute dtype, as the frontend stub hands them), tokens
    and labels, drawn on the card from a generator seeded with ``i``, so
    a re-issued microbatch gets the same data."""
    def data_fn(i: int) -> dict:
        g = torch.Generator(device="cuda").manual_seed(5000 + int(i))
        B, S = WHISPER_BATCH, WHISPER_SEQ
        audio = torch.randn(B, cfg.encoder_max_len, cfg.d_model,
                            generator=g, device="cuda").to(
                                cfg.compute_jdtype)
        tok = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                            device="cuda", dtype=torch.int32)
        lab = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                            device="cuda", dtype=torch.int32)
        return {"tokens": {"audio": audio, "tok": tok}, "labels": lab}
    return data_fn


def _kill_and_join(runner, stage: int):
    """Sim process: kill a peer of ``stage`` holding gradients of the
    round (``_kill_holder``), then warm-join a replacement on it."""
    yield from _kill_holder(runner, stage)
    yield from runner._join_new_peer(span=range(stage, stage + 1))


def _whisper_swarm(torch, cfg, data_fn, name: str, steps: int, peers,
                   codec: str = "none", kill: bool = False) -> dict:
    """Train whisper ``steps`` steps with ``SwarmRunner`` over 3 stages
    (counters zeroed just before); every (stage, microbatch) admitted
    exactly once per round.  Returns the phase's row (not emitted)."""
    from repro_torch import kernels
    from repro_torch.core.swarm import SwarmConfig, SwarmRunner
    from repro_torch.models.params import to_numpy_tree
    free(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runner = SwarmRunner(cfg, SwarmConfig(
        n_stages=3, microbatch_size=WHISPER_BATCH, seq_len=WHISPER_SEQ,
        global_batch=WHISPER_GB, n_trainers=2, rebalance_period=0.0,
        codec=codec, max_steps=steps), train_opt(), seed=0,
        data_fn=data_fn, record_accumulation=True, device="cuda")
    runner.build(peers)
    # the peers now hold the step-0 state; the runner's own reference to
    # it (what a stage restores when it loses every peer and finds no
    # checkpoint) moves to host memory, where ``_ckpt_snapshot`` installs
    # it from as from a checkpoint: on the card it would keep 19.2 GB of
    # step-0 weights and AdamW moments beside the trained state from the
    # first step on
    runner._ref_params = [to_numpy_tree(p) for p in runner._ref_params]
    runner._ref_opt = [to_numpy_tree(o) for o in runner._ref_opt]
    if kill:
        runner.sim.spawn(_kill_and_join(runner, 1))
    torch.cuda.synchronize()
    kernels.reset_launches()
    with plain_flash_calls() as plain:
        t0 = time.time()
        m = runner.run(until=1e9)
        torch.cuda.synchronize()
        wall = time.time() - t0
    barriers = _exactly_once(runner)
    if barriers != steps or runner._inflight or any(
            runner.ledger.stage_counts()):
        raise AssertionError(f"{name}: ledger not drained ({barriers} "
                             f"barriers, {runner.ledger.stage_counts()})")
    if plain:
        raise AssertionError(f"{name}: plain flash calls {plain[:4]}")
    got = m["loss"]
    if len(got) != steps or not all(math.isfinite(v) for v in got):
        raise AssertionError(f"{name}: losses {got}")
    row = {"phase": name, "arch": cfg.name, "codec": codec, "steps": steps,
           "losses": got, "launches": dict(kernels.LAUNCHES),
           "plain_flash_calls": 0, "wall_s": wall,
           "tokens_per_s": steps * WHISPER_GB * WHISPER_SEQ / wall,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9,
           "failures": m["failures"], "joins": m["joins"],
           "recomputed_microbatches": m["recomputed_microbatches"],
           "wire_bytes": m["wire_bytes"],
           "barriers_exactly_once": barriers,
           "peers_per_stage": [len(runner._covering(s))
                               for s in range(runner.n_stages)]}
    del runner, m
    free(torch)
    return row


def phase_train_whisper(torch) -> dict:
    """whisper-large-v3 trained by ``SwarmRunner`` (AdamW, seq 448,
    microbatch 2, global batch 8): losses against the staged reference
    on the same card, weights and data within ``train``'s bounds, 2 x 96
    flash launches a microbatch (forward, recompute) and no plain call;
    then a second stage-1 peer that dies holding gradients and a warm
    join, losses equal to the fault-free run's to the bit; then the int8
    wire, one QDQ launch per float leaf of every boundary tree crossed
    (``enc``; ``x`` and ``enc``; back the same), ``tok`` passing
    through."""
    from repro_torch.configs import get_config
    from repro_torch.runtime import build_stage_programs
    from repro_torch.train.reference import reference_losses
    cfg = get_config("whisper-large-v3")
    data_fn = whisper_data(torch, cfg)
    t_phase = time.time()
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    progs = build_stage_programs(cfg, 3, WHISPER_SEQ, "none")
    t0 = time.time()
    want = _counted(torch, lambda: reference_losses(
        cfg, progs, train_opt(), 0, WHISPER_STEPS, WHISPER_SEQ,
        WHISPER_BATCH, WHISPER_GB, data_fn=data_fn, device="cuda"))
    ref = {"reference_losses": want, "reference_s": time.time() - t0,
           "reference_max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9}
    del progs
    free(torch)
    mbs = WHISPER_GB // WHISPER_BATCH
    plain = _whisper_swarm(torch, cfg, data_fn, "train_whisper",
                           WHISPER_STEPS, 1)
    diff = _check_losses("train_whisper", plain["losses"], want)
    # a microbatch's forward and its recompute, each the prefill's calls
    per_step = 2 * (cfg.encoder_layers + 2 * cfg.n_layers) * mbs
    if plain["launches"]["flash_attention_fwd"] != per_step * WHISPER_STEPS:
        raise AssertionError(f"train_whisper: flash launches "
                             f"{plain['launches']['flash_attention_fwd']},"
                             f" want {per_step} a step")
    plain.update(ref, max_abs_loss_diff=diff,
                 step1_rel_diff=abs(plain["losses"][0] - want[0])
                 / abs(want[0]), flash_launches_per_step=per_step)
    emit(plain)
    churn = _whisper_swarm(torch, cfg, data_fn, "train_whisper_churn",
                           WHISPER_STEPS, [1, 2, 1], kill=True)
    if churn["losses"] != plain["losses"]:
        raise AssertionError(f"train_whisper_churn: losses "
                             f"{churn['losses']} differ from "
                             f"{plain['losses']}")
    if not (churn["failures"] == 1 and churn["joins"] == 1
            and churn["recomputed_microbatches"] >= 1):
        raise AssertionError(f"train_whisper_churn: no peer died holding "
                             f"gradients and rejoined: {churn}")
    emit(churn)
    q = _whisper_swarm(torch, cfg, data_fn, "train_whisper_int8",
                       WHISPER_INT8_STEPS, 1, codec="int8")
    # forward: {enc} out of stage 0, {x, enc} out of stage 1; backward
    # the cotangents {x, enc} into stage 1 and {enc} into stage 0
    want_q = 6 * mbs * WHISPER_INT8_STEPS
    step1 = abs(q["losses"][0] - plain["losses"][0]) / abs(plain["losses"][0])
    if q["launches"]["qdq_flat"] != want_q:
        raise AssertionError(f"train_whisper_int8: {q['launches']['qdq_flat']}"
                             f" QDQ launches, want {want_q}")
    if step1 > WHISPER_INT8_STEP1_RTOL:
        raise AssertionError(f"train_whisper_int8: step-1 loss "
                             f"{q['losses'][0]} vs {plain['losses'][0]}")
    q.update(qdq_launches_per_step=want_q // WHISPER_INT8_STEPS,
             plain_wire_losses=plain["losses"][:WHISPER_INT8_STEPS],
             step1_rel_diff_to_plain_wire=step1)
    emit(q)
    emit({"phase": "train_whisper_done", "seconds": time.time() - t_phase})
    return plain


# ------------------------------------------------------------ phase 6d
# the one-process training step on the card: qwen2-vl-2b at full width
# and depth through the launcher, global batch 8 of 512 tokens in 4
# microbatches of 2; swarm-1b against the staged reference at the
# ``train`` phase's shapes
SINGLE_ARCH, SINGLE_BATCH, SINGLE_SEQ = "qwen2-vl-2b", 8, 512
SINGLE_ARGS = ["--arch", SINGLE_ARCH, "--batch", str(SINGLE_BATCH),
               "--seq", str(SINGLE_SEQ), "--lr", "1e-4"]
SINGLE_ACCUM, SINGLE_STEPS = 4, 4
# the checkpoint cut and resume run at this depth (of 28 layers): the
# equal-to-the-bit check does not need the full model's 18.5 GB cut
SINGLE_CUT_LAYERS = 4


@contextlib.contextmanager
def _depth(n: int):
    """``launch.train``'s architectures cut to their first ``n``
    layers."""
    from repro_torch.launch import train as launch_train
    orig = launch_train.get_config
    launch_train.get_config = lambda a: orig(a).with_overrides(n_layers=n)
    try:
        yield
    finally:
        launch_train.get_config = orig
# accum 1 against accum 4.  At full depth in bf16 the step-1 losses are
# equal to the bit and held at the first bound; step 2 is reported: the
# microbatches' weight gradients round to bf16 apart (the accumulated
# gradient lies a few % from the whole batch's, as accum 2's witness
# does), and AdamW's sign-like first step moves every element by about
# lr whatever its size.  Both bounds hold an f32 twin at 2 layers, where
# the difference is f32 rounding; with depth the random weights amplify
# it (the twin at 4 layers is reported: PERF.md, §6)
ACCUM_STEP1_RTOL, ACCUM_STEP2_RTOL = 1e-6, 1e-4
ACCUM_TWIN_LAYERS = 2
# swarm-1b against the staged reference is held with every wq / wk
# scaled by this (as the CPU trajectory tests scale them): at JAX's init
# the attention saturates, the one-process mean and the staged token
# sums then give gradients that differ by far more than rounding, and
# the JAX-init run is reported beside it (PERF.md, §6)
SWARM_ATTN_SCALE = 0.3


def remat_launches(cfg, mode: str, accum: int) -> dict:
    """Flash and rmsnorm launches a training step: each layer's forward
    once, again in a ``block`` checkpoint's recompute, and under
    ``2level`` also in its group's recompute, except the group's last
    layer, which nothing saved in the group needs (a non-reentrant
    checkpoint stops its recompute once it has what backward reads).
    Two norms a layer and the final norm, flash once a layer."""
    from repro_torch.models.model import _sqrt_divisor
    L = cfg.n_layers
    passes = {"none": L, "block": 2 * L}
    n1 = _sqrt_divisor(L)
    passes["2level"] = 2 * L + n1 * (L // n1 - 1)
    flash = passes[mode]
    return {"flash_attention_fwd": accum * flash,
            "rmsnorm": accum * (2 * flash + 1)}


def _single_run(torch, argv: list, name: str, cfg, keep_state=False):
    """One ``repro_torch.launch.train`` run on the card (``main``, or
    ``run`` where the final state is kept), launch counters set to 0 just
    before and read just after, no plain flash call.  Returns (row, final
    state or None)."""
    from repro_torch import kernels
    from repro_torch.launch import train as launch_train
    free(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    args = launch_train.parse_args(argv)
    kernels.reset_launches()
    with plain_flash_calls() as plain:
        t0 = time.time()
        if keep_state:
            losses, summary, state = launch_train.run(args)
        else:
            (losses, summary), state = launch_train.main(argv), None
        torch.cuda.synchronize()
        wall = time.time() - t0
    if plain:
        raise AssertionError(f"{name}: plain flash calls {plain[:4]}")
    steps = len(losses)
    per_step = {k: v / steps for k, v in kernels.LAUNCHES.items() if v}
    want = remat_launches(cfg, args.remat, args.accum)
    if per_step != want:
        raise AssertionError(f"{name}: launches a step {per_step}, "
                             f"want {want}")
    row = {"phase": name, "arch": cfg.name, "argv": argv,
           "losses": losses, "launches_per_step": per_step,
           "plain_flash_calls": 0, "wall_s": wall,
           "step_seconds": summary["step_seconds"],
           "tokens_per_s": summary["tokens_per_s"],
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9}
    return row, state


def _bits_differ(torch, got, want) -> list:
    """Leaf indices where two trees of f32 tensors differ in any bit."""
    from repro_torch.tree import tree_leaves
    return [i for i, (a, b) in enumerate(zip(tree_leaves(got),
                                              tree_leaves(want)))
            if not torch.equal(a.view(torch.int32), b.view(torch.int32))]


def _capture_opt(store: list):
    """An optimizer that keeps the gradients it is handed and returns
    zero updates: the step's accumulated gradients, read through the
    entry points that compute them."""
    from repro_torch.optim.adamw import Optimizer
    from repro_torch.tree import tree_map

    def update(grads, state, params):
        store.append(grads)
        return tree_map(lambda p: p.new_zeros(p.shape), params), state
    return Optimizer(lambda params: {}, update)


def _grad_gap(torch, got: list, want: list) -> dict:
    """Relative L2 distance of two gradient leaf lists, and the share of
    elements above 1e-8 in either whose signs disagree (AdamW's first
    step moves each such element by about lr, whatever its size)."""
    num = den = 0.0
    flips = above = 0
    for a, b in zip(got, want):
        d = a.double() - b.double()
        num += float((d * d).sum())
        den += float((b.double() ** 2).sum())
        m = (a.abs() > 1e-8) | (b.abs() > 1e-8)
        above += int(m.sum())
        flips += int(((torch.sign(a) != torch.sign(b)) & m).sum())
    return {"grad_rel_l2": math.sqrt(num / den),
            "grad_sign_flip_share": flips / max(above, 1)}


def _swarm_vs_single(torch, attn_scale: float, bounded: bool) -> dict:
    """swarm-1b (3 groups x 16 shared applications, LayerNorm, no
    learned codec) at full width, every attention's wq / wk scaled by
    ``attn_scale``: ``make_train_step`` (accum 4, block remat) from
    ``make_state(seed 0)`` against ``reference_losses`` fed
    ``split_lm_params`` of the same initial params and the same
    microbatches; ``adamw`` without clipping on both sides (SWARM clips
    each stage's own gradients, the plain step the whole model's).
    Also the two sides' step-1 gradients (one-process accumulated mean,
    staged token sums over the token count) leaf by leaf.  ``bounded``:
    the losses are held to ``train``'s bounds."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.runtime import build_stage_programs
    from repro_torch.runtime.stage_model import split_lm_params
    from repro_torch.train.reference import reference_losses
    from repro_torch.train.steps import make_state, make_train_step
    from repro_torch.tree import tree_leaves
    name = f"train_single_swarm_attn{attn_scale:g}"
    cfg = get_config("swarm-1b")
    accum = TRAIN_GB // TRAIN_MB
    data_fn = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_MB, seed=17).batch
    opt = adamw(lr=1e-4, grad_clip=0.0)
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    state = make_state(cfg, opt, 0)
    params0 = state["params"]
    with torch.no_grad():
        for seg in params0["blocks"]:
            for key in ("wq", "wk"):
                seg["attn"][key].mul_(attn_scale)
    device = params0["embed"].device

    def step_batch(k):
        mbs = [data_fn(k * accum + j) for j in range(accum)]
        return {key: torch.cat([m[key] for m in mbs]).to(device)
                for key in ("tokens", "labels")}

    progs = build_stage_programs(cfg, 3, TRAIN_SEQ, "none")
    single, staged = [], []
    make_train_step(cfg, _capture_opt(single), remat="block",
                    accum=accum)(state, step_batch(0))
    _counted(torch, lambda: reference_losses(
        cfg, progs, _capture_opt(staged), 0, 1, TRAIN_SEQ, TRAIN_MB,
        TRAIN_GB, params=split_lm_params(cfg, 3, params0), data_fn=data_fn,
        device="cuda"))
    gap = _grad_gap(torch, [a for t in split_lm_params(cfg, 3, single[0])
                            for a in tree_leaves(t)],
                    [a for t in staged for a in tree_leaves(t)])
    del single, staged
    free(torch)
    step_fn = make_train_step(cfg, opt, remat="block", accum=accum)
    got, step_s = [], []
    with plain_flash_calls() as plain:
        for k in range(TRAIN_STEPS):
            batch = step_batch(k)
            torch.cuda.synchronize()
            t0 = time.time()
            state, m = step_fn(state, batch)
            got.append(float(m["loss"]))
            step_s.append(time.time() - t0)
    if plain:
        raise AssertionError(f"{name}: plain flash {plain[:4]}")
    single_peak = torch.cuda.max_memory_allocated() / 1e9
    del state, m, batch
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    want = _counted(torch, lambda: reference_losses(
        cfg, progs, opt, 0, TRAIN_STEPS, TRAIN_SEQ, TRAIN_MB, TRAIN_GB,
        params=split_lm_params(cfg, 3, params0), data_fn=data_fn,
        device="cuda"))
    torch.cuda.synchronize()
    ref_s = time.time() - t0
    tokens = TRAIN_STEPS * TRAIN_GB * TRAIN_SEQ
    row = {"phase": name, "arch": cfg.name, "attn_scale": attn_scale,
           "bounded": bounded, "steps": TRAIN_STEPS, "accum": accum,
           "remat": "block", "losses": got, "reference_losses": want,
           "rel_diff": [abs(a - b) / abs(b) for a, b in zip(got, want)],
           "abs_diff": [abs(a - b) for a, b in zip(got, want)],
           **gap, "step_seconds": step_s,
           "tokens_per_s": tokens / sum(step_s),
           "reference_tokens_per_s": tokens / ref_s,
           "max_memory_allocated_gb": single_peak,
           "reference_max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9}
    del progs, params0
    free(torch)
    if bounded:
        _check_losses(name, got, want)
    return row


def _accum_twin(torch, layers: int) -> dict:
    """``--accum 1`` (and 2, a witness) against ``--accum 4`` in an
    f32-compute twin of qwen2-vl-2b at full width and ``layers`` layers,
    JAX's init, through ``make_state`` / ``make_train_step`` on the
    launcher's batches, two steps each.  Returns the row (not emitted;
    the caller bounds it)."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch.train import step_batch
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_state, make_train_step
    cfg = get_config(SINGLE_ARCH).with_overrides(compute_dtype="float32",
                                                 n_layers=layers)
    ds = SyntheticLM(cfg.vocab_size, SINGLE_SEQ, SINGLE_BATCH, seed=17)
    losses = {}
    for accum in (4, 1, 2):
        opt = adamw(lr=1e-4)
        state = make_state(cfg, opt, 0)
        device = state["params"]["embed"].device
        step_fn = make_train_step(cfg, opt, remat="block", accum=accum)
        losses[accum] = []
        for k in range(2):
            state, m = step_fn(state, step_batch(cfg, ds, k, device))
            losses[accum].append(float(m["loss"]))
        del state, m
        free(torch)
    rel = {a: [abs(x - y) / abs(y) for x, y in zip(losses[a], losses[4])]
           for a in (1, 2)}
    return {"phase": "train_single_accum_twin", "arch": cfg.name,
            "compute_dtype": "float32", "layers": layers,
            "bounded": layers == ACCUM_TWIN_LAYERS, "losses": losses,
            "rel_diff_accum1": rel[1], "rel_diff_accum2_witness": rel[2]}


def phase_train_single(torch) -> dict:
    """The single-process training path (``launch/train.py`` over
    ``train/steps.py``'s ``make_train_step``) on qwen2-vl-2b at full
    width and depth (28 layers, d 1536, 12/2 heads of 128, vocab
    151,936, tied embeddings; f32 weights from seed 0, M-RoPE text
    positions), seq 512, global batch 8, ``--accum 4``, lr 1e-4:
    four steps with finite losses, flash and rmsnorm launches a step
    against ``remat_launches``, no plain flash call; two steps under each
    remat mode with losses and params after step 2 equal to the bit; at
    ``SINGLE_CUT_LAYERS`` layers, a run cut after step 2 and resumed
    from its checkpoint equal to the uninterrupted one to the bit (the
    cuts under ``build/``, removed at the end); ``--accum 1`` (and ``--accum 2``, a witness) against
    ``--accum 4``, step 1 bounded, and both steps bounded in an f32 twin
    at 2 layers (``ACCUM_STEP1_RTOL``'s comment says why); then swarm-1b
    against the staged reference, bounded at ``SWARM_ATTN_SCALE`` and
    reported at JAX's init."""
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.models import flops as F
    cfg = get_config(SINGLE_ARCH)
    t_phase = time.time()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build")
    os.makedirs(root, exist_ok=True)
    # a cut: f32 params and AdamW's two f32 moments
    cut = 12.0 * F.total_params(cfg.with_overrides(
        n_layers=SINGLE_CUT_LAYERS))
    disk, host = shutil.disk_usage(root).free, _mem_available()
    emit({"phase": "train_single_resources", "cut_gb": cut / 1e9,
          "free_disk_gb": disk / 1e9, "mem_available_gb": host / 1e9})
    if disk < 2.2 * cut:          # the step-2 cut and the resumed run's
        raise RuntimeError(f"train_single: {disk / 1e9:.1f} GB free "
                           f"under {root}, need {2.2 * cut / 1e9:.1f}")
    if host < 1.2 * cut:          # one host copy of the state
        raise RuntimeError(f"train_single: {host / 1e9:.1f} GB of host "
                           f"memory available, need {1.2 * cut / 1e9:.1f}")
    base = SINGLE_ARGS + ["--accum", str(SINGLE_ACCUM)]
    main_row, _ = _single_run(torch, base + [
        "--steps", str(SINGLE_STEPS), "--remat", "block"],
        "train_single", cfg)
    full = main_row["losses"]
    emit(main_row)
    block_row, state2 = _single_run(torch, base + [
        "--steps", "2", "--remat", "block"], "train_single_block", cfg,
        keep_state=True)
    params2 = state2["params"]
    del state2
    if block_row["losses"] != full[:2]:
        raise AssertionError(f"train_single_block: losses "
                             f"{block_row['losses']} vs {full[:2]}")
    # the checkpoint cut and resume, at SINGLE_CUT_LAYERS layers
    cut_cfg = cfg.with_overrides(n_layers=SINGLE_CUT_LAYERS)
    ckpt = tempfile.mkdtemp(prefix="ckpt_single_", dir=root)
    try:
        with _depth(SINGLE_CUT_LAYERS):
            short, _ = _single_run(torch, base + [
                "--steps", str(SINGLE_STEPS), "--remat", "block"],
                "train_single_short", cut_cfg)
            cut_row, _ = _single_run(torch, base + [
                "--steps", "2", "--remat", "block", "--ckpt-dir", ckpt],
                "train_single_cut", cut_cfg)
            cut_bytes = sum(os.path.getsize(os.path.join(
                ckpt, "step_00000002", f)) for f in os.listdir(
                    os.path.join(ckpt, "step_00000002")))
            if cut_row["losses"] != short["losses"][:2]:
                raise AssertionError(f"train_single_cut: losses "
                                     f"{cut_row['losses']} vs "
                                     f"{short['losses'][:2]}")
            resumed, _ = _single_run(torch, base + [
                "--steps", str(SINGLE_STEPS), "--remat", "block",
                "--ckpt-dir", ckpt], "train_single_resume", cut_cfg)
            if resumed["losses"] != short["losses"][2:]:
                raise AssertionError(f"train_single_resume: losses "
                                     f"{resumed['losses']} vs "
                                     f"{short['losses'][2:]}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    emit({**resumed, "cut_losses": cut_row["losses"],
          "cut_bytes": cut_bytes, "cut_wall_s": cut_row["wall_s"],
          "uninterrupted_losses": short["losses"][2:],
          "reduced": {"n_layers": [cfg.n_layers, SINGLE_CUT_LAYERS]}})
    modes = {"block": {"losses": block_row["losses"],
                       "launches_per_step": block_row["launches_per_step"],
                       "max_memory_allocated_gb":
                           block_row["max_memory_allocated_gb"],
                       "tokens_per_s": block_row["tokens_per_s"]}}
    for mode in ("none", "2level"):
        row, state = _single_run(torch, base + [
            "--steps", "2", "--remat", mode], f"train_single_{mode}", cfg,
            keep_state=True)
        differ = _bits_differ(torch, state["params"], params2)
        del state
        if row["losses"] != block_row["losses"] or differ:
            raise AssertionError(f"train_single_{mode}: losses "
                                 f"{row['losses']} vs block's "
                                 f"{block_row['losses']}, params differ at "
                                 f"leaves {differ[:8]}")
        modes[mode] = {k: row[k] for k in modes["block"]}
    del params2
    emit({"phase": "train_single_remat", "arch": cfg.name,
          "params_equal_to_the_bit": True, "modes": modes})
    for a in (1, 2):
        row, _ = _single_run(torch, SINGLE_ARGS + [
            "--accum", str(a), "--steps", "2", "--remat", "block"],
            f"train_single_accum{a}", cfg)
        rel = [abs(x - y) / abs(y) for x, y in zip(row["losses"], full[:2])]
        if rel[0] > ACCUM_STEP1_RTOL:
            raise AssertionError(f"train_single_accum{a}: step-1 loss "
                                 f"{row['losses'][0]} vs accum 4's "
                                 f"{full[0]}")
        emit({**row, "accum4_losses": full[:2], "rel_diff": rel})
    for layers in (ACCUM_TWIN_LAYERS, 2 * ACCUM_TWIN_LAYERS):
        row = _accum_twin(torch, layers)
        emit(row)
        rel = row["rel_diff_accum1"]
        if row["bounded"] and (rel[0] > ACCUM_STEP1_RTOL
                               or rel[1] > ACCUM_STEP2_RTOL):
            raise AssertionError(f"train_single_accum_twin: {row}")
    emit(_swarm_vs_single(torch, SWARM_ATTN_SCALE, bounded=True))
    emit(_swarm_vs_single(torch, 1.0, bounded=False))
    emit({"phase": "train_single_done", "seconds": time.time() - t_phase})
    return main_row


# ------------------------------------------------------ phases 22-23
# train_mesh (ii): the microbatch of 2 split 1 + 1 over a virtual 2-way
# mesh changes only the rounding of each microbatch's forward and
# backward.  Step 1's loss is a function of the step-0 weights and that
# forward alone: held to ``train``'s step-1 bound.  Steps 2-3 also carry
# AdamW's response to gradients that differ by rounding, which with
# random full-depth weights reaches 1.05e-2 between two orders of the
# same step (``train_single``'s swarm-1b, unscaled attention, H100 80GB
# HBM3 at 700 W): reported, under a gross-error bound only.  The mesh
# code itself is held in an f32 twin at 2 applications a group, every
# wq / wk scaled by SWARM_ATTN_SCALE (``_scale_attention``): equal to the
# numeric programs run on the same halves within MESH_TWIN_EXACT.  A
# first bound, 1e-4 on the split against the whole microbatch, read
# 5.6e-3 of a gradient leaf's largest entry on the same card: cuBLAS's
# f32 rounding at batch 1 and at batch 2, amplified by the random
# weights, which the twin now reports.
MESH_BOUNDS = (STEP1_RTOL, 5e-2)
MESH_TWIN_EXACT = 1e-6
# train_pipeline: 8 microbatches of 1 x 512 a step, 2 steps; the f32 twins
# (swarm-1b at 2 applications a group, qwen2-vl-2b at one layer a stage,
# both at wq / wk x SWARM_ATTN_SCALE) hold loss and gradients to the
# staged reference: the same computation, the gradient summed over
# microbatches in another order
PIPE_M, PIPE_STEPS = 8, 2
PIPE_TWIN_LOSS_RTOL, PIPE_TWIN_GRAD_RTOL = 1e-5, 1e-4


@contextlib.contextmanager
def mesh_launches():
    """Count the kernel launches made inside the mesh executors' calls
    (their programs and their wire codec), by kernel."""
    from repro_torch import kernels
    from repro_torch.runtime import mesh as mesh_rt
    counts = {k: 0 for k in kernels.LAUNCHES}
    saved = []
    for cls in (mesh_rt.MeshExecutor, mesh_rt.MeshSpanExecutor):
        for name in ("run_fwd", "run_bwd", "wire_fwd", "wire_bwd"):
            orig = getattr(cls, name)

            def counted(self, *a, _orig=orig, **k):
                before = dict(kernels.LAUNCHES)
                try:
                    return _orig(self, *a, **k)
                finally:
                    for key, v in kernels.LAUNCHES.items():
                        counts[key] += v - before[key]
            saved.append((cls, name, cls.__dict__.get(name)))
            setattr(cls, name, counted)
    try:
        yield counts
    finally:
        for cls, name, orig in saved:
            if orig is None:
                delattr(cls, name)
            else:
                setattr(cls, name, orig)


@contextlib.contextmanager
def plain_codec_calls():
    """Count the codec forward wrappers' calls on a tensor off the card
    (each a call the encode or decode kernel should have taken)."""
    from repro_torch.kernels.boundary import kernel as K
    calls: list = []
    orig = (K.encode, K.decode)

    def encode(x, *a, **k):
        if not x.is_cuda:
            calls.append(("encode", tuple(x.shape)))
        return orig[0](x, *a, **k)

    def decode(z, *a, **k):
        if not z.is_cuda:
            calls.append(("decode", tuple(z.shape)))
        return orig[1](z, *a, **k)
    K.encode, K.decode = encode, decode
    try:
        yield calls
    finally:
        K.encode, K.decode = orig


def _card_mesh(torch, n: int, shape=None, axes=("data",)):
    """A mesh listing the card ``n`` times (``make_peer_mesh`` for one
    device: the card itself)."""
    from repro_torch.launch.mesh import make_debug_mesh, make_peer_mesh
    if shape is None and n == 1:
        return make_peer_mesh(1)
    dev = torch.device("cuda", 0)
    return make_debug_mesh(shape or (n,), axes, devices=[dev] * n)


def _mesh_exec(cfg, where, mesh, codec: str = "bottleneck"):
    from repro_torch.runtime import MeshExecutor, MeshSpanExecutor
    if isinstance(where, tuple):
        return MeshSpanExecutor(cfg, 3, TRAIN_SEQ, where, mesh,
                                compress=codec)
    return MeshExecutor(cfg, 3, TRAIN_SEQ, where, mesh, compress=codec)


def _max_gap(torch, got: list, want: list) -> float:
    """The largest leaf's max |got - want| over its max |want|."""
    gap = 0.0
    for a, b in zip(got, want):
        d = float((a.double() - b.double()).abs().max())
        gap = max(gap, d / max(float(b.double().abs().max()), 1e-30))
    return gap


def _scale_attention(torch, trees: list) -> None:
    """Every attention's wq / wk scaled by ``SWARM_ATTN_SCALE`` in place:
    at the init's saturated attention, f32 rounding is amplified, as
    ``train_single`` found; unscaled, ``_mesh_twin``'s split and whole
    microbatch were 1.81 of a gradient leaf's largest entry apart on an
    H100 80GB HBM3 (700 W), at x 0.3 5.6e-3."""
    with torch.no_grad():
        for tree in trees:
            for seg in tree["blocks"]:
                for key in ("wq", "wk"):
                    seg["attn"][key].mul_(SWARM_ATTN_SCALE)


def _mesh_twin(torch) -> dict:
    """swarm-1b-bottleneck at full width, 2 applications a group, f32,
    every wq / wk scaled by ``SWARM_ATTN_SCALE``: one microbatch (2 x
    512) through the three stages (a) on 2-way mesh executors of the
    card (split 1 + 1), (b) on numeric executors run on each half apart,
    losses and gradients added in f64 and cotangents joined — what the
    mesh computes, without the mesh — and (c) on numeric executors over
    the whole microbatch, from one state.  (a) against (b) shows the
    mesh's placement, gathering and reduction exact
    (``MESH_TWIN_EXACT``); (b) against (c) is the split's reduction
    order, reported."""
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.dist.mesh import gather
    from repro_torch.runtime import MeshExecutor, StageState, \
        build_numeric_executors
    from repro_torch.tree import tree_leaves
    cfg = swarm1b().with_overrides(n_layers=6, compute_dtype="float32")
    num = build_numeric_executors(cfg, 3, TRAIN_SEQ)
    sts = [e.init_state(s) for s, e in enumerate(num)]
    _scale_attention(torch, [st.params for st in sts])
    mesh = _card_mesh(torch, 2)
    mex = [MeshExecutor(cfg, 3, TRAIN_SEQ, s, mesh) for s in range(3)]
    msts = []
    for s in range(3):
        st = StageState()
        mex[s].restore(st, {"params": sts[s].params, "opt": None})
        msts.append(st)
    b = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_MB, seed=17).batch(0)
    tok = torch.as_tensor(b["tokens"], device="cuda")
    lab = torch.as_tensor(b["labels"], device="cuda")

    def chain(ex, st, tok, lab):
        xs = [tok]
        for s in range(2):
            xs.append(ex[s].wire_fwd(ex[s].run_fwd(st[s], xs[-1])))
        loss, gx, g2 = ex[2].run_bwd(st[2], xs[2], labels=lab)
        gxs = [ex[2].wire_bwd(gx)]
        _, gx, g1 = ex[1].run_bwd(st[1], xs[1], dy=gxs[0])
        gxs.append(ex[1].wire_bwd(gx))
        _, _, g0 = ex[0].run_bwd(st[0], xs[0], dy=gxs[1])
        return float(loss), gxs, [a for g in (g0, g1, g2)
                                  for a in tree_leaves(g)]

    def split():
        halves = [chain(num, sts, tok[i:i + 1], lab[i:i + 1])
                  for i in range(TRAIN_MB)]
        return (halves[0][0] + halves[1][0],
                [torch.cat([a, b]) for a, b in zip(halves[0][1],
                                                   halves[1][1])],
                [a.double() + b.double() for a, b in zip(halves[0][2],
                                                         halves[1][2])])

    with plain_precision(torch):
        loss_m, gx_m, g_m = _counted(torch, lambda: chain(mex, msts, tok,
                                                          lab))
        g_m = [gather(a, a.mesh.devices.flat[0]) for a in g_m]
        loss_s, gx_s, g_s = _counted(torch, split)
        loss_n, gx_n, g_n = _counted(torch, lambda: chain(num, sts, tok,
                                                          lab))
    row = {"twin": "f32, 2 applications a group, wq / wk x 0.3",
           "dp_shards": mex[1].dp_shards(TRAIN_MB),
           "mesh_vs_split": {
               "loss_abs_diff": abs(loss_m - loss_s),
               "grad_max_gap": _max_gap(torch, g_m, g_s),
               "cotangent_max_gap": _max_gap(torch, gx_m, gx_s)},
           "split_vs_whole": {
               "loss_rel_diff": abs(loss_s - loss_n) / abs(loss_n),
               "grad_max_gap": _max_gap(torch, g_s, g_n),
               "cotangent_max_gap": _max_gap(torch, gx_s, gx_n),
               **_grad_gap(torch, g_s, g_n)}}
    if row["dp_shards"] != 2 or max(row["mesh_vs_split"].values()) > \
            MESH_TWIN_EXACT:
        raise AssertionError(f"train_mesh twin: {row}")
    del num, sts, mex, msts, g_n, g_m, g_s, gx_n, gx_m, gx_s
    free(torch)
    return row


def _mesh_churn(runner, log: list):
    """Sim process: once a mesh peer of stage 1 holds gradients of the
    round, kill it and warm-join it back (the dead peer object is
    revived); once step 1 is done and stage 0 holds gradients again,
    move the span peer [0, 2) to [1, 3)."""
    from repro_torch.core.sim import Sleep
    from repro_torch.runtime import MeshExecutor, MeshSpanExecutor
    while not runner.stopped:
        holders = set(runner.ledger.acc[1].values())
        victim = next((p for p in runner._covering(1)
                       if isinstance(p.executor, MeshExecutor)
                       and p.id in holders), None)
        if victim is not None and not runner.ledger.complete():
            mesh = victim.executor.mesh
            runner._fail_peer(victim)
            yield from runner._join_new_peer(span=range(1, 2))
            log.append({"event": "revived", "peer": victim.id,
                        "alive": victim.alive,
                        "backend": type(victim.executor).__name__,
                        "same_mesh": victim.executor.mesh is mesh})
            break
        yield Sleep(0.01)
    span = next(p for p in runner.peers.values()
                if isinstance(p.executor, MeshSpanExecutor))
    while not runner.stopped and (runner.step < 1 or
                                  not runner.ledger.stage_counts()[0]):
        yield Sleep(0.05)
    if runner.stopped:
        return
    mesh = span.executor.mesh
    yield from runner._migrate(span, range(1, 3))
    log.append({"event": "migrated", "peer": span.id,
                "backend": type(span.executor).__name__,
                "span": [span.stages.start, span.stages.stop],
                "same_mesh": span.executor.mesh is mesh})


def phase_train_mesh(torch, train: dict, ref_losses: list) -> dict:
    """Mesh-backed peers (``MeshExecutor``, ``MeshSpanExecutor``) in
    ``train``'s layout: (i) stage 1's peer on a one-device mesh, equal
    to ``train`` to the bit; (ii) 2-way virtual-mesh peers of the card
    beside a numeric peer at every stage and a mesh span peer on [0, 2),
    the microbatch split 1 + 1, a mesh peer killed mid-step and revived,
    the span peer moved to [1, 3): both still mesh-backed, exactly once,
    the losses against the staged reference (``MESH_BOUNDS``), the split
    bounded in an f32 twin; (iii) a 2-way mesh peer on stage 1 with the
    int8 wire, two QDQ launches of its own a microbatch.  Launches made
    by the mesh peers are counted apart; no plain flash or codec
    call."""
    from repro_torch.models.params import to_numpy_tree
    from repro_torch.runtime import MeshExecutor
    t0 = time.time()
    cfg = swarm1b()
    names: dict = {}       # peer names only: a Peer keeps its runner
    rows = {}

    def require(name: str, counts: dict, plain: list, kernels_: tuple):
        bad = [k for k in kernels_ if counts[k] <= 0]
        if bad or plain:
            raise AssertionError(f"{name}: mesh peers launched no {bad}; "
                                 f"plain calls {plain[:4]}")

    def setup_one(runner):
        names["one"] = runner.add_peer(1, executor=_mesh_exec(
            cfg, 1, _card_mesh(torch, 1))).id

    with mesh_launches() as counts, plain_flash_calls() as pf, \
            plain_codec_calls() as pc:
        def check_one(runner, m):
            ex = runner.peers[names["one"]].executor
            if not isinstance(ex, MeshExecutor) or ex.device_count != 1:
                raise AssertionError(f"train_mesh_one: {type(ex)}")
            require("train_mesh_one", counts, pf + pc,
                    ("flash_attention_fwd", "encode", "decode"))
            return {"mesh_launches": dict(counts), "plain_calls": 0}
        rows["one"] = phase_train(torch, "train_mesh_one", cfg, TRAIN_STEPS,
                                  train["losses"], peers=[1, 0, 1],
                                  exact=True, setup=setup_one,
                                  check=check_one)

    rows["twin"] = _mesh_twin(torch)
    log: list = []

    def setup_two(runner):
        mesh = _card_mesh(torch, 2)
        for s in range(3):
            runner.add_peer(s, executor=_mesh_exec(cfg, s, mesh))
        runner.add_peer(range(0, 2), executor=_mesh_exec(cfg, (0, 2), mesh))
        # every peer now aliases the step-0 state; the runner's own
        # reference moves to the host (see ``_whisper_swarm``)
        runner._ref_params = [to_numpy_tree(p) for p in runner._ref_params]
        runner._ref_opt = [to_numpy_tree(o) for o in runner._ref_opt]
        runner.sim.spawn(_mesh_churn(runner, log))

    with mesh_launches() as counts, plain_flash_calls() as pf, \
            plain_codec_calls() as pc:
        def check_two(runner, m):
            events = {e["event"]: e for e in log}
            rev, mig = events.get("revived"), events.get("migrated")
            if not rev or not mig or rev["backend"] != "MeshExecutor" \
                    or not rev["alive"] or not rev["same_mesh"] \
                    or mig["backend"] != "MeshSpanExecutor" \
                    or mig["span"] != [1, 3] or not mig["same_mesh"] \
                    or (m["failures"], m["joins"], m["migrations"]) != \
                    (1, 1, 1) or m["recomputed_microbatches"] < 1:
                raise AssertionError(f"train_mesh_2way: events {log}, "
                                     f"{m['failures']} failures, "
                                     f"{m['joins']} joins, "
                                     f"{m['migrations']} migrations")
            require("train_mesh_2way", counts, pf + pc,
                    ("flash_attention_fwd", "encode", "decode"))
            return {"events": log, "mesh_launches": dict(counts),
                    "plain_calls": 0, "bounds": list(MESH_BOUNDS),
                    "twin": rows["twin"]}
        rows["two"] = phase_train(torch, "train_mesh_2way", cfg,
                                  TRAIN_STEPS, ref_losses[:TRAIN_STEPS],
                                  peers=[1, 1, 1], setup=setup_two,
                                  check=check_two, bounds=MESH_BOUNDS)

    def setup_int8(runner):
        names["int8"] = runner.add_peer(1, executor=_mesh_exec(
            cfg, 1, _card_mesh(torch, 2), codec="int8")).id

    with mesh_launches() as counts:
        def check_int8(runner, m):
            want = 2 * TRAIN_GB // TRAIN_MB
            if counts["qdq_flat"] != want:
                raise AssertionError(f"train_mesh_int8: the mesh peer made "
                                     f"{counts['qdq_flat']} QDQ launches, "
                                     f"want {want}")
            return {"mesh_launches": dict(counts)}
        # held to the staged reference's step 1 (without a wire codec)
        # only by finiteness: the int8 wire is another function
        rows["int8"] = phase_train(torch, "train_mesh_int8", cfg, 1,
                                   ref_losses[:1], peers=[1, 0, 1],
                                   setup=setup_int8, check=check_int8,
                                   bounds=(math.inf, math.inf),
                                   must=("flash_attention_fwd", "qdq_flat"),
                                   codec="int8")
    emit({"phase": "train_mesh_done", "seconds": time.time() - t0})
    return rows


# ------------------------------------------------------ train_mesh_tp
# tensor-parallel compute over a virtual mesh's ``model`` axis: swarm-1b
# trained TP_STEPS steps (stage 1 on (data 1, model 2), a span peer on
# (2, 2)); yi-6b at full width, one layer a stage over 3 stages, on
# (1, 8).  Splitting a product over heads or FFN columns changes the
# order of its f32 sums (the all-reduce adds the shards' f32 partials),
# as splitting the microbatch changes cuBLAS's (train_mesh's twin): at
# full width, random weights amplify that rounding.  A first probe (H100
# 80GB HBM3, 700.00 W) read, against one-device mesh peers on the same
# state: f32 twins' loss 8.1e-6 (swarm-1b, 2 applications a group) and
# 5.8e-7 (yi-6b) relative, their gradients 5.5e-3 and 1.1e-3 of a leaf's
# largest entry (the CPU tests' 1e-5 holds at their widths; at d 1024 on
# the CPU, 2.8e-4); bf16 training's step-1 loss 1.9e-4 relative to the
# staged reference (the data split's 1e-5 bound holds there because rows
# keep their sums).  Bounds: the f32 twins' loss at the CPU tests' 1e-5,
# their gradients and cotangents at 1e-2; training at 1e-3 on step 1,
# MESH_BOUNDS' 5e-2 later
TP_STEPS = 2
TP_TWIN_LOSS_RTOL, TP_TWIN_GRAD_RTOL = 1e-5, 1e-2
TP_BOUNDS = (1e-3, MESH_BOUNDS[1])
TP_YI_LAYERS, TP_YI_MODEL = 3, 8


@contextlib.contextmanager
def coord_launches():
    """Kernel launches by the mesh coordinate they ran as
    (``dist.mesh.at``; the tensor-parallel shards' scopes), while the
    global counters go on as before."""
    import collections
    from repro_torch import kernels
    from repro_torch.dist.mesh import current_coord
    per: dict = collections.defaultdict(collections.Counter)

    class ByCoord(dict):
        def __setitem__(self, k, v):
            c = current_coord()
            if c is not None:
                per[c][k] += v - self.get(k, 0)
            super().__setitem__(k, v)
    orig = kernels.LAUNCHES
    kernels.LAUNCHES = ByCoord(orig)
    try:
        yield per
    finally:
        orig.update(kernels.LAUNCHES)
        kernels.LAUNCHES = orig


def _tp_mesh(torch, shape):
    return _card_mesh(torch, shape[0] * shape[1], shape, ("data", "model"))


def _tp_bytes(ex, state, name: str = "train_mesh_tp") -> list:
    """Each model coordinate of every data shard: the bytes of the params
    it gathered beside those ``block_bytes`` reckons; raises unless
    equal."""
    from repro_torch.dist import tensor_parallel as tp
    from repro_torch.tree import tree_leaves
    specs = ex.prog.specs
    stages = list(ex.stages) if isinstance(ex.param_shardings, dict) \
        and all(isinstance(k, int) for k in ex.param_shardings) else None
    rows = []
    n = int(ex.mesh.shape.get("data", 1))
    for i in range(n):
        data = i if ex.slices_experts(n) else None
        ms = ex._model_shards(state, i, data)
        for j, tree in enumerate(ms.trees):
            got = sum(a.numel() * a.element_size()
                      for a in tree_leaves(tree))
            want = (sum(tp.block_bytes(specs[s], ex.param_shardings[s], j,
                                       data) for s in stages) if stages
                    else tp.block_bytes(specs, ex.param_shardings, j,
                                        data))
            rows.append({"coord": list(ms.group.coords[j]),
                         "gathered_bytes": got, "reckoned_bytes": want})
        del ms
    if any(r["gathered_bytes"] != r["reckoned_bytes"] for r in rows):
        raise AssertionError(f"{name}: gathered bytes {rows}")
    return rows


def _tp_require(name: str, per: dict, coords: list, kernels_: tuple,
                plain: list) -> dict:
    """Every one of ``kernels_`` launched on each coordinate, no plain
    call; returns the launches by coordinate."""
    bad = [(c, k) for c in coords for k in kernels_ if per[c][k] <= 0]
    if bad or plain:
        raise AssertionError(f"{name}: no launch of {bad[:6]} on those "
                             f"model shards; plain calls {plain[:4]}")
    return {str(list(c)): dict(per[c]) for c in coords}


def _tp_chain(torch, ex, st, tok, lab):
    """One microbatch through a chain of stage executors: every stage's
    forward, then every backward; ``(loss, cotangents, grads)``."""
    from repro_torch.dist.mesh import gather
    from repro_torch.tree import tree_leaves
    xs = [tok]
    for s in range(len(ex) - 1):
        xs.append(ex[s].wire_fwd(ex[s].run_fwd(st[s], xs[-1])))
    loss, gx, g = ex[-1].run_bwd(st[-1], xs[-1], labels=lab)
    gxs, grads = [gx], [tree_leaves(g)]
    for s in reversed(range(len(ex) - 1)):
        _, gx, g = ex[s].run_bwd(st[s], xs[s], dy=ex[s + 1].wire_bwd(gxs[-1]))
        gxs.append(gx)
        grads.insert(0, tree_leaves(g))
    flat = [gather(a, a.mesh.devices.flat[0]) for g in grads for a in g]
    return float(loss), [g for g in gxs if g is not None], flat


def _tp_pair(torch, cfg, n_stages: int, shape, tok, lab, codec="none",
             scale=True):
    """Every stage of ``cfg`` on a one-device mesh and on a ``shape``
    ("data", "model") mesh of the card, from one state (``wq`` / ``wk``
    scaled by ``SWARM_ATTN_SCALE`` where ``scale``): one microbatch
    through each chain, the tensor-parallel one under launch and
    all-reduce counters.  Returns (row, one-device result,
    tensor-parallel result), each ``(loss, cotangents, grads)``."""
    from repro_torch.dist import tensor_parallel as tp
    from repro_torch.runtime import MeshExecutor, StageState
    one = [MeshExecutor(cfg, n_stages, TRAIN_SEQ, s, _card_mesh(torch, 1),
                        compress=codec) for s in range(n_stages)]
    mesh = _tp_mesh(torch, shape)
    tpx = [MeshExecutor(cfg, n_stages, TRAIN_SEQ, s, mesh, compress=codec)
           for s in range(n_stages)]
    st1 = [e.init_state(s) for s, e in enumerate(one)]
    if scale:
        from repro_torch.dist.mesh import Placed
        with torch.no_grad():
            for st in st1:
                for seg in st.params["blocks"]:
                    for key in ("wq", "wk"):
                        p = seg["attn"][key]
                        for t in p.shards.flat if isinstance(p, Placed) \
                                else [p]:
                            t.mul_(SWARM_ATTN_SCALE)
    stp = []
    for s in range(n_stages):
        st = StageState()
        tpx[s].restore(st, one[s].snapshot(st1[s]))
        stp.append(st)
    if {e.compute_path for e in tpx} != {"tensor_parallel"}:
        raise AssertionError(f"train_mesh_tp: paths "
                             f"{[e.compute_path for e in tpx]}")
    bytes_rows = [_tp_bytes(e, st) for e, st in zip(tpx, stp)]
    got_one = _counted(torch, lambda: _tp_chain(torch, one, st1, tok, lab))
    tp.ALL_REDUCES.clear()
    with coord_launches() as per, plain_flash_calls() as pf, \
            plain_codec_calls() as pc:
        got_tp = _counted(torch, lambda: _tp_chain(torch, tpx, stp, tok,
                                                    lab))
    apps = [sum(n * sp.reps for _, n in sp.runs)
            for sp in one[0].plan.stages]
    row = {"mesh": list(shape), "paths": [e.compute_path for e in tpx],
           "gathered_bytes_by_stage": bytes_rows,
           "all_reduces": dict(tp.ALL_REDUCES),
           # two a layer application forward: in every stage's forward
           # but the last's (the chain's last stage runs its backward
           # only) and again in every backward's recompute
           "activation_all_reduces_planned": 2 * (2 * sum(apps)
                                                  - apps[-1]),
           "launches_by_coord": _tp_require(
               "train_mesh_tp", per, mesh.coords(),
               ("flash_attention_fwd",)
               + (("rmsnorm",) if cfg.norm == "rmsnorm" else ()), pf + pc)}
    if row["all_reduces"].get("activation") != \
            row["activation_all_reduces_planned"]:
        raise AssertionError(f"train_mesh_tp: all-reduces {row}")
    del one, tpx, st1, stp
    return row, got_one, got_tp


def _tp_gaps(torch, a, b) -> dict:
    """The tensor-parallel result ``b`` against the one-device ``a``."""
    return {"loss_rel_diff": abs(a[0] - b[0]) / abs(a[0]),
            "cotangent_max_gap": _max_gap(torch, b[1], a[1]),
            "grad_max_gap": _max_gap(torch, b[2], a[2])}


def _tp_bounded(name: str, row: dict) -> None:
    if row["loss_rel_diff"] > TP_TWIN_LOSS_RTOL or max(
            row["cotangent_max_gap"], row["grad_max_gap"]) > \
            TP_TWIN_GRAD_RTOL:
        raise AssertionError(f"{name}: {row}")


def phase_train_mesh_tp(torch, ref_losses: list) -> dict:
    """Tensor-parallel compute over the ``model`` axis of virtual meshes
    of the card (``dist.tensor_parallel``): (i) swarm-1b-bottleneck in
    ``train``'s layout, stage 1 held by a mesh peer on (data 1, model
    2) and a span peer on [0, 2) over (2, 2), TP_STEPS steps, the losses
    held to the staged reference within ``TP_BOUNDS``, and an f32 twin
    of the three stages (2 applications a group) held to one-device
    mesh peers (``TP_TWIN_*``, whose comment gives the measurements
    behind them); (ii) yi-6b at full width, one layer a stage over 3
    stages, on (1, 8): one microbatch's forward and backward, the f32
    twin bounded so, bf16 reported.  In
    each: the path every peer ran, flash (and rmsnorm where the model
    has it) launched on every model shard, no plain flash or codec
    call, each coordinate's gathered parameter bytes equal to the
    reckoned block bytes, and the layers' all-reduces against the plan
    (two a layer forward)."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.dist import tensor_parallel as tp
    from repro_torch.models.params import to_numpy_tree
    t0 = time.time()
    cfg = swarm1b()
    rows: dict = {}
    names: dict = {}
    meshes = {"stage1": (1, 2), "span": (2, 2)}

    def setup(runner):
        names["stage1"] = runner.add_peer(1, executor=_mesh_exec(
            cfg, 1, _tp_mesh(torch, meshes["stage1"]))).id
        names["span"] = runner.add_peer(range(0, 2), executor=_mesh_exec(
            cfg, (0, 2), _tp_mesh(torch, meshes["span"]))).id
        runner._ref_params = [to_numpy_tree(p) for p in runner._ref_params]
        runner._ref_opt = [to_numpy_tree(o) for o in runner._ref_opt]

    tp.ALL_REDUCES.clear()
    with mesh_launches() as counts, coord_launches() as per, \
            plain_flash_calls() as pf, plain_codec_calls() as pc:
        def check(runner, m):
            peers = {k: runner.peers[v] for k, v in names.items()}
            paths = {k: p.executor.compute_path for k, p in peers.items()}
            if set(paths.values()) != {"tensor_parallel"}:
                raise AssertionError(f"train_mesh_tp: paths {paths}")
            coords = sorted({c for p in peers.values()
                             for c in p.executor.mesh.coords()})
            by = _tp_require("train_mesh_tp", per, coords,
                             ("flash_attention_fwd",), pf + pc)
            nbytes = {k: _tp_bytes(p.executor, p.state)
                      for k, p in peers.items()}
            return {"paths": paths, "meshes": meshes,
                    "mesh_launches": dict(counts), "launches_by_coord": by,
                    "plain_calls": 0, "all_reduces": dict(tp.ALL_REDUCES),
                    "gathered_bytes": nbytes, "bounds": list(TP_BOUNDS)}
        rows["train"] = phase_train(torch, "train_mesh_tp", cfg, TP_STEPS,
                                    ref_losses[:TP_STEPS], peers=[0, 0, 1],
                                    setup=setup, check=check,
                                    bounds=TP_BOUNDS)
    free(torch)
    twin_cfg = swarm1b().with_overrides(n_layers=6, compute_dtype="float32")
    b = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_MB, seed=17).batch(0)
    tok = torch.as_tensor(b["tokens"], device="cuda")
    lab = torch.as_tensor(b["labels"], device="cuda")
    with plain_precision(torch):
        row, one, par = _tp_pair(torch, twin_cfg, 3, meshes["stage1"], tok,
                                 lab, codec="bottleneck")
    row.update(_tp_gaps(torch, one, par), twin="swarm-1b-bottleneck f32, "
               "2 applications a group, wq / wk x 0.3",
               bounds=[TP_TWIN_LOSS_RTOL, TP_TWIN_GRAD_RTOL])
    emit({"phase": "train_mesh_tp_twin", **row})
    _tp_bounded("train_mesh_tp twin", row)
    rows["twin"] = row
    del one, par
    free(torch)
    yi = get_config("yi-6b").with_overrides(n_layers=TP_YI_LAYERS)
    yb = SyntheticLM(yi.vocab_size, TRAIN_SEQ, TRAIN_MB, seed=17).batch(0)
    tok = torch.as_tensor(yb["tokens"], device="cuda")
    lab = torch.as_tensor(yb["labels"], device="cuda")
    for dt in ("float32", "bfloat16"):
        c = yi.with_overrides(compute_dtype=dt)
        ctx = plain_precision(torch) if dt == "float32" else \
            contextlib.nullcontext()
        torch.cuda.reset_peak_memory_stats()
        with ctx:
            row, one, par = _tp_pair(torch, c, 3, (1, TP_YI_MODEL), tok,
                                     lab)
        row.update(_tp_gaps(torch, one, par), arch=yi.name,
                   compute_dtype=dt, reduced={"n_layers": [32,
                                                           TP_YI_LAYERS]},
                   losses=[one[0], par[0]],
                   max_memory_allocated_gb=torch.cuda.max_memory_allocated()
                   / 1e9, bounded=dt == "float32")
        emit({"phase": f"train_mesh_tp_yi6b_{dt}", **row})
        if dt == "float32":
            _tp_bounded("train_mesh_tp yi-6b", row)
        if not math.isfinite(par[0]):
            raise AssertionError(f"train_mesh_tp yi-6b {dt}: loss {par[0]}")
        rows[f"yi6b_{dt}"] = row
        del one, par
        free(torch)
    emit({"phase": "train_mesh_tp_done", "seconds": time.time() - t0})
    return rows


def vl_positions(torch, batch: int, seq: int, grid: int = 8):
    """M-RoPE positions ``[3, batch, seq]`` of a vision-language prompt:
    a ``grid`` x ``grid`` image at temporal position 0 (the h and w
    streams its rows and columns), then text from ``grid`` on, the three
    streams equal."""
    n = grid * grid
    i = torch.arange(n, device="cuda")
    p = torch.empty(3, batch, seq, dtype=torch.int32, device="cuda")
    p[0, :, :n] = 0
    p[1, :, :n] = (i // grid).int()
    p[2, :, :n] = (i % grid).int()
    p[:, :, n:] = (grid + torch.arange(seq - n, device="cuda")).int()
    return p


def pipe_batch(torch, cfg, index: int, mrope: bool) -> dict:
    from repro_torch.data.synthetic import SyntheticLM
    b = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, PIPE_M, seed=17).batch(index)
    out = {k: torch.as_tensor(v, device="cuda") for k, v in b.items()}
    if mrope:
        out["positions"] = vl_positions(torch, PIPE_M, TRAIN_SEQ)
    return out


def pipe_reckoning(cfg, S: int, compress: str) -> dict:
    """Kernel launches of one pipeline step (remat per tick): every live
    slot's forward and its recompute — flash 2 M L, rmsnorm 2 M (2 L +
    1) (two a layer and the head's), encode and decode 2 M (S - 1) — and
    int8's QDQ three times a crossing (forward, recompute, the cotangent)
    but the recompute of the S - 1 warm-up ticks, which ends at their
    last crossing (torch's checkpoint stops once backward has what it
    reads, and an int8 crossing saves nothing)."""
    M, L = PIPE_M, cfg.n_layers
    out = {"flash_attention_fwd": 2 * M * L}
    if cfg.norm == "rmsnorm":
        out["rmsnorm"] = 2 * M * (2 * L + 1)
    if compress in ("bottleneck", "maxout"):
        out["encode"] = out["decode"] = 2 * M * (S - 1)
    if compress == "int8":
        out["qdq_flat"] = 3 * M * (S - 1) - (S - 1)
    return out


def _pipe_grads(torch, cfg, S: int, params, batch, mesh, compress):
    """The pipelined loss and gradients (one step's forward and
    backward, no update)."""
    from repro_torch.dist.pipeline import make_pipeline_train_step
    from repro_torch.train.steps import _value_and_grad
    step = make_pipeline_train_step(cfg, train_opt(), S, PIPE_M,
                                    compress=compress)
    with mesh:
        loss, _, g = _value_and_grad(step.loss_fn, params, batch)
    return float(loss), g


def _ref_grads(torch, cfg, S: int, params, batch, compress):
    """The staged reference's loss and gradients, a microbatch at a time:
    its loss is the microbatches' mean, so its gradient is the mean of
    theirs, and one microbatch's graph is alive at a time."""
    from repro_torch.dist.pipeline import make_reference_loss_fn
    from repro_torch.train.steps import _value_and_grad
    from repro_torch.tree import tree_map
    ref = make_reference_loss_fn(cfg, S, 1, compress=compress)
    total, grads = 0.0, None
    for m in range(PIPE_M):
        bm = {k: (v[:, m:m + 1] if k == "positions" else v[m:m + 1])
              for k, v in batch.items()}
        loss, _, g = _value_and_grad(ref, params, bm)
        total += float(loss)
        grads = g if grads is None else tree_map(
            lambda a, b: a.add_(b), grads, g)
        del g
    return total / PIPE_M, tree_map(lambda a: a / PIPE_M, grads)


def _pipe_vs_reference(torch, cfg, S: int, mesh, compress, mrope,
                       twin: bool = False) -> dict:
    """Loss and gradients of the pipeline and of the staged reference on
    one state (``make_state`` seed 0; a ``twin``'s wq / wk scaled by
    ``SWARM_ATTN_SCALE``) and batch."""
    from repro_torch.train.steps import make_state
    from repro_torch.tree import tree_leaves
    state = make_state(cfg, train_opt(), 0)
    if twin:
        _scale_attention(torch, [state["params"]])
    batch = pipe_batch(torch, cfg, 0, mrope)
    loss_p, g_p = _counted(torch, lambda: _pipe_grads(
        torch, cfg, S, state["params"], batch, mesh, compress))
    loss_r, g_r = _counted(torch, lambda: _ref_grads(
        torch, cfg, S, state["params"], batch, compress))
    out = {"loss": loss_p, "reference_loss": loss_r,
           "loss_rel_diff": abs(loss_p - loss_r) / abs(loss_r),
           "grad_max_gap": _max_gap(torch, tree_leaves(g_p),
                                    tree_leaves(g_r)),
           **_grad_gap(torch, tree_leaves(g_p), tree_leaves(g_r))}
    del state, g_p, g_r
    free(torch)
    return out


def _pipe_train(torch, name: str, cfg, S: int, compress: str, mrope: bool,
                twin, steps: int = PIPE_STEPS) -> dict:
    """``steps`` AdamW steps of ``make_pipeline_train_step`` over (``pod``
    S, ``data`` 1) of the card: launches a step against
    ``pipe_reckoning``, no plain call, finite losses, tokens/s, peak
    memory; then the pipeline against the staged reference on one
    state, reported at full depth and bounded in the f32 ``twin``
    config."""
    from repro_torch import kernels
    from repro_torch.dist.pipeline import make_pipeline_train_step, \
        stage_periodic
    from repro_torch.train.steps import make_state
    if not stage_periodic(cfg, S):
        raise AssertionError(f"{name}: {cfg.name} not periodic at {S}")
    mesh = _card_mesh(torch, S, shape=(S, 1), axes=("pod", "data"))
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    state = make_state(cfg, train_opt(), 0)
    step = make_pipeline_train_step(cfg, train_opt(), S, PIPE_M,
                                    compress=compress)
    want = pipe_reckoning(cfg, S, compress)
    losses, secs, launches = [], [], []
    with plain_flash_calls() as pf, plain_codec_calls() as pc:
        for i in range(steps):
            batch = pipe_batch(torch, cfg, i, mrope)
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.time()
            with mesh:
                state, m = step(state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            secs.append(time.time() - t0)
            launches.append({k: v for k, v in kernels.LAUNCHES.items()
                             if v})
    peak = torch.cuda.max_memory_allocated() / 1e9
    del state, step
    free(torch)
    bad = [(i, k, got.get(k, 0), n) for i, got in enumerate(launches)
           for k, n in want.items() if got.get(k, 0) != n]
    if bad or pf or pc or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: launches off the reckoning {bad}, "
                             f"plain calls {(pf + pc)[:4]}, losses "
                             f"{losses}")
    row = {"phase": name, "arch": cfg.name, "stages": S,
           "mesh": dict(mesh.shape), "compress": compress,
           "microbatches": PIPE_M, "microbatch": [1, TRAIN_SEQ],
           "losses": losses, "launches_per_step": launches,
           "reckoning": want, "plain_calls": 0, "step_s": secs,
           "tokens_per_s": PIPE_M * TRAIN_SEQ * len(secs) / sum(secs),
           "max_memory_allocated_gb": peak}
    if twin is not None:
        row["full_depth_bf16"] = _pipe_vs_reference(
            torch, cfg, S, mesh, compress, mrope)
        tw = _pipe_vs_reference(torch, twin, S, mesh, compress, mrope,
                                twin=True)
        tw["layers"] = twin.n_layers
        row["f32_twin"] = tw
        if tw["loss_rel_diff"] > PIPE_TWIN_LOSS_RTOL or \
                tw["grad_max_gap"] > PIPE_TWIN_GRAD_RTOL:
            raise AssertionError(f"{name}: f32 twin off the reference: "
                                 f"{tw}")
    emit(row)
    return row


def phase_train_pipeline(torch) -> dict:
    """``make_pipeline_train_step`` at full width and depth: swarm-1b-
    bottleneck over 3 stages (``pod`` 3) with its learned codec, then
    one step on the int8 wire; qwen2-vl-2b over 4 stages (``pod`` 4) on
    the int8 wire with vision-language M-RoPE positions."""
    from repro_torch.configs import get_config
    t0 = time.time()
    sw = swarm1b()
    rows = {"swarm": _pipe_train(
        torch, "train_pipeline", sw, 3, "bottleneck", False,
        sw.with_overrides(n_layers=6, compute_dtype="float32"))}
    rows["swarm_int8"] = _pipe_train(torch, "train_pipeline_int8", sw, 3,
                                     "int8", False, None, steps=1)
    qw = get_config("qwen2-vl-2b")
    rows["qwen"] = _pipe_train(
        torch, "train_pipeline_qwen2_vl", qw, 4, "int8", True,
        qw.with_overrides(n_layers=4, compute_dtype="float32"))
    emit({"phase": "train_pipeline_done", "seconds": time.time() - t0})
    return rows


# ------------------------------------------------------------ phase 13d
# train_mesh_moe: llama4-scout-17b-a16e at full width (d 5120, 16 experts
# x 8192, 40 / 8 heads of 128, bf16), depth cut to one layer a stage over
# 2 stages, a microbatch of 2 x 512 split 1 + 1 over a [cuda:0] x 2 mesh
# and expert-parallel over (1, 2) and (2, 2), against the same executor
# on a one-device mesh.  A layer is 4.42 GB, the embedding and the head
# 2.07 GB each, so a stage holds 6.5 GB; its 2-way run_bwd reaches about
# 72 GB (phase_train_mesh_moe's reckoning).  The f32 twin (the MoE layer
# alone) holds 8.6 GB of weights and two gradient sets of it; the f32
# expert-parallel twin a 13 GB last stage, its model blocks, its
# gradients and their f64 sum (72.6 GB on (2, 2), reckoned on meta).
# deepseek-v2-236b takes the same meshes at full width (d 5120, 128 heads
# of (192, 128), kv_lora 512, q_lora 1536, 160 experts x 1536 top-6, 2
# shared), one mla_moe layer a stage: a layer holds 3.97 G parameters,
# 7.95 GB in bf16, so a stage 9.0 GB; a (2, 2) run_bwd reckons 60.2 GB
# above it on meta, so the one-device gradients wait on the host.  Its
# f32 twin is the last stage of the dense mla kind (0.69 GB a layer, the
# head 2.1 GB).
MOE_ARCH = "llama4-scout-17b-a16e"
MLA_ARCH = "deepseek-v2-236b"
MOE_SEQ, MOE_MB = 512, 2
MOE_BF16_RTOL = 2e-2            # the families' bf16 MoE bound
MOE_TWIN_RTOL = 1e-5            # the f32 twin, split against unsplit
PIPE_MOE_M = 2                  # microbatches of 2 x 512, split 1 + 1
# the pipeline's bounds against its reference, between the sound run's
# reading (loss 0, gradients 1.55e-2 of a leaf's largest entry) and the
# control's, which routes each shard on its own rows (loss 3.0e-5,
# gradients 0.75): PERF.md PR 26, H100 80GB HBM3 at 700 W
PIPE_MOE_LOSS_RTOL = 1e-5
PIPE_MOE_GRAD_RTOL = 5e-2


def moe_config(arch: str = MOE_ARCH, kind: str = None):
    """``arch`` at full width, one layer a stage over 2 stages (its
    layers of ``kind`` where given)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    pattern = (kind,) * 2 if kind else \
        cfg.block_pattern[:2] if cfg.block_pattern else None
    return cfg.with_overrides(n_layers=2, block_pattern=pattern)


@contextlib.contextmanager
def moe_calls():
    """Record every ``apply_moe`` and ``apply_moe_tp`` call's router (the
    model shards' blocks joined at home), input and split rule (the
    routes are recomputed from them afterwards); an ``apply_moe_a2a``
    call as one such call a data shard, under the microbatch's split
    contexts."""
    import torch
    from repro_torch.models import layers as L
    calls: list = []
    orig, orig_tp, orig_a2a = L.apply_moe, L.apply_moe_tp, L.apply_moe_a2a

    def recorded(cfg, p, x, route=None):
        calls.append((cfg, p["router"], x.detach(), L.split_provider()))
        return orig(cfg, p, x, route=route)

    def recorded_tp(cfg, ps, x, group, route=None):
        router = ps[0]["router"].detach() if not L.experts_split(
            cfg, ps[0]) else torch.cat([p["router"].detach().to(x.device)
                                        for p in ps], dim=-1)
        calls.append((cfg, router, x.detach(), L.split_provider()))
        return orig_tp(cfg, ps, x, group, route=route)

    def recorded_a2a(cfg, pss, xs, groups):
        routers = [torch.cat([p["router"].detach().to(x.device)
                              for p in ps], dim=-1)
                   for ps, x in zip(pss, xs)]
        counts = [L.moe_route(cfg, {"router": r}, x)[3].sum(0)
                  for r, x in zip(routers, xs)]
        splits = L.split_contexts(counts, [x.shape[0] * x.shape[1]
                                           for x in xs])
        for r, x, sp in zip(routers, xs, splits):
            calls.append((cfg, r, x.detach(),
                          lambda tokens, cnt, _s=sp: _s))
        return orig_a2a(cfg, pss, xs, groups)
    L.apply_moe, L.apply_moe_tp = recorded, recorded_tp
    L.apply_moe_a2a = recorded_a2a
    try:
        yield calls
    finally:
        L.apply_moe, L.apply_moe_tp = orig, orig_tp
        L.apply_moe_a2a = orig_a2a


def _routing(torch, call) -> dict:
    """One recorded call's routes: each pair's expert, its kept flag as
    the layer took it (the microbatch's capacity and slots where split),
    the shard's route counts, and the kept flag under the shard's own
    capacity and slots (what the port computed before the split
    context)."""
    from repro_torch.models import layers as L
    cfg, router, x, provider = call
    m = cfg.moe
    _, _, sel, onehot = L.moe_route(cfg, {"router": router}, x)
    T, k, E = x.shape[0] * x.shape[1], m.top_k, m.num_experts
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
    e = sel.reshape(-1)
    own = pos < max(1, int(m.capacity_factor * T * k / E))
    keep = own
    if provider is not None:
        split = provider(T, onehot.sum(0))
        C = max(1, int(m.capacity_factor * split.tokens * k / E))
        keep = split.offsets[e] + pos < C
    return {"sel": e, "keep": keep, "counts": onehot.sum(0), "own": own}


def _route_checks(torch, whole: list, shards: list) -> dict:
    """A layer's routes on the split mesh (``shards``: one call a shard)
    against (a) the whole-microbatch routing of the same router inputs
    joined, which the split must equal exactly, and (b) the one-device
    run (``whole``: one call), whose router inputs may differ by
    rounding: flips are reported.  Also the pairs the shards' own
    capacity would have kept or dropped otherwise."""
    parts = [_routing(torch, c) for c in shards]
    sel = torch.cat([p["sel"] for p in parts])
    keep = torch.cat([p["keep"] for p in parts])
    own = torch.cat([p["own"] for p in parts])
    cfg, router = shards[0][0], shards[0][1]
    joined = _routing(torch, (cfg, router, torch.cat(
        [c[2] for c in shards]), None))
    one = _routing(torch, whole[0])
    return {
        "semantics_equal": bool(torch.equal(sel, joined["sel"])
                                and torch.equal(keep, joined["keep"])),
        "route_flips_vs_one_device": int((sel != one["sel"]).sum()),
        "kept_flips_vs_one_device": int((keep != one["keep"]).sum()),
        "counts_equal_one_device": bool(torch.equal(
            sum(p["counts"] for p in parts), one["counts"])),
        "dropped": int((~keep).sum()),
        "old_capacity_differs": int((own != keep).sum())}


def _moe_layer_split(torch, cfg, p, x, n: int = 2):
    """``apply_moe`` over ``n`` row shards with the split context of the
    whole microbatch: (outputs joined, aux shares summed)."""
    from repro_torch.models import layers as L
    ys, auxs = L.apply_moe_shards(cfg, [p] * n, list(x.chunk(n)))
    return torch.cat(ys), torch.stack(auxs).sum()


def _moe_twin(torch) -> dict:
    """The MoE layer alone at full width in f32: the split context over 2
    shards against the unsplit layer, output, aux and every gradient
    (the weights' and the input's) within ``MOE_TWIN_RTOL`` of each
    leaf's largest entry."""
    from repro_torch.models import layers as L
    from repro_torch.models import params as P
    from repro_torch.tree import tree_leaves, tree_map
    cfg = moe_config().with_overrides(compute_dtype="float32",
                                      param_dtype="float32")
    p = P.init(7, L.moe_specs(cfg), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(MOE_MB, MOE_SEQ, cfg.d_model, generator=gen,
                    device="cuda")
    dy = torch.randn(x.shape, generator=gen, device="cuda")

    def run(split: bool):
        pl = tree_map(lambda a: a.detach().requires_grad_(), p)
        xl = x.detach().requires_grad_()
        with torch.enable_grad():
            y, aux = (_moe_layer_split(torch, cfg, pl, xl) if split
                      else L.apply_moe(cfg, pl, xl))
            grads = torch.autograd.grad((y * dy).sum() + aux,
                                        [xl] + tree_leaves(pl))
        return y.detach(), float(aux.detach()), list(grads)

    with plain_precision(torch):
        y1, a1, g1 = run(False)
        y2, a2, g2 = run(True)
    row = {"output_max_gap": _max_gap(torch, [y2], [y1]),
           "aux_rel_diff": abs(a2 - a1) / abs(a1),
           "grad_max_gap": _leaf_gaps(torch, g2, g1)["grad_max_gap"]}
    del p, x, dy, y1, y2, g1, g2
    free(torch)
    if max(row.values()) > MOE_TWIN_RTOL:
        raise AssertionError(f"train_mesh_moe f32 twin: {row}")
    return row


def _leaf_paths(tree, prefix: str = "") -> list:
    """``"a/b/0"`` paths of a tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _leaf_paths(v, f"{prefix}{i}/")]
    return [] if tree is None else [prefix.rstrip("/")]


def _leaf_gaps(torch, got: list, want: list, chunk: int = 1 << 24
               ) -> dict:
    """``_max_gap`` and ``_grad_gap`` in one pass, a leaf at a time in
    chunks of ``chunk`` elements (f64 copies of a 1e9-element leaf would
    take 25 GB of transients)."""
    gap = num = den = 0.0
    flips = above = 0
    for a, b in zip(got, want):
        a, b = a.reshape(-1), b.reshape(-1)
        dmax = bmax = 0.0
        for i in range(0, a.numel(), chunk):
            x, y = a[i:i + chunk].double(), b[i:i + chunk].double()
            d = x - y
            dmax = max(dmax, float(d.abs().max()))
            bmax = max(bmax, float(y.abs().max()))
            num += float((d * d).sum())
            den += float((y * y).sum())
            m = (x.abs() > 1e-8) | (y.abs() > 1e-8)
            above += int(m.sum())
            flips += int(((torch.sign(x) != torch.sign(y)) & m).sum())
            del x, y, d, m
        gap = max(gap, dmax / max(bmax, 1e-30))
    return {"grad_max_gap": gap, "grad_rel_l2": math.sqrt(num / den),
            "grad_sign_flip_share": flips / max(above, 1)}


# the mesh peers of train_mesh_moe, by name: one device; the microbatch
# split 1 + 1 over [cuda:0] x 2 (the gathered path); expert-parallel over
# ("data", "model") (1, 2) and (2, 2); and (2, 2) with the weights
# replicated over "data" (MOE_RULES: no FSDP), where each data shard
# holds the expert stacks whole and the shards run in lockstep under
# their split contexts (models.layers.apply_moe_shards_tp)
MOE_MESHES = {"one": None, "data2": None, "tp1x2": (1, 2), "tp2x2": (2, 2),
              "tp2x2w": (2, 2)}
MOE_TP = ("tp1x2", "tp2x2", "tp2x2w")
# the meshes whose stacks come whole over "data", by name: the rules'
# overrides of DEFAULT_RULES
MOE_RULES = {"tp2x2w": {"embed": None}}
# the meshes of a run of _mesh_moe, the one-device run first: both archs
# on the first; MOE_ARCH alone on the second, a run of its own (a stage
# replicated over "data" holds twice its 6.5 GB beside the others)
MOE_RUNS = (("one", "data2", "tp1x2", "tp2x2"), ("one", "tp2x2w"))


def moe_rules(name: str):
    """The ``ShardingRules`` of mesh ``name`` (None: the defaults)."""
    if name not in MOE_RULES:
        return None
    from repro_torch.dist.sharding import DEFAULT_RULES
    return DEFAULT_RULES.with_rules(**MOE_RULES[name])
# the f32 expert-parallel twin's floor under a leaf's largest gradient
# entry, as a share of the stage's largest: the top-1 router's gradient
# is rounding noise (1e-8 against entries of 0.1-10 on the CPU)
MOE_NOISE_FLOOR = 1e-6


def _moe_meshes(torch, names) -> dict:
    return {name: (_card_mesh(torch, 1) if name == "one" else
                   _card_mesh(torch, 2) if MOE_MESHES[name] is None else
                   _tp_mesh(torch, MOE_MESHES[name]))
            for name in names}


def moe_all_reduces_planned(n: int, sliced: bool = True) -> dict:
    """``ALL_REDUCES`` a microbatch of ``n`` data shards adds on a
    tensor-parallel mesh in train_mesh_moe's sequence (stage 0's and
    stage 1's forward, stage 1's then stage 0's backward; a layer a
    stage): a layer application (forward or recompute) makes one
    attention all-reduce, one router gather and one shared-expert
    all-reduce a data shard, and with one data shard one return of
    expert rows; with more (each expert's slots once per microbatch,
    ``apply_moe_a2a``) once for the microbatch the columns' all-to-all,
    the slots' all-gather, the gate and up partials' all-reduces and the
    rows' return; stage 0's embedding one a data shard; the head's loss
    three; the backward one cotangent all-reduce a fanout (the
    attention's and the MoE's a layer, the head's) a data shard and,
    with more than one, a layer's columns transposed and its two
    partials' sums.  Where the stacks come whole over ``data``
    (``sliced`` false) every data shard returns its own expert rows and
    nothing else crosses ``data``."""
    out = {"activation": 4 * n, "router": 4 * n, "shared_expert": 4 * n,
           "embedding": 2 * n, "loss": 6 * n, "cotangent": 5 * n}
    if n == 1 or not sliced:
        return {**out, "expert_rows": 4 * n}
    return {**out, "expert_rows": 4, "expert_columns": 4,
            "expert_slots": 4, "expert_partials": 8,
            "cotangent": 5 * n + 6}


def _moe_meta_peak(torch, cfg, s: int, shape, inp_shape, last: bool,
                   rules=None) -> int:
    """The bytes stage ``s``'s ``run_bwd`` on a ``shape`` ("data",
    "model") mesh allocates at its peak, every coordinate's together
    (the card holds them all), reckoned on meta by the dry run's ledger
    (``DeviceLedger.peak_total``)."""
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import params as P
    from repro_torch.runtime import MeshExecutor, StageState
    meta = torch.device("meta")
    mesh = make_debug_mesh(shape, ("data", "model"),
                           devices=[meta] * (shape[0] * shape[1]))
    ex = MeshExecutor(cfg, 2, MOE_SEQ, s, mesh, compress="none",
                      rules=rules)
    st = StageState(params=ex._place(P.abstract(ex.prog.specs),
                                     ex.param_shardings))
    tok = torch.empty(inp_shape[:2], dtype=torch.int64, device=meta)
    x = torch.empty(inp_shape, dtype=cfg.compute_jdtype, device=meta)
    with H.DeviceLedger() as led:
        if last:
            out = ex.run_bwd(st, x, labels=tok)
        else:
            out = ex.run_bwd(st, tok, dy=x)
    del out
    return led.peak_total


def moe_launches_planned(mesh) -> dict:
    """Flash and rmsnorm launches on each coordinate of a
    tensor-parallel mesh in train_mesh_moe's sequence (a layer a stage;
    stage 0's and stage 1's forward, then both backwards, each
    recomputing its layer): the attention's flash and ``ln1`` on every
    model shard a layer application, ``ln2`` at each home (the MoE's
    input, normed there), the final norm on every shard in stage 1's
    forward and its backward (the vocab-parallel head)."""
    return {c: {"flash_attention_fwd": 4,
                "rmsnorm": 4 + 2 + (4 if c[-1] == 0 else 0)}
            for c in mesh.coords()}


@contextlib.contextmanager
def dispatch_shapes():
    """The shape of every expert buffer ``apply_moe_a2a`` fills
    (``models.layers._dispatch``), by the mesh coordinate it ran as."""
    import collections
    from repro_torch.dist.mesh import current_coord
    from repro_torch.models import layers as L
    seen: dict = collections.defaultdict(set)
    orig = L._dispatch

    def recorded(*args):
        out = orig(*args)
        seen[current_coord()].add(tuple(out.shape))
        return out
    L._dispatch = recorded
    try:
        yield seen
    finally:
        L._dispatch = orig


def moe_buffers_planned(cfg, shape, sliced: bool = True) -> dict:
    """Each coordinate's expert buffer on a ``shape`` ("data", "model")
    mesh in train_mesh_moe: ``[E / m, C, d / n]`` with C the
    microbatch's capacity where the microbatch splits over ``n > 1``
    data shards holding the stacks' data slices (each expert's slots
    once per microbatch), none where it runs on one data shard
    (``apply_moe_tp``'s ``[E / m, Cb, d]``) or the stacks come whole
    over ``data`` (``sliced`` false: ``apply_moe_shards_tp``)."""
    n, m = shape
    if n == 1 or not sliced:
        return {}
    mo = cfg.moe
    C = max(1, int(mo.capacity_factor * MOE_MB * MOE_SEQ * mo.top_k
                   / mo.num_experts))
    return {str([i, j]): [[mo.num_experts // m, C, cfg.d_model // n]]
            for i in range(n) for j in range(m)}


@contextlib.contextmanager
def flash_dims_by_coord():
    """The ``(heads, Dqk, Dv)`` of every flash kernel call, by the mesh
    coordinate it ran as."""
    import collections
    from repro_torch.dist.mesh import current_coord
    from repro_torch.kernels.flash_attention import kernel as fk
    seen: dict = collections.defaultdict(set)
    orig = fk.flash_attention_fwd

    def recorded(q, k, v, *args, **kw):
        seen[current_coord()].add((q.shape[2], q.shape[3], v.shape[3]))
        return orig(q, k, v, *args, **kw)
    fk.flash_attention_fwd = recorded
    try:
        yield seen
    finally:
        fk.flash_attention_fwd = orig


def phase_train_mesh_moe(torch) -> dict:
    """A MoE stage on split meshes, for ``MOE_ARCH`` (llama4-scout's
    ``moe`` kind) and ``MLA_ARCH`` (deepseek-v2's ``mla_moe``): each stage
    of ``moe_config(arch)`` as a ``MeshExecutor`` on the meshes of
    ``MOE_RUNS[0]`` (:func:`_mesh_moe`), ``MOE_ARCH`` again on
    ``MOE_RUNS[1]`` (the stacks whole over ``data``), then the f32
    twins:
    llama4-scout's MoE layer split against unsplit, and the last stage
    tensor-parallel against one device (llama4-scout's, and deepseek-v2's
    of the dense ``mla`` kind)."""
    t0 = time.time()
    row = _mesh_moe(torch, MOE_ARCH)
    row[MLA_ARCH] = _mesh_moe(torch, MLA_ARCH)
    row["stacks_whole"] = _mesh_moe(torch, MOE_ARCH, MOE_RUNS[1])
    twins = ((row, "f32_twin", _moe_twin),
             (row, "f32_tp_twin", lambda t: _moe_tp_twin(t, moe_config())),
             (row[MLA_ARCH], "f32_tp_twin", lambda t: _moe_tp_twin(
                 t, moe_config(MLA_ARCH, "mla"))))
    for r, key, twin in twins:
        torch.cuda.reset_peak_memory_stats()
        t1 = time.time()
        r[key] = twin(torch)
        r[key]["max_memory_allocated_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
        r[key]["seconds"] = time.time() - t1
    row["seconds"] = time.time() - t0
    emit(row)
    for r in (row, row[MLA_ARCH], row["stacks_whole"]):
        _mesh_moe_checks(r)
    return row


def _mesh_moe(torch, arch: str, names=MOE_RUNS[0]) -> dict:
    """``moe_config(arch)``'s stages as ``MeshExecutor`` s on the meshes
    ``names`` of ``MOE_MESHES`` (one device; the microbatch split 1 + 1
    over ``[cuda:0] x 2``, its MoE layers in lockstep; tensor-parallel
    over ("data", "model") (1, 2) and (2, 2), the data shards in lockstep
    there too, with each mesh's ``moe_rules``) from the same weights and
    inputs: each run's path; routes
    per layer (every split's identical to the whole-microbatch routing of
    the same router inputs; flips against the one-device run reported);
    the bf16 losses, the gradients' gap reported; on the tensor-parallel
    meshes each coordinate's gathered bytes against ``block_bytes``,
    flash and rmsnorm launches on each coordinate against
    ``moe_launches_planned`` and flash's head dims, no plain flash call,
    ``ALL_REDUCES`` against ``moe_all_reduces_planned``, each backward's
    peak beside its meta reckoning, tokens/s (a microbatch's forward and
    backward over both stages, host clock).  One stage's weights live at
    a time (drawn again from their seed for stage 0's backward), no
    mesh's state holds a gradient accumulator, and the one-device
    gradients wait on the host, so the peak is a stage's weights (6.5 GB
    llama4-scout, 9.0 GB deepseek-v2) and a tensor-parallel run_bwd (a
    model block set, a shard's bf16 gradients, their f64 sum and a fold's
    f64 block).  Checked by :func:`_mesh_moe_checks`."""
    import collections
    from repro_torch import kernels
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.dist import tensor_parallel as tp
    from repro_torch.dist.mesh import gather
    from repro_torch.models import params as P
    from repro_torch.runtime import MeshExecutor, StageState
    from repro_torch.runtime.numeric import get_stage_programs
    from repro_torch.tree import tree_leaves
    t0 = time.time()
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    cfg = moe_config(arch)
    progs = get_stage_programs(cfg, 2, MOE_SEQ, "none")
    meshes = _moe_meshes(torch, names)
    tps = [n for n in names if n in MOE_TP]

    def stage(s: int) -> dict:
        """Stage ``s``'s executors on every mesh over one weight tree."""
        params = P.init(11 + s, progs[s].specs, "cuda")
        out = {}
        for name, mesh in meshes.items():
            ex = MeshExecutor(cfg, 2, MOE_SEQ, s, mesh, compress="none",
                              rules=moe_rules(name))
            st = StageState()
            ex.restore(st, {"params": params, "opt": None})
            # the phase never accumulates: no zeroed copy of the stage a
            # mesh
            st.grad_acc = None
            out[name] = (ex, st)
        return out

    b = SyntheticLM(cfg.vocab_size, MOE_SEQ, MOE_MB, seed=17).batch(0)
    tok = torch.as_tensor(b["tokens"], device="cuda")
    lab = torch.as_tensor(b["labels"], device="cuda")
    before = dict(kernels.LAUNCHES)
    routes = {name: [] for name in meshes if name != "one"}
    losses, gaps, peaks, reckoned, card_bytes = {}, {}, {}, {}, {}
    secs = collections.Counter()
    reduces = {name: collections.Counter() for name in tps}
    per = {name: collections.defaultdict(collections.Counter)
           for name in tps}
    dims = {name: collections.defaultdict(set) for name in tps}
    bufs = {name: collections.defaultdict(set) for name in tps}
    paths, nbytes, plain = {}, {}, []

    def run(name: str, fn):
        """``fn`` (a run of mesh ``name``'s executor), timed, its MoE
        calls recorded, its launches and flash dims by coordinate and its
        ``ALL_REDUCES`` kept under ``name``."""
        was = collections.Counter(tp.ALL_REDUCES)
        with moe_calls() as calls, coord_launches() as by, \
                plain_flash_calls() as pf, flash_dims_by_coord() as fd, \
                dispatch_shapes() as ds:
            torch.cuda.synchronize()
            t1 = time.time()
            out = fn()
            torch.cuda.synchronize()
            secs[name] += time.time() - t1
        plain.extend(pf)
        if name in reduces:
            reduces[name].update(collections.Counter(tp.ALL_REDUCES) - was)
            for c, n in by.items():
                per[name][c].update(n)
            for c, d in fd.items():
                dims[name][c] |= d
            for c, d in ds.items():
                bufs[name][c] |= d
        return out, calls

    def forward(ex, s: int, inp, *extra):
        out, calls = {}, {}
        for name, (e, st) in ex.items():
            paths[f"stage{s}_{name}"] = e.compute_path
            if name in MOE_TP:
                nbytes[f"stage{s}_{name}"] = _tp_bytes(e, st,
                                                       "train_mesh_moe")
            out[name], calls[name] = run(
                name, lambda e=e, st=st: e.run_fwd(st, inp, *extra))
        for name in routes:
            routes[name].append(_route_checks(torch, calls["one"],
                                              calls[name]))
        return out

    def backward(ex, s: int, inp, **kw):
        """Every mesh's run_bwd: the input cotangent of the one-device
        run, and the other runs' gaps from it."""
        ref = gx_ref = None
        for name, (e, st) in ex.items():
            if name in MOE_TP:
                reckoned[f"stage{s}_{name}"] = _moe_meta_peak(
                    torch, cfg, s, MOE_MESHES[name],
                    (MOE_MB, MOE_SEQ, cfg.d_model), s == 1,
                    moe_rules(name))
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            (_, gx, gp), _ = run(name, lambda e=e, st=st: e.run_bwd(
                st, inp, **kw))
            key = f"stage{s}_{name}"
            peaks[key] = torch.cuda.max_memory_allocated() / 1e9
            if name in MOE_TP:
                card_bytes[key] = torch.cuda.max_memory_allocated() - base
            if name == "one":
                # one part's f64 "sum" is that part exactly: kept in the
                # host's page-locked memory (pageable copies of a stage's
                # gradients, out and back to each mesh, took ~20 s a
                # model) in the gradients' own dtypes (the params'), each
                # f64 sum freed in turn
                ref = []
                for a, w in zip(tree_leaves(gp), tree_leaves(st.params)):
                    g = gather(a, a.mesh.devices.flat[0]).to(w.dtype)
                    ref.append(torch.empty(g.shape, dtype=g.dtype,
                                           pin_memory=True).copy_(g))
                    a.shards.fill(None)
                    del g
                gx_ref = gx
                # no later run reads the reference's weights
                st.params = None
            else:
                got = {}
                for path, a, r in zip(_leaf_paths(gp), tree_leaves(gp),
                                      ref):
                    g = gather(a, a.mesh.devices.flat[0])
                    a.shards.fill(None)
                    got[path] = _leaf_gaps(torch, [g], [r.to(g.device)])[
                        "grad_max_gap"]
                    del g
                # a top-1 router's gradient is rounding noise in both
                # runs (a token's renormalised gate is exactly 1), so its
                # gap is read apart
                gaps[key] = {"grad_max_gap": max(got.values()),
                             "grad_max_gap_but_router": max(
                                 v for p, v in got.items()
                                 if not p.endswith("router")),
                             "per_leaf": got}
                if gx is not None:
                    gaps[key]["cotangent_max_gap"] = _max_gap(
                        torch, [gx], [gx_ref])
            del gp
            free(torch)
        del ref
        free(torch)
        return gx_ref

    for name in names[1:]:
        probe = MeshExecutor(cfg, 2, MOE_SEQ, 0, meshes[name],
                             compress="none")
        if probe.dp_shards(MOE_MB) != (MOE_MESHES[name] or (2,))[0]:
            raise AssertionError(f"train_mesh_moe: the microbatch did not "
                                 f"split over {name}")
    ex0 = stage(0)
    w = forward(ex0, 0, tok)
    wire_gap = {name: _max_gap(torch, [w[name]], [w["one"]])
                for name in routes}
    w = w["one"]
    del ex0
    free(torch)
    ex1 = stage(1)
    out = forward(ex1, 1, w, lab)
    losses = {name: float(v) for name, v in out.items()}
    dy = backward(ex1, 1, w, labels=lab)
    del ex1
    free(torch)
    ex0 = stage(0)                    # the same weights, drawn again
    backward(ex0, 0, tok, dy=dy)
    del ex0, w, dy
    free(torch)
    launched = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES
                if kernels.LAUNCHES[k] != before[k]}
    tokens = MOE_MB * MOE_SEQ
    a = cfg.mla
    row = {"phase": "train_mesh_moe", "arch": cfg.name,
           "kinds": sorted(set(cfg.block_kinds)),
           "layers": cfg.n_layers, "stages": 2,
           "microbatch": [MOE_MB, MOE_SEQ],
           "meshes": {k: MOE_MESHES[k] for k in tps},
           "rules": {k: MOE_RULES[k] for k in tps if k in MOE_RULES},
           "paths": paths, "routes": routes, "losses": losses,
           "loss_rel_diff": {n: abs(v - losses["one"]) / abs(losses["one"])
                             for n, v in losses.items() if n != "one"},
           "stage0_output_max_gap": wire_gap, "grads": gaps,
           "seconds_by_mesh": dict(secs),
           "tokens_per_s": {n: tokens / v for n, v in secs.items()},
           "launches": launched,
           "launches_by_coord": {n: _tp_require(
               "train_mesh_moe", per[n], meshes[n].coords(),
               ("flash_attention_fwd", "rmsnorm"), plain)
               for n in tps},
           "launches_by_coord_planned": {
               n: {str(list(c)): v for c, v in moe_launches_planned(
                   meshes[n]).items()} for n in tps},
           # every flash call's (heads, Dqk, Dv) on each coordinate, and
           # the plan's: the config's heads over the model shards
           "flash_dims_by_coord": {n: {str(list(c)): [list(d) for d in
                                                      sorted(v)]
                                       for c, v in dims[n].items()}
                                   for n in tps},
           "flash_dims_planned": {n: {str(list(c)): [[
               cfg.n_heads // MOE_MESHES[n][1],
               a.qk_nope_dim + a.qk_rope_dim if a else cfg.hd,
               a.v_head_dim if a else cfg.hd]] for c in meshes[n].coords()}
               for n in tps},
           # each coordinate's expert buffers (apply_moe_a2a) and the
           # plan's: [E / m, C, d / n] where the microbatch splits over
           # the stacks' data slices
           "buffers_by_coord": {n: {str(list(c)): [list(d) for d in
                                                   sorted(v)]
                                    for c, v in bufs[n].items()}
                                for n in tps},
           "buffers_planned": {n: moe_buffers_planned(
               cfg, MOE_MESHES[n], n not in MOE_RULES) for n in tps},
           "all_reduces": {n: dict(v) for n, v in reduces.items()},
           "all_reduces_planned": {n: moe_all_reduces_planned(
               MOE_MESHES[n][0], n not in MOE_RULES) for n in tps},
           "gathered_bytes": nbytes, "peaks_gb": peaks,
           # a backward's peak above what was allocated before it, on the
           # card and reckoned on meta
           "card_peak_bytes": card_bytes, "reckoned_peak_bytes": reckoned,
           "max_memory_allocated_gb": max(peaks.values())}
    row["checks_s"] = time.time() - t0
    return row


def _mesh_moe_checks(row: dict) -> None:
    """:func:`_mesh_moe`'s row: routes, losses, paths, collectives,
    launches and flash dims by coordinate, peak."""
    routes, losses, paths = row["routes"], row["losses"], row["paths"]
    name = f"train_mesh_moe {row['arch']}"
    bad = [r for rs in routes.values() for r in rs
           if not r["semantics_equal"]]
    if bad or max(row["loss_rel_diff"].values()) > MOE_BF16_RTOL:
        raise AssertionError(f"{name}: routes {routes}, losses {losses}")
    if "data2" in routes and \
            sum(r["old_capacity_differs"] for r in routes["data2"]) == 0:
        raise AssertionError(f"{name}: the shards' own capacity keeps the "
                             "same pairs; the check does not bite")
    if any(p != ("tensor_parallel" if k.split("_")[1] in MOE_TP
                 else "gathered") for k, p in paths.items()):
        raise AssertionError(f"{name}: paths {paths}")
    if row["all_reduces"] != row["all_reduces_planned"]:
        raise AssertionError(f"{name}: all-reduces {row}")
    if row["buffers_by_coord"] != row["buffers_planned"]:
        raise AssertionError(f"{name}: expert buffers "
                             f"{row['buffers_by_coord']}")
    if row["launches_by_coord"] != row["launches_by_coord_planned"]:
        raise AssertionError(f"{name}: launches by coordinate "
                             f"{row['launches_by_coord']}")
    if row["flash_dims_by_coord"] != row["flash_dims_planned"]:
        raise AssertionError(f"{name}: flash dims "
                             f"{row['flash_dims_by_coord']}")
    launched = row["launches"]
    if not launched.get("flash_attention_fwd") or \
            not launched.get("rmsnorm"):
        raise AssertionError(f"{name}: launches {launched}")
    if row["max_memory_allocated_gb"] >= 80:
        raise AssertionError(f"{name}: peak {row['peaks_gb']}")


def _moe_tp_twin(torch, cfg) -> dict:
    """The last stage of ``cfg`` (``moe_config``'s MoE layer, or the
    dense ``mla`` layer of deepseek-v2, the final norm and the head) at
    full width in f32 on the tensor-parallel meshes of ``MOE_TP``
    against one device, on one batch: the loss within
    ``TP_TWIN_LOSS_RTOL``, the input cotangent and every gradient within
    ``TP_TWIN_GRAD_RTOL`` of each leaf's largest entry (train_mesh_tp's
    bounds for rounding amplified at full width), a leaf's entry floored
    at ``MOE_NOISE_FLOOR`` of the stage's largest (the top-1 router's
    gradient is zero but for rounding: a token's renormalised gate is
    exactly 1, and the stage programs leave the aux loss out, as JAX's
    do).  The one-device gradients wait on the host: a (2, 2) run_bwd
    of the 13 GB stage reckons 59.6 GB above its weights on meta."""
    from repro_torch.dist.mesh import gather
    from repro_torch.models import params as P
    from repro_torch.runtime import MeshExecutor, StageState
    from repro_torch.runtime.numeric import get_stage_programs
    from repro_torch.tree import tree_leaves
    cfg = cfg.with_overrides(compute_dtype="float32", param_dtype="float32")
    prog = get_stage_programs(cfg, 2, MOE_SEQ, "none")[1]
    params = P.init(12, prog.specs, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(MOE_MB, MOE_SEQ, cfg.d_model, generator=gen,
                    device="cuda")
    lab = torch.randint(0, cfg.vocab_size, (MOE_MB, MOE_SEQ),
                        generator=gen, device="cuda")
    tps = [n for n in MOE_TP if n not in MOE_RULES]
    meshes = _moe_meshes(torch, ["one"] + tps)

    def grads(name: str):
        ex = MeshExecutor(cfg, 2, MOE_SEQ, 1, meshes[name], compress="none")
        st = StageState()
        ex.restore(st, {"params": params, "opt": None})
        st.grad_acc = None               # never accumulated into
        loss, gx, gp = ex.run_bwd(st, x, labels=lab)
        return ex.compute_path, float(loss), gx, gp

    row = {}
    with plain_precision(torch):
        _, loss1, gx1, gp = grads("one")
        ref = []
        for a in tree_leaves(gp):
            g = gather(a, a.mesh.devices.flat[0]).float()
            ref.append(torch.empty(g.shape, dtype=g.dtype,
                                   pin_memory=True).copy_(g))
            a.shards.fill(None)
            del g
        del gp
        free(torch)
        scales = [float(r.abs().max()) for r in ref]
        floor = MOE_NOISE_FLOOR * max(scales)
        for name in tps:
            path, loss, gx, gp = grads(name)
            gaps = {}
            for path_, a, r, bmax in zip(_leaf_paths(gp), tree_leaves(gp),
                                         ref, scales):
                g = gather(a, a.mesh.devices.flat[0])
                a.shards.fill(None)
                gap = _leaf_gaps(torch, [g], [r.to(g.device)])[
                    "grad_max_gap"]
                gaps[path_] = gap * bmax / max(bmax, floor)
                del g
            row[name] = {"path": path,
                         "loss_rel_diff": abs(loss - loss1) / abs(loss1),
                         "cotangent_max_gap": _max_gap(torch, [gx], [gx1]),
                         "grad_max_gap": max(gaps.values()),
                         "per_leaf": gaps}
            del gp, gx
            free(torch)
    del params, ref, x
    free(torch)
    bad = {n: r for n, r in row.items() if r["path"] != "tensor_parallel"
           or r["loss_rel_diff"] > TP_TWIN_LOSS_RTOL
           or max(r["cotangent_max_gap"], r["grad_max_gap"])
           > TP_TWIN_GRAD_RTOL}
    if bad:
        raise AssertionError(f"train_mesh_moe {cfg.name} f32 "
                             f"tensor-parallel twin: {row}")
    return row


def _pipeline_routes(torch, calls: list, ref_calls: list) -> list:
    """The pipeline's recorded ``apply_moe`` calls as route checks: each
    slot's two shard calls in turn (the forward's, then the ticks'
    recompute), each pair against the reference's call of the same
    layer and microbatch (the one with the pair's router whose input is
    nearest the pair's joined input)."""
    shard = [c for c in calls if c[2].shape[0] == MOE_MB // 2]
    if not shard or len(shard) % 2:
        raise AssertionError(f"train_pipeline_moe: {len(shard)} shard "
                             "calls of apply_moe")
    out = []
    for i in range(0, len(shard), 2):
        pair = shard[i:i + 2]
        x = torch.cat([c[2] for c in pair]).float()
        whole = min((c for c in ref_calls if torch.equal(c[1], pair[0][1])),
                    key=lambda c: float((c[2].float() - x).abs().max()))
        out.append(_route_checks(torch, [whole], pair))
    return out


def phase_train_pipeline_moe(torch) -> dict:
    """The pipeline's MoE case: ``make_pipeline_train_step``'s loss and
    gradients (no update) for ``moe_config`` over (``pod`` 2, ``data``
    2) of the card, ``PIPE_MOE_M`` microbatches of 2 x 512 each split 1
    + 1 (their MoE layers in lockstep), against
    ``make_reference_loss_fn`` on the same card, params and batch.
    Every layer's routes on the split must equal the whole-microbatch
    routing of the same router inputs, and the shards' own capacity must
    keep or drop some pairs otherwise.  A control routes each shard on
    its own rows (the reference at ``2 * PIPE_MOE_M`` microbatches of
    one row: the port's computation before the split context), and the
    loss and gradient bounds sit between the sound run's reading and the
    control's (``PIPE_MOE_LOSS_RTOL``, ``PIPE_MOE_GRAD_RTOL``); the
    control must break one of them.  Reckoned: params 13.0 GB bf16, two
    gradient sets of 13.0 GB each (the pipeline's is freed before the
    control's), a tick's gathered stage blocks 8.8 GB: about 50 GB."""
    from repro_torch import kernels
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.dist.pipeline import make_pipeline_train_step, \
        make_reference_loss_fn
    from repro_torch.models import params as P
    from repro_torch.train.steps import _value_and_grad, model_specs
    from repro_torch.tree import tree_leaves
    t0 = time.time()
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    cfg = moe_config()
    mesh = _card_mesh(torch, 4, shape=(2, 2), axes=("pod", "data"))
    params = P.init(0, model_specs(cfg), "cuda")
    b = SyntheticLM(cfg.vocab_size, MOE_SEQ, MOE_MB * PIPE_MOE_M,
                    seed=17).batch(0)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in b.items()}
    step = make_pipeline_train_step(cfg, train_opt(), 2, PIPE_MOE_M)
    before = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    t1 = time.time()
    with mesh, plain_flash_calls() as pf, moe_calls() as calls:
        loss_p, _, g_p = _value_and_grad(step.loss_fn, params, batch)
    torch.cuda.synchronize()
    pipe_s = time.time() - t1
    launched = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES
                if kernels.LAUNCHES[k] != before[k]}
    ref = make_reference_loss_fn(cfg, 2, PIPE_MOE_M)
    with moe_calls() as ref_calls:
        loss_r, _, g_r = _counted(torch, lambda: _value_and_grad(
            ref, params, batch))
    routes = _pipeline_routes(torch, calls, ref_calls)
    del calls, ref_calls
    gr = tree_leaves(g_r)
    sound = {"loss_rel_diff": abs(float(loss_p) - float(loss_r))
             / abs(float(loss_r)), **_leaf_gaps(torch, tree_leaves(g_p),
                                                gr)}
    del g_p
    free(torch)
    own = make_reference_loss_fn(cfg, 2, 2 * PIPE_MOE_M)
    loss_c, _, g_c = _counted(torch, lambda: _value_and_grad(
        own, params, batch))
    control = {"loss_rel_diff": abs(float(loss_c) - float(loss_r))
               / abs(float(loss_r)), **_leaf_gaps(torch, tree_leaves(g_c),
                                                  gr)}
    row = {"phase": "train_pipeline_moe", "arch": cfg.name,
           "layers": cfg.n_layers, "mesh": dict(mesh.shape),
           "microbatches": PIPE_MOE_M, "microbatch": [MOE_MB, MOE_SEQ],
           "loss": float(loss_p), "reference_loss": float(loss_r),
           **sound, "control_loss": float(loss_c),
           "control": control, "bounds": {
               "loss_rel_diff": PIPE_MOE_LOSS_RTOL,
               "grad_max_gap": PIPE_MOE_GRAD_RTOL},
           "route_pairs": len(routes),
           "routes_semantics_equal": all(r["semantics_equal"]
                                         for r in routes),
           "route_flips_vs_reference": sum(
               r["route_flips_vs_one_device"] for r in routes),
           "kept_flips_vs_reference": sum(
               r["kept_flips_vs_one_device"] for r in routes),
           "old_capacity_differs": [r["old_capacity_differs"]
                                    for r in routes],
           "pipeline_s": pipe_s, "launches": launched,
           "plain_flash_calls": len(pf),
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
           / 1e9}
    del params, g_r, g_c, gr, step, ref, own
    free(torch)
    row["seconds"] = time.time() - t0
    emit(row)

    def within(r):
        return (r["loss_rel_diff"] <= PIPE_MOE_LOSS_RTOL
                and r["grad_max_gap"] <= PIPE_MOE_GRAD_RTOL)
    if not row["routes_semantics_equal"] or \
            not sum(row["old_capacity_differs"]) or not within(sound) or \
            within(control) or pf or not all(
                launched.get(k) for k in ("flash_attention_fwd", "rmsnorm",
                                          "qdq_flat")):
        raise AssertionError(f"train_pipeline_moe: {row}")
    return row


# ------------------------------------------------------- serve_mesh_tp
# tensor-parallel serving at full width, depth cut: (arch, layers, the
# ("data", "model") meshes); batch 2, prompt 512, then 16 greedy decode
# steps, f32 twins bounded, bf16 reported
SERVE_TP_ARCHS = (("yi-6b", 2, ((1, 8),)),
                  (MOE_ARCH, 1, ((1, 2), (2, 2))),
                  (MLA_ARCH, 1, ((1, 2), (2, 2))))
SERVE_TP_BATCH, SERVE_TP_PROMPT, SERVE_TP_NEW = 2, 512, 16
SERVE_TP_LOGIT_RTOL = 1e-5      # the f32 twins, of the largest entry
# wq / wk scaled so that attention logits have a trained model's scale:
# the random init reads the heads axis as fan-in (as the JAX package's
# does), which saturates every softmax (logits of std ~280 at yi-6b's
# widths) and amplifies f32 rounding past the bound: unscaled, the f32
# twin's logits lay 1.2e-3 (yi-6b, 2 layers) and 4.9e-5 (llama4-scout)
# off one device with every token equal (PERF.md); on the CPU,
# yi-6b at 512 tokens gives 1.0e-4 unscaled, 1.4e-5 at 0.3 and 3.2e-6
# at 0.1 (logits of std 2.8).  MLA's init is not saturated (1.6e-6 /
# 3.1e-6 unscaled): it is left as drawn
SERVE_TP_ATTN_SCALE = 0.1


def serve_tp_config(arch: str, layers: int, dt: str):
    """``arch`` at full width, its first ``layers`` layers, computing in
    ``dt`` (the parameters keep their dtype)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg.with_overrides(
        n_layers=layers, compute_dtype=dt,
        block_pattern=cfg.block_pattern[:layers] if cfg.block_pattern
        else None)


@contextlib.contextmanager
def _returns(module, name: str):
    """Every value ``module.name`` returns while the block runs."""
    seen: list = []
    orig = getattr(module, name)

    def recorded(*args, **kw):
        out = orig(*args, **kw)
        seen.append(out)
        return out
    setattr(module, name, recorded)
    try:
        yield seen
    finally:
        setattr(module, name, orig)


def _serve_session(torch, cfg, params, tok, group=None, after=None):
    """``make_prefill_step`` then ``SERVE_TP_NEW`` greedy
    ``make_serve_step`` calls, on one device (``group`` None) or over
    ``group``'s model shards (a list of groups: the data shards, the
    rows split in order); ``after(caches)`` after each step.  Returns
    ``(tokens [B, 1 + NEW], logits [steps, B, V] f32)``."""
    from repro_torch.models import model as model_lib
    from repro_torch.train import steps as S
    many = isinstance(group, list)
    pre = S.make_prefill_step(cfg, cache_len=SERVE_TP_PROMPT + SERVE_TP_NEW,
                              group=group)
    dec = S.make_serve_step(cfg, group=group)
    rows = [{"tokens": t} for t in tok.chunk(len(group))] if many else \
        {"tokens": tok}
    toks, logits = [], []
    with _returns(model_lib, "head" if group is None else
                  "head_blocks_tp") as heads:
        with torch.no_grad():
            nxt, caches = pre(params, rows)
            for i in range(SERVE_TP_NEW + 1):
                if after is not None:
                    after(caches)
                toks.append(torch.cat(nxt) if many else nxt)
                if i < SERVE_TP_NEW:
                    nxt, caches = dec(params, caches, nxt,
                                      SERVE_TP_PROMPT + i)
    n = len(group) if many else 1
    for k in range(0, len(heads), n):
        parts = [h if group is None else torch.cat(h, -1)
                 for h in heads[k:k + n]]
        logits.append(torch.cat(parts)[:, -1].float())
    del caches
    return torch.cat(toks, 1), torch.stack(logits)


def serve_tp_launches_planned(cfg, mesh) -> dict:
    """Flash and rmsnorm launches on each coordinate in a session
    (prefill, ``SERVE_TP_NEW`` decode steps) where the heads, the FFN
    and the vocab split: flash a layer on every shard in the prefill
    (decode attends in plain PyTorch, as the JAX package does); a step
    norms ``ln1`` on every shard (each writes its cache block or copy),
    ``ln2`` on every shard for a dense FFN, at home for a MoE, and the
    final norm on every shard (the vocab-parallel head)."""
    steps, L = 1 + SERVE_TP_NEW, cfg.n_layers
    moe = bool({"moe", "mla_moe"} & set(cfg.block_kinds))
    return {c: {"flash_attention_fwd": L,
                "rmsnorm": steps * (L * (1 if moe and c[-1] else 2) + 1)}
            for c in mesh.coords()}


def _copies_equal(torch, rows: list, shardings) -> bool:
    """Every data shard's copies of a replicated cache (a leaf whose
    layout does not split it over ``model``: each model shard holds it
    whole) equal to the bit; ``rows[i][j]`` data shard ``i``'s model
    shard ``j``'s caches."""
    from repro_torch.dist import tensor_parallel as tp
    from repro_torch.dist.mesh import NamedSharding
    from repro_torch.tree import tree_leaves
    whole = [tp.split_dim(s) is None for s in tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, NamedSharding))]
    for row in rows:
        for copy, col in zip(whole, zip(*(tree_leaves(c) for c in row))):
            if copy and not all(torch.equal(t, col[0]) for t in col[1:]):
                return False
    return True


def _serve_tp_arch(torch, arch: str, layers: int, shapes) -> dict:
    """One arch of :func:`phase_serve_mesh_tp`."""
    from repro_torch.dist import sharding as sh
    from repro_torch.dist import tensor_parallel as tp
    from repro_torch.dist.mesh import place_as
    from repro_torch.models import model as model_lib
    from repro_torch.models import params as P
    from repro_torch.models.params import is_spec
    from repro_torch.train import steps as S
    from repro_torch.tree import tree_leaves, tree_map
    rows: dict = {"arch": arch, "reduced": {"n_layers": layers}}
    base = serve_tp_config(arch, layers, "bfloat16")
    params = P.init(31, S.model_specs(base), "cuda")
    with torch.no_grad():
        for seg in params["blocks"]:
            for key in ("wq", "wk") if "attn" in seg else ():
                seg["attn"][key].mul_(SERVE_TP_ATTN_SCALE)
    rows["attn_scale"] = SERVE_TP_ATTN_SCALE if any(
        "attn" in seg for seg in params["blocks"]) else None
    gen = torch.Generator(device="cuda").manual_seed(32)
    tok = torch.randint(0, base.vocab_size, (SERVE_TP_BATCH,
                                             SERVE_TP_PROMPT),
                        generator=gen, device="cuda")
    for dt in ("float32", "bfloat16"):
        cfg = serve_tp_config(arch, layers, dt)
        def ctx():
            return plain_precision(torch) if dt == "float32" else \
                contextlib.nullcontext()
        with ctx(), moe_calls() as one_calls:
            t1, l1 = _counted(torch, lambda: _serve_session(
                torch, cfg, params, tok))
        for shape in shapes:
            mesh = _tp_mesh(torch, shape)
            groups = [tp.Group.of(mesh, data=i) for i in range(shape[0])]
            placed = tree_map(place_as, params,
                              sh.param_shardings(cfg, mesh))
            # the routed expert stacks as their data slices where the
            # batch splits over every data shard (apply_moe_a2a)
            sliced = tp.slices_experts(mesh, len(groups))
            trees = [[tp.gather_block(placed, mesh.devices[c], j,
                                      i if sliced else None)
                      for j, c in enumerate(g.coords)]
                     for i, g in enumerate(groups)]
            specs = model_lib.lm_cache_specs(
                cfg, SERVE_TP_BATCH, SERVE_TP_PROMPT + SERVE_TP_NEW)
            cache_sh = sh.cache_shardings_from_specs(cfg, mesh, specs,
                                                     batch_axis="data")
            shapes_ = tree_map(lambda s: torch.Size(s.shape), specs,
                               is_leaf=is_spec)
            copies, blocks = [], {}

            def after(caches):
                rows_ = caches if len(groups) > 1 else [caches]
                copies.append(_copies_equal(torch, rows_, cache_sh))
                if blocks:
                    return
                for g, row in zip(groups, rows_):
                    for c, cj in zip(g.coords, row):
                        tp.check_cache_blocks(cj, shapes_, cache_sh, c)
                        blocks[str(list(c))] = sum(
                            t.numel() * t.element_size()
                            for t in tree_leaves(cj))
            group = groups if len(groups) > 1 else groups[0]
            t0 = time.time()
            with ctx(), moe_calls() as calls, coord_launches() as per, \
                    flash_dims_by_coord() as dims, plain_flash_calls() as pf, \
                    dispatch_shapes() as bufs:
                t2, l2 = _serve_session(
                    torch, cfg, trees if len(groups) > 1 else trees[0], tok,
                    group, after)
            secs = time.time() - t0
            n = len(groups)
            routes = [_route_checks(torch, one_calls[k:k + 1],
                                    calls[k * n:(k + 1) * n])
                      for k in range(len(one_calls))]
            gap = float((l2 - l1).abs().max() / l1.abs().max())
            key = f"{dt}_{shape[0]}x{shape[1]}"
            rows[key] = {
                "mesh": list(shape), "seconds": secs,
                "token_flips": int((t1 != t2).sum()),
                "tokens": int(t1.numel()),
                "logits_max_gap": gap,
                "bounded": dt == "float32",
                "copies_equal_every_step": all(copies),
                "steps_checked": len(copies),
                "cache_bytes_by_coord": blocks,
                "routes_semantics_equal": all(r["semantics_equal"]
                                              for r in routes),
                # each coordinate's expert buffer shapes where the
                # experts hold their data slices (apply_moe_a2a)
                "expert_slices": sliced,
                "buffers_by_coord": {str(list(c)): sorted(
                    list(x) for x in v) for c, v in bufs.items()},
                "route_flips_vs_one_device": sum(
                    r["route_flips_vs_one_device"] for r in routes),
                "plain_flash_calls": len(pf),
                "launches_by_coord": {str(list(c)): {
                    k: per[c][k] for k in ("flash_attention_fwd",
                                           "rmsnorm")}
                    for c in mesh.coords()},
                "launches_by_coord_planned": {
                    str(list(c)): v for c, v in
                    serve_tp_launches_planned(cfg, mesh).items()},
                "flash_dims_by_coord": {str(list(c)): sorted(
                    list(x) for x in dims[c]) for c in mesh.coords()},
                "flash_dims_planned": {str(list(c)): [[
                    cfg.n_heads // shape[1], *_head_dims(cfg)]]
                    for c in mesh.coords()}}
            emit({"phase": "serve_mesh_tp", "arch": arch, "run": key,
                  **rows[key]})
            del placed, trees, calls, t2, l2
            free(torch)
        del one_calls, t1, l1
        free(torch)
    del params
    free(torch)
    return rows


def _serve_tp_checks(row: dict) -> None:
    """:func:`_serve_tp_arch`'s gates."""
    name = f"serve_mesh_tp {row['arch']}"
    for key, r in row.items():
        if not isinstance(r, dict) or "mesh" not in r:
            continue
        bad = []
        if r["bounded"] and (r["token_flips"] or
                             r["logits_max_gap"] > SERVE_TP_LOGIT_RTOL):
            bad.append("f32 twin")
        if not r["copies_equal_every_step"] or \
                r["steps_checked"] != SERVE_TP_NEW + 1:
            bad.append("cache copies")
        if not r["routes_semantics_equal"]:
            bad.append("routes")
        if r["expert_slices"] and \
                len(r["buffers_by_coord"]) != r["mesh"][0] * r["mesh"][1]:
            bad.append("expert buffers")
        if r["plain_flash_calls"] or \
                r["launches_by_coord"] != r["launches_by_coord_planned"]:
            bad.append("launches")
        if r["flash_dims_by_coord"] != r["flash_dims_planned"]:
            bad.append("flash heads")
        if bad:
            raise AssertionError(f"{name} {key}: {bad}: {r}")


def phase_serve_mesh_tp(torch) -> dict:
    """Tensor-parallel serving (``make_prefill_step`` /
    ``make_serve_step`` with model-shard groups) at full width on
    virtual ("data", "model") meshes of the card, for each of
    ``SERVE_TP_ARCHS`` against the one-device steps on the same weights
    and prompts: an f32 twin's tokens equal and its logits within
    ``SERVE_TP_LOGIT_RTOL`` of the largest entry, bf16 token flips
    reported; MoE routes equal to the whole batch's routing of the same
    router inputs; every replicated cache copy equal to the bit after
    every step; each coordinate's cache blocks those of JAX's layout
    (``cache_shardings_from_specs``), their bytes reported; flash and
    rmsnorm launches and flash's head count by coordinate against the
    plan, no plain flash call; the phase's peak under the card's 80
    GB."""
    t0 = time.time()
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    rows = {}
    for arch, layers, shapes in SERVE_TP_ARCHS:
        t1 = time.time()
        rows[arch] = _serve_tp_arch(torch, arch, layers, shapes)
        rows[arch]["seconds"] = time.time() - t1
    peak = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "serve_mesh_tp_done", "seconds": time.time() - t0,
          "max_memory_allocated_gb": peak,
          "archs": {a: r["seconds"] for a, r in rows.items()}})
    for r in rows.values():
        _serve_tp_checks(r)
    if peak >= 80:
        raise AssertionError(f"serve_mesh_tp: peak {peak} GB")
    return rows


# ------------------------------------------------------------ phase 21b
# the examples (repro_torch.examples) on the card: quickstart, the
# serving demo on yi-6b's reduced config (head dims widened for the
# flash kernel), and the Fig. 4 parity run at --model 100m with both
# arms unclipped (the example's default clip of 1.0, JAX's, is per stage
# in SWARM and of the whole model in make_train_step: ROADMAP queue 3)
EXAMPLE_SERVE = ["--arch", "yi-6b", "--batch", "4", "--prompt-len", "32",
                 "--new-tokens", "16"]
EXAMPLE_TRAIN = ["--model", "100m", "--steps", "12", "--grad-clip", "0"]


def phase_examples(torch) -> dict:
    """Each example's ``main`` on the card (its default device):
    quickstart's loss falls through its preemption; serve_pipeline's
    tokens equal ``reference_generate``'s on the same weights and
    prompts; train_swarm_lm at ``--model 100m --grad-clip 0`` prints
    parity ``OK``, both curves fall, and its f32 flash and the int8
    wire's QDQ launch."""
    from repro_torch import kernels
    from repro_torch.configs import get_reduced
    from repro_torch.examples import card_sized, quickstart, \
        serve_pipeline, train_swarm_lm
    from repro_torch.models import model as model_lib
    from repro_torch.models import params as P
    from repro_torch.serve import reference_generate
    t0 = time.time()
    rows = {}
    t1 = time.time()
    out = quickstart.main([])
    rows["quickstart"] = {"losses": out["losses"],
                          "failures": out["failures"],
                          "seconds": time.time() - t1}
    cfg = card_sized(get_reduced("yi-6b"), torch.device("cuda"))
    params = P.init(0, model_lib.lm_specs(cfg), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen,
                            device="cuda")
    t1 = time.time()
    got = serve_pipeline.main(EXAMPLE_SERVE, params=params, prompts=prompts)
    rows["serve_pipeline"] = {"head_dim": cfg.hd,
                              "seconds": time.time() - t1}
    want = _counted(torch, lambda: reference_generate(
        cfg, params, prompts.cpu().numpy(), 16))
    rows["serve_pipeline"]["tokens_equal_reference"] = bool(
        (got.cpu().numpy() == want).all())
    del params
    free(torch)
    before = dict(kernels.LAUNCHES)
    t1 = time.time()
    with plain_flash_calls() as pf:
        out = train_swarm_lm.main(EXAMPLE_TRAIN)
    launched = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES
                if kernels.LAUNCHES[k] != before[k]}
    rows["train_swarm_lm"] = {
        "argv": EXAMPLE_TRAIN, "swarm_losses": out["swarm_losses"],
        "ref_losses": out["ref_losses"], "swarm_wall_s": out["swarm_s"],
        "ref_wall_s": out["ref_s"], "parity": out["parity"],
        "launches": launched, "plain_flash_calls": len(pf),
        "seconds": time.time() - t1}
    free(torch)
    emit({"phase": "examples", **rows, "seconds": time.time() - t0})
    tr = rows["train_swarm_lm"]
    if not rows["serve_pipeline"]["tokens_equal_reference"] or \
            tr["parity"] != "OK" or pf or \
            not tr["swarm_losses"][-1] < tr["swarm_losses"][0] or \
            not tr["ref_losses"][-1] < tr["ref_losses"][0] or \
            not launched.get("flash_attention_fwd") or \
            not launched.get("qdq_flat"):
        raise AssertionError(f"examples: {rows}")
    return rows


# ------------------------------------------------------------ phase 22
# the dry run's pipeline cell: make_pipeline_train_step over the multi-pod
# mesh (pod 2 x data 16 x model 16, on meta), which the dry run takes for
# a stage-periodic config: yi-6b's 32 layers split 16 + 16, while
# swarm-1b-bottleneck's 3 shared groups do not split over 2 pods (its
# multi cell is the data-parallel path)
DRYRUN_CELL = ("yi-6b", "train_4k", "multi")
# the meta reckoning against the card, both ways: |meta - card| within 5 %
# of the card's peak plus 64 MiB (PERF.md §6, the dry run's prediction:
# allocator blocks, CUDA ops' own workspaces)
DRYRUN_REL, DRYRUN_ABS = 0.05, 64 * 2 ** 20
TRAIN_SEQ_DRYRUN = 4096         # the train_4k cell's sequence
DRYRUN_TP_LAYERS, DRYRUN_TP_SEQ = 2, 512    # the tensor-parallel calls
DRYRUN_WAIT = 600               # seconds the last phase waits for the cell


def _dryrun_calls(torch, dev: str) -> dict:
    """Phase dryrun's calls on ``dev`` (``"meta"`` or ``"cuda"``),
    their inputs made there (random from a seed on the card, shapes alone
    on meta): yi-6b's attn layer at the train shape (B 2, S 4,096),
    forward and backward (flash, rmsnorm); swarm-1b-bottleneck's
    boundary at its training microbatch (2 x 512), encode then decode;
    the same boundary on swarm-1b's int8 wire (qdq_flat); and the
    tensor-parallel prefill and decode (:func:`_dryrun_tp_calls`)."""
    from repro_torch.compression import codecs
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.models import params as P
    from repro_torch.models.blocks import REGISTRY
    from repro_torch.tree import tree_leaves
    meta = dev == "meta"

    def make(specs, seed):
        return P.abstract(specs) if meta else P.init(seed, specs, dev)

    def randn(shape, dtype, seed):
        if meta:
            return torch.empty(shape, dtype=dtype, device="meta")
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    yi = get_config("yi-6b")
    p = make(REGISTRY["attn"][0](yi), 25)
    leaves = [a.requires_grad_() for a in tree_leaves(p)]
    x = randn((2, TRAIN_SEQ_DRYRUN, yi.d_model), yi.compute_jdtype, 26)
    x.requires_grad_()
    pos = model_lib.default_positions(yi, 2, TRAIN_SEQ_DRYRUN, device=dev)

    def attn_layer():
        y, _ = REGISTRY["attn"][1](yi, p, x, pos)
        return torch.autograd.grad(y.to(torch.float32).sum(), [x] + leaves)

    sw = swarm1b()
    bp = {**make(codecs.sender_specs(sw), 27),
          **make(codecs.receiver_specs(sw), 28)}
    z = randn((2, 512, sw.d_model), sw.compute_jdtype, 29)
    int8 = get_config("swarm-1b")

    def boundary():
        with torch.no_grad():
            return codecs.decode_wire(sw, "bottleneck", bp, codecs.encode_wire(
                sw, "bottleneck", bp, z))

    def int8_wire():
        with torch.no_grad():
            return codecs.int8_boundary(int8, z)

    return {"attn_layer": attn_layer, "boundary": boundary,
            "int8_wire": int8_wire, **_dryrun_tp_calls(torch, dev)}


def _dryrun_tp_calls(torch, dev: str) -> dict:
    """Phase dryrun's tensor-parallel serving calls on ``dev``: yi-6b cut
    to ``DRYRUN_TP_LAYERS`` layers over a (1, 2) ("data", "model") mesh
    of ``dev`` (virtual on the card), a prefill of 2 x ``DRYRUN_TP_SEQ``
    tokens and one decode step on the caches a prefill made beforehand
    (``make_prefill_step`` / ``make_serve_step`` with the group)."""
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as sh
    from repro_torch.dist import tensor_parallel as tp
    from repro_torch.dist.mesh import place_as
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import params as P
    from repro_torch.train import steps as S
    from repro_torch.tree import tree_map
    meta = dev == "meta"
    cfg = get_config("yi-6b").with_overrides(n_layers=DRYRUN_TP_LAYERS)
    d = torch.device("meta") if meta else torch.device("cuda", 0)
    mesh = make_debug_mesh((1, 2), ("data", "model"), devices=[d] * 2)
    group = tp.Group.of(mesh, data=0)
    specs = S.model_specs(cfg)
    params = P.abstract(specs) if meta else P.init(33, specs, dev)
    placed = tree_map(place_as, params, sh.param_shardings(cfg, mesh))
    trees = [tp.gather_block(placed, d, j) for j in range(2)]
    shape = (2, DRYRUN_TP_SEQ)
    if meta:
        tok = torch.empty(shape, dtype=torch.int64, device=d)
    else:
        g = torch.Generator(device=dev).manual_seed(34)
        tok = torch.randint(0, cfg.vocab_size, shape, generator=g,
                            device=dev)
    pre = S.make_prefill_step(cfg, cache_len=DRYRUN_TP_SEQ + 1,
                              group=group)
    dec = S.make_serve_step(cfg, group=group)
    with torch.no_grad():
        nxt, caches = _counted(torch, lambda: pre(trees, {"tokens": tok}))

    def tp_prefill():
        with torch.no_grad():
            return pre(trees, {"tokens": tok})

    def tp_decode():
        with torch.no_grad():
            return dec(trees, caches, nxt, DRYRUN_TP_SEQ)
    return {"tp_prefill": tp_prefill, "tp_decode": tp_decode}



def _within(a: float, card: float) -> bool:
    return abs(a - card) <= DRYRUN_REL * card + DRYRUN_ABS


def start_dryrun_cell():
    """Start the dry run of ``DRYRUN_CELL`` (``python -m
    repro_torch.launch.dryrun``, one CPU thread) beside the card's
    phases: it runs on meta and needs the host alone (about two minutes
    on one core), so it costs the script no wall time.  Stopped at exit
    if it is still running."""
    import atexit
    root = os.path.dirname(os.path.abspath(__file__))
    arch, shape, mesh = DRYRUN_CELL
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--force"], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    atexit.register(stop)
    return proc


def phase_dryrun(torch, proc) -> dict:
    """(a) Each of ``_dryrun_calls`` once on meta under the dry run's
    ledger and counters and once on the card: ``LAUNCHES`` on the card
    equal to ``META_CALLS`` on meta for every kernel; the ledger's meta
    peak and the ledger run on the card's call against the allocator's
    peak above what was allocated before (after a warm-up call), within
    ``DRYRUN_REL`` / ``DRYRUN_ABS``.  (b) The dry-run cell ``DRYRUN_CELL``
    on this machine's torch (``proc``, :func:`start_dryrun_cell`): its
    record's memory, FLOPs and collectives (a reckoning on meta)."""
    from repro_torch import kernels
    from repro_torch.launch import dryrun
    from repro_torch.launch import hlo_analysis as H
    t0 = time.time()
    on_meta, on_card = _dryrun_calls(torch, "meta"), \
        _dryrun_calls(torch, "cuda")
    rows = {}
    for name, fn in on_meta.items():
        kernels.reset_meta_calls()
        ledger = H.DeviceLedger()
        with ledger:
            out = fn()
        del out
        # every coordinate's bytes together (the tensor-parallel calls
        # run as the mesh's coordinates; the card holds them all)
        meta_calls, meta_peak = dict(kernels.META_CALLS), ledger.peak_total
        card = on_card[name]
        _counted(torch, card)                 # warm: cuBLAS workspaces
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        tracked = H.DeviceLedger()
        with tracked:
            out = card()
        torch.cuda.synchronize()
        card_peak = torch.cuda.max_memory_allocated() - base
        launches = dict(kernels.LAUNCHES)
        del out
        on_card_peak = tracked.peak_total
        row = {"launches": launches, "meta_calls": meta_calls,
               "meta_peak_bytes": meta_peak, "card_peak_bytes": card_peak,
               "tracked_card_peak_bytes": on_card_peak,
               "meta_minus_card_bytes": meta_peak - card_peak,
               "tracked_minus_card_bytes": on_card_peak - card_peak,
               "bound_bytes": DRYRUN_REL * card_peak + DRYRUN_ABS}
        emit({"phase": "dryrun", "call": name, **row})
        if launches != meta_calls or not any(launches.values()):
            raise AssertionError(f"dryrun {name}: launches {launches} != "
                                 f"meta calls {meta_calls}")
        if not (_within(meta_peak, card_peak)
                and _within(on_card_peak, card_peak)):
            raise AssertionError(f"dryrun {name}: meta {meta_peak} / "
                                 f"tracked {on_card_peak} bytes against "
                                 f"the card's {card_peak}")
        rows[name] = row
    del on_meta, on_card
    free(torch)
    t1 = time.time()
    out, err = proc.communicate(timeout=DRYRUN_WAIT)
    arch, shape, mesh = DRYRUN_CELL
    path = os.path.join(os.path.dirname(dryrun.artifact_path(arch, shape,
                                                             mesh)),
                        f"{mesh}__{arch}__{shape}.json")
    if proc.returncode != 0 or not os.path.exists(path):
        raise AssertionError(f"dryrun cell {DRYRUN_CELL} failed: "
                             f"{out[-2000:]} {err[-4000:]}")
    with open(path) as f:
        rec = json.load(f)
    if rec["status"] != "ok" or not rec["pipeline"] or \
            rec["flops_per_device"] <= 0:
        raise AssertionError(f"dryrun cell {DRYRUN_CELL}: {rec}")
    rows["cell"] = {k: rec[k] for k in (
        "arch", "shape", "mesh", "pipeline", "n_devices", "device",
        "data_shards", "computed_shards", "memory", "flops_per_device",
        "bytes_per_device", "collectives", "run_s", "cell_s")}
    emit({"phase": "dryrun_cell", "reckoned_on": "meta", **rows["cell"],
          "waited_s": time.time() - t1})
    emit({"phase": "dryrun_done", "seconds": time.time() - t0})
    return rows


def main() -> None:
    import numpy as np
    if sys.argv[1:] not in ([], ["--kernels-only"]):
        sys.exit(f"usage: {sys.argv[0]} [--kernels-only]")
    torch = setup()
    from repro_torch import kernels
    t_start = time.time()
    dryrun_proc = None if sys.argv[1:] else start_dryrun_cell()
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
    # the attention families at full width (depth cut for the two MoE
    # models), each config's launches counted from its own serve run
    phase_serve_families(torch)
    # the encoder-decoder at full width and depth, served and trained
    phase_serve_whisper(torch)
    phase_train_whisper(torch)
    # one-process training through the launcher, and swarm-1b's staged
    # reference against it
    phase_train_single(torch)
    # the reference steps train holds (the mesh phases hold a prefix)
    ref_losses = train_reference(torch, swarm1b(), TRAIN_STEPS)
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
    # span peers, each run held to train's losses to the bit:
    # swarm-1b-span has swarm-1b-bottleneck's shapes and stage params
    for phase in (phase_train_span, phase_train_span_resize,
                  phase_train_span_rebalance):
        phase(torch, train)
    # mesh-backed peers (virtual meshes of the card), then the compiled
    # shifting-buffer pipeline at full width and depth
    phase_train_mesh(torch, train, ref_losses)
    # tensor-parallel compute over the model axis of virtual meshes
    phase_train_mesh_tp(torch, ref_losses)
    phase_train_pipeline(torch)
    # a MoE stage over a data-split microbatch (llama4-scout at full
    # width, one layer a stage): mesh peers, then the pipeline
    phase_train_mesh_moe(torch)
    phase_train_pipeline_moe(torch)
    # serving over the model axis (prefill and decode), full width
    phase_serve_mesh_tp(torch)
    # the async tick: in-flight edges (losses to train's bit), then
    # delayed parameter updates behind the bounded-staleness barrier
    t_new = time.time()
    phase_train_overlap(torch, train)
    train_async = phase_train_async(torch)
    phase_train_async_churn(torch, train_async)
    # serving the paper's own model (shared groups) and a learned codec
    phase_serve_shared(torch)
    phase_serve_codec(torch)
    emit({"phase": "async_and_shared_serving_done",
          "seconds": time.time() - t_new})
    phase_train_rollback(torch)
    launches.update(phase_wire_codes(torch)["launches"])
    phase_train_profile(torch)
    phase_examples(torch)
    # the dry run's meta reckoning against the card, and one pipeline cell
    phase_dryrun(torch, dryrun_proc)
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
