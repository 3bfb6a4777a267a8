"""Baseline systems the paper compares against (Table 2): GPipe, 1F1B, and
ZeRO-Offload, modelled on the same device/network cost model as SWARM
(port of ``repro.core.baselines``).

These are steady-state analytic models (the baselines are rigid synchronous
systems, so closed forms are exact up to the bubble term), matching the
paper's §4.2 setup: 16 workers, 4 stages x 4 data-parallel groups for the
pipelines; full-model data parallelism for ZeRO-Offload.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.peer import DeviceProfile
from repro_torch.models.config import ArchConfig
from repro_torch.models import flops as F


@dataclasses.dataclass(frozen=True)
class BaselineResult:
    name: str
    throughput: float          # samples/s
    allreduce_time: float      # s per averaging round


def _stage_times(cfg: ArchConfig, profile: DeviceProfile, seq: int,
                 n_stages: int, microbatch: int, compress: str):
    ctx = F._ctx_for(cfg, seq, causal_avg=True)
    per = cfg.n_layers // n_stages
    fpt = sum(F.per_token_layer_flops(cfg, k, ctx)
              for k in cfg.block_kinds[:per])
    t_c = profile.compute_time(3.0 * fpt * seq * microbatch)   # fwd+bwd
    # boundary_bytes resolves the REAL per-codec wire size (int8 block
    # scales, cfg.bottleneck_dim / maxout k) — baseline-vs-SWARM tables
    # therefore compare identical wire-byte assumptions for every mode
    nbytes = F.boundary_bytes(cfg, microbatch, seq, compress)
    t_n = 2 * (profile.latency + nbytes / profile.up_bw)       # act + grad
    return t_c, t_n


def _allreduce_time(nbytes: float, k: int, bw: float, latency: float):
    return 2 * (k - 1) / max(k, 1) * nbytes / bw + 2 * latency * k


def gpipe(cfg: ArchConfig, profile: DeviceProfile, *, seq: int = 512,
          n_workers: int = 16, n_stages: int = 4, microbatch: int = 1,
          n_microbatches: int = 8, compress: str = "none",
          name: str = "GPipe") -> BaselineResult:
    """Synchronous pipeline: communication is exposed (blocking RPC), and
    the (S-1)/(M+S-1) bubble applies."""
    groups = n_workers // n_stages
    t_c, t_n = _stage_times(cfg, profile, seq, n_stages, microbatch,
                            compress)
    t_mb = t_c + t_n                          # no compute/comm overlap
    t_batch = (n_microbatches + n_stages - 1) * t_mb
    thr = groups * n_microbatches * microbatch / t_batch
    stage_bytes = 2.0 * F.total_params(cfg) / n_stages
    ar = _allreduce_time(stage_bytes, groups, profile.up_bw,
                         profile.latency)
    return BaselineResult(name, thr, ar)


def one_f1b(cfg: ArchConfig, profile: DeviceProfile, **kw) -> BaselineResult:
    """1F1B (PipeDream-flush): same steady-state throughput as GPipe,
    lower activation memory (identical in this cost model — Table 2 shows
    identical throughput/all-reduce too)."""
    r = gpipe(cfg, profile, **kw)
    return BaselineResult("1F1B", r.throughput, r.allreduce_time)


def zero_offload(cfg: ArchConfig, profile: DeviceProfile, *, seq: int = 512,
                 n_workers: int = 16, microbatch: int = 1,
                 offload_slowdown: float = 1.6) -> BaselineResult:
    """Full-model data parallelism with CPU-offloaded optimizer: every
    worker computes the whole model (slowed by PCIe streaming), then
    All-Reduces the FULL parameter-sized gradient."""
    ctx = F._ctx_for(cfg, seq, causal_avg=True)
    fpt = sum(F.per_token_layer_flops(cfg, k, ctx) for k in cfg.block_kinds)
    t_c = profile.compute_time(3.0 * fpt * seq * microbatch) \
        * offload_slowdown
    thr = n_workers * microbatch / t_c
    ar = _allreduce_time(2.0 * F.total_params(cfg), n_workers,
                         profile.up_bw, profile.latency)
    return BaselineResult("ZeRO-Offload", thr, ar)
