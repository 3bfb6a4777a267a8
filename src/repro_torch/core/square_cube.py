"""The square-cube law of distributed training (paper §3.1, Fig. 1/3,
Table 1), and the inter-region link model the span planners price
boundaries with (port of ``repro.core.square_cube``, copied: plain
arithmetic).

Per pipeline stage: compute grows ~O(n^3) with the hidden dimension
(matmul) while the boundary transfer grows ~O(n^2) (activations) — so
device utilization ``t_compute / (t_compute + t_exposed_comm)`` rises
with model size at fixed bandwidth.  SWARM additionally overlaps
communication with queued microbatches; ``overlap`` interpolates between
fully-serial (0) and fully-overlapped (1) communication.

The efficiency curve models the empirical fact (paper App. F, Table 6
timings) that small matmuls underutilize the GPU: eff rises from ~8% for
d=768 toward ~45% for d=12288 on V100-class parts running unfused fp16
PyTorch blocks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

MBPS = 125_000.0


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One benchmark configuration of §4.1 / App. F."""
    name: str
    d_model: int
    d_ff: int
    n_heads: int
    layers_per_stage: int = 1
    quantize8: bool = False


# The four configurations of §4.1 (App. F).
BASE = LayerSpec("base", 768, 3072, 12)
XXLARGE = LayerSpec("xxlarge", 4096, 16384, 32)
GPT3 = LayerSpec("GPT-3", 12288, 49152, 96)
OURS = LayerSpec("Ours", 4096, 16384, 32, layers_per_stage=3, quantize8=True)
ALL_SPECS = [BASE, XXLARGE, GPT3, OURS]


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """One inter-region (or intra-region) link class: the §4.3
    deployment spans preemptible zones whose pairwise bandwidth/latency
    differ by an order of magnitude, so boundary pricing must be a
    function of the REGION PAIR, not one fleet-wide constant."""
    a: str
    b: str
    bandwidth_mbps: float
    latency_s: float

    def transfer_time(self, nbytes: float) -> float:
        return self.latency_s + nbytes / (self.bandwidth_mbps * MBPS)


class LinkTable:
    """Symmetric region-pair -> :class:`LinkSpec` lookup.

    Unlisted pairs fall back to ``intra_default`` (same region) or
    ``cross_default`` (different regions) so a partial table still
    prices every edge.  ``edge_costs`` is the planner entry point: it
    turns per-boundary byte counts plus a per-stage region vector into
    per-boundary *seconds*, which feed ``optimal_assignment`` /
    ``plan_span_change`` as ``boundary_cost`` — an edge between stages
    homed in regions linked by a slow WAN pair prices high, so the span
    planners fuse across slow links first (the region-aware placement
    of the paper's App. I fleets)."""

    def __init__(self, specs: "list[LinkSpec] | None" = None, *,
                 intra_default: Optional[LinkSpec] = None,
                 cross_default: Optional[LinkSpec] = None):
        self._by_pair: dict[frozenset, LinkSpec] = {}
        for sp in specs or []:
            self._by_pair[frozenset((sp.a, sp.b))] = sp
        self.intra_default = intra_default or LinkSpec(
            "*", "*", bandwidth_mbps=800.0, latency_s=0.002)
        self.cross_default = cross_default or LinkSpec(
            "*", "*", bandwidth_mbps=100.0, latency_s=0.045)

    def spec(self, a: str, b: str) -> LinkSpec:
        sp = self._by_pair.get(frozenset((a, b)))
        if sp is not None:
            return sp
        return self.intra_default if a == b else self.cross_default

    def transfer_time(self, nbytes: float, a: str, b: str) -> float:
        return self.spec(a, b).transfer_time(nbytes)

    def edge_costs(self, nbytes_per_edge: "Sequence[float]",
                   stage_regions: "Sequence[str]") -> list[float]:
        """Per-boundary seconds for edge ``b`` between the regions
        serving stages ``b`` and ``b+1``."""
        if len(stage_regions) != len(nbytes_per_edge) + 1:
            raise ValueError(
                f"{len(stage_regions)} stage regions cannot price "
                f"{len(nbytes_per_edge)} edges (need n_stages = "
                f"n_edges + 1)")
        return [self.transfer_time(nb, stage_regions[b],
                                   stage_regions[b + 1])
                for b, nb in enumerate(nbytes_per_edge)]


def default_wan_table() -> LinkTable:
    """A 4-region preemptible-fleet WAN model (App. I flavored):
    fast in-zone links, a slower cross-country pair, and genuinely
    bad trans-ocean pairs — the spread that makes region-aware span
    fusion matter."""
    regions = ("us-east", "us-west", "eu", "ap")
    specs = [LinkSpec(r, r, bandwidth_mbps=800.0, latency_s=0.002)
             for r in regions]
    specs += [
        LinkSpec("us-east", "us-west", 200.0, 0.030),
        LinkSpec("us-east", "eu", 100.0, 0.045),
        LinkSpec("us-west", "eu", 80.0, 0.070),
        LinkSpec("us-east", "ap", 60.0, 0.080),
        LinkSpec("us-west", "ap", 100.0, 0.060),
        LinkSpec("eu", "ap", 50.0, 0.090),
    ]
    return LinkTable(specs)


def layer_flops(spec: LayerSpec, seq: int, batch: int) -> float:
    d, f = spec.d_model, spec.d_ff
    attn = 8 * d * d + 4 * seq * d
    ffn = 4 * d * f
    per_token = (attn + ffn) * spec.layers_per_stage
    return per_token * seq * batch


# Calibrated against the paper's Table 1 (20 points, log-space least
# squares): V100 running unfused fp16 PyTorch blocks reaches ~31 TFLOP/s
# asymptotically; small matmuls fall off with tau=2000; each boundary RPC
# costs ~5 ms; queued microbatches overlap ~90% of communication.
PEAK_FLOPS = 31e12
RPC_OVERHEAD = 0.005
DEFAULT_OVERLAP = 0.9


def matmul_efficiency(d_model: int, peak_flops: float = PEAK_FLOPS) -> float:
    """Effective fraction of peak for an unfused fp16 transformer layer —
    saturating curve calibrated on the paper's App. F timings."""
    return 0.45 * (1.0 - math.exp(-d_model / 2000.0)) + 0.02


def stage_times(spec: LayerSpec, *, seq: int = 512, batch: int = 1,
                bandwidth_mbps: float = 500.0, rtt_s: float = 0.0,
                peak_flops: float = PEAK_FLOPS, train: bool = True
                ) -> tuple[float, float]:
    """(compute_time, comm_time) for one microbatch through one stage."""
    flops = layer_flops(spec, seq, batch) * (3.0 if train else 1.0)
    eff = matmul_efficiency(spec.d_model, peak_flops)
    t_compute = flops / (peak_flops * eff)
    elem_bytes = 1.0625 if spec.quantize8 else 2.0   # int8+scales vs fp16
    nbytes = batch * seq * spec.d_model * elem_bytes
    n_transfers = 2.0 if train else 1.0              # activations + grads
    bw = bandwidth_mbps * MBPS
    t_comm = n_transfers * (nbytes / bw + RPC_OVERHEAD + rtt_s / 2.0)
    return t_compute, t_comm


def utilization(spec: LayerSpec, *, overlap: float = DEFAULT_OVERLAP,
                **kw) -> float:
    """Fraction of time the GPU computes (paper's '100% - idle time')."""
    t_c, t_n = stage_times(spec, **kw)
    exposed = max(0.0, t_n * (1 - overlap) + max(0.0, t_n - t_c) * overlap)
    return t_c / (t_c + exposed)


def scaling_exponents(spec: LayerSpec, factor: float = 2.0,
                      seq: int = 512) -> tuple[float, float]:
    """Empirical d(log cost)/d(log n): compute ~2-3, comm ~1 in d_model —
    the square-cube gap (property-tested)."""
    big = dataclasses.replace(spec, d_model=int(spec.d_model * factor),
                     d_ff=int(spec.d_ff * factor))
    f1 = layer_flops(spec, seq, 1)
    f2 = layer_flops(big, seq, 1)
    c1 = spec.d_model
    c2 = big.d_model
    return (math.log(f2 / f1) / math.log(factor),
            math.log(c2 / c1) / math.log(factor))
