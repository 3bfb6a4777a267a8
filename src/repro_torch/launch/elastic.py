"""Elastic re-meshing policy for the launcher (port of
``repro.launch.elastic``; DESIGN.md §3).

SWARM's control-plane ideas, re-used at slice granularity: when pods (or
slices) join/leave, the launcher recomputes the layers-per-pod partition
with the same load-balance objective as Algorithm 2 and restarts from the
latest checkpoint onto the new mesh.  This module is the *policy* (pure,
unit-tested); `repro_torch.launch.train` + `repro_torch.ckpt` are the
mechanism (checkpoint restore).

Balance objective: minimize the maximum per-pod stage cost (the pipeline
weakest-link law, §3.2), where a stage's cost is the sum of its layers'
per-token FLOPs — heterogeneous pods (e.g. mixed accelerator generations)
divide by their relative speed, exactly like IWRR weights peers by
throughput.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.models.config import ArchConfig
from repro_torch.models import flops as F


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    n_pods: int
    layer_splits: tuple[int, ...]      # layers per stage, one per pod
    microbatches: int
    bubble_fraction: float

    @property
    def stage_bounds(self) -> list[tuple[int, int]]:
        out, lo = [], 0
        for n in self.layer_splits:
            out.append((lo, lo + n))
            lo += n
        return out


def layer_costs(cfg: ArchConfig, seq: int) -> list[float]:
    ctx = F._ctx_for(cfg, seq, causal_avg=True)
    return [F.per_token_layer_flops(cfg, k, ctx) for k in cfg.block_kinds]


def balanced_splits(costs: Sequence[float], n_stages: int,
                    speeds: Optional[Sequence[float]] = None
                    ) -> tuple[int, ...]:
    """Contiguous partition of layers into n_stages minimizing the max
    stage cost/speed (DP over prefix sums; L, S are tiny)."""
    L = len(costs)
    speeds = list(speeds or [1.0] * n_stages)
    assert L >= n_stages >= 1
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)

    INF = float("inf")
    # best[s][i] = minimal max-cost partitioning first i layers into s
    best = [[INF] * (L + 1) for _ in range(n_stages + 1)]
    cut = [[0] * (L + 1) for _ in range(n_stages + 1)]
    best[0][0] = 0.0
    for s in range(1, n_stages + 1):
        for i in range(s, L + 1):
            for j in range(s - 1, i):
                seg = (prefix[i] - prefix[j]) / speeds[s - 1]
                v = max(best[s - 1][j], seg)
                if v < best[s][i]:
                    best[s][i] = v
                    cut[s][i] = j
    splits, i = [], L
    for s in range(n_stages, 0, -1):
        j = cut[s][i]
        splits.append(i - j)
        i = j
    return tuple(reversed(splits))


def plan_mesh(cfg: ArchConfig, n_pods: int, seq: int = 4096,
              microbatches: int = 8,
              pod_speeds: Optional[Sequence[float]] = None) -> MeshPlan:
    if n_pods <= 1 or cfg.n_layers < n_pods:
        return MeshPlan(max(n_pods, 1), (cfg.n_layers,), microbatches, 0.0)
    splits = balanced_splits(layer_costs(cfg, seq), n_pods, pod_speeds)
    bubble = (n_pods - 1) / (microbatches + n_pods - 1)
    return MeshPlan(n_pods, splits, microbatches, bubble)


def replan_on_failure(cfg: ArchConfig, plan: MeshPlan,
                      surviving_pods: int, seq: int = 4096) -> MeshPlan:
    """A pod died: shrink the pipeline (Alg. 2's migration collapses to
    re-partitioning at slice granularity) and restart from checkpoint.
    Survives down to a single pod — SWARM's '>= 1 peer per stage'
    invariant maps to '>= 1 pod total'."""
    assert surviving_pods >= 1
    return plan_mesh(cfg, surviving_pods, seq, plan.microbatches)


def replan_on_join(cfg: ArchConfig, plan: MeshPlan, new_total: int,
                   seq: int = 4096) -> MeshPlan:
    return plan_mesh(cfg, new_total, seq, plan.microbatches)
