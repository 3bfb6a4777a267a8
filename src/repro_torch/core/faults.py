"""Preemption traces for fault-tolerance experiments (port of
``repro.core.faults``, copied: numpy only).

The paper replays the number of active T4 nodes over a 32-hour segment of
its §4.3 run (App. I).  That raw trace is not published, so statistically
similar traces are generated: spot-instance lifetimes are approximately
exponential with a mean of a few hours, arrivals Poisson with the pool
drifting around a capacity target, plus occasional mass-preemption
events (App. I's "large drops").  A trace is a list of ``(time_s,
delta_peers)`` events that ``SwarmRunner.apply_trace`` replays on the
virtual clock: ``-k`` fails k random peers (never stranding a stage),
``+k`` warm-joins k peers.  The generator makes the JAX package's numpy
draws in the same order, so one seed gives the same trace in both.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    time: float
    delta: int            # +k join, -k leave
    #: cloud zone the event hits (None = region-agnostic).  Mass
    #: preemptions carry ONE region — spot reclaims are zone-correlated.
    region: Optional[str] = None


def synth_preemptible_trace(
    horizon_s: float = 32 * 3600.0,
    target_peers: int = 400,
    mean_lifetime_s: float = 6 * 3600.0,
    mass_preemption_rate_per_h: float = 0.15,
    mass_fraction: float = 0.12,
    seed: int = 0,
    regions: Optional[Sequence[str]] = None,
) -> list[TraceEvent]:
    """``regions`` tags every event with a drawn zone (mass events hit a
    single zone); the extra draws happen only when regions are
    requested."""
    rng = np.random.default_rng(seed)

    def _region() -> Optional[str]:
        if regions is None:
            return None
        return str(regions[int(rng.integers(len(regions)))])
    events: list[TraceEvent] = []
    n = target_peers
    t = 0.0
    # per-peer hazard -> pool-level departure rate n/mean_lifetime;
    # arrivals replenish toward target with rate prop. to deficit + churn.
    while t < horizon_s:
        leave_rate = n / mean_lifetime_s
        join_rate = max(target_peers - n, 0) / 600.0 + 0.3 * leave_rate
        mass_rate = mass_preemption_rate_per_h / 3600.0
        total = leave_rate + join_rate + mass_rate
        t += rng.exponential(1.0 / total)
        if t >= horizon_s:
            break
        u = rng.uniform() * total
        if u < leave_rate and n > 1:
            events.append(TraceEvent(t, -1, _region()))
            n -= 1
        elif u < leave_rate + join_rate:
            events.append(TraceEvent(t, +1, _region()))
            n += 1
        elif n > 4:
            k = max(1, int(n * mass_fraction * rng.uniform(0.5, 1.5)))
            k = min(k, n - 1)
            events.append(TraceEvent(t, -k, _region()))
            n -= k
    return events


def constant_pool(n_peers: int, horizon_s: float) -> list[TraceEvent]:
    del n_peers, horizon_s
    return []


def active_counts(trace: list[TraceEvent], n0: int,
                  horizon_s: float, dt: float = 60.0) -> np.ndarray:
    """Sampled active-peer counts (for plots and Table 5 style
    summaries)."""
    ts = np.arange(0.0, horizon_s, dt)
    out = np.zeros(len(ts), np.int64)
    n, i = n0, 0
    for j, t in enumerate(ts):
        while i < len(trace) and trace[i].time <= t:
            n += trace[i].delta
            i += 1
        out[j] = n
    return out
