"""Preemption trace events (port of ``TraceEvent`` of
``repro.core.faults``).

A trace is a list of ``(time_s, delta_peers)`` events that
``SwarmRunner.apply_trace`` replays on the virtual clock: ``-k`` fails k
random peers (never stranding a stage), ``+k`` warm-joins k peers.  The
synthetic preemptible-trace generators come with the control-plane
slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    time: float
    delta: int            # +k join, -k leave
    #: cloud zone the event hits (None = region-agnostic).  Mass
    #: preemptions carry ONE region — spot reclaims are zone-correlated.
    region: Optional[str] = None
