"""Stochastic wiring (paper §3.2 + Appendix C, Algorithm 1); port of
``repro.core.wiring``, copied: plain Python.

Interleaved Weighted Round-Robin over a priority queue: every peer serving a
stage carries *the total processing time over all previous requests*; a
microbatch routes to the peer with the smallest total, whose priority is
then bumped by the EMA of its response time.  A device that is 2× faster
thus receives 2× the requests.  Failed peers are banned (priority = ∞)
until they re-announce in the DHT.

Faithfulness notes vs Algorithm 1:
  * ``ema`` starts at ``epsilon`` and is updated as
    ``ema = gamma*dt + (1-gamma)*ema`` (line 30).
  * ``choose_server`` bumps priority by the *current* EMA before dispatch
    (lines 14-19) so concurrent trainers spread load.
  * different trainers keep independent EMAs — this is what makes routing
    topology-aware (§3.2 "trainers automatically adjust to the network
    topology").
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Hashable, Optional

INF = math.inf


@dataclasses.dataclass
class _Entry:
    priority: float
    seq: int
    server: Hashable
    valid: bool = True


class StagePriorityQueue:
    """Lazy-deletion priority queue keyed by accumulated processing time.

    Every ``choose_server`` bump pushes a fresh tuple and merely marks
    the old one invalid, so without compaction the heap grows O(#requests)
    for the life of the trainer (a leak).  When invalidated
    entries outnumber live ones the heap is rebuilt in place from the
    survivors — amortized O(1) per update, keeping the heap O(#servers)."""

    #: below this size compaction isn't worth the heapify (and the ratio
    #: test would thrash on 2-3 entry heaps)
    _COMPACT_MIN = 8

    def __init__(self):
        self._heap: list[tuple[float, int, _Entry]] = []
        self._entries: dict[Hashable, _Entry] = {}
        self._seq = 0
        self._invalid = 0        # invalidated entries still in the heap

    def _invalidate(self, e: _Entry) -> None:
        e.valid = False
        if e.priority != INF:    # INF entries were never pushed
            self._invalid += 1

    def _maybe_compact(self) -> None:
        if self._invalid > self._COMPACT_MIN \
                and 2 * self._invalid > len(self._heap):
            self._heap = [t for t in self._heap if t[2].valid]
            heapq.heapify(self._heap)
            self._invalid = 0

    def update(self, server: Hashable, priority: float) -> None:
        old = self._entries.get(server)
        if old is not None:
            self._invalidate(old)
        self._seq += 1
        e = _Entry(priority, self._seq, server)
        self._entries[server] = e
        if priority != INF:
            heapq.heappush(self._heap, (priority, self._seq, e))
        self._maybe_compact()

    def remove(self, server: Hashable) -> None:
        old = self._entries.pop(server, None)
        if old is not None:
            self._invalidate(old)
            self._maybe_compact()

    def top(self) -> Optional[tuple[Hashable, float]]:
        while self._heap:
            priority, _, e = self._heap[0]
            if not e.valid:
                heapq.heappop(self._heap)
                self._invalid -= 1
                continue
            return e.server, priority
        return None

    def heap_size(self) -> int:
        """Current physical heap length (leak diagnostics / tests)."""
        return len(self._heap)

    def servers(self) -> list[Hashable]:
        return [s for s, e in self._entries.items() if e.priority != INF]

    def priority_of(self, server: Hashable) -> Optional[float]:
        e = self._entries.get(server)
        return e.priority if e is not None else None


class StochasticWiring:
    """Algorithm 1. One instance per *trainer* (per-trainer EMAs)."""

    def __init__(self, n_stages: int, gamma: float = 0.1,
                 epsilon: float = 1e-3, seed: Optional[int] = None):
        self.n_stages = n_stages
        self.gamma = gamma
        self.epsilon = epsilon
        self.ema: dict[Hashable, float] = {}
        self.queues = [StagePriorityQueue() for _ in range(n_stages)]
        self._stages_of: dict[Hashable, list[int]] = {}
        import random
        self._rng = random.Random(seed)

    # ------------------------------------------------------------ peers
    def add_server(self, server: Hashable, stages: list[int]) -> None:
        # jittered priors break the herd: with exactly-equal priorities
        # every trainer's first assignments pile onto one peer until EMAs
        # diverge (real deployments never observe identical times).
        prior = self.epsilon * self._rng.uniform(0.5, 1.5)
        self.ema.setdefault(server, prior)
        self._stages_of[server] = list(stages)
        for s in stages:
            self.queues[s].update(server, self.ema[server])

    def remove_server(self, server: Hashable) -> None:
        for s in self._stages_of.pop(server, []):
            self.queues[s].remove(server)

    def ban_server(self, server: Hashable) -> None:
        for s in self._stages_of.get(server, []):
            self.queues[s].update(server, INF)

    def move_server(self, server: Hashable, new_stages: list[int]) -> None:
        self.remove_server(server)
        self.add_server(server, new_stages)

    # ------------------------------------------------------------ routing
    def choose_server(self, stage: int) -> Optional[Hashable]:
        top = self.queues[stage].top()
        if top is None:
            return None
        server, priority = top
        self.queues[stage].update(server, priority + self.ema[server])
        return server

    def observe(self, server: Hashable, dt: float) -> None:
        """EMA update after a completed request (Alg. 1 line 30)."""
        prev = self.ema.get(server, self.epsilon)
        self.ema[server] = self.gamma * dt + (1 - self.gamma) * prev

    def is_banned(self, server: Hashable) -> bool:
        stages = self._stages_of.get(server)
        if not stages:
            return False
        return any(self.queues[s].priority_of(server) == INF
                   for s in stages)

    def refresh_from_dht(self, dht, stage_of_peer) -> None:
        """Reconcile routing state with the DHT's live view (§3.2).
        ``stage_of_peer``: server -> stage from DHT records.

        Three cases: evict peers ABSENT from the snapshot, re-admit
        banned peers that re-announced, discover new ones.  Eviction is
        the load-bearing half on preemptible fleets — a reclaimed spot
        instance never says goodbye, its DHT records simply expire, so
        a peer missing from the snapshot must leave the queues,
        ``_stages_of`` and ``ema`` after ONE refresh; otherwise routing
        keeps offering the dead peer until a request fails, and under
        churn the maps grow without bound.  A healthy peer is never
        evicted by this —
        its own TTL'd announcement keeps it in every snapshot — and an
        evicted peer that comes back is re-discovered below with a
        fresh jittered EMA prior, exactly like a first join."""
        for server in list(self._stages_of):
            if server not in stage_of_peer:
                self.remove_server(server)
                self.ema.pop(server, None)
        for server, stage in stage_of_peer.items():
            cur = self._stages_of.get(server)
            if cur != [stage]:
                self.move_server(server, [stage])
            elif self.is_banned(server):
                # stage unchanged but the peer is live in the DHT: the
                # ban was transient (e.g. a routing race during a
                # migration window) and lifts on re-announce — it must
                # not become a permanent per-trainer blacklist
                for s in cur:
                    self.queues[s].update(server, self.ema[server])
