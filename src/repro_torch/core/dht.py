"""Distributed Hash Table, in-process (Kademlia semantics à la hivemind);
port of ``repro.core.dht``, copied: plain Python.

SWARM uses the DHT for (a) peer discovery — each peer announces the stage it
serves with a TTL and re-announces every few minutes; trainers ban peers
until their next re-announcement (§3.2) — and (b) the rebalancing protocol,
which writes per-peer queue sizes under ``DHT[stage]`` as (subkey -> value)
pairs (Alg. 2 line 4).

We model the *semantics* (multi-writer keys, expiration, staleness) on the
virtual clock; network latency for DHT RPCs is charged by the caller via the
cost model.  Replication/routing internals of Kademlia are irrelevant to the
algorithms built on top and are not simulated.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Hashable, Optional


@dataclasses.dataclass
class DHTRecord:
    value: Any
    expiration: float


class DHT:
    def __init__(self, clock: Callable[[], float]):
        self._clock = clock
        self._store: dict[Hashable, dict[Hashable, DHTRecord]] = {}

    def store(self, key: Hashable, subkey: Hashable, value: Any,
              ttl: float) -> None:
        self._store.setdefault(key, {})[subkey] = DHTRecord(
            value, self._clock() + ttl)

    def get(self, key: Hashable) -> dict[Hashable, DHTRecord]:
        """Live records under ``key``.

        Deliberately a *mutating* read: expired records are compacted
        out of the backing store as a write-back side effect.  On a
        preemptible fleet most peers never say goodbye — their records
        simply lapse — so without this compaction every key table grows
        with the total number of peers that EVER announced, and the
        control plane's snapshot capture would scan dead entries
        forever.  Callers relying on ``get`` being side-effect-free on
        the store are wrong on purpose; the returned dict is a copy and
        safe to hold."""
        now = self._clock()
        recs = self._store.get(key, {})
        live = {sk: r for sk, r in recs.items() if r.expiration > now}
        self._store[key] = live
        return dict(live)

    def get_values(self, key: Hashable) -> dict[Hashable, Any]:
        """Live ``{subkey: value}`` under ``key`` — the snapshot-capture
        fast path.  Same write-back compaction as :meth:`get`, but skips
        materialising :class:`DHTRecord` copies: at 1000-peer scale a
        span-fused fleet announces ~50k load records per round, and the
        double copy in ``get`` dominates capture time."""
        now = self._clock()
        recs = self._store.get(key, {})
        if any(r.expiration <= now for r in recs.values()):
            recs = {sk: r for sk, r in recs.items() if r.expiration > now}
            self._store[key] = recs
        return {sk: r.value for sk, r in recs.items()}

    def n_records(self, prefix: Optional[str] = None) -> int:
        """Count of live records (optionally only under keys whose str
        form starts with ``prefix``) — leak diagnostics: after a churny
        run this should track the LIVE fleet, not every peer that ever
        existed."""
        now = self._clock()
        return sum(
            sum(1 for r in recs.values() if r.expiration > now)
            for key, recs in self._store.items()
            if prefix is None or str(key).startswith(prefix))

    def get_value(self, key: Hashable, subkey: Hashable,
                  default: Any = None) -> Any:
        rec = self.get(key).get(subkey)
        return rec.value if rec is not None else default

    def delete(self, key: Hashable, subkey: Optional[Hashable] = None):
        if subkey is None:
            self._store.pop(key, None)
        else:
            self._store.get(key, {}).pop(subkey, None)

    # convenience namespaces used by SWARM
    @staticmethod
    def stage_key(stage: int) -> str:
        return f"stage/{stage}"

    @staticmethod
    def load_key(stage: int) -> str:
        return f"load/{stage}"
