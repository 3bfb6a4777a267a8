"""Exactly-once elastic gradient accounting (paper App. A).

SWARM promises *synchronous semantics under churn*: every optimizer step
averages exactly ``global_batch`` samples, with gradients lost to dead or
migrating peers recomputed by survivors.  The :class:`MicrobatchLedger`
is the bookkeeping that makes this literal rather than statistical — per
round it tracks, for every pipeline stage, *which* microbatch indices
have been folded into some live peer's gradient accumulator and *by
whom*:

* ``record(stage, idx, peer)`` admits each ``(stage, idx)`` pair at most
  once per round, so a microbatch that fails mid-backward and gets
  re-issued is never double-counted by the stages that already hold it
  (re-running the backward with unchanged params reproduces the same
  gradient, so skipping the re-accumulation is exact);
* ``release_peer(stage, peer)`` forgets the contributions that die with
  a failed or migrating peer and re-queues exactly those indices for
  recompute — no generic re-dispatch budget that could over-issue;
* ``complete()`` is the All-Reduce trigger: every stage holds every
  index of the round, i.e. the global batch is bitwise accounted.

The ledger is mode-agnostic: numeric and throughput-only simulations use
the same accounting, so timing experiments exercise the identical
protocol the equivalence tests verify.

Serving reuses the same spine: :class:`ExactlyOnceLedger` is the
stage-by-key holdership core (admit each ``(stage, key)`` once, forget a
dead peer's holdings), :class:`MicrobatchLedger` layers training rounds
and re-dispatch on top, and :class:`SessionKVLedger` tracks which peer
holds each live session's KV cache per stage — where "admit at most
once" becomes the *no-double-prefill* invariant: a session's stage is
prefilled exactly once unless its holder died and released it first.
"""
from __future__ import annotations

from collections import deque
from typing import Hashable, Iterable, Optional


class ExactlyOnceLedger:
    """Per-stage keyed holdership with at-most-once admission.

    The shared accounting spine: ``acc[stage]`` maps a key (a microbatch
    index, a session id) to the peer currently holding the associated
    state (accumulated grads, a KV cache).  ``record`` admits each
    ``(stage, key)`` at most once; ``release_peer`` forgets what died
    with a peer and returns it so the caller can schedule recompute."""

    def __init__(self, n_stages: int):
        self.n_stages = n_stages
        # per stage: key -> id of the peer holding its state
        self.acc: list[dict[Hashable, Hashable]] = \
            [{} for _ in range(n_stages)]

    def record(self, stage: int, key: Hashable,
               peer_id: Hashable) -> bool:
        """Admit ``(stage, key)``; False if already held, in which case
        the caller must NOT duplicate the associated state."""
        if key in self.acc[stage]:
            return False
        self.acc[stage][key] = peer_id
        return True

    def holder(self, stage: int, key: Hashable) -> Optional[Hashable]:
        return self.acc[stage].get(key)

    def release(self, stage: int, key: Hashable) -> bool:
        """Forget one ``(stage, key)`` holdership (True if it was held)."""
        return self.acc[stage].pop(key, None) is not None

    def release_peer(self, stage: int, peer_id: Hashable) -> list:
        """Forget ``peer_id``'s holdings at ``stage`` (they died with
        it); returns the lost keys."""
        lost = [k for k, pid in self.acc[stage].items() if pid == peer_id]
        for k in lost:
            del self.acc[stage][k]
        return lost

    def release_all(self, peer_id: Hashable) -> list[tuple[int, Hashable]]:
        """Release ``peer_id`` from every stage (peer death)."""
        return [(s, k) for s in range(self.n_stages)
                for k in self.release_peer(s, peer_id)]

    def missing_stages(self, key: Hashable) -> list[int]:
        return [s for s in range(self.n_stages) if key not in self.acc[s]]

    def stage_counts(self) -> list[int]:
        return [len(d) for d in self.acc]


class SessionKVLedger(ExactlyOnceLedger):
    """``(stage, session) -> peer`` holdership of serving KV caches.

    The serving analogue of gradient accounting: a session's stage is
    prefilled into exactly one live peer's ``"kv"`` slot.  ``record`` is
    *strict* by default — admitting a held ``(stage, session)`` twice
    means some recovery path re-prefilled a stage whose cache never
    died, so it raises instead of returning False (release first, on
    peer death, is the only legal path to a second prefill).
    ``transfer`` moves holdership without re-admission: the
    disaggregated prefill -> decode hand-off, where the cache crosses
    peers via ``export_slot``/``install_slot`` but was computed once."""

    def record(self, stage: int, key: Hashable, peer_id: Hashable,
               strict: bool = True) -> bool:
        if not super().record(stage, key, peer_id):
            if strict:
                raise RuntimeError(
                    f"double prefill: stage {stage} of session {key!r} "
                    f"already held by {self.acc[stage][key]!r}")
            return False
        return True

    def transfer(self, stage: int, key: Hashable,
                 new_peer: Hashable) -> None:
        assert key in self.acc[stage], (stage, key)
        self.acc[stage][key] = new_peer

    def sessions_of(self, peer_id: Hashable) -> set:
        return {k for d in self.acc for k, pid in d.items()
                if pid == peer_id}


class MicrobatchLedger(ExactlyOnceLedger):
    """Per-round exactly-once accounting of (stage, microbatch) pairs."""

    def __init__(self, n_stages: int):
        super().__init__(n_stages)
        self.round_indices: tuple[int, ...] = ()
        self._round_set: frozenset[int] = frozenset()
        self.inflight: set[int] = set()
        self.attempts: dict[int, int] = {}
        self._pending: deque[int] = deque()
        self._pending_set: set[int] = set()

    # ------------------------------------------------------------ rounds
    def open_round(self, indices: Iterable[int]) -> None:
        """Start a fresh accumulation round over ``indices``."""
        self.round_indices = tuple(indices)
        self._round_set = frozenset(self.round_indices)
        for d in self.acc:
            d.clear()
        self.inflight.clear()
        self.attempts = {i: 0 for i in self.round_indices}
        self._pending = deque(self.round_indices)
        self._pending_set = set(self.round_indices)

    def complete(self) -> bool:
        n = len(self.round_indices)
        return all(len(d) == n for d in self.acc)

    # ---------------------------------------------------------- dispatch
    def next_index(self) -> Optional[tuple[int, int]]:
        """Next microbatch index needing (re)dispatch, as ``(index,
        attempt)`` provenance, or None when nothing is pending.  An index
        is pending iff it is not in flight and some stage lacks it."""
        while self._pending:
            idx = self._pending.popleft()
            self._pending_set.discard(idx)
            if idx in self.inflight or not self.missing_stages(idx):
                continue
            self.inflight.add(idx)
            self.attempts[idx] += 1
            return idx, self.attempts[idx]
        return None

    def settle(self, idx: int) -> None:
        """The in-flight attempt for ``idx`` finished (ok or not); if any
        stage still lacks the index, queue it for re-issue."""
        self.inflight.discard(idx)
        if self.missing_stages(idx):
            self._requeue(idx)

    # ------------------------------------------------------- accounting
    def record(self, stage: int, idx: int, peer_id: Hashable) -> bool:
        """Admit ``(stage, idx)``; False if already held (or stale — the
        index is not part of the current round), in which case the
        caller must NOT fold the gradient in."""
        if idx not in self._round_set or idx in self.acc[stage]:
            return False
        self.acc[stage][idx] = peer_id
        return True

    def release_peer(self, stage: int, peer_id: Hashable) -> list[int]:
        """Forget ``peer_id``'s contributions to ``stage`` (its grads
        died with it); the lost indices are re-queued for recompute."""
        lost = [i for i, pid in self.acc[stage].items() if pid == peer_id]
        for i in lost:
            del self.acc[stage][i]
            if i not in self.inflight:
                self._requeue(i)
        return lost

    def release_all(self, peer_id: Hashable) -> list[tuple[int, int]]:
        """Release ``peer_id`` from every stage (peer death)."""
        return [(s, i) for s in range(self.n_stages)
                for i in self.release_peer(s, peer_id)]

    # ---------------------------------------------------------- queries
    def missing_stages(self, idx: int) -> list[int]:
        return [s for s in range(self.n_stages) if idx not in self.acc[s]]

    def stage_counts(self) -> list[int]:
        return [len(d) for d in self.acc]

    def _requeue(self, idx: int) -> None:
        if idx not in self._pending_set:
            self._pending.append(idx)
            self._pending_set.add(idx)
