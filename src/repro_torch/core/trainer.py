"""Trainer processes (paper §3.2 / App. C; port of
``repro.core.trainer``).

Trainers own no parameters and no device: they form microbatches and
route them through the pipeline as a chain of *hops* — one peer per
contiguous stage span — forward, then back, using stochastic wiring.  On
a peer failure anywhere along the path the trainer bans the peer and
re-routes — backward can go to a *different* peer than forward because
stages recompute activations from the boundary input (activation
checkpointing, App. A); a re-routed backward hop must cover the SAME
span (the cotangent in hand is pinned to that span's edges).

Stage execution and wire handling go through the peer's
:class:`repro_torch.runtime.StageExecutor`.  Under the async tick
(``swarm.overlap``) each edge's tensor is one in-flight transfer on the
peers' links, priced end to end at the pair's bottleneck, instead of two
blocking sleeps; the synchronous path keeps its two sleeps.  In both
modes stage math goes through the executors' dispatch/collect pair,
collected at once.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.core.sim import Sim, Sleep
from repro_torch.core.peer import Peer, PeerFailure
from repro_torch.core.wiring import StochasticWiring

Tree = Any


@dataclasses.dataclass
class Microbatch:
    index: int
    tokens: Any = None          # numeric mode: [b, S] token ids
    labels: Any = None
    size: int = 1               # sequences
    n_tokens: int = 0
    attempt: int = 1            # provenance: ledger dispatch attempt


@dataclasses.dataclass
class _Hop:
    """One completed forward hop: which peer ran which span on what."""
    peer: Peer
    span: range
    inp: Any                    # the hop's boundary input (for recompute)


class Trainer:
    def __init__(self, sim: Sim, swarm, wiring: StochasticWiring,
                 name: str, *, max_retries: int = 50,
                 refresh_interval: float = 30.0):
        self.sim = sim
        self.swarm = swarm
        self.wiring = wiring
        self.name = name
        self.max_retries = max_retries
        self.refresh_interval = refresh_interval
        self._last_refresh = -1e9

    # ------------------------------------------------------------ helpers
    def _maybe_refresh(self):
        if self.sim.now - self._last_refresh >= self.refresh_interval:
            self.wiring.refresh_from_dht(
                self.swarm.dht, self.swarm.announced_stages())
            self._last_refresh = self.sim.now

    def _pick(self, stage: int, span: Optional[range] = None):
        """Choose a live peer whose span STARTS at ``stage`` (optionally
        covering exactly ``span`` — the backward re-route constraint),
        or None when unavailable."""
        self._maybe_refresh()
        peer_id = self.wiring.choose_server(stage)
        if peer_id is None:
            return None
        peer = self.swarm.peers.get(peer_id)
        if peer is None or not peer.alive or not peer.serving \
                or peer.stage != stage:
            self.wiring.ban_server(peer_id)
            return None
        if span is not None and peer.stages != span:
            return None
        return peer

    def _boundary_bytes(self, mb: Microbatch,
                        boundary: Optional[int] = None) -> float:
        """Wire bytes for one edge (``boundary`` indexes the pipeline
        boundary crossed; None or out of range: uniform pricing)."""
        return self.swarm.boundary_nbytes(mb, boundary)

    # ------------------------------------------------------------ core
    def run_microbatch(self, mb: Microbatch):
        """Generator process: one microbatch through fwd+bwd. Yields sim
        commands; returns (loss_sum, ok)."""
        swarm = self.swarm
        S = swarm.n_stages
        numeric = swarm.numeric
        overlap = swarm.overlap
        hops: list[_Hop] = []

        # ---------------- forward (hop chain over spans)
        x = mb.tokens if numeric else None
        s = 0
        retries = 0
        while s < S:
            peer = self._pick(s)
            if peer is None:
                # dead end: no live peer's span starts at this boundary —
                # fail the attempt now so the re-issue re-rolls the path
                if s > 0 and not any(p.alive and p.stages.start == s
                                     for p in swarm.peers.values()):
                    return None, False
                retries += 1
                if retries > self.max_retries:
                    return None, False
                yield Sleep(1.0)
                continue
            span = peer.stages
            covers_last = span.stop == S
            nbytes = self._boundary_bytes(mb, s - 1) if s > 0 else \
                mb.n_tokens * 4.0
            t0 = self.sim.now
            try:
                if overlap:
                    # one in-flight transfer prices the whole edge at the
                    # pair's bottleneck (vs the serial send + recv pair);
                    # the sender's uplink is occupied, never its queue
                    prev = hops[-1].peer if hops else None
                    serial = peer.profile.recv_time(nbytes) + (
                        prev.profile.send_time(nbytes)
                        if prev is not None else 0.0)
                    tw = self.sim.now
                    yield peer.recv(nbytes, frm=prev).wait()
                    swarm.count_inflight_wire(
                        serial, self.sim.now - tw, nbytes)
                else:
                    yield Sleep(peer.profile.recv_time(nbytes))
                if s > 0:        # a real host boundary crossing
                    swarm.count_wire_bytes(nbytes)
                inp = x
                if numeric:
                    # the executor runs the whole span AND produces the
                    # wire tensor that crosses to the next hop; the
                    # program is launched when the thunk runs, and
                    # collect orders the consumer behind its launches
                    if covers_last:
                        thunk = (lambda _p=peer, _i=inp:
                                 _p.executor.dispatch_fwd(
                                     _p.state, _i, mb.labels)())
                    else:
                        thunk = (lambda _p=peer, _i=inp:
                                 _p.executor.wire_fwd(
                                     _p.executor.dispatch_fwd(
                                         _p.state, _i)()))
                else:
                    thunk = lambda: None
                ct = swarm.compute_time(peer, "fwd", s, mb)
                y = yield peer.submit("fwd", ct, thunk).wait()
                if overlap:
                    if covers_last:     # the scalar loss back to us
                        yield peer.send(64.0).wait()
                    # else: the next hop's recv prices this edge once,
                    # end to end — nothing to wait on here
                else:
                    yield Sleep(peer.profile.send_time(
                        self._boundary_bytes(mb, span.stop - 1)
                        if not covers_last else 64.0))
                self.wiring.observe(peer.id, self.sim.now - t0)
                hops.append(_Hop(peer, span, inp))
                x = y
                s = span.stop
                retries = 0
            except PeerFailure:
                self.wiring.ban_server(peer.id)
                retries += 1
                if retries > self.max_retries:
                    return None, False

        # ---------------- backward (reverse hop chain, re-routable)
        loss_sum = float(x) if numeric else 0.0
        dy = None
        bwd_prev: Optional[Peer] = None   # who produced the dy in hand
        h = len(hops) - 1
        retries = 0
        while h >= 0:
            hop = hops[h]
            peer = hop.peer
            if peer is None or not peer.alive or not peer.serving \
                    or peer.stages != hop.span:
                peer = self._pick(hop.span.start, span=hop.span)
            if peer is None:
                # no live peer still has this hop's exact span: fail the
                # attempt now; the ledger re-issues it
                if not any(p.alive and p.stages == hop.span
                           for p in swarm.peers.values()):
                    return None, False
                retries += 1
                if retries > self.max_retries:
                    return None, False
                yield Sleep(1.0)
                continue
            covers_last = hop.span.stop == S
            nbytes = self._boundary_bytes(mb, hop.span.stop - 1)
            t0 = self.sim.now
            try:
                if overlap:
                    serial = peer.profile.recv_time(nbytes) + (
                        bwd_prev.profile.send_time(nbytes)
                        if bwd_prev is not None else 0.0)
                    tw = self.sim.now
                    yield peer.recv(nbytes, frm=bwd_prev).wait()
                    swarm.count_inflight_wire(
                        serial, self.sim.now - tw, nbytes)
                else:
                    yield Sleep(peer.profile.recv_time(nbytes))
                if not covers_last:      # a cotangent really crossed
                    swarm.count_wire_bytes(nbytes)
                if numeric and covers_last:
                    def thunk(_p=peer, _i=hop.inp):
                        loss, gx, gp = _p.executor.dispatch_bwd(
                            _p.state, _i, labels=mb.labels)()
                        # the ledger admits each covered (stage, index)
                        # at most once per round
                        self.swarm.accumulate(_p, gp, mb, float(loss))
                        return _p.executor.wire_bwd(gx)
                elif numeric:
                    def thunk(_p=peer, _i=hop.inp, _dy=dy):
                        _, gx, gp = _p.executor.dispatch_bwd(
                            _p.state, _i, dy=_dy)()
                        self.swarm.accumulate(_p, gp, mb, None)
                        return _p.executor.wire_bwd(gx)
                else:
                    def thunk(_p=peer):
                        self.swarm.accumulate(_p, None, mb, None)
                        return None
                ct = swarm.compute_time(peer, "bwd", hop.span.start, mb)
                gx = yield peer.submit("bwd", ct, thunk).wait()
                if overlap:
                    if hop.span.start == 0:   # grads landed: a tiny ack
                        yield peer.send(64.0).wait()
                    # else: the next hop's recv prices this edge
                else:
                    yield Sleep(peer.profile.send_time(
                        self._boundary_bytes(mb, hop.span.start - 1)
                        if hop.span.start > 0 else 64.0))
                self.wiring.observe(peer.id, self.sim.now - t0)
                dy = gx
                bwd_prev = peer
                h -= 1
                retries = 0
            except PeerFailure:
                self.wiring.ban_server(peer.id)
                retries += 1
                if retries > self.max_retries:
                    return None, False

        return loss_sum, True

    def run(self):
        """Main trainer loop: pull microbatch indices until stopped."""
        swarm = self.swarm
        while not swarm.stopped:
            mb = swarm.next_microbatch()
            if mb is None:
                yield Sleep(0.5)
                continue
            result = yield from self.run_microbatch(mb)
            loss_sum, ok = result if result is not None else (None, False)
            swarm.microbatch_done(mb, ok)
