"""SWARM peers: device profiles, the GPU executor loop, stage state
(port of ``repro.core.peer``; the tree operations are torch).

A peer serves one pipeline stage (a group of layers with identical
parameters across the stage's peers).  In **numeric mode** requests execute
real tensor math — forward, and backward via activation checkpointing (the
peer recomputes the forward from the boundary input, exactly like the
paper's implementation) — while *virtual* time advances per the device cost
model.  In **throughput mode** only the clock moves, which is how the
Table 2/5 style experiments run 400-peer × 32-hour traces in seconds.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from repro_torch.core.sim import Sim, Sleep, Event, Interrupt
# StageState is owned by the stage-runtime layer: every mutation that
# touches device memory goes through a StageExecutor.
from repro_torch.runtime.base import StageState  # noqa: F401  (re-export)
from repro_torch.tree import tree_leaves, tree_map

Tree = Any


class PeerFailure(Exception):
    pass


def _alias_state(dst: StageState, src: StageState) -> None:
    """Zero-copy single-stage state adoption (identical backend +
    placement: aliasing the immutable device arrays is exact).  Only the
    training state crosses: the donor's non-core slots (e.g. serving KV,
    whose per-session holdership the KV ledger tracks) are NOT cloned,
    and any the adopter held are dropped — same semantics as a
    snapshot/restore hand-off with default ``slots=()``."""
    from repro_torch.runtime.base import CORE_SLOTS
    dst.params = tree_map(lambda x: x, src.params)
    dst.opt = tree_map(lambda x: x, src.opt)
    dst.version = src.version
    for name in [n for n in dst.slots if n not in CORE_SLOTS]:
        del dst.slots[name]
    dst.grad_acc = (tree_map(torch.zeros_like, src.params)
                    if src.params is not None else None)
    dst.loss_sum = 0.0
    dst.token_count = 0


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Effective (not peak) throughput + NIC model, per paper §4 hardware."""
    name: str
    flops_per_s: float          # effective mixed-precision FLOP/s
    up_bw: float                # bytes/s
    down_bw: float              # bytes/s
    latency: float              # one-way network latency, seconds

    def compute_time(self, flops: float) -> float:
        return flops / self.flops_per_s

    def send_time(self, nbytes: float) -> float:
        return self.latency + nbytes / self.up_bw

    def recv_time(self, nbytes: float) -> float:
        return self.latency + nbytes / self.down_bw


MBPS = 125_000.0  # 1 Mb/s in bytes/s

# Effective throughputs: vendor peak x a realistic utilization for
# unfused fp16 transformer blocks (paper App. F measures ~10-45%).
T4 = DeviceProfile("T4", 65e12 * 0.25, 400 * MBPS, 400 * MBPS, 0.005)
V100 = DeviceProfile("V100", 125e12 * 0.25, 500 * MBPS, 500 * MBPS, 0.003)
A100 = DeviceProfile("A100", 312e12 * 0.25, 550 * MBPS, 550 * MBPS, 0.003)


@dataclasses.dataclass
class _Task:
    kind: str                 # "fwd" | "bwd"
    payload: Any
    done: Event
    compute_time: float


class Peer:
    _ids = 0

    def __init__(self, sim: Sim, profile: DeviceProfile,
                 stage: "int | range", *, name: Optional[str] = None,
                 executor=None, region: str = "local"):
        Peer._ids += 1
        self.id = name or f"peer{Peer._ids}"
        self.sim = sim
        self.profile = profile
        # which cloud zone this instance lives in (region-priced links
        # come with the control-plane slice)
        self.region = region
        # how this peer runs its stages (repro_torch.runtime.StageExecutor):
        # a NumericExecutor shared by the stage's peers, a PipelineExecutor
        # fusing a contiguous span, or None in timing-only simulations.
        self.executor = executor
        self.set_span(stage)
        self.alive = True
        # serving=False while the peer downloads stage state (a joining
        # or migrating peer must never serve stale params); routing and
        # submit both refuse non-serving peers
        self.serving = True
        self.state = self._fresh_state()
        self._tasks: list[_Task] = []
        self._wake = sim.event()
        self._epoch = 0               # bumped by drain(): voids queued work
        self._generation = 0          # bumped by revive(): retires executor
        self.busy_time = 0.0          # for utilization metrics
        # NIC model for the async tick: boundary tensors in flight
        # occupy these links, never the compute queue, so the peer
        # computes microbatch k+1 while k's boundary is on the wire
        self.uplink = sim.link()
        self.downlink = sim.link()
        self.idle_time = 0.0          # executor-waited-empty seconds
        self._idle_since: Optional[float] = None
        self.spawn_executor()

    # ------------------------------------------------------------ span
    def set_span(self, stage: "int | range"):
        """Adopt a stage assignment: a single stage or a contiguous span
        ``range(lo, hi)``.  ``self.stage`` stays the ENTRY stage (span
        start) — the only stage a trainer may route this peer at — while
        ``self.stages`` is the full covered range (the peer's DHT slots,
        All-Reduce groups, and ledger rows)."""
        span = stage if isinstance(stage, range) else range(stage, stage + 1)
        if self.executor is not None and hasattr(self.executor, "stages"):
            assert (self.executor.stages.start == span.start
                    and self.executor.stages.stop == span.stop), \
                (self.executor.stages, span)
        self.span = span
        self.stage = span.start

    @property
    def stages(self) -> range:
        return self.span

    def _fresh_state(self) -> StageState:
        # timing-only span peers (no executor) still keep per-stage
        # bookkeeping so the All-Reduce barrier reads per-stage counters
        if self.executor is None and len(self.span) > 1:
            return StageState(per_stage={s: StageState() for s in self.span})
        return StageState()

    # ------------------------------------------------------------ executor
    def spawn_executor(self):
        self.sim.spawn(self._executor(self._generation))

    def _executor(self, gen: int):
        while self.alive and gen == self._generation:
            if not self._tasks:
                self._wake = self.sim.event()
                self._idle_since = self.sim.now
                try:
                    yield self._wake.wait()
                except Interrupt:
                    self._close_idle()
                    return
                self._close_idle()
                continue
            task = self._tasks.pop(0)
            epoch = self._epoch
            yield Sleep(task.compute_time)
            if not self.alive or gen != self._generation:
                task.done.fail(PeerFailure(self.id))   # died mid-compute
                return
            if epoch != self._epoch:    # drained mid-compute (migration)
                task.done.fail(PeerFailure(self.id))
                continue
            self.busy_time += task.compute_time
            try:
                result = task.payload()
            except PeerFailure as e:
                task.done.fail(e)
                continue
            task.done.fire(result)

    def queue_size(self) -> int:
        return len(self._tasks)

    def _close_idle(self) -> None:
        if self._idle_since is not None:
            self.idle_time += self.sim.now - self._idle_since
            self._idle_since = None

    def total_idle(self, now: Optional[float] = None) -> float:
        """Executor idle seconds, including the currently open interval."""
        open_dt = 0.0
        if self._idle_since is not None:
            open_dt = (now if now is not None else self.sim.now) \
                - self._idle_since
        return self.idle_time + open_dt

    # ------------------------------------------------------------ wire
    def send(self, nbytes: float, to: "Optional[Peer]" = None) -> Event:
        """Put ``nbytes`` on this peer's uplink.  The transfer occupies
        the LINK, not the compute queue — the executor keeps working
        while the boundary is in flight.  With ``to`` given the transfer
        is end-to-end priced at the bottleneck of the pair (one latency,
        min of up/down bandwidth) and the receiver's downlink is charged
        the same window."""
        if to is None:
            dur = self.profile.send_time(nbytes)
        else:
            bw = min(self.profile.up_bw, to.profile.down_bw)
            dur = self.profile.latency + nbytes / bw
            to.downlink.occupy(dur, nbytes)
        return self.uplink.transfer(dur, nbytes)

    def recv(self, nbytes: float, frm: "Optional[Peer]" = None) -> Event:
        """Await ``nbytes`` landing on this peer's downlink.  With
        ``frm`` given the transfer is priced at the bottleneck of the
        pair and the sender's uplink is charged the same window."""
        if frm is None:
            dur = self.profile.recv_time(nbytes)
        else:
            bw = min(self.profile.down_bw, frm.profile.up_bw)
            dur = self.profile.latency + nbytes / bw
            frm.uplink.occupy(dur, nbytes)
        return self.downlink.transfer(dur, nbytes)

    def submit(self, kind: str, compute_time: float,
               thunk: Callable[[], Any]) -> Event:
        """Enqueue work; returns completion Event (fails on peer death
        and while the peer is downloading state, i.e. not serving)."""
        if not self.alive or not self.serving:
            ev = self.sim.event()
            ev.fail(PeerFailure(self.id))
            return ev
        done = self.sim.event()
        self._tasks.append(_Task(kind, thunk, done, compute_time))
        if not self._wake.fired:
            self._wake.fire()
        return done

    # ------------------------------------------------------------ failure
    def fail(self):
        self.alive = False
        self.serving = False
        for t in self._tasks:
            t.done.fail(PeerFailure(self.id))
        self._tasks.clear()
        if not self._wake.fired:
            self._wake.fail(Interrupt())

    def drain(self):
        """Fail every queued and in-compute task without killing the
        peer — trainers observe PeerFailure and re-route (App. A).  Used
        when a migration retires the peer's current stage: queued thunks
        were built against the old stage's params and must never execute
        against the newly adopted state."""
        self._epoch += 1
        for t in self._tasks:
            t.done.fail(PeerFailure(self.id))
        self._tasks.clear()

    def revive(self, stage: "int | range"):
        """Rejoin (a fresh preemptible instance reusing this peer
        object): reset state and restart the executor.  The swarm that
        revives a peer is responsible for the warm join — download the
        stage state, re-announce in the DHT, and re-spawn the announcer
        (see ``SwarmRunner._join_new_peer``)."""
        self.alive = True
        self.serving = True
        self.set_span(stage)
        self.state = self._fresh_state()
        self._tasks = []
        self._epoch += 1
        self._generation += 1        # retire any executor still parked
        self._wake = self.sim.event()
        self.spawn_executor()

    # ------------------------------------------------------------ state
    def state_nbytes(self, stage: Optional[int] = None) -> float:
        """Transferable state bytes: one covered stage with ``stage=``,
        the whole (possibly span) state otherwise."""
        views = ([self.state.stage_view(stage)] if stage is not None
                 else self.state.views())
        pbytes = sum(x.numel() * x.element_size()
                     for v in views if v.params is not None
                     for x in tree_leaves(v.params))
        return 3 * pbytes          # params + adam m/v, roughly

    def adopt_state_from(self, donor: "Peer"):
        """Download the stage checkpoint from a live neighbor (Fig. 2).

        The transfer goes through the executors' snapshot/restore pair —
        a host-side (numpy) tree is the wire format — so the donor and
        the adopter may run *different* backends (a mesh-backed peer can
        seed a single-device joiner and vice versa).  Peers SHARING an
        executor (all numeric peers of a stage do) skip the host
        round-trip: identical backend and placement make aliasing the
        immutable device arrays exact and zero-copy."""
        if (self.executor is not None and donor.executor is not None
                and self.executor is not donor.executor
                and (donor.state.params is not None
                     or donor.state.per_stage is not None)):
            self.executor.restore(self.state,
                                  donor.executor.snapshot(donor.state))
            return
        if donor.state.per_stage is not None:   # shared span backend
            self.state.per_stage = {}
            for s, sub in donor.state.per_stage.items():
                mine = self.state.per_stage[s] = StageState()
                _alias_state(mine, sub)
            return
        _alias_state(self.state, donor.state)
