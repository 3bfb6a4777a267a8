"""Discrete-event simulation kernel (SimPy-lite, generator coroutines).

The SWARM runner simulates hundreds of heterogeneous preemptible peers on a
virtual clock; real JAX math (numeric mode) executes instantly in wall time
while *virtual* time advances by the device cost model.  Processes are
generators that ``yield`` commands:

    yield Sleep(dt)          — advance virtual time
    yield ev.wait()          — block until Event.fire()
    yield res.acquire()      — exclusive resource (a GPU, a link); pair with
    res.release()
    yield Spawn(gen)         — start a child process
    yield link.transfer(dur, nbytes)
                             — await an in-flight transfer: the bytes
                             occupy the LINK for ``dur``, not the
                             issuing process or any compute queue

A fired :class:`Event` may carry a value or an exception (peer failures
propagate into whoever awaits them — that is how trainers observe faults).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Any, Callable, Generator, Optional


@dataclasses.dataclass
class Sleep:
    dt: float


@dataclasses.dataclass
class Spawn:
    gen: Generator


class Interrupt(Exception):
    """Raised inside a process that awaited a failed peer/event."""


class Event:
    __slots__ = ("sim", "fired", "value", "exc", "_waiters")

    def __init__(self, sim: "Sim"):
        self.sim = sim
        self.fired = False
        self.value = None
        self.exc: Optional[BaseException] = None
        self._waiters: list[Generator] = []

    def wait(self) -> "Event":
        return self

    def fire(self, value: Any = None) -> None:
        if self.fired:
            return
        self.fired = True
        self.value = value
        for g in self._waiters:
            self.sim._schedule(0.0, g, value=value)
        self._waiters.clear()

    def fail(self, exc: BaseException) -> None:
        if self.fired:
            return
        self.fired = True
        self.exc = exc
        for g in self._waiters:
            self.sim._schedule(0.0, g, exc=exc)
        self._waiters.clear()


class Resource:
    """FIFO exclusive resource (e.g. one GPU executor, one uplink)."""

    def __init__(self, sim: "Sim"):
        self.sim = sim
        self.busy = False
        self._queue: list[Event] = []

    def acquire(self) -> Event:
        ev = Event(self.sim)
        if not self.busy:
            self.busy = True
            ev.fire()
        else:
            self._queue.append(ev)
        return ev

    def release(self) -> None:
        if self._queue:
            self._queue.pop(0).fire()
        else:
            self.busy = False


class Link:
    """In-flight transfer primitive: one direction of a peer's NIC.

    A ``transfer`` occupies the LINK for its duration — never the
    issuing process or a compute queue — so boundary tensors ride the
    wire while the peer computes the next microbatch (the async tick's
    overlap lever).  Transfers serialize FIFO on the link's bandwidth:
    a transfer issued while another is on the wire starts when the link
    frees up.  The returned :class:`Event` fires when the bytes have
    landed; callers that need the payload await it, callers that only
    produce it keep going.
    """

    def __init__(self, sim: "Sim"):
        self.sim = sim
        self._free_at = 0.0          # virtual time the link drains
        self.busy_time = 0.0         # cumulative occupied seconds
        self.bytes_total = 0.0       # cumulative bytes put on the wire
        self.inflight = 0            # transfers currently on the wire

    def transfer(self, duration: float, nbytes: float = 0.0) -> Event:
        ev = Event(self.sim)
        begin = max(self.sim.now, self._free_at)
        end = begin + duration
        self._free_at = end
        self.busy_time += duration
        self.bytes_total += nbytes
        self.inflight += 1
        self.sim.spawn(self._complete(ev, end - self.sim.now))
        return ev

    def occupy(self, duration: float, nbytes: float = 0.0) -> None:
        """Account occupancy without a completion event — the far side
        of a point-to-point transfer (the receiving link owns the
        event; the sending link is just busy for the window)."""
        begin = max(self.sim.now, self._free_at)
        self._free_at = begin + duration
        self.busy_time += duration
        self.bytes_total += nbytes

    def _complete(self, ev: Event, dt: float):
        yield Sleep(dt)
        self.inflight -= 1
        ev.fire()


class Sim:
    def __init__(self):
        self.now = 0.0
        self._heap: list = []
        self._ctr = itertools.count()
        self.live_processes = 0

    # -------------------------------------------------------- scheduling
    def _schedule(self, dt: float, gen: Generator, value: Any = None,
                  exc: Optional[BaseException] = None) -> None:
        heapq.heappush(self._heap,
                       (self.now + dt, next(self._ctr), gen, value, exc))

    def spawn(self, gen: Generator) -> None:
        self.live_processes += 1
        self._schedule(0.0, gen)

    def event(self) -> Event:
        return Event(self)

    def resource(self) -> Resource:
        return Resource(self)

    def link(self) -> Link:
        return Link(self)

    # -------------------------------------------------------- stepping
    def _step_process(self, gen: Generator, value: Any,
                      exc: Optional[BaseException]) -> None:
        try:
            cmd = gen.throw(exc) if exc is not None else gen.send(value)
        except StopIteration:
            self.live_processes -= 1
            return
        except Interrupt:
            self.live_processes -= 1
            return
        if isinstance(cmd, Sleep):
            self._schedule(cmd.dt, gen)
        elif isinstance(cmd, Event):
            if cmd.fired:
                self._schedule(0.0, gen, value=cmd.value, exc=cmd.exc)
            else:
                cmd._waiters.append(gen)
        elif isinstance(cmd, Spawn):
            self.spawn(cmd.gen)
            self._schedule(0.0, gen)
        else:
            raise TypeError(f"process yielded {cmd!r}")

    def run(self, until: Optional[float] = None) -> float:
        while self._heap:
            t, _, gen, value, exc = self._heap[0]
            if until is not None and t > until:
                self.now = until
                return self.now
            heapq.heappop(self._heap)
            self.now = t
            self._step_process(gen, value, exc)
        if until is not None:
            self.now = until
        return self.now
