"""SwarmRunner — elastic SWARM training on the virtual clock (port of
``repro.core.swarm``).

Composition (paper Fig. 2): consecutive swarms of peers serve pipeline
stages; trainer processes route microbatches via stochastic wiring; a
DHT carries liveness and load; adaptive rebalancing (Alg. 2) migrates
peers between stages; once the microbatch ledger shows the global batch
accumulated exactly once at every stage, each stage All-Reduces its
gradients (token-weighted) and applies the optimizer step.  Gradients
lost to dead or migrating peers are recomputed by survivors under the
same microbatch indices, so an optimizer step under churn averages the
identical sample set as fault-free training (App. A).  With a
``ckpt_dir`` every ``ckpt_period`` steps persist a pipeline-consistent
cut; a stage that loses every peer resumes from it, rewinding the whole
pipeline to it first (Varuna-style global rollback) when it is older
than the current step, and a runner built over a non-empty ``ckpt_dir``
resumes that run.

A peer's assignment is a contiguous span of stages (usually width 1).
Span peers (:class:`repro_torch.runtime.PipelineExecutor`) occupy one DHT
slot, one All-Reduce group and one ledger row per covered stage, but run
the whole span in one fused program: only span-edge tensors cross the
host (the square-cube lever, §3.1), and ``metrics["wire_bytes"]``
charges per hop edge.  ``split_span``/``merge_spans``/``_resize_span``
re-partition spans, Varuna-style: a shrinking span peer hands per-stage
state to single-stage peers, a merge pulls it back.  With
``spans=True`` Alg. 2 also proposes these resizes, and with a
``link_table`` it prices each boundary in region-pair seconds.

Two modes:
  numeric=True   — real PyTorch math per stage on the runner's device;
  numeric=False  — timing only: no executors and no tensors (so no
                   device), analytic per-stage FLOPs priced by the stage
                   plan (the paper's throughput and preemption
                   experiments).

The async tick (``SwarmConfig.overlap`` / ``staleness`` / ``dpu``):
boundary tensors ride the peers' links in flight, stage math goes
through the executors' dispatch/collect pair, and the All-Reduce window
runs beside the next round's compute, with delayed parameter updates
keeping the trajectory the sequential DPU reference's.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.compression import codecs
from repro_torch.core.dht import DHT
from repro_torch.core.faults import TraceEvent
from repro_torch.core.ledger import MicrobatchLedger
from repro_torch.core.peer import DeviceProfile, Peer, T4
from repro_torch.core import rebalance as rb
from repro_torch.core.sim import Sim, Sleep
from repro_torch.core.trainer import Microbatch, Trainer
from repro_torch.core.wiring import StochasticWiring
from repro_torch.models import flops as F
from repro_torch.models.config import ArchConfig
from repro_torch.models.stage_plan import get_stage_plan
from repro_torch.optim.adamw import Optimizer
from repro_torch.runtime import StageExecutor, StageProgram, \
    build_numeric_executors, init_stage_params
from repro_torch.tree import tree_map

Tree = Any

@dataclasses.dataclass
class SwarmConfig:
    """Swarm-level knobs (the architecture lives in ``ArchConfig``); the
    JAX package's fields and defaults, minus the deprecated ``compress``
    spelling.

    The async tick is controlled by two fields:

    * ``overlap`` — boundary tensors ride the peers' links as in-flight
      transfers (priced end to end at the sending/receiving pair's
      bottleneck) instead of two blocking serial sleeps, and stage math
      goes through the executors' dispatch/collect pair.  Pure timing:
      the losses are those of the blocking tick, float for float.
    * ``staleness`` — bounded staleness for the All-Reduce window: the
      optimizer step's numerics apply at the barrier instant while the
      window's time runs beside the next round's compute; at most
      ``staleness`` windows may be unfinished before the next barrier
      waits on the oldest.  Any value > 0 wraps the optimizer in
      ``delayed_parameter_updates`` (DPU, paper §3.2), so the trajectory
      equals the sequential DPU(delay=1) reference; 0 keeps the
      synchronous barrier.  ``dpu=True`` is the historical spelling of
      ``staleness=1``.

    ``ckpt_dir``: persist a pipeline-consistent cut of every stage's
    state each ``ckpt_period`` completed steps; a stage that loses all
    its peers resumes from the latest cut instead of the step-0
    reference, and a runner built over a non-empty ``ckpt_dir`` resumes
    that run (step counter and data cursor adopt the latest cut).

    ``spans``: let the Alg. 2 loop also propose span splits and merges
    (``rebalance.plan_span_change``).  ``link_table`` (a
    ``repro_torch.core.square_cube.LinkTable``): price each boundary over
    the link between the regions serving its two stages (seconds, not
    bytes), so span merges fuse across slow links first."""
    n_stages: int = 3
    microbatch_size: int = 1
    seq_len: int = 128
    global_batch: int = 8                # sequences per optimizer step
    n_trainers: int = 4
    rebalance_period: float = 300.0      # T (paper §4.3)
    announce_interval: float = 120.0
    announce_ttl: float = 300.0
    wiring_gamma: float = 0.1            # EMA alpha (paper §4.3)
    # boundary wire codec: "none" | "int8" | "bottleneck" | "maxout" |
    # "auto" (defer to ``cfg.boundary_compression``); None -> "int8"
    codec: Optional[str] = None
    quant_block: int = 64
    dpu: bool = False
    overlap: bool = False
    staleness: int = 0
    max_steps: Optional[int] = None
    allreduce_bw: float = 50e6           # bytes/s effective per peer
    trainer_max_retries: int = 50        # per-attempt routing retries
    ckpt_dir: Optional[str] = None
    ckpt_period: int = 1
    spans: bool = False
    link_table: Optional[Any] = None

    def __post_init__(self):
        if self.codec is None:
            self.codec = "int8"
        if self.codec != "auto" and self.codec not in codecs.MODES:
            raise ValueError(f"unknown codec {self.codec!r}; expected "
                             f"'auto' or one of {codecs.MODES}")
        if self.staleness < 0:
            raise ValueError(f"staleness must be >= 0, got "
                             f"{self.staleness}")
        if self.dpu:
            # historical spelling of the bounded-staleness knob
            self.staleness = max(self.staleness, 1)


def _as_span(stage: "int | range") -> range:
    return stage if isinstance(stage, range) else range(stage, stage + 1)


class SwarmRunner:
    def __init__(self, cfg: ArchConfig, scfg: SwarmConfig,
                 optimizer: Optimizer, *, numeric: bool = True,
                 seed: int = 0,
                 profile_fn: Optional[Callable[[int], DeviceProfile]] = None,
                 data_fn: Optional[Callable[[int], dict]] = None,
                 programs: Optional[list[StageProgram]] = None,
                 record_accumulation: bool = False,
                 region_fn: Optional[Callable[[int], str]] = None,
                 device="cuda"):
        """``device`` is where a numeric run's stages compute (the card
        unless the caller names the CPU); a timing-only run builds no
        tensors and reads no device."""
        self.cfg = cfg
        self.scfg = scfg
        if scfg.staleness > 0:
            # bounded staleness implies DPU: the step applies the grads
            # banked one round ago while this round's fold rides the
            # concurrent All-Reduce window (paper §3.2).  Wrapping here
            # keeps checkpoints, the reference init and every
            # export/adopt consistent with the wrapped state's shape.
            from repro_torch.optim.dpu import delayed_parameter_updates
            optimizer = delayed_parameter_updates(optimizer, delay=1)
        self.optimizer = optimizer
        self.overlap = bool(scfg.overlap)
        self.numeric = numeric
        self.sim = Sim()
        self.dht = DHT(lambda: self.sim.now)
        self.n_stages = scfg.n_stages
        self.plan = get_stage_plan(cfg, scfg.n_stages)
        self.compress_mode = codecs.resolve_mode(
            cfg, None if scfg.codec == "auto" else scfg.codec)
        self.quant_block = scfg.quant_block
        self.rng = np.random.default_rng(seed)
        self.profile_fn = profile_fn or (lambda i: T4)
        # zone placement, keyed by join index like profile_fn
        self.region_fn = region_fn or (lambda i: "local")
        self.data_fn = data_fn

        # one executor per stage, shared by all that stage's peers; the
        # step-0 reference state restores a stage that lost every peer
        # when no checkpoint is newer
        self.executors: list[Optional[StageExecutor]] = \
            [None] * scfg.n_stages
        self.programs: list[Optional[StageProgram]] = \
            [None] * scfg.n_stages
        self.device = None
        self._ref_params: Optional[list[Tree]] = None
        if numeric:
            if programs is not None:
                assert len(programs) == scfg.n_stages
            self.executors = build_numeric_executors(
                cfg, scfg.n_stages, scfg.seq_len,
                compress=self.compress_mode, quant_block=scfg.quant_block,
                device=device, programs=programs)
            self.device = self.executors[0].device
            self.programs = [e.prog for e in self.executors]
            self._ref_params = init_stage_params(self.programs, seed,
                                                 self.device)
            self._ref_opt = [optimizer.init(p) for p in self._ref_params]

        self.peers: dict[str, Peer] = {}
        self.wirings: list[StochasticWiring] = []
        self.trainers: list[Trainer] = []
        # (lo, hi) -> the shared default PipelineExecutor of that span
        self._span_execs: dict[tuple[int, int], StageExecutor] = {}

        # training progress
        self.stopped = False
        self._t_stopped: Optional[float] = None   # virtual stop instant
        self._mb_counter = 0
        self._inflight = 0
        self._dispatch_paused = False
        self.step = 0
        # exactly-once accounting (App. A): which (stage, microbatch)
        # pairs of the current round are held, and by whom
        self.ledger = MicrobatchLedger(scfg.n_stages)
        # optional audit trail, as (kind, step, stage, index, attempt,
        # peer_id) with kind in {"acc", "rel", "step"}
        self.record_accumulation = record_accumulation
        self.ledger_log: list[tuple[str, int, int, int, int, str]] = []
        self.metrics: dict[str, Any] = {
            "loss": [], "step_time": [], "samples_done": [],
            "throughput_t": [], "throughput_v": [], "migrations": 0,
            "failures": 0, "joins": 0, "recomputed_microbatches": 0,
            "span_changes": 0,       # span resizes applied
            "wire_bytes": 0.0,       # boundary bytes that crossed the
                                     # host (fused boundaries: none)
            "ckpt_restores": [],     # (stage, restored-from step)
            "rollbacks": [],         # (step rolled back from, to)
            # async-tick accounting (overlap mode): what the same edges
            # would have cost as blocking send + recv pairs, and what
            # they took in flight; run() derives overlap_fraction
            "wire_serial_s": 0.0,
            "wire_inflight_s": 0.0,
            "inflight_bytes": 0.0,
        }
        self._ar_pending: list = []  # unfinished All-Reduce windows
        self._samples_done_total = 0
        self._default_ds = None
        # cold-start resume: a non-empty ckpt_dir means this runner
        # continues that run — the latest consistent cut's step and data
        # cursor, so peers restore step-k state and training replays the
        # sample indices fault-free training would use from step k
        self._resume_step = self._common_ckpt_step() if numeric else 0
        if self._resume_step:
            self.step = self._resume_step
            self._mb_counter = self._resume_step * self._round_size()
        self._open_round()

    # ================================================== setup
    def _span_executor(self, span: range) -> Optional[StageExecutor]:
        """The default executor of a span (None in timing mode): the
        stage family's for width 1, a runner-cached
        :class:`~repro_torch.runtime.PipelineExecutor` otherwise, so all
        default-backed peers of one span share one executor (which keeps
        ``adopt_state_from``'s zero-copy alias path)."""
        if self.executors[span.start] is None or len(span) == 1:
            return self.executors[span.start]
        key = (span.start, span.stop)
        ex = self._span_execs.get(key)
        if ex is None:
            ex = self._span_execs[key] = \
                self.executors[span.start].for_span(span)
        return ex

    def _rebacked_executor(self, peer: Peer,
                           span: range) -> Optional[StageExecutor]:
        """``peer``'s backend re-targeted at ``span``: a mesh-backed peer
        keeps its mesh (``for_span``); a default-backed peer goes back
        through the runner's shared executors."""
        if peer.executor is None:
            return None
        from repro_torch.runtime.mesh import MeshExecutor, MeshSpanExecutor
        if isinstance(peer.executor, (MeshExecutor, MeshSpanExecutor)):
            return peer.executor.for_span(span)
        return self._span_executor(span)

    def _routes_without(self, peer: Peer,
                        new_span: Optional[range]) -> bool:
        """Would the serving layout still tile [0, n_stages) if ``peer``
        served ``new_span`` (None = left entirely)?"""
        layout = [(q.stages.start, q.stages.stop)
                  for q in self.peers.values()
                  if q.alive and q.serving and q is not peer]
        if new_span is not None:
            layout.append((new_span.start, new_span.stop))
        return rb.spans_route(self.n_stages, layout)

    def add_peer(self, stage: "int | range",
                 profile: Optional[DeviceProfile] = None,
                 executor: Optional[StageExecutor] = None) -> Peer:
        """Cold-start a peer (initial ``build``): it installs the state
        of the step the runner starts at (the step-0 reference, or the
        resumed cut), so announcing immediately is safe.  Mid-run joins
        go through ``_join_new_peer``, which downloads the stage state
        *before* announcing (warm join)."""
        span = _as_span(stage)
        if executor is not None:
            assert (executor.stages.start, executor.stages.stop) == \
                (span.start, span.stop), (executor.stages, span)
        else:
            executor = self._span_executor(span)
        peer = Peer(self.sim, profile or self.profile_fn(len(self.peers)),
                    span, executor=executor,
                    region=self.region_fn(len(self.peers)))
        self.peers[peer.id] = peer
        # _resume_step 0 pins the step-0 reference: a torn or leftover
        # ckpt_dir with no common step must not leak differing per-stage
        # "latest" states into a fresh run
        for s in peer.stages:
            self._restore_from_checkpoint(peer, s, step=self._resume_step)
        self._announce(peer)
        for w in self.wirings:
            w.add_server(peer.id, [peer.stages.start])
        self.sim.spawn(self._announcer(peer))
        return peer

    def build(self, peers_per_stage: int | list[int]):
        if isinstance(peers_per_stage, int):
            peers_per_stage = [peers_per_stage] * self.n_stages
        for s, n in enumerate(peers_per_stage):
            for _ in range(n):
                self.add_peer(s)
        for i in range(self.scfg.n_trainers):
            w = StochasticWiring(self.n_stages,
                                 gamma=self.scfg.wiring_gamma,
                                 seed=1000 + i)
            for pid, p in self.peers.items():
                if p.alive:
                    w.add_server(pid, [p.stages.start])
            self.wirings.append(w)
            t = Trainer(self.sim, self, w, f"trainer{i}",
                        max_retries=self.scfg.trainer_max_retries)
            self.trainers.append(t)
            self.sim.spawn(t.run())
        self.sim.spawn(self._sync_loop())
        if self.scfg.rebalance_period > 0:
            self.sim.spawn(self._rebalance_loop())

    # ================================================== DHT liveness
    def _announce(self, peer: Peer):
        for s in peer.stages:
            self.dht.store(self.dht.stage_key(s), peer.id, s,
                           self.scfg.announce_ttl)

    def _dht_forget(self, peer: Peer):
        for s in peer.stages:
            self.dht.delete(self.dht.stage_key(s), peer.id)
            self.dht.delete(self.dht.load_key(s), peer.id)

    def _announcer(self, peer: Peer):
        gen = peer._generation
        while peer.alive and peer._generation == gen and not self.stopped:
            if peer.serving:          # no announcements mid-download
                self._announce(peer)
            yield Sleep(self.scfg.announce_interval)

    def announced_stages(self) -> dict[str, int]:
        """Live serving peers by their ROUTING slot (span start) — what
        the wirings refresh from."""
        out = {}
        for s in range(self.n_stages):
            for pid in self.dht.get(self.dht.stage_key(s)):
                peer = self.peers.get(pid)
                if peer is not None and peer.alive and peer.serving \
                        and s in peer.stages:
                    out[pid] = peer.stages.start
        return out

    def _covering(self, stage: int, but: Optional[Peer] = None
                  ) -> list[Peer]:
        """Live serving peers whose span covers ``stage``."""
        return [p for p in self.peers.values()
                if p.alive and p.serving and stage in p.stages
                and p is not but]

    def _stage_regions(self) -> list[str]:
        """Dominant region per stage: the most common zone among the
        live serving peers covering it (alphabetical tie-break; "local"
        when nobody covers) — the region vector the link table prices
        boundary edges with."""
        regions = []
        for s in range(self.n_stages):
            counts: dict[str, int] = {}
            for p in self._covering(s):
                counts[p.region] = counts.get(p.region, 0) + 1
            regions.append(max(sorted(counts), key=counts.get)
                           if counts else "local")
        return regions

    # ================================================== data / dispatch
    def _round_size(self) -> int:
        """Microbatches per optimizer step."""
        return self.scfg.global_batch // max(self.scfg.microbatch_size, 1)

    def _open_round(self):
        """Fix the next round's sample set: exactly ``global_batch``
        samples (App. E synchronous semantics).  Lost samples re-issue
        under the *same* index."""
        K = self._round_size()
        self.ledger.open_round(
            range(self._mb_counter, self._mb_counter + K))
        self._mb_counter += K

    def next_microbatch(self) -> Optional[Microbatch]:
        """Hand out work while some stage of the current round is short —
        the ledger re-issues exactly the indices whose gradients died
        with failed peers (App. A)."""
        if self.stopped or self._dispatch_paused:
            return None
        nxt = self.ledger.next_index()
        if nxt is None:
            return None
        idx, attempt = nxt
        if attempt > 1:
            self.metrics["recomputed_microbatches"] += 1
        self._inflight += 1
        b, S = self.scfg.microbatch_size, self.scfg.seq_len
        mb = Microbatch(index=idx, size=b, n_tokens=b * S, attempt=attempt)
        if self.numeric:
            batch = (self.data_fn(idx) if self.data_fn else
                     self._default_data(idx))
            mb.tokens, mb.labels = batch["tokens"], batch["labels"]
        return mb

    def _default_data(self, idx: int) -> dict:
        if self._default_ds is None:    # one dataset per runner, reused
            from repro_torch.data.synthetic import SyntheticLM
            self._default_ds = SyntheticLM(
                self.cfg.vocab_size, self.scfg.seq_len,
                self.scfg.microbatch_size, seed=17)
        return self._default_ds.batch(idx)

    def microbatch_done(self, mb: Microbatch, ok: bool):
        self._inflight -= 1
        # the ledger re-queues the index iff some stage still lacks it
        self.ledger.settle(mb.index)
        if ok:
            self._samples_done_total += mb.size
            self.metrics["throughput_t"].append(self.sim.now)
            self.metrics["throughput_v"].append(self._samples_done_total)

    # ================================================== cost model
    def compute_time(self, peer: Peer, kind: str, stage: int,
                     mb: Microbatch) -> float:
        ex = peer.executor
        if ex is not None:
            fpt = (ex.fwd_flops_per_token if kind == "fwd"
                   else ex.bwd_flops_per_token)
            speedup = max(1, ex.dp_shards(mb.size))
            return peer.profile.compute_time(fpt * mb.n_tokens) / speedup
        # timing-only: analytic per-stage flops summed over the hop's
        # covered stages, priced per kind by the stage plan
        stages = peer.stages if stage in peer.stages \
            else range(stage, stage + 1)
        fpt = sum(self.plan.stage_flops(s, self.scfg.seq_len)
                  for s in stages)
        if kind == "bwd":
            fpt *= 3.0
        return peer.profile.compute_time(fpt * mb.n_tokens)

    def boundary_nbytes(self, mb: Microbatch,
                        boundary: Optional[int] = None) -> float:
        """Bytes the active codec puts on the wire at ``boundary``
        (uniform hidden-state pricing when None or out of range)."""
        if boundary is not None and 0 <= boundary < self.n_stages - 1:
            return self.plan.boundary_bytes(
                boundary, mb.size, self.scfg.seq_len, self.compress_mode)
        return F.boundary_bytes(
            self.cfg, mb.size, self.scfg.seq_len, self.compress_mode)

    def count_wire_bytes(self, nbytes: float):
        """One boundary tensor actually crossed the host."""
        self.metrics["wire_bytes"] += nbytes

    def count_inflight_wire(self, serial_s: float, actual_s: float,
                            nbytes: float):
        """One in-flight edge landed (overlap mode): ``serial_s`` is what
        the blocking send + recv pair would have cost, ``actual_s`` what
        the trainer really waited.  Clamped per edge: a wait beyond the
        serial estimate is FIFO queueing on a contended link (the sync
        path prices links as infinitely parallel), not negative overlap,
        so it must not cancel savings other edges really hid."""
        self.metrics["wire_serial_s"] += serial_s
        self.metrics["wire_inflight_s"] += min(actual_s, serial_s)
        self.metrics["inflight_bytes"] += nbytes

    # ================================================== gradient sync
    def accumulate(self, peer: Peer, gp: Optional[Tree], mb: Microbatch,
                   loss: Optional[float], stage: Optional[int] = None
                   ) -> bool:
        """Fold a microbatch gradient into ``peer``'s accumulator —
        exactly once per (stage, index) per round, for every stage the
        peer's span covers.  A re-issued attempt falls through for the
        stages that already hold the gradient (re-running backward with
        unchanged params reproduces it, so skipping is exact), so a span
        peer may fold a subset of its stages.  ``gp`` is the stage's tree
        for a single-stage peer, a ``{global stage id: tree}`` dict for a
        span peer."""
        stages = [stage] if stage is not None else list(peer.stages)
        span_keyed = isinstance(gp, dict) and bool(gp) and \
            all(isinstance(k, int) for k in gp)
        last = self.n_stages - 1
        any_folded = False
        for s in stages:
            if not self.ledger.record(s, mb.index, peer.id):
                continue
            if self.record_accumulation:
                self.ledger_log.append(
                    ("acc", self.step, s, mb.index, mb.attempt, peer.id))
            loss_s = loss if s == last else None
            if peer.executor is not None:
                peer.executor.accumulate(peer.state,
                                         gp[s] if span_keyed else gp,
                                         loss_s, mb.n_tokens, stage=s)
            else:                               # timing-only simulation
                view = peer.state.stage_view(s)
                view.token_count += mb.n_tokens
                if loss_s is not None:
                    view.loss_sum += loss_s
            any_folded = True
        return any_folded

    def _sync_loop(self):
        """Trigger All-Reduce + optimizer step when the ledger shows the
        full global batch accumulated at every stage."""
        if self.scfg.staleness > 0:
            yield from self._sync_loop_async()
            return
        while not self.stopped:
            # barrier: every stage holds every index AND nothing is in
            # flight (an in-flight re-issue may still run stale thunks
            # whose accumulations must land in *this* round)
            if not self.ledger.complete() or self._inflight > 0:
                yield Sleep(0.2)
                continue
            self._dispatch_paused = True
            t0 = self.sim.now
            yield from self._all_reduce_and_step()
            self.metrics["step_time"].append(self.sim.now - t0)
            self._open_round()
            self._dispatch_paused = False
            if (self.scfg.max_steps is not None
                    and self.step >= self.scfg.max_steps):
                self.stopped = True
                self._t_stopped = self.sim.now

    def _sync_loop_async(self):
        """Bounded-staleness barrier (``scfg.staleness`` > 0): the step's
        numerics apply atomically at the barrier instant (the gradients
        and install order of the sync path, so the trajectory equals the
        sequential DPU reference), while the All-Reduce *time* rides a
        concurrent window off the critical path — the next round's
        compute starts at once.  At most ``staleness`` windows may be
        unfinished before the next barrier waits on the oldest; dispatch
        never pauses (no yields between barrier detection and the
        round's reopening)."""
        last_barrier = 0.0
        while not self.stopped:
            if not self.ledger.complete() or self._inflight > 0:
                yield Sleep(0.2)
                continue
            self._ar_pending = [ev for ev in self._ar_pending
                                if not ev.fired]
            if len(self._ar_pending) >= self.scfg.staleness:
                yield self._ar_pending[0].wait()
                # re-check the barrier: a peer that died during the wait
                # released ledger rows whose recomputes are now in
                # flight (the JAX package steps here on the incomplete
                # round, then trips over their stale settles)
                continue
            total = yield from self._all_reduce_and_step(window=True)
            # step_time = the inter-barrier interval: with the window off
            # the critical path this is the number to compare to sync
            self.metrics["step_time"].append(self.sim.now - last_barrier)
            last_barrier = self.sim.now
            ev = self.sim.event()
            self._ar_pending.append(ev)
            self.sim.spawn(self._ar_window(total, ev))
            self._open_round()
            if (self.scfg.max_steps is not None
                    and self.step >= self.scfg.max_steps):
                self.stopped = True
                self._t_stopped = self.sim.now

    def _ar_window(self, duration: float, ev):
        yield Sleep(duration)
        ev.fire()

    def _log_releases(self, lost: list[tuple[int, int]], peer_id: str):
        if self.record_accumulation:
            for s, i in lost:
                self.ledger_log.append(("rel", self.step, s, i, 0, peer_id))

    def _all_reduce_and_step(self, window: bool = False):
        """Per-stage ring All-Reduce (time) + optimizer step (numerics).

        Synchronous barrier: every stage's step is computed at the
        barrier instant, before the first sleep, so failures inside the
        All-Reduce window cannot remove gradients from a step that
        already observed the complete global batch; each stage installs
        after its ring's time.  ``window=True`` (the bounded-staleness
        barrier): nothing is slept — each stage installs as soon as it is
        computed (no time passes, so the numerics are the same, and only
        one stage's old and new state are alive together) — and the
        generator returns the summed All-Reduce time for the concurrent
        window."""
        plan = self._ar_plan()
        if not window:
            plan = list(plan)
        total = 0.0
        for s, group, ar_time, new_params, new_opt in plan:
            if window:
                total += ar_time
            else:
                yield Sleep(ar_time)
            self._ar_install(s, group, new_params, new_opt)
            del new_params, new_opt
        self.step += 1
        self._maybe_checkpoint()
        return total

    def _ar_install(self, s: int, group: list, new_params, new_opt):
        for p in group:
            if not p.alive:      # died inside the ring: state is dead
                continue
            if self.numeric:
                p.executor.adopt_step(p.state, new_params, new_opt,
                                      stage=s)
            else:
                p.state.stage_view(s).zero_grads()

    def _ar_plan(self):
        """Gradient averaging + optimizer step, one stage at a time as the
        caller draws (shared by the sync and bounded-staleness barriers):
        the group's gradients summed (in f64, order-independent: see
        ``runtime.base.fold_into``) and divided by the group's token
        count, the update applied as ``p + u.to(p.dtype)``."""
        if self.record_accumulation:
            self.ledger_log.append(("step", self.step, -1, -1, 0, ""))
        for s in range(self.n_stages):
            # non-serving peers are mid-download: stale params, drained
            # grads — they adopt the stepped state when the download ends
            group = self._covering(s)
            if not group:
                continue
            k = len(group)
            nbytes = group[0].state_nbytes(stage=s) / 3.0   # grads only
            if nbytes == 0.0:                        # throughput mode
                nbytes = 2.0 * F.total_params(self.cfg) / self.n_stages
            ar_time = (2 * (k - 1) / max(k, 1)) * nbytes \
                / self.scfg.allreduce_bw + 0.01 * k
            if not self.numeric:
                yield s, group, ar_time, None, None
                continue
            total_tokens = sum(p.state.stage_view(s).token_count
                               for p in group)
            gsum = group[0].executor.export_grads(group[0].state, stage=s)
            for p in group[1:]:
                gsum = tree_map(lambda a, b: a + b, gsum,
                                p.executor.export_grads(p.state, stage=s))
            params, opt = group[0].executor.export_state(group[0].state,
                                                         stage=s)
            # the f64 sum rounded once to the params' dtype
            gmean = tree_map(lambda g, p: g.to(p.dtype)
                             / max(total_tokens, 1), gsum, params)
            updates, new_opt = self.optimizer.update(gmean, opt, params)
            new_params = tree_map(lambda p, u: p + u.to(p.dtype), params,
                                  updates)
            # hold no reference to the old state across the yield: a
            # caller that installs before drawing the next stage frees it
            del gsum, gmean, updates, params, opt
            loss_sum = sum(p.state.stage_view(s).loss_sum for p in group)
            if s == self.n_stages - 1 and total_tokens:
                self.metrics["loss"].append(loss_sum / total_tokens)
            yield s, group, ar_time, new_params, new_opt
            del new_params, new_opt

    # ================================================== rebalancing
    def _rebalance_loop(self):
        """Alg. 2 every ``rebalance_period`` seconds: peers report queue
        sizes under the DHT load keys of every stage they cover, one
        frozen ``ControlSnapshot`` per round, and the planned migration
        executes — or, with ``spans=True`` and no migration, the planned
        span resize."""
        T = self.scfg.rebalance_period
        while not self.stopped:
            yield Sleep(T)
            # mid-download peers neither report nor qualify as donors
            for p in self.peers.values():
                if p.alive and p.serving:
                    for s in p.stages:
                        self.dht.store(self.dht.load_key(s), p.id,
                                       p.queue_size() + 1e-3, T * 1.5)
            pps = {s: [p.id for p in self.peers.values()
                       if p.alive and p.serving and p.stages ==
                       range(s, s + 1)]
                   for s in range(self.n_stages)}
            snap = rb.ControlSnapshot.capture(self.dht, self.n_stages)
            mig = rb.plan_migration(snap, self.n_stages, pps)
            if mig is not None:
                yield from self._migrate(self.peers[mig.peer],
                                         mig.dst_stage)
                continue
            if not self.scfg.spans:
                continue
            spans = {p.id: (p.stages.start, p.stages.stop)
                     for p in self.peers.values()
                     if p.alive and p.serving}
            # per-boundary wire prices from the stage plan: merges fuse
            # the most expensive edge first; with a link table the bytes
            # become region-priced seconds, so the swarm fuses across
            # slow links first
            bcosts = self.plan.boundary_costs(
                self.scfg.microbatch_size, self.scfg.seq_len,
                self.compress_mode)
            if self.scfg.link_table is not None:
                bcosts = self.scfg.link_table.edge_costs(
                    list(bcosts), self._stage_regions())
            ch = rb.plan_span_change(snap, self.n_stages, spans,
                                     boundary_costs=bcosts)
            if ch is not None:
                yield from self._resize_span(self.peers[ch.peer],
                                             range(*ch.new_span))

    # ================================================== checkpoints
    def _maybe_checkpoint(self):
        """Persist every stage's state (executor ``snapshot`` ->
        ``repro_torch.ckpt``) after a completed optimizer step.  A
        checkpoint is a pipeline-consistent cut: every stage is saved at
        this step or none is (a stranded stage skips the whole save), so
        the stage directories hold the same step numbers."""
        if (not self.numeric or not self.scfg.ckpt_dir
                or self.step % max(self.scfg.ckpt_period, 1)):
            return
        holders = []
        for s in range(self.n_stages):
            holder = next(
                (p for p in self._covering(s)
                 if p.state.stage_view(s).params is not None), None)
            if holder is None:
                return                 # no consistent cut exists right now
            holders.append(holder)
        from repro_torch.ckpt import prune_checkpoints, save_checkpoint, \
            stage_dir
        for s, holder in enumerate(holders):
            d = stage_dir(self.scfg.ckpt_dir, s)
            save_checkpoint(d, self.step,
                            holder.executor.snapshot(holder.state, stage=s))
            # keep 2 cuts: a cut torn by a process dying between per-stage
            # saves is excluded by _common_ckpt_step's intersection, and
            # resume falls back to the previous one
            prune_checkpoints(d, keep=2)

    def _common_ckpt_step(self) -> int:
        """Newest checkpointed step EVERY stage can serve (0 if none): a
        torn cut is excluded by the intersection, never resumed at mixed
        versions."""
        if not self.scfg.ckpt_dir:
            return 0
        from repro_torch.ckpt import available_steps, stage_dir
        common = None
        for s in range(self.n_stages):
            steps = set(available_steps(stage_dir(self.scfg.ckpt_dir, s)))
            common = steps if common is None else common & steps
        return max(common) if common else 0

    def _rollback_to(self, step_k: int):
        """Rewind EVERY stage to checkpoint step ``step_k`` < the current
        step (Varuna-style global rollback), so the pipeline trains one
        consistent version: the step counter, the data cursor and the
        loss list rewind with it, and the replayed steps consume the
        sample indices fault-free training used after ``step_k``."""
        self._dispatch_paused = True
        # drain in-flight microbatches: their accumulations belong to the
        # aborted round (attempts against the stranded stage fail once
        # trainer retries exhaust)
        while self._inflight > 0 and not self.stopped:
            yield Sleep(0.1)
        if self.stopped:
            return
        for s in range(self.n_stages):
            group = self._covering(s)
            if not group:
                continue
            # one disk read per stage, explicitly the target step (not
            # "latest"), so every stage rewinds to the same cut
            snap = self._ckpt_snapshot(s, step=step_k)
            for p in group:
                p.executor.restore(p.state, snap, stage=s)
            del snap          # one stage's host copy at a time
        self.metrics["rollbacks"].append((self.step, step_k))
        self.step = step_k
        self._mb_counter = step_k * self._round_size()
        # the loss list is relative to the step this runner started at
        del self.metrics["loss"][max(step_k - self._resume_step, 0):]
        self._open_round()
        self._dispatch_paused = False

    # ================================================== state transfer
    def _restore_from_checkpoint(self, peer: Peer, stage: int,
                                 step: Optional[int] = None):
        """Install a persisted state through the peer's executor (see
        :meth:`_ckpt_snapshot` for ``step``); nothing in timing mode."""
        if self._ref_params is None:
            return
        peer.executor.restore(peer.state,
                              self._ckpt_snapshot(stage, step=step),
                              stage=stage)

    def _ckpt_snapshot(self, stage: int, step: Optional[int] = None):
        """Snapshot tree for ``stage``: checkpoint ``step`` from
        ``ckpt_dir`` (None = the latest; 0 = the step-0 reference,
        bypassing the directory), the step-0 reference when the stage's
        directory is empty.  A directory that has steps but not the one
        asked for is inconsistent with its siblings: RuntimeError."""
        snap = {"params": self._ref_params[stage],
                "opt": self._ref_opt[stage], "version": 0}
        if self.scfg.ckpt_dir and step != 0:
            from repro_torch.ckpt import available_steps, \
                restore_checkpoint, stage_dir
            d = stage_dir(self.scfg.ckpt_dir, stage)
            try:
                snap, got = restore_checkpoint(d, like=snap, step=step)
                self.metrics["ckpt_restores"].append((stage, got))
            except FileNotFoundError:
                if step is not None and available_steps(d):
                    raise RuntimeError(
                        f"checkpoint dir {d} has steps "
                        f"{available_steps(d)} but not the requested "
                        f"step {step} — stage dirs are inconsistent")
        return snap

    def _download_stage_state(self, peer: Peer, s: int):
        """Warm-state download of ONE stage from a live covering
        neighbour (retrying if the donor dies mid-transfer), falling back
        to the checkpoint when the stage has no survivors.  Returns with
        the stage installed, or early if the peer itself dies."""
        if not self.numeric:           # timing-only state transfer
            yield Sleep(1.0)
            return
        while True:
            donors = self._covering(s, but=peer)
            if not donors:
                yield Sleep(1.0)
                # never adopt inside an All-Reduce window
                while self._dispatch_paused and not self.stopped:
                    yield Sleep(0.05)
                if not peer.alive or self.stopped:
                    return
                if self._covering(s, but=peer):
                    continue           # a peer recovered during the wait
                # truly stranded: resume from the latest persisted cut,
                # first rewinding the WHOLE pipeline to it when it is
                # older than the current step — a lone stage never
                # serves params older than its neighbours'
                k = self._common_ckpt_step()
                if k < self.step:
                    yield from self._rollback_to(k)
                if peer.alive:
                    self._restore_from_checkpoint(peer, s, step=k)
                return
            donor = donors[0]
            yield Sleep(peer.profile.recv_time(donor.state_nbytes(stage=s)))
            # adopt outside the All-Reduce window, or the joiner would
            # capture pre-step params while the stage steps past it
            while self._dispatch_paused and not self.stopped:
                yield Sleep(0.05)
            if not peer.alive:
                return
            if donor.alive and donor.serving and s in donor.stages:
                if peer.stages == donor.stages:
                    peer.adopt_state_from(donor)   # zero-copy alias
                else:
                    peer.executor.restore(
                        peer.state,
                        donor.executor.snapshot(donor.state, stage=s),
                        stage=s)
                return

    def _download_state(self, peer: Peer, span: range):
        """Download every stage of ``span``, each from whoever covers it
        (a merging peer may pull its stages from different donors)."""
        for s in span:
            yield from self._download_stage_state(peer, s)
            if not peer.alive or self.stopped:
                return

    def _catch_up(self, peer: Peer):
        """Before ``peer`` serves again, re-adopt each stage of its span
        that an optimizer step passed by: the All-Reduce installs a step
        only into serving peers, so a stage it kept across a resize, or
        downloaded before a later stage's download ended, is a version
        behind its live covers when a step landed meanwhile.  No
        transfer time is charged, so timing-only runs are unchanged.
        (The JAX package serves such a stage stale.)  The
        bounded-staleness barrier installs its step the same way, at the
        barrier instant and into serving peers only, so the same single
        re-adoption holds there; under DPU the banked gradients travel
        in the snapshot's ``opt`` with the moments."""
        if peer.executor is None:
            return
        for s in peer.stages:
            mine = peer.state.stage_view(s).version
            donor = next((q for q in self._covering(s, but=peer)
                          if q.state.stage_view(s).version > mine), None)
            if donor is not None:
                peer.executor.restore(
                    peer.state, donor.executor.snapshot(donor.state,
                                                        stage=s),
                    stage=s)

    def _complete_warm_join(self, peer: Peer, span: range):
        """Warm-join tail shared by migrations and joins: the state
        download completes BEFORE the peer is announced or entered into
        any wiring — a (re)joining peer must never serve stale params.
        Returns False if the peer died mid-download."""
        peer.serving = False
        yield from self._download_state(peer, span)
        if not peer.alive:                     # preempted mid-download
            return False
        self._catch_up(peer)
        peer.serving = True
        self._announce(peer)
        for w in self.wirings:
            w.move_server(peer.id, [span.start])
        return True

    def _retire_assignment(self, peer: Peer):
        """Stop serving the current stage, in exactly-once order: drain
        queued thunks (they must never run against newly adopted state),
        release the ledger entries the peer's gradients backed
        (survivors recompute those indices), zero its gradients, leave
        the DHT slots and wirings."""
        peer.serving = False
        peer.drain()
        lost = []
        for s in peer.stages:
            lost += [(s, i) for i in self.ledger.release_peer(s, peer.id)]
        self._log_releases(lost, peer.id)
        peer.state.zero_grads()                # grads die with the move
        self._dht_forget(peer)
        for w in self.wirings:
            w.ban_server(peer.id)

    def _migrate(self, peer: Peer, dst: "int | range"):
        """Stage switch (Alg. 2), in exactly-once order: stop serving,
        drain, release the ledger rows, zero the grads, drop the old
        stage's state, download the destination's — and only then
        announce again and re-enter the wirings."""
        dst_span = _as_span(dst)
        # never yank accumulated grads out of an in-progress All-Reduce
        while self._dispatch_paused and not self.stopped:
            yield Sleep(0.05)
        if self.stopped or not peer.alive or not peer.serving:
            return
        # the plan came from an older snapshot: leaving must neither
        # strand a source stage nor break the layout's routability
        if not all(self._covering(s, but=peer) for s in peer.stages) \
                or not self._routes_without(peer, dst_span):
            return
        self._retire_assignment(peer)
        peer.executor = self._rebacked_executor(peer, dst_span)
        peer.set_span(dst_span)
        # the old stage's device state (its gradient slots; params and
        # moments alias the stage's other peers) is dropped here, before
        # the destination's is installed
        peer.state = peer._fresh_state()
        ok = yield from self._complete_warm_join(peer, dst_span)
        if ok:
            self.metrics["migrations"] += 1

    def _resize_span(self, peer: Peer, new_span: range):
        """Shrink or grow a serving peer's span in place (how spans split
        into single-stage peers and merge back).  Exactly-once order as
        in ``_migrate``: drain and release first, then swap the executor
        and state.  A stage kept across the resize keeps its device
        tensors (the restore aliases them: no transfer time); a newly
        covered stage warm-downloads from whoever covers it.  Refuses a
        resize that would strand a dropped stage or break routing."""
        while self._dispatch_paused and not self.stopped:
            yield Sleep(0.05)
        if self.stopped or not peer.alive or not peer.serving:
            return False
        old_span = peer.stages
        if new_span == old_span:
            return False
        dropped = [s for s in old_span if s not in new_span]
        if not all(self._covering(s, but=peer) for s in dropped):
            return False                       # would strand a stage
        if not self._routes_without(peer, new_span):
            return False                       # coverage != routability
        kept = {}
        if peer.executor is not None:
            for s in new_span:
                if s in old_span:
                    v = peer.state.stage_view(s)
                    kept[s] = {"params": v.params, "opt": v.opt,
                               "version": v.version}
        self._retire_assignment(peer)
        peer.executor = self._rebacked_executor(peer, new_span)
        peer.set_span(new_span)
        peer.state = peer._fresh_state()
        for s, snap in kept.items():
            peer.executor.restore(peer.state, snap, stage=s)
        peer.serving = False
        for s in new_span:
            if s not in old_span:
                yield from self._download_stage_state(peer, s)
                if not peer.alive or self.stopped:
                    return False
        self._catch_up(peer)
        peer.serving = True
        self._announce(peer)
        for w in self.wirings:
            w.move_server(peer.id, [new_span.start])
        self.metrics["span_changes"] += 1
        return True

    def split_span(self, peer: Peer, at: int):
        """Split ``peer``'s span ``[lo, hi)`` at ``at``: a fresh (or
        revived) peer warm-joins on ``[at, hi)``, downloading those
        stages from the splitting peer, which still serves them; only
        then does the donor shrink to ``[lo, at)``, so coverage never
        gaps."""
        lo, hi = peer.stages.start, peer.stages.stop
        if not (lo < at < hi):
            raise ValueError(f"split point {at} outside ({lo}, {hi})")
        yield from self._join_new_peer(span=range(at, hi))
        yield from self._resize_span(peer, range(lo, at))

    def merge_spans(self, peer: Peer, new_span: range):
        """Grow ``peer`` to ``new_span``, downloading the stages it
        absorbs from their current holders — the inverse of
        ``split_span``."""
        yield from self._resize_span(peer, new_span)

    # ================================================== fault injection
    def apply_trace(self, trace: list[TraceEvent]):
        self.sim.spawn(self._trace_proc(trace))

    def _trace_proc(self, trace: list[TraceEvent]):
        for ev in trace:
            dt = ev.time - self.sim.now
            if dt > 0:
                yield Sleep(dt)
            if self.stopped:
                return
            if ev.delta < 0:
                for _ in range(-ev.delta):
                    self._fail_random_peer(region=ev.region)
            else:
                for _ in range(ev.delta):
                    yield from self._join_new_peer(region=ev.region)

    def _fail_random_peer(self, region: Optional[str] = None):
        live = [p for p in self.peers.values() if p.alive]

        def covered(p: Peer) -> bool:
            return all(any(q.serving and s in q.stages
                           for q in live if q is not p)
                       for s in p.stages)
        # never strand a stage, never break the span layout's routing
        candidates = [p for p in live
                      if covered(p) and self._routes_without(p, None)]
        if region is not None:
            candidates = [p for p in candidates
                          if getattr(p, "region", "local") == region]
        if not candidates:
            return
        self._fail_peer(candidates[self.rng.integers(len(candidates))])

    def _fail_peer(self, victim: Peer):
        """Preempt ``victim`` NOW (no stage-coverage guard)."""
        victim.fail()
        self.metrics["failures"] += 1
        # the victim's accumulated gradients die with it: survivors
        # recompute exactly the indices it held (App. A)
        self._log_releases(self.ledger.release_all(victim.id), victim.id)
        for w in self.wirings:
            w.ban_server(victim.id)
        self._dht_forget(victim)

    def _join_new_peer(self, span: Optional[range] = None,
                       region: Optional[str] = None):
        if span is None:
            # new peers join the most loaded stage (§3.2)
            loads = []
            for s in range(self.n_stages):
                group = self._covering(s)
                q = sum(p.queue_size() for p in group)
                loads.append((q + 1) / max(len(group), 1e-9))
            span = _as_span(int(np.argmax(loads)))
        # preemptible instances coming back reuse their peer object
        dead = [p for p in self.peers.values() if not p.alive]
        if dead:
            peer = dead[0]
            # a revived peer keeps its backend (a mesh coming back is
            # that mesh), re-targeted at the join span
            peer.executor = self._rebacked_executor(peer, span)
            if region is not None:
                peer.region = region
            peer.revive(span)
        else:
            peer = Peer(self.sim, self.profile_fn(len(self.peers)), span,
                        executor=self._span_executor(span),
                        region=(region if region is not None
                                else self.region_fn(len(self.peers))))
            self.peers[peer.id] = peer
        self.metrics["joins"] += 1
        ok = yield from self._complete_warm_join(peer, span)
        if ok:
            self.sim.spawn(self._announcer(peer))

    # ================================================== run
    def run(self, until: Optional[float] = None,
            max_steps: Optional[int] = None):
        if max_steps is not None:
            self.scfg = dataclasses.replace(self.scfg, max_steps=max_steps)
        self.sim.run(until=until)
        self.stopped = True
        # per-peer executor idle time, closed at the instant training
        # stopped (a max_steps run drains the clock to the horizon
        # afterwards, and that is not executor idleness)
        t_end = min(self.sim.now, self._t_stopped
                    if self._t_stopped is not None else self.sim.now)
        m = self.metrics
        m["peer_idle_s"] = {pid: p.total_idle(t_end)
                            for pid, p in self.peers.items()}
        # how much of the serial wire cost the in-flight transfers hid;
        # clamped: an all-span swarm has no peer-to-peer edge to hide, so
        # in-flight equals serial up to float noise — 0, not -1e-15
        m["overlap_fraction"] = max(0.0, (
            1.0 - m["wire_inflight_s"] / m["wire_serial_s"]
            if m["wire_serial_s"] > 0 else 0.0))
        return self.metrics

    def throughput(self, window: Optional[float] = None) -> float:
        """Samples/s over the run (optionally a trailing window)."""
        ts, vs = (self.metrics["throughput_t"],
                  self.metrics["throughput_v"])
        if len(ts) < 2:
            return 0.0
        if window:
            lo = bisect.bisect_left(ts, ts[-1] - window)
            lo = min(lo, len(ts) - 2)
            return (vs[-1] - vs[lo]) / max(ts[-1] - ts[lo], 1e-9)
        return vs[-1] / max(ts[-1], 1e-9)
