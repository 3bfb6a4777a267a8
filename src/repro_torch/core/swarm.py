"""SwarmRunner — elastic SWARM training on the virtual clock (port of
``repro.core.swarm``, synchronous tick, numeric mode).

Composition (paper Fig. 2): consecutive swarms of peers serve pipeline
stages; trainer processes route microbatches via stochastic wiring; a
DHT carries liveness; once the microbatch ledger shows the global batch
accumulated exactly once at every stage, each stage All-Reduces its
gradients (token-weighted) and applies the optimizer step.  Gradients
lost to dead peers are recomputed by survivors under the same
microbatch indices, so an optimizer step under churn averages the
identical sample set as fault-free training (App. A).

Every stage runs real PyTorch math on the runner's device (``numeric``
must be True).  What this slice leaves to later ones, each raising
``NotImplementedError`` where it is asked for: timing-only runs
(``numeric=False``) and rebalancing migration (``rebalance_period >
0``; ROADMAP queue 1 item 2's control plane), span peers, ``overlap``
and ``staleness``/``dpu`` (queue 1 item 4), checkpoints and global
rollback (``ckpt_dir``, the stranded-stage fallback past step 0), and
region-priced links (``link_table``).
"""
from __future__ import annotations

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
from repro_torch.models.config import ArchConfig
from repro_torch.models.stage_plan import get_stage_plan
from repro_torch.optim.adamw import Optimizer
from repro_torch.runtime import StageExecutor, StageProgram, \
    build_numeric_executors, init_stage_params
from repro_torch.tree import tree_map

Tree = Any

_ASYNC = "ROADMAP queue 1 item 4 (spans and async overlap)"
_CONTROL = "ROADMAP queue 1 item 2 (rebalancing migration)"
_CKPT = "ROADMAP queue 1 item 2 (checkpoints and rollback)"


def _stub(what: str, item: str):
    raise NotImplementedError(f"SwarmRunner: {what} is not ported yet "
                              f"({item})")


@dataclasses.dataclass
class SwarmConfig:
    """Swarm-level knobs (the architecture lives in ``ArchConfig``); the
    JAX package's fields and defaults, minus the deprecated ``compress``
    spelling.  Fields of later slices must keep their defaults."""
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
        for name, later in (("dpu", _ASYNC), ("overlap", _ASYNC),
                            ("staleness", _ASYNC), ("spans", _ASYNC),
                            ("ckpt_dir", _CKPT),
                            ("link_table", "ROADMAP queue 1 item 2")):
            if getattr(self, name):
                _stub(f"SwarmConfig.{name}", later)


def _as_span(stage: "int | range") -> range:
    return stage if isinstance(stage, range) else range(stage, stage + 1)


class SwarmRunner:
    def __init__(self, cfg: ArchConfig, scfg: SwarmConfig,
                 optimizer: Optimizer, *, numeric: bool = True,
                 seed: int = 0,
                 profile_fn: Optional[Callable[[int], DeviceProfile]] = None,
                 data_fn: Optional[Callable[[int], dict]] = None,
                 programs: Optional[list[StageProgram]] = None,
                 record_accumulation: bool = False, device="cuda"):
        if not numeric:
            _stub("a timing-only run (numeric=False)", _CONTROL)
        if scfg.rebalance_period > 0:
            _stub("rebalancing (rebalance_period > 0; pass 0)", _CONTROL)
        self.cfg = cfg
        self.scfg = scfg
        self.optimizer = optimizer
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
        self.data_fn = data_fn

        # one executor per stage, shared by all that stage's peers
        if programs is not None:
            assert len(programs) == scfg.n_stages
        self.executors: list[StageExecutor] = build_numeric_executors(
            cfg, scfg.n_stages, scfg.seq_len, compress=self.compress_mode,
            quant_block=scfg.quant_block, device=device, programs=programs)
        self.device = self.executors[0].device
        self.programs: list[StageProgram] = [e.prog for e in self.executors]
        self._ref_params = init_stage_params(self.programs, seed,
                                             self.device)
        self._ref_opt = [optimizer.init(p) for p in self._ref_params]

        self.peers: dict[str, Peer] = {}
        self.wirings: list[StochasticWiring] = []
        self.trainers: list[Trainer] = []

        # training progress
        self.stopped = False
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
            "wire_bytes": 0.0,
        }
        self._samples_done_total = 0
        self._default_ds = None
        self._open_round()

    # ================================================== setup
    def _span_executor(self, span: range) -> StageExecutor:
        if len(span) != 1:
            _stub("a span peer", _ASYNC)
        return self.executors[span.start]

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
        """Cold-start a peer (initial ``build``): at step 0 the reference
        params ARE current, so announcing immediately is safe.  Mid-run
        joins go through ``_join_new_peer``, which downloads the stage
        state *before* announcing (warm join)."""
        span = _as_span(stage)
        if executor is not None:
            assert (executor.stages.start, executor.stages.stop) == \
                (span.start, span.stop), (executor.stages, span)
        else:
            executor = self._span_executor(span)
        peer = Peer(self.sim, profile or self.profile_fn(len(self.peers)),
                    span, executor=executor)
        self.peers[peer.id] = peer
        if self.step:
            _stub("a cold start past step 0 (use a warm join)", _CKPT)
        for s in peer.stages:
            self._restore_from_checkpoint(peer, s)
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

    # ================================================== data / dispatch
    def _open_round(self):
        """Fix the next round's sample set: exactly ``global_batch``
        samples (App. E synchronous semantics).  Lost samples re-issue
        under the *same* index."""
        K = self.scfg.global_batch // max(self.scfg.microbatch_size, 1)
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
        fpt = (ex.fwd_flops_per_token if kind == "fwd"
               else ex.bwd_flops_per_token)
        speedup = max(1, ex.dp_shards(mb.size))
        return peer.profile.compute_time(fpt * mb.n_tokens) / speedup

    def boundary_nbytes(self, mb: Microbatch,
                        boundary: Optional[int] = None) -> float:
        """Bytes the active codec puts on the wire at ``boundary``
        (uniform hidden-state pricing when None or out of range)."""
        if boundary is not None and 0 <= boundary < self.n_stages - 1:
            return self.plan.boundary_bytes(
                boundary, mb.size, self.scfg.seq_len, self.compress_mode)
        from repro_torch.models import flops as F
        return F.boundary_bytes(
            self.cfg, mb.size, self.scfg.seq_len, self.compress_mode)

    def count_wire_bytes(self, nbytes: float):
        """One boundary tensor actually crossed the host."""
        self.metrics["wire_bytes"] += nbytes

    # ================================================== gradient sync
    def accumulate(self, peer: Peer, gp: Optional[Tree], mb: Microbatch,
                   loss: Optional[float], stage: Optional[int] = None
                   ) -> bool:
        """Fold a microbatch gradient into ``peer``'s accumulator —
        exactly once per (stage, index) per round.  A re-issued attempt
        falls through for the stages that already hold the gradient
        (re-running backward with unchanged params reproduces it, so
        skipping is exact)."""
        stages = [stage] if stage is not None else list(peer.stages)
        last = self.n_stages - 1
        any_folded = False
        for s in stages:
            if not self.ledger.record(s, mb.index, peer.id):
                continue
            if self.record_accumulation:
                self.ledger_log.append(
                    ("acc", self.step, s, mb.index, mb.attempt, peer.id))
            peer.executor.accumulate(peer.state, gp,
                                     loss if s == last else None,
                                     mb.n_tokens, stage=s)
            any_folded = True
        return any_folded

    def _sync_loop(self):
        """Trigger All-Reduce + optimizer step when the ledger shows the
        full global batch accumulated at every stage."""
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

    def _log_releases(self, lost: list[tuple[int, int]], peer_id: str):
        if self.record_accumulation:
            for s, i in lost:
                self.ledger_log.append(("rel", self.step, s, i, 0, peer_id))

    def _all_reduce_and_step(self):
        """Per-stage ring All-Reduce (time) + optimizer step (numerics).
        All numerics are computed at the barrier instant, so failures
        inside the All-Reduce window cannot remove gradients from a step
        that already observed the complete global batch."""
        plan = self._ar_plan()
        for s, group, ar_time, new_params, new_opt in plan:
            yield Sleep(ar_time)
            self._ar_install(s, group, new_params, new_opt)
        self.step += 1

    def _ar_install(self, s: int, group: list, new_params, new_opt):
        for p in group:
            if not p.alive:      # died inside the ring: state is dead
                continue
            p.executor.adopt_step(p.state, new_params, new_opt, stage=s)

    def _ar_plan(self):
        """Gradient averaging + optimizer step per stage: the group's
        gradients summed (in f64, order-independent: see
        ``runtime.base.fold_into``) and divided by the group's token
        count, the update applied as ``p + u.to(p.dtype)``."""
        if self.record_accumulation:
            self.ledger_log.append(("step", self.step, -1, -1, 0, ""))
        plan = []
        for s in range(self.n_stages):
            group = self._covering(s)
            if not group:
                continue
            k = len(group)
            nbytes = group[0].state_nbytes(stage=s) / 3.0   # grads only
            ar_time = (2 * (k - 1) / max(k, 1)) * nbytes \
                / self.scfg.allreduce_bw + 0.01 * k
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
            del gsum, gmean, updates
            loss_sum = sum(p.state.stage_view(s).loss_sum for p in group)
            if s == self.n_stages - 1 and total_tokens:
                self.metrics["loss"].append(loss_sum / total_tokens)
            plan.append((s, group, ar_time, new_params, new_opt))
        return plan

    # ================================================== state transfer
    def _restore_from_checkpoint(self, peer: Peer, stage: int):
        """A cold start: install the step-0 reference state."""
        peer.executor.restore(peer.state, self._ckpt_snapshot(stage),
                              stage=stage)

    def _ckpt_snapshot(self, stage: int):
        return {"params": self._ref_params[stage],
                "opt": self._ref_opt[stage], "version": 0}

    def _download_stage_state(self, peer: Peer, s: int):
        """Warm-state download of ONE stage from a live covering
        neighbour (retrying if the donor dies mid-transfer); a stage
        with no survivors resumes from the step-0 reference at step 0
        and needs the checkpoint slice past it."""
        while True:
            donors = self._covering(s, but=peer)
            if not donors:
                yield Sleep(1.0)
                while self._dispatch_paused and not self.stopped:
                    yield Sleep(0.05)
                if not peer.alive or self.stopped:
                    return
                if self._covering(s, but=peer):
                    continue           # a peer recovered during the wait
                if self.step > 0:
                    _stub("global rollback of a stranded stage", _CKPT)
                self._restore_from_checkpoint(peer, s)
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

    def _complete_warm_join(self, peer: Peer, span: range):
        """The state download completes BEFORE the peer is announced or
        entered into any wiring — a joining peer must never serve stale
        params.  Returns False if the peer died mid-download."""
        peer.serving = False
        for s in span:
            yield from self._download_stage_state(peer, s)
            if not peer.alive or self.stopped:
                break
        if not peer.alive:                     # preempted mid-download
            return False
        peer.serving = True
        self._announce(peer)
        for w in self.wirings:
            w.move_server(peer.id, [span.start])
        return True

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
            peer.executor = self._span_executor(span)
            if region is not None:
                peer.region = region
            peer.revive(span)
        else:
            peer = Peer(self.sim, self.profile_fn(len(self.peers)), span,
                        executor=self._span_executor(span),
                        region=region or "local")
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
        return self.metrics
