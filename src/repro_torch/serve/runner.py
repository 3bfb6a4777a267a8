"""ServeRunner — elastic span serving over a simulated SWARM (port of
``repro.serve.runner``; the model math runs on the runner's device, the
swarm, its clock and its ledgers are the JAX package's, verbatim).

Training crosses the pipeline once per microbatch; serving crosses it
once per *generated token*, dragging a per-stage KV cache along.  This
runner drives sessions through churning span pools on the same discrete
event sim training uses (:mod:`repro_torch.core.sim` / :class:`Peer`), with
three serving-specific mechanisms:

* **Prefill/decode disaggregation** — two span pools from
  :func:`repro_torch.core.rebalance.serve_assignment`: narrow compute-optimal
  prefill spans (a boundary costs one prompt-sized transfer, amortized),
  wide decode spans (every host hop taxes every token).  After the
  prefill chain runs, each stage's cache crosses to its decode peer via
  the executor ``export_slot``/``install_slot`` wire and a
  :class:`~repro_torch.core.ledger.SessionKVLedger` ``transfer`` — computed
  once, moved, never re-prefilled.

* **Slot-granular continuous batching** — requests with matching shape
  are stacked into batched sessions (``max_batch`` requests per slot,
  ``max_sessions`` slots decoding concurrently); a finishing session
  frees its slot for the next queued batch immediately, no global
  barrier between generations.

* **KV-exact recovery** — the runner records the wire tensor entering
  every hop (the prompt / full-sequence wire at prefill, one position
  per decode step).  When a decode peer dies, only *its* span
  re-prefills: a same-span replacement rebuilds rows ``[0, pos)`` from
  the recorded boundary history in one fused prefill, then the
  interrupted token step resumes at that hop with its recorded input.
  Surviving upstream/downstream spans never recompute, and the KV
  ledger's strict ``record`` turns any double-prefill into a hard error
  rather than silent waste.  (Recomputing the prefix into a *fresh*
  cache is what makes recovery cache-type-agnostic: attention rows
  rebuild bitwise, and recurrent/SSM states — which are not idempotent
  under re-applied decode steps — rebuild by the same scan prefill
  always runs.)

Virtual time advances by the device cost model (compute from the
session program's flops, wire from actual tensor bytes), exactly as in
the JAX package, so the two runners take the same decisions at the same
virtual times.  Wire tensors stay on the runner's device (the JAX runner
pulls each to host numpy); every hop is the same computation either
way.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.compression import codecs
from repro_torch.core.ledger import SessionKVLedger
from repro_torch.core.peer import T4, DeviceProfile, Peer, PeerFailure
from repro_torch.core.rebalance import serve_assignment
from repro_torch.core.sim import Sim, Sleep
from repro_torch.models import params as P
from repro_torch.models.config import ArchConfig
from repro_torch.runtime.base import StageState, place
from repro_torch.runtime.numeric import build_numeric_executors
from repro_torch.runtime.stage_model import split_lm_params
from repro_torch.serve.programs import KV_SLOT, full_session_program
from repro_torch.tree import tree_leaves

Tree = Any

_REQ_IDS = itertools.count()


class SessionFailed(Exception):
    """No live route could finish the session within the retry budget."""


def _tree_nbytes(tree: Tree) -> float:
    return float(sum(x.numel() * x.element_size()
                     if isinstance(x, torch.Tensor) else x.nbytes
                     for x in tree_leaves(tree) if hasattr(x, "shape")))


@dataclasses.dataclass
class Request:
    """One generation request: greedy-decode ``new_tokens`` after
    ``prompt``.  Filled in place as the swarm serves it."""
    prompt: np.ndarray                    # [S] int32 prompt token ids
    new_tokens: int
    id: int = dataclasses.field(default_factory=lambda: next(_REQ_IDS))
    arrival: float = 0.0
    done_at: Optional[float] = None
    tokens: Optional[np.ndarray] = None   # [new_tokens] generated ids
    failed: bool = False


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    n_stages: int = 4
    max_batch: int = 2        # requests stacked into one session slot
    max_sessions: int = 2     # session slots decoding concurrently
    codec: str = "none"       # wire codec; "auto" = cfg.boundary_compression
    quant_block: int = 64
    retry_wait: float = 0.25  # backoff while a boundary has no live peer
    max_retries: int = 10     # per-hop failure budget before the session fails
    poll: float = 0.05        # scheduler tick


@dataclasses.dataclass
class ServeStats:
    completed: int = 0            # requests fully generated
    failed: int = 0               # requests lost to dead routes
    tokens: int = 0               # tokens generated (sum over requests)
    hop_failures: int = 0         # PeerFailure observed by sessions
    reprefills: int = 0           # recovery prefills (one per lost span)
    reprefilled_stages: int = 0   # stages rebuilt by those prefills
    kv_transfers: int = 0         # prefill -> decode cache hand-offs
    handoff_fallbacks: int = 0    # hand-offs voided by a dead prefill peer
    wire_bytes: float = 0.0
    latencies: list = dataclasses.field(default_factory=list)

    def percentile(self, q: float) -> float:
        if not self.latencies:
            return 0.0
        xs = sorted(self.latencies)
        return xs[min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))]

    def summary(self, elapsed: float) -> dict:
        return {
            "completed": self.completed, "failed": self.failed,
            "tokens": self.tokens, "elapsed_s": elapsed,
            "tokens_per_s": self.tokens / max(elapsed, 1e-9),
            "p50_latency_s": self.percentile(0.5),
            "p99_latency_s": self.percentile(0.99),
            "hop_failures": self.hop_failures,
            "reprefills": self.reprefills,
            "reprefilled_stages": self.reprefilled_stages,
            "kv_transfers": self.kv_transfers,
            "handoff_fallbacks": self.handoff_fallbacks,
            "wire_bytes": self.wire_bytes,
        }


@dataclasses.dataclass
class _Session:
    """One batched generation in flight (a continuous-batching slot)."""
    key: int
    requests: list
    tokens: np.ndarray            # [B, S] stacked prompts
    new_tokens: int
    total_len: int
    # boundary stage -> wire tensors sent into hops entering there, in
    # order: the full-sequence prefill wire, then one per decode step.
    # Concatenated along the sequence axis this is exactly the input a
    # replacement peer needs to re-prefill the boundary's span.
    edges: dict = dataclasses.field(default_factory=dict)
    chain: list = dataclasses.field(default_factory=list)        # decode peers
    chain_spans: list = dataclasses.field(default_factory=list)  # their spans
    generated: list = dataclasses.field(default_factory=list)    # [B,1] each
    last: Optional[torch.Tensor] = None                          # [B,1]

    @property
    def prompt_len(self) -> int:
        return self.tokens.shape[1]

    @property
    def batch(self) -> int:
        return self.tokens.shape[0]


def reference_generate(cfg: ArchConfig, params: Tree, prompts,
                       new_tokens: int) -> np.ndarray:
    """Single-process greedy reference on the device ``params`` live on:
    the token-for-token oracle the staged swarm is tested against.
    Returns ``[B, new_tokens]``."""
    device = tree_leaves(params)[0].device
    prompts = torch.as_tensor(np.asarray(prompts, np.int32), device=device)
    S = prompts.shape[1]
    prog = full_session_program(cfg, S + new_tokens)
    nxt, kv = prog.prefill(params, prompts)
    out = [nxt]
    for i in range(new_tokens - 1):
        nxt, kv = prog.decode(params, kv, nxt, S + i)
        out.append(nxt)
    return torch.cat(out, dim=1).cpu().numpy()


class ServeRunner:
    """Serve sessions through prefill/decode span pools under churn."""

    def __init__(self, cfg: ArchConfig, scfg: Optional[ServeConfig] = None,
                 params: Optional[Tree] = None, seed: int = 0,
                 device="cuda"):
        """``params``: a full-model tree (numpy or tensors; tensors
        already on ``device`` are used in place, never copied), or None
        to initialise one from ``seed``.  ``device`` defaults to the
        card; asking for it where there is none raises."""
        self.cfg = cfg
        self.device = P.resolve_device(device)
        self.scfg = scfg or ServeConfig()
        self.n_stages = self.scfg.n_stages
        self.sim = Sim()
        self.comp = codecs.resolve_mode(
            cfg, None if self.scfg.codec == "auto" else self.scfg.codec)
        if params is None:
            from repro_torch.models import model as model_lib
            params = P.init(seed, model_lib.lm_specs(cfg), self.device)
        self.params = place(params, self.device)
        self._stage_params = split_lm_params(cfg, self.n_stages, params,
                                             compress=self.comp)
        # seq_len only keys the (unused-here) training program cache
        self._family = build_numeric_executors(
            cfg, self.n_stages, seq_len=8, compress=self.comp,
            quant_block=self.scfg.quant_block, device=self.device)
        self._ex_cache: dict[tuple[int, int], Any] = {}
        self.kv = SessionKVLedger(self.n_stages)
        self.prefill_peers: list[Peer] = []
        self.decode_peers: list[Peer] = []
        self._peers: dict = {}
        self.queue: list[Request] = []
        self.active = 0
        self._session_ids = itertools.count()
        self.stats = ServeStats()

    # ------------------------------------------------------------- pools
    def _span_executor(self, lo: int, hi: int):
        ex = self._ex_cache.get((lo, hi))
        if ex is None:
            ex = self._family[lo].for_span(range(lo, hi))
            self._ex_cache[(lo, hi)] = ex
        return ex

    @staticmethod
    def _blank_state(span: range) -> StageState:
        if len(span) > 1:
            return StageState(per_stage={s: StageState() for s in span})
        return StageState()

    def _install_params(self, peer: Peer) -> None:
        for s in peer.span:
            peer.executor.restore(
                peer.state, {"params": self._stage_params[s]}, stage=s)

    def add_peer(self, span: tuple[int, int], pool: str = "decode",
                 profile: DeviceProfile = T4,
                 name: Optional[str] = None) -> Peer:
        lo, hi = span
        peer = Peer(self.sim, profile, range(lo, hi), name=name,
                    executor=self._span_executor(lo, hi))
        peer.state = self._blank_state(peer.span)
        self._install_params(peer)
        pool_list = self.prefill_peers if pool == "prefill" \
            else self.decode_peers
        pool_list.append(peer)
        self._peers[peer.id] = peer
        return peer

    def build_pools(self, n_prefill: int, n_decode: int,
                    stage_costs: Optional[list[float]] = None,
                    profile: DeviceProfile = T4,
                    boundary_cost: float = 0.0) -> dict:
        """Disaggregated layout via :func:`serve_assignment`; with
        ``n_prefill == 0`` prefill runs on the decode chain itself."""
        layout = serve_assignment(n_prefill, n_decode, self.n_stages,
                                  stage_costs, boundary_cost=boundary_cost)
        for sp in layout["prefill"]:
            self.add_peer(sp, pool="prefill", profile=profile)
        for sp in layout["decode"]:
            self.add_peer(sp, pool="decode", profile=profile)
        return layout

    def _resolve(self, peer) -> Peer:
        return self._peers[peer] if not isinstance(peer, Peer) else peer

    # ------------------------------------------------------------- churn
    def fail_peer(self, peer) -> None:
        """Kill a peer; its KV holdings are released so recovery (and a
        later revival of the same peer object) sees them as lost."""
        peer = self._resolve(peer)
        peer.fail()
        self.kv.release_all(peer.id)

    def revive_peer(self, peer) -> None:
        """Warm-rejoin a dead peer on its old span: fresh state, params
        re-installed; sessions re-prefill KV on their next touch."""
        peer = self._resolve(peer)
        peer.revive(peer.span)
        peer.state = self._blank_state(peer.span)
        self._install_params(peer)

    def schedule_fail(self, t: float, peer) -> None:
        def proc():
            yield Sleep(t)
            self.fail_peer(peer)
        self.sim.spawn(proc())

    def schedule_revive(self, t: float, peer) -> None:
        def proc():
            yield Sleep(t)
            self.revive_peer(peer)
        self.sim.spawn(proc())

    # ---------------------------------------------------------- requests
    def submit(self, prompt: Sequence[int], new_tokens: int) -> Request:
        r = Request(prompt=np.asarray(prompt, np.int32),
                    new_tokens=int(new_tokens), arrival=self.sim.now)
        self.queue.append(r)
        return r

    def run(self, until: Optional[float] = None) -> dict:
        """Serve every queued request to completion (or ``until``);
        returns the stats summary."""
        self.sim.spawn(self._scheduler())
        with torch.inference_mode():
            self.sim.run(until=until)
        return self.stats.summary(self.sim.now)

    # --------------------------------------------------------- scheduler
    def _next_batch(self) -> Optional[list[Request]]:
        if not self.queue:
            return None
        head = self.queue[0]
        shape = (len(head.prompt), head.new_tokens)
        batch = [r for r in self.queue
                 if (len(r.prompt), r.new_tokens) == shape]
        batch = batch[:self.scfg.max_batch]
        for r in batch:
            self.queue.remove(r)
        return batch

    def _scheduler(self):
        while self.queue or self.active:
            while self.queue and self.active < self.scfg.max_sessions:
                batch = self._next_batch()
                if not batch:
                    break
                sess = _Session(
                    key=next(self._session_ids), requests=batch,
                    tokens=np.stack([r.prompt for r in batch]),
                    new_tokens=batch[0].new_tokens,
                    total_len=len(batch[0].prompt) + batch[0].new_tokens)
                self.active += 1
                self.sim.spawn(self._session_proc(sess))
            yield Sleep(self.scfg.poll)

    # ------------------------------------------------------------ session
    def _session_proc(self, sess: _Session):
        try:
            yield from self._prefill_phase(sess)
            yield from self._handoff(sess)
            for step in range(sess.new_tokens - 1):
                yield from self._decode_step(sess, step)
            self._finish(sess)
        except (SessionFailed, PeerFailure):
            for r in sess.requests:
                r.failed = True
            self.stats.failed += len(sess.requests)
            self._release(sess)
        finally:
            self.active -= 1

    def _pick(self, pool: list[Peer], start: int,
              span: Optional[tuple[int, int]] = None,
              exclude: Optional[Peer] = None) -> Optional[Peer]:
        cand = [p for p in pool
                if p.alive and p.serving and p is not exclude
                and p.span.start == start
                and (span is None
                     or (p.span.start, p.span.stop) == span)]
        if not cand:
            return None
        return min(cand, key=lambda p: (p.queue_size(), str(p.id)))

    def _edge(self, sess: _Session, b: int, x) -> None:
        sess.edges.setdefault(b, []).append(x)

    # ------------------------------------------------------------ prefill
    def _prefill_phase(self, sess: _Session):
        """Route the prompt through the prefill pool (or, without one,
        the decode pool — which then doubles as the session's chain),
        recording each hop's entry wire and the per-stage KV holders."""
        pool = self.prefill_peers or self.decode_peers
        direct = not self.prefill_peers
        b, retries = 0, 0
        x = torch.as_tensor(sess.tokens, device=self.device)
        while b < self.n_stages:
            peer = self._pick(pool, b)
            if peer is None:
                retries += 1
                if retries > self.scfg.max_retries:
                    raise SessionFailed(f"no prefill peer at boundary {b}")
                yield Sleep(self.scfg.retry_wait)
                continue
            span = (peer.span.start, peer.span.stop)
            prog = peer.executor.session_program(sess.total_len)
            self._edge(sess, b, x)
            nb = _tree_nbytes(x)
            self.stats.wire_bytes += nb
            yield Sleep(peer.profile.recv_time(nb))
            ct = peer.profile.compute_time(
                prog.flops_per_token * sess.batch * sess.prompt_len)
            try:
                out = yield peer.submit(
                    "prefill", ct,
                    self._prefill_thunk(sess, peer, prog, x)).wait()
            except PeerFailure:
                self.stats.hop_failures += 1
                retries += 1
                if retries > self.scfg.max_retries:
                    raise SessionFailed(f"prefill died at boundary {b}")
                yield Sleep(self.scfg.retry_wait)
                continue
            if direct:
                sess.chain.append(peer)
                sess.chain_spans.append(span)
            x, b = out, span[1]
        sess.last = x                        # first generated token [B,1]
        sess.generated.append(sess.last)

    def _prefill_thunk(self, sess: _Session, peer: Peer, prog, x):
        def thunk():
            views = [peer.state.stage_view(s) for s in prog.stages]
            params = tuple(v.params for v in views)
            out, kv = prog.prefill(params, x)
            for s, c in zip(prog.stages, kv):
                peer.executor.install_slot(peer.state, KV_SLOT, sess.key,
                                           c, stage=s)
                self.kv.record(s, sess.key, peer.id)
            if prog.covers_last:
                return out
            return peer.executor.wire_fwd(out)
        return thunk

    # ------------------------------------------------------------ handoff
    def _handoff(self, sess: _Session):
        """Build the decode chain; move each stage's KV from its prefill
        holder over the executor slot wire (``transfer``: computed once,
        never re-prefilled).  A dead prefill holder voids its span's
        hand-off — the first decode step's missing-stage path re-prefills
        it from the recorded boundary history instead."""
        if not self.prefill_peers:
            return                    # prefilled on the decode chain itself
        b, retries = 0, 0
        while b < self.n_stages:
            peer = self._pick(self.decode_peers, b)
            if peer is None:
                retries += 1
                if retries > self.scfg.max_retries:
                    raise SessionFailed(f"no decode peer at boundary {b}")
                yield Sleep(self.scfg.retry_wait)
                continue
            span = (peer.span.start, peer.span.stop)
            sess.chain.append(peer)
            sess.chain_spans.append(span)
            holders = {s: self._peers.get(self.kv.holder(s, sess.key))
                       for s in range(*span)}
            if all(h is not None and h.alive for h in holders.values()):
                nb = 0.0
                for s in range(*span):
                    h = holders[s]
                    val = h.executor.export_slot(h.state, KV_SLOT,
                                                 sess.key, stage=s)
                    peer.executor.install_slot(peer.state, KV_SLOT,
                                               sess.key, val, stage=s)
                    h.executor.drop_slot(h.state, KV_SLOT, key=sess.key,
                                         stage=s)
                    self.kv.transfer(s, sess.key, peer.id)
                    nb += _tree_nbytes(val)
                    self.stats.kv_transfers += 1
                self.stats.wire_bytes += nb
                yield Sleep(peer.profile.recv_time(nb))
            else:
                for s in range(*span):
                    self.kv.release(s, sess.key)
                self.stats.handoff_fallbacks += 1
            b = span[1]

    # ------------------------------------------------------------- decode
    def _decode_step(self, sess: _Session, step: int):
        pos = sess.prompt_len + step
        x = sess.last
        for hop in range(len(sess.chain)):
            x = yield from self._decode_hop(sess, hop, x, pos)
        sess.last = x
        sess.generated.append(sess.last)

    def _decode_hop(self, sess: _Session, hop: int, x, pos: int):
        lo, hi = sess.chain_spans[hop]
        self._edge(sess, lo, x)
        retries = 0
        while True:
            peer = sess.chain[hop]
            if not (peer.alive and peer.serving):
                repl = self._pick(self.decode_peers, lo, span=(lo, hi),
                                  exclude=peer)
                if repl is None:
                    retries += 1
                    if retries > self.scfg.max_retries:
                        raise SessionFailed(
                            f"no replacement for decode span ({lo}, {hi})")
                    yield Sleep(self.scfg.retry_wait)
                    continue
                sess.chain[hop] = peer = repl
            prog = peer.executor.session_program(sess.total_len)
            missing = [s for s in range(lo, hi)
                       if self.kv.holder(s, sess.key) != peer.id]
            try:
                if missing:
                    yield from self._reprefill(sess, peer, prog, missing)
                nb = _tree_nbytes(x)
                self.stats.wire_bytes += nb
                yield Sleep(peer.profile.recv_time(nb))
                ct = peer.profile.compute_time(
                    prog.flops_per_token * sess.batch)
                out = yield peer.submit(
                    "decode", ct,
                    self._decode_thunk(sess, peer, prog, x, pos)).wait()
                return out
            except PeerFailure:
                self.stats.hop_failures += 1
                retries += 1
                if retries > self.scfg.max_retries:
                    raise SessionFailed(
                        f"decode span ({lo}, {hi}) kept dying")
                yield Sleep(self.scfg.retry_wait)

    def _reprefill(self, sess: _Session, peer: Peer, prog, missing):
        """Rebuild exactly the lost span's KV on ``peer``: one fused
        prefill of the recorded boundary history ``[0, pos)`` (the last
        recorded entry is the *interrupted* step's input — it resumes as
        a decode right after, so it is excluded from the prefix)."""
        lo, hi = prog.span
        # KV moves span-atomically (hand-off and re-prefill both run
        # without yielding), so a partial hold means ledger corruption
        assert missing == list(range(lo, hi)), (missing, prog.span)
        hist = sess.edges.get(lo)
        if not hist:
            raise SessionFailed(f"no boundary history at stage {lo}")
        prefix = hist[0] if len(hist) == 1 \
            else torch.cat(hist[:-1], dim=1)
        ct = peer.profile.compute_time(
            prog.flops_per_token * sess.batch * prefix.shape[1])

        def thunk():
            views = [peer.state.stage_view(s) for s in prog.stages]
            params = tuple(v.params for v in views)
            _, kv = prog.prefill(params, prefix)   # prefix output discarded:
            for s, c in zip(prog.stages, kv):      # downstream KV is alive
                peer.executor.install_slot(peer.state, KV_SLOT, sess.key,
                                           c, stage=s)
                self.kv.record(s, sess.key, peer.id)   # strict: died first
            return None

        yield peer.submit("prefill", ct, thunk).wait()
        self.stats.reprefills += 1
        self.stats.reprefilled_stages += hi - lo

    def _decode_thunk(self, sess: _Session, peer: Peer, prog, x, pos: int):
        def thunk():
            views = [peer.state.stage_view(s) for s in prog.stages]
            params = tuple(v.params for v in views)
            kv = tuple(v.slot(KV_SLOT)[sess.key] for v in views)
            out, new_kv = prog.decode(params, kv, x, pos)
            for v, c in zip(views, new_kv):
                v.slot(KV_SLOT)[sess.key] = c
            if prog.covers_last:
                return out
            return peer.executor.wire_fwd(out)
        return thunk

    # ----------------------------------------------------------- teardown
    def _finish(self, sess: _Session) -> None:
        gen = torch.cat(sess.generated, dim=1).cpu().numpy()  # [B, new]
        for r, row in zip(sess.requests, gen):
            r.tokens = row
            r.done_at = self.sim.now
            self.stats.latencies.append(self.sim.now - r.arrival)
        self.stats.completed += len(sess.requests)
        self.stats.tokens += int(gen.size)
        self._release(sess)

    def _release(self, sess: _Session) -> None:
        for s in range(self.n_stages):
            pid = self.kv.holder(s, sess.key)
            if pid is None:
                continue
            peer = self._peers.get(pid)
            if peer is not None and peer.alive:
                peer.executor.drop_slot(peer.state, KV_SLOT, key=sess.key,
                                        stage=s)
            self.kv.release(s, sess.key)
