"""Adaptive swarm rebalancing and span assignment (port of
``repro.core.rebalance``, copied: plain arithmetic).

Alg. 2 of the paper (§3.2, App. D): every ``T`` seconds each peer writes
its local queue size under ``DHT[load/<stage>]``; the peer with the
smallest queue in the minimum-load stage migrates to the maximum-load
stage.  :func:`plan_migration` is the pure decision function; one
planning round reads the DHT once, through a :class:`ControlSnapshot`,
and ``SwarmRunner._rebalance_loop`` executes the plan.

:func:`serve_assignment` lays out the disaggregated prefill and decode
span pools; it prices spans with :func:`optimal_assignment` (``spans=True``
for decode, the counts form for the prefill chunks) over contiguous
partitions, exactly as the JAX package does, so both packages make the
same decisions on the same inputs.  :func:`plan_span_change` proposes
the span splits and merges (``SpanChange``) that
``SwarmRunner._resize_span`` executes.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Hashable, Iterable, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Migration:
    peer: Hashable
    src_stage: int
    dst_stage: int


@dataclasses.dataclass(frozen=True)
class SpanChange:
    """Resize ``peer``'s span in place (Varuna-style re-partitioning):
    ``new_span`` inside ``old_span`` is a split/shrink (concentrate on
    the bottleneck stage), ``new_span`` around ``old_span`` a merge/grow
    (absorb an adjacent well-covered stage, saving its host boundary)."""
    peer: Hashable
    old_span: tuple[int, int]
    new_span: tuple[int, int]


@dataclasses.dataclass(frozen=True)
class ControlSnapshot:
    """One planning round's frozen view of the control-plane DHT: one
    ``DHT.get`` per load key, shared by every decision of the round."""
    n_stages: int
    #: per stage: {peer id -> announced queue size}
    queues: tuple[dict, ...]
    #: per stage: sum of announced queue sizes (Alg. 2 lines 7-18)
    loads: tuple[float, ...]

    @classmethod
    def capture(cls, dht, n_stages: int) -> "ControlSnapshot":
        queues = tuple(dht.get_values(dht.load_key(s))
                       for s in range(n_stages))
        return cls(n_stages, queues,
                   tuple(float(sum(q.values())) for q in queues))

    def queue_of(self, pid: Hashable, stage: int,
                 default: float = 0.0) -> float:
        return float(self.queues[stage].get(pid, default))


def _as_snapshot(dht, n_stages: int) -> ControlSnapshot:
    """Planner entry points take a DHT (one capture per call) or a
    pre-captured :class:`ControlSnapshot` (one capture per round)."""
    if isinstance(dht, ControlSnapshot):
        if dht.n_stages != n_stages:
            raise ValueError(f"snapshot captured for {dht.n_stages} "
                             f"stages, planner asked about {n_stages}")
        return dht
    return ControlSnapshot.capture(dht, n_stages)


def stage_loads(dht, n_stages: int) -> list[float]:
    """Sum the per-peer queue sizes announced for every stage (lines
    7-18).  ``dht`` may be a live DHT or a :class:`ControlSnapshot`."""
    return list(_as_snapshot(dht, n_stages).loads)


def plan_migration(dht, n_stages: int,
                   peers_per_stage: dict[int, list[Hashable]]
                   ) -> Optional[Migration]:
    """Algorithm 2, lines 5-31, computed from the DHT snapshot.  Never
    empties a stage (SWARM requires >= 1 peer per stage, App. A).
    Returns None when the swarm is balanced or the min stage has a
    single peer."""
    snap = _as_snapshot(dht, n_stages)
    loads = snap.loads
    s_min = min(range(n_stages), key=lambda s: loads[s])
    s_max = max(range(n_stages), key=lambda s: loads[s])
    if s_min == s_max or loads[s_max] <= loads[s_min]:
        return None
    donors = peers_per_stage.get(s_min, [])
    if len(donors) <= 1:
        return None
    q_min, peer_min = math.inf, None
    for peer in donors:
        qv = snap.queue_of(peer, s_min, default=math.inf)
        if qv < q_min:
            q_min, peer_min = qv, peer
    if peer_min is None:
        return None
    return Migration(peer_min, s_min, s_max)


def spans_route(n_stages: int,
                spans: Iterable[tuple[int, int]]) -> bool:
    """Can a trainer tile ``[0, n_stages)`` out of these spans?

    Per-stage *coverage* is necessary but not sufficient: a hop enters a
    span only at its START, so the layout must admit a chain of spans
    ``0 -> ... -> n_stages``.  (``{(0,2), (1,2)}`` covers both stages of
    a 2-stage pipe and routes; ``{(0,2), (1,3)}`` covers all of a
    3-stage pipe but strands boundary 2 — no span starts there.)
    Every span-layout mutation must preserve this, or routing stalls
    forever.  Only the SET of spans matters, so any iterable of ``(lo,
    hi)`` works — including a span-multiset dict's keys, which is how
    :func:`plan_span_change` calls it at 1000-peer scale (O(U + S) on U
    unique spans instead of O(P))."""
    starts: dict[int, set[int]] = {}
    for lo, hi in spans:
        starts.setdefault(lo, set()).add(hi)
    seen: set[int] = set()
    frontier = {0}
    while frontier:
        s = frontier.pop()
        if s == n_stages:
            return True
        if s in seen:
            continue
        seen.add(s)
        frontier |= starts.get(s, set())
    return n_stages == 0


def _edge_cost(boundary_cost, b: int) -> float:
    """Cost of crossing boundary ``b`` (between stages b and b+1).
    ``boundary_cost`` may be a uniform scalar (historical) or a
    per-boundary sequence of length ``n_stages - 1`` — e.g. the stage
    plan's ``boundary_costs``, where a whisper boundary carries encoder
    state + token ids and an expert-sharded MoE boundary pays top_k
    routed token copies."""
    if isinstance(boundary_cost, (list, tuple)):
        return float(boundary_cost[b])
    return float(boundary_cost)


def _span_cost(span: tuple[int, int], costs: list[float],
               boundary_cost, n_stages: int,
               overlap_wire: bool = False) -> float:
    """Per-microbatch service cost of one peer running ``span`` fused:
    the covered stages' compute plus the boundary cost per *host* edge
    (scalar or per-boundary, see :func:`_edge_cost`) — fused intra-span
    boundaries are free, which is exactly the saved wire bytes the span
    backend realizes.  ``overlap_wire`` prices the async tick: boundary
    transfers ride the NIC concurrently with the next microbatch's
    compute, so the steady-state cost is the MAX of compute and wire
    (the busier of the two pipelines), not their sum — never more than
    the serial price, equal when either side is zero."""
    lo, hi = span
    wire = (_edge_cost(boundary_cost, lo - 1) if lo > 0 else 0.0) \
        + (_edge_cost(boundary_cost, hi - 1) if hi < n_stages else 0.0)
    compute = sum(costs[lo:hi])
    if overlap_wire:
        return max(compute, wire)
    return compute + wire


def span_stage_rates(spans: Sequence[tuple[int, int]],
                     speeds: Sequence[float], n_stages: int,
                     stage_costs: Optional[list[float]] = None,
                     boundary_cost: float = 0.0,
                     overlap_wire: bool = False) -> list[float]:
    """Aggregate service rate per stage under a span assignment: a peer
    of speed ``v`` serving span σ contributes ``v / cost(σ)`` to every
    stage of σ (it pushes each microbatch through the whole span).

    The span cost is memoized per unique ``(lo, hi)`` — planner output
    reuses a handful of chunk shapes across hundreds of peers, so the
    accumulation is O(P + U·S̄) rather than O(P·S̄) cost re-derivations
    (and bitwise-identical to the unmemoized sum: same divisor, same
    peer-order accumulation)."""
    costs = stage_costs or [1.0] * n_stages
    rate = [0.0] * n_stages
    ccache: dict[tuple[int, int], float] = {}
    for span, v in zip(spans, speeds):
        if span is None:
            continue
        key = (span[0], span[1])
        c = ccache.get(key)
        if c is None:
            c = ccache[key] = max(
                _span_cost(key, costs, boundary_cost, n_stages,
                           overlap_wire), 1e-12)
        for s in range(key[0], key[1]):
            rate[s] += v / c
    return rate


def _contiguous_partition(n_chunks: int, costs: list[float]
                          ) -> list[tuple[int, int]]:
    """Split stages into ``n_chunks`` contiguous spans with near-equal
    cost (greedy cumulative walk; every chunk non-empty)."""
    S = len(costs)
    n_chunks = max(1, min(n_chunks, S))
    total = sum(costs)
    spans, lo, acc = [], 0, 0.0
    for s in range(S):
        acc += costs[s]
        chunks_left = n_chunks - len(spans)          # incl. the open one
        stages_left = S - (s + 1)
        # close when the cost target is met — or when every remaining
        # chunk needs exactly one of the remaining stages — but never so
        # early that a later chunk would come up empty
        must = stages_left == chunks_left - 1
        want = acc >= total / n_chunks
        if chunks_left > 1 and (want or must) \
                and stages_left >= chunks_left - 1:
            spans.append((lo, s + 1))
            lo, acc = s + 1, 0.0
    spans.append((lo, S))
    return spans


def _greedy_single_assignment(speeds: list[float], n_stages: int,
                              costs: list[float], boundary_cost: float,
                              overlap_wire: bool = False
                              ) -> Optional[list[tuple[int, int]]]:
    """Best-effort width-1 placement (the span-free baseline): fastest
    peers first, each onto the currently weakest stage.  None when
    ``n_peers < n_stages`` — no single-stage placement can cover.

    The weakest stage lives at the top of a heap keyed ``(rate, -cost,
    stage)`` — the same lexicographic order the original O(P·S) argmin
    scan used (uncovered stages always win, costlier stages break rate
    ties, lowest index breaks exact ties), so placements are
    bitwise-identical at O(P log S)."""
    if len(speeds) < n_stages:
        return None
    order = sorted(range(len(speeds)), key=lambda i: -speeds[i])
    spans: list[Optional[tuple[int, int]]] = [None] * len(speeds)
    denom = [max(_span_cost((s, s + 1), costs, boundary_cost, n_stages,
                            overlap_wire), 1e-12) for s in range(n_stages)]
    heap = [(0.0, -costs[s], s) for s in range(n_stages)]
    heapq.heapify(heap)
    for i in order:
        # only the top entry is ever updated, so every entry is current
        rate, negc, s = heap[0]
        spans[i] = (s, s + 1)
        heapq.heapreplace(heap, (rate + speeds[i] / denom[s], negc, s))
    return spans


#: Fleets up to this size run the original exhaustive candidate search
#: (every chunk count priced with a from-scratch ``span_stage_rates``
#: per surplus peer) so the 4-8 peer fixtures' decisions stay
#: bitwise-stable; larger fleets take :func:`_best_span_candidate_fast`,
#: the heap-bounded scale path.
_EXACT_PEER_LIMIT = 64


def _best_span_candidate_fast(v: list[float], order: list[int],
                              n_stages: int, costs: list[float],
                              boundary_cost, max_span: Optional[int],
                              overlap_wire: bool, single, thr):
    """Heap-bounded span-candidate search for large fleets.

    Two facts make this cheap.  Every candidate assigns whole *chunks*
    of one contiguous partition, so all stages of a chunk share one
    aggregate rate — the surplus-reinforcement step only needs a heap
    over ``(chunk rate, chunk lo)`` (the exact tie-break the per-stage
    argmin used, since the weakest stage is the lowest-indexed stage of
    the weakest chunk), one ``heapreplace`` per surplus peer instead of
    a from-scratch ``span_stage_rates``.  And a chunk count whose
    fractional upper bound ``Σv / Σ chunk_cost`` cannot strictly beat
    the incumbent throughput is skipped outright — min-rate is never
    above the speed-mass / cost-mass ratio, and a tie would lose to the
    earlier candidate anyway (``max`` keeps the first maximum).

    O(S·(S + P' log S) + P log P) per call for P' surplus peers, vs the
    original O(P²·S²): the 99-second ``optimal_assignment`` at 1000
    peers × 48 stages (see benchmarks/bench_control.py) drops under the
    50 ms round budget."""
    n_peers = len(v)
    total_v = sum(v)
    best = single
    best_thr = thr(single) if single is not None else -math.inf
    for k in range(1, min(n_peers, n_stages) + 1):
        chunks = _contiguous_partition(k, costs)
        if max_span is not None and any(
                hi - lo > max_span for lo, hi in chunks):
            continue
        ccost = [max(_span_cost(c, costs, boundary_cost, n_stages,
                                overlap_wire), 1e-12) for c in chunks]
        if total_v / sum(ccost) <= best_thr:
            continue
        by_cost = sorted(range(k), key=lambda c: -ccost[c])
        assign: list[Optional[tuple[int, int]]] = [None] * n_peers
        heap = []
        for rank, c in enumerate(by_cost):
            i = order[rank]
            assign[i] = chunks[c]
            heap.append((v[i] / ccost[c], chunks[c][0], c))
        heapq.heapify(heap)
        for i in order[k:]:                  # surplus: reinforce weakest
            # only the top entry is ever updated -> all entries current
            rate, lo_c, c = heap[0]
            assign[i] = chunks[c]
            heapq.heapreplace(heap, (rate + v[i] / ccost[c], lo_c, c))
        cand_thr = heap[0][0]                # min chunk rate == min stage
        if cand_thr > best_thr:
            best_thr, best = cand_thr, assign
    if best is None:
        raise ValueError(
            f"max_span={max_span} cannot cover {n_stages} stages with "
            f"{n_peers} peers (need n_peers * max_span >= n_stages)")
    return best


def optimal_assignment(n_peers: int, n_stages: int,
                       stage_costs: Optional[list[float]] = None, *,
                       speeds: Optional[Sequence[float]] = None,
                       spans: bool = False, boundary_cost: float = 0.0,
                       max_span: Optional[int] = None,
                       overlap_wire: bool = False):
    """Throughput-optimal placement (the 'always optimal' baseline of
    Table 5).

    ``spans=False`` (default): peer *counts* per stage, proportional to
    per-stage compute cost, each stage >= 1 — the historical contract.
    Raises ``ValueError`` when ``n_peers < n_stages``: one peer per
    stage is the floor of this form, so a smaller fleet cannot cover
    the pipeline (historically this silently returned an alloc summing
    to ``n_stages`` — more peers than exist).

    ``spans=True``: one contiguous ``(lo, hi)`` span per peer.  Strong
    peers may hold several stages fused (square-cube, §3.1), pricing
    each host boundary at ``boundary_cost``; the width-1 greedy
    placement is always among the candidates, so the result's
    :func:`pipeline_throughput` is never below the span-free
    assignment's.  Guarantees full stage coverage for any ``n_peers >=
    1`` (a single peer serves the whole pipeline as one span).
    ``max_span=1`` forces the width-1 baseline itself.  Fleets beyond
    :data:`_EXACT_PEER_LIMIT` peers take the heap-bounded
    :func:`_best_span_candidate_fast` path."""
    costs = list(stage_costs or [1.0] * n_stages)
    if not spans:
        if n_peers < n_stages:
            raise ValueError(
                f"{n_peers} peers cannot cover {n_stages} stages one "
                f"stage per peer (the counts form needs n_peers >= "
                f"n_stages) — use spans=True, which fuses contiguous "
                f"stages so any n_peers >= 1 covers the pipeline")
        total = sum(costs)
        alloc = [max(1, round(n_peers * c / total)) for c in costs]
        # fix rounding to sum exactly n_peers, never dropping below 1
        while sum(alloc) > n_peers:
            i = max(range(n_stages), key=lambda j: alloc[j])
            if alloc[i] > 1:
                alloc[i] -= 1
            else:
                break
        while sum(alloc) < n_peers:
            i = min(range(n_stages),
                    key=lambda j: alloc[j] / max(costs[j], 1e-9))
            alloc[i] += 1
        return alloc

    v = list(speeds) if speeds is not None else [1.0] * n_peers
    assert len(v) == n_peers

    def thr(assign):
        return pipeline_throughput(assign, v, stage_costs=costs,
                                   boundary_cost=boundary_cost,
                                   overlap_wire=overlap_wire)

    single = _greedy_single_assignment(v, n_stages, costs, boundary_cost,
                                       overlap_wire)
    if max_span == 1:
        if single is None:
            raise ValueError(f"max_span=1 cannot cover {n_stages} stages "
                             f"with {n_peers} peers")
        return single

    order = sorted(range(n_peers), key=lambda i: -v[i])
    if n_peers > _EXACT_PEER_LIMIT:
        return _best_span_candidate_fast(v, order, n_stages, costs,
                                         boundary_cost, max_span,
                                         overlap_wire, single, thr)

    candidates = [] if single is None else [single]
    # contiguous partitions into k chunks, fastest peers on the
    # costliest chunks, surplus peers reinforcing the weakest chunk
    for k in range(1, min(n_peers, n_stages) + 1):
        chunks = _contiguous_partition(k, costs)
        if max_span is not None and any(
                hi - lo > max_span for lo, hi in chunks):
            continue
        by_cost = sorted(range(k), key=lambda c: -_span_cost(
            chunks[c], costs, boundary_cost, n_stages, overlap_wire))
        assign: list[Optional[tuple[int, int]]] = [None] * n_peers
        for rank, c in enumerate(by_cost):
            assign[order[rank]] = chunks[c]
        for i in order[k:]:                  # surplus: reinforce weakest
            rate = span_stage_rates(
                [a for a in assign if a is not None],
                [v[j] for j, a in enumerate(assign) if a is not None],
                n_stages, costs, boundary_cost, overlap_wire)
            weakest = min(range(n_stages), key=lambda s: rate[s])
            assign[i] = next(c for c in chunks
                             if c[0] <= weakest < c[1])
        candidates.append(assign)
    if not candidates:
        raise ValueError(
            f"max_span={max_span} cannot cover {n_stages} stages with "
            f"{n_peers} peers (need n_peers * max_span >= n_stages)")
    return max(candidates, key=thr)


def serve_assignment(n_prefill: int, n_decode: int, n_stages: int,
                     stage_costs: Optional[list[float]] = None, *,
                     prefill_speeds: Optional[Sequence[float]] = None,
                     decode_speeds: Optional[Sequence[float]] = None,
                     boundary_cost: float = 0.0
                     ) -> dict[str, list[tuple[int, int]]]:
    """Disaggregated serving layout: one span pool per phase.

    Prefill is throughput-bound like the training forward — a host
    boundary costs one activation transfer amortized over the whole
    prompt, so narrow spans placed compute-optimal are fine.  Decode
    moves a single token per hop, so per-hop latency dominates: the
    decode pool prices each host edge at the whole pipe's compute,
    pushing the partition toward maximally fused (wide) spans.

    The prefill layout *refines* the decode layout: every decode-span
    start is also a prefill hop boundary.  The serve runner records the
    wire tensor entering each hop, and recovery re-prefills a dead decode
    peer's span from that recorded history — which only exists at
    boundaries where the prefill chain actually hopped.

    Returns ``{"prefill": [(lo, hi), ...], "decode": [(lo, hi), ...]}``
    (one span per pool peer; both layouts tile, hence route).  With
    ``n_prefill == 0`` the prefill pool is empty and prefill runs on the
    decode chain itself (no disaggregation)."""
    costs = list(stage_costs or [1.0] * n_stages)
    dv = list(decode_speeds) if decode_speeds is not None \
        else [1.0] * n_decode
    pv = list(prefill_speeds) if prefill_speeds is not None \
        else [1.0] * n_prefill
    assert len(dv) == n_decode and len(pv) == n_prefill

    floor = sum(costs)                 # per-hop latency dominates decode
    decode_bc = ([max(float(b), floor) for b in boundary_cost]
                 if isinstance(boundary_cost, (list, tuple))
                 else max(float(boundary_cost), floor))
    decode = [tuple(sp) for sp in optimal_assignment(
        n_decode, n_stages, costs, speeds=dv, spans=True,
        boundary_cost=decode_bc)]
    if n_prefill == 0:
        return {"prefill": [], "decode": decode}

    # decode-aligned chunks: every decode-span edge is a cut point
    cuts = sorted({0, n_stages} | {lo for lo, _ in decode}
                  | {hi for _, hi in decode})
    chunks = list(zip(cuts[:-1], cuts[1:]))
    if n_prefill < len(chunks):
        raise ValueError(
            f"prefill pool of {n_prefill} cannot tile the {len(chunks)} "
            f"decode-aligned chunks — grow the pool or pass n_prefill=0 "
            f"to prefill on the decode chain")

    # spread the pool over the chunks by compute cost (counts form),
    # then refine each chunk into near-equal sub-spans; surplus peers
    # reinforce their chunk's sub-spans round-robin
    alloc = optimal_assignment(n_prefill, len(chunks),
                               [sum(costs[lo:hi]) for lo, hi in chunks])
    slots: list[tuple[int, int]] = []
    for (lo, hi), k in zip(chunks, alloc):
        subs = _contiguous_partition(min(k, hi - lo), costs[lo:hi])
        subs = [(lo + a, lo + b) for a, b in subs]
        slots.extend(subs[j % len(subs)] for j in range(k))
    # fastest prefill peers onto the costliest sub-spans
    slots.sort(key=lambda sp: -sum(costs[sp[0]:sp[1]]))
    prefill: list[Optional[tuple[int, int]]] = [None] * n_prefill
    for rank, i in enumerate(
            sorted(range(n_prefill), key=lambda i: -pv[i])):
        prefill[i] = slots[rank]
    assert spans_route(n_stages, prefill) and spans_route(n_stages, decode)
    return {"prefill": prefill, "decode": decode}


def pipeline_throughput(alloc, peer_speed=1.0,
                        stage_costs: Optional[list[float]] = None,
                        boundary_cost: float = 0.0,
                        overlap_wire: bool = False) -> float:
    """Steady-state pipeline throughput = min over stages of aggregate
    stage speed (the weakest-link law, §3.2).

    Two forms: per-stage peer *counts* (``[2, 1, 2]``, historical), or a
    per-peer *span assignment* (``[(0, 2), (2, 3), ...]``) with
    ``peer_speed`` a scalar or per-peer sequence — where each host
    boundary a peer's span touches costs ``boundary_cost`` on top of the
    covered stages' compute, so fused boundaries visibly buy
    throughput.  ``overlap_wire=True`` prices the async tick instead:
    wire rides concurrently with compute, so each peer's cost is
    ``max(compute, wire)`` — overlapped throughput is never below the
    serial figure, and equals it at ``boundary_cost=0``."""
    if alloc and not isinstance(alloc[0], (int, float)):
        spans = [tuple(a) for a in alloc]
        n_stages = len(stage_costs) if stage_costs else \
            max(hi for _, hi in spans)
        speeds = (list(peer_speed) if isinstance(peer_speed, (list, tuple))
                  else [float(peer_speed)] * len(spans))
        rate = span_stage_rates(spans, speeds, n_stages, stage_costs,
                                boundary_cost, overlap_wire)
        return min(rate) if rate else 0.0
    costs = stage_costs or [1.0] * len(alloc)
    if any(a <= 0 for a in alloc):
        return 0.0
    n_stages = len(alloc)
    return min(
        a * peer_speed / max(_span_cost((s, s + 1), costs, boundary_cost,
                                        n_stages, overlap_wire), 1e-12)
        for s, (a, c) in enumerate(zip(alloc, costs)))


def plan_span_change(dht, n_stages: int,
                     spans: dict[Hashable, tuple[int, int]],
                     imbalance: float = 1.25,
                     boundary_costs: Optional[Sequence[float]] = None
                     ) -> Optional[SpanChange]:
    """Span-aware Alg.-2 step, from the DHT load snapshot.

    * SPLIT/shrink: the max-load stage is genuinely hotter than the
      min-load stage (beyond the ``imbalance`` ratio — raw queue sums
      jitter, so exact comparison would misread noise as imbalance) and
      sits inside a multi-stage span — concentrate the most backlogged
      such peer on the bottleneck stage alone, provided every stage it
      drops keeps another cover (the runner hands the dropped stages'
      state to those peers).
    * MERGE/grow: loads are within the tolerance band — let the
      least-loaded peer absorb an adjacent stage that is covered by >= 2
      peers, deleting one host boundary crossing for its traffic at no
      coverage risk.  (A hot pipe with nothing to split proposes
      nothing: growing it would only slow the bottleneck.)

    ``boundary_costs`` (per-boundary wire prices, e.g. the stage plan's
    ``boundary_costs``) ranks merge candidates by the NET wire saving of
    the fused boundary — absorbing the stage behind an expensive edge
    (a routed-MoE or whisper boundary) wins over a cheap one; without it
    the historical least-loaded-first order applies.

    Never proposes a change that would strand a stage — or break span
    *routability* (:func:`spans_route`): coverage alone is too weak,
    a layout like ``{(0,2), (1,2), (1,3)}`` covers every stage of a
    3-stage pipe yet no span starts at boundary 2, so every microbatch
    would stall.

    ``dht`` may be a live DHT or a per-round :class:`ControlSnapshot`;
    the candidate scan itself is O(P·S̄ + C·(U + S)) for C candidate
    moves over U unique spans — per-candidate work is an O(1) coverage
    lookup (difference-array) and a span-multiset routability probe,
    never a per-candidate DHT read or full-layout rebuild."""
    snap = _as_snapshot(dht, n_stages)
    loads = snap.loads
    s_max = max(range(n_stages), key=lambda s: loads[s])
    s_min = min(range(n_stages), key=lambda s: loads[s])

    cover = [0] * (n_stages + 1)
    span_count: dict[tuple[int, int], int] = {}
    for lo, hi in spans.values():
        cover[lo] += 1
        cover[hi] -= 1
        span_count[(lo, hi)] = span_count.get((lo, hi), 0) + 1
    for s in range(n_stages):
        cover[s + 1] += cover[s]
    base_routes = spans_route(n_stages, span_count)

    def covers(stage: int, but: Hashable) -> int:
        lo, hi = spans[but]
        return cover[stage] - (1 if lo <= stage < hi else 0)

    def routes_after(pid: Hashable, new: tuple[int, int]) -> bool:
        old = spans[pid]
        if base_routes and span_count.get(old, 0) >= 2:
            # another peer keeps old's routing edge, and adding an edge
            # never breaks reachability -> superset of a routing layout
            return True
        span_count[old] -= 1
        if not span_count[old]:
            del span_count[old]
        span_count[new] = span_count.get(new, 0) + 1
        ok = spans_route(n_stages, span_count)
        span_count[new] -= 1
        if not span_count[new]:
            del span_count[new]
        span_count[old] = span_count.get(old, 0) + 1
        return ok

    def queue_of(pid: Hashable, stage: int) -> float:
        return snap.queue_of(pid, stage)

    hot = loads[s_max] > imbalance * loads[s_min] + 0.05
    if hot:
        donors = sorted(
            (pid for pid, (lo, hi) in spans.items()
             if hi - lo > 1 and lo <= s_max < hi),
            key=lambda pid: (-queue_of(pid, s_max), str(pid)))
        for pid in donors:
            lo, hi = spans[pid]
            new = (s_max, s_max + 1)
            if all(covers(s, but=pid) >= 1
                   for s in range(lo, hi) if s != s_max) \
                    and routes_after(pid, new):
                return SpanChange(pid, (lo, hi), new)
        return None

    # balanced: grow toward fewer host boundaries
    def edge(b: int) -> float:
        if boundary_costs is None or not 0 <= b < n_stages - 1:
            return 0.0
        return float(boundary_costs[b])

    growers = sorted(spans, key=lambda pid: (queue_of(pid, spans[pid][0]),
                                             str(pid)))
    cands = []
    for pid in growers:
        lo, hi = spans[pid]
        for t, new in ((hi, (lo, hi + 1)), (lo - 1, (lo - 1, hi))):
            if 0 <= t < n_stages and covers(t, but=pid) >= 2 \
                    and routes_after(pid, new):
                # growing up fuses boundary hi-1 but exposes boundary
                # hi; growing down fuses lo-1 but exposes lo-2
                saved = (edge(hi - 1) - edge(hi) if t == hi
                         else edge(lo - 1) - edge(lo - 2))
                cands.append((saved, pid, (lo, hi), new))
    if not cands:
        return None
    if boundary_costs is not None:
        cands.sort(key=lambda c: -c[0])        # stable: ties keep the
        # least-loaded-first order from the grower scan above
    _, pid, old, new = cands[0]
    return SpanChange(pid, old, new)
