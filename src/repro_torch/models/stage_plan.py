"""First-class stage plans (port of ``repro.models.stage_plan``, copied:
plain arithmetic over the config).

The single source of stage structure.

A ``StagePlan`` is computed once per ``(cfg, n_stages)`` and read by
every layer that needs stage structure: ``runtime/`` (the executors and
the session programs), ``serve/`` and ``core/`` (rebalance pricing).

Three stage shapes exist:

* **LM** — ``n_layers`` decoder blocks split evenly over ``n_stages``;
  a stage's ``runs`` are the maximal same-kind segments of its slice.
* **shared (ALBERT)** — ``share_groups`` parameter groups split evenly;
  each group re-applies ``reps = n_layers / share_groups`` times.
* **encoder-decoder (whisper)** — stage 0 is the encoder pod
  (``whisper_enc``); stages ``1..n_stages-1`` split the decoder layers
  (``whisper_dec``).  The pod boundary sits exactly at the
  cross-attention hand-off: boundary 0 ships encoder output + tokens,
  interior boundaries ship hidden state + encoder output + tokens.

Pricing lives here too: ``stage_flops`` gives per-kind forward FLOPs
per token for one stage (summing over stages reproduces
``flops.forward_flops_per_token`` exactly), and ``boundary_bytes``
prices each boundary individually — MoE stages with
``moe.expert_sharded`` charge per-token-routed bytes (``top_k`` copies
of each token cross into the expert-sharded stage), and whisper
boundaries price their composite payload trees.
"""
from __future__ import annotations

import dataclasses
import functools

from repro_torch.models.config import ArchConfig

#: kinds whose decode/state carry is recurrent (not recomputable from a
#: KV ring alone) — their stages own the "kv" executor slot so churn
#: recovery goes through the slot ledger like grads/KV.
RECURRENT_KINDS = frozenset({"mlstm", "slstm", "mamba", "hymba"})
MOE_KINDS = frozenset({"moe", "mla_moe"})
WHISPER_ENC = "whisper_enc"
WHISPER_DEC = "whisper_dec"


def segments(pattern: tuple[str, ...]) -> list[tuple[str, int]]:
    """Maximal same-kind runs of a layer pattern (moved-up twin of
    ``models.model.segments``; kept import-light for the planners)."""
    runs: list[tuple[str, int]] = []
    for k in pattern:
        if runs and runs[-1][0] == k:
            runs[-1] = (k, runs[-1][1] + 1)
        else:
            runs.append((k, 1))
    return runs


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """Structure of one pipeline stage.

    ``runs`` are ``(kind, count)`` segments executed in order; each run
    is one ``lax.scan`` in the stage program.  ``reps`` > 1 means every
    run re-applies its parameter group that many times (ALBERT sharing).
    ``aux_slots`` names the keyed executor slots (beyond the core
    grads/opt pair) this stage's executor owns — recurrent-state stages
    declare ``("kv",)`` so serving carry survives churn via the ledger.
    """
    index: int
    kinds: tuple[str, ...]
    runs: tuple[tuple[str, int], ...]
    reps: int = 1
    owns_embed: bool = False
    owns_head: bool = False
    aux_slots: tuple[str, ...] = ()

    @property
    def n_layers(self) -> int:
        return sum(n for _, n in self.runs) * self.reps

    @property
    def structural_key(self):
        """Stages with equal keys run structurally identical programs
        (:meth:`StagePlan.fusion_groups` groups them)."""
        return (self.runs, self.reps, self.owns_embed, self.owns_head)


@dataclasses.dataclass(frozen=True)
class StagePlan:
    cfg: ArchConfig
    n_stages: int
    stages: tuple[StageSpec, ...]

    @property
    def is_encdec(self) -> bool:
        return self.cfg.encoder_layers > 0

    @property
    def periodic(self) -> bool:
        """True iff every stage runs the same block structure — the
        precondition for a shifting-buffer pipeline over stages (embed
        and head live outside the stage functions there, so ownership is
        excluded)."""
        if self.is_encdec:
            return False
        return len({(st.runs, st.reps) for st in self.stages}) == 1

    # ---- pricing -----------------------------------------------------
    def stage_flops(self, s: int, seq_len: int) -> float:
        """Forward FLOPs per (decoder) token for stage ``s``.  Summing
        over all stages reproduces ``flops.forward_flops_per_token``."""
        from repro_torch.models import flops as F
        cfg, spec = self.cfg, self.stages[s]
        ctx = F._ctx_for(cfg, seq_len, causal_avg=True)
        enc_ctx = float(min(seq_len, cfg.encoder_max_len))
        fpt = 0.0
        for kind, n in spec.runs:
            c = enc_ctx if kind == WHISPER_ENC else ctx
            fpt += n * spec.reps * F.per_token_layer_flops(
                cfg, kind, c, enc_ctx=enc_ctx)
        if spec.owns_head:
            fpt += 2.0 * cfg.d_model * cfg.vocab_size
        return fpt

    def stage_costs(self, seq_len: int) -> tuple[float, ...]:
        """Per-stage relative compute rates (fwd FLOPs/token) for the
        rebalance planner."""
        return tuple(self.stage_flops(s, seq_len)
                     for s in range(self.n_stages))

    def boundary_bytes(self, b: int, batch: int, seq_len: int,
                       compression: str = "none") -> float:
        """Bytes crossing boundary ``b`` (between stages b and b+1),
        one direction.  Whisper boundaries price the composite payload
        tree; a boundary *entering* an expert-sharded MoE stage prices
        ``top_k`` routed copies of every token."""
        from repro_torch.models import flops as F
        cfg = self.cfg
        if not 0 <= b < self.n_stages - 1:
            raise ValueError(f"boundary {b} out of range "
                             f"[0, {self.n_stages - 1})")
        if self.is_encdec:
            enc_elems = batch * cfg.encoder_max_len * cfg.d_model
            enc_b = F.wire_nbytes(enc_elems, compression)
            tok_b = 4.0 * batch * seq_len          # int32 tokens ride along
            if b == 0:
                return enc_b + tok_b
            return (F.boundary_bytes(cfg, batch, seq_len, compression)
                    + enc_b + tok_b)
        base = F.boundary_bytes(cfg, batch, seq_len, compression)
        recv = self.stages[b + 1]
        if (cfg.moe is not None and cfg.moe.expert_sharded
                and any(k in MOE_KINDS for k in recv.kinds)):
            base *= float(cfg.moe.top_k)
        return base

    def boundary_costs(self, batch: int, seq_len: int,
                       compression: str = "none") -> tuple[float, ...]:
        return tuple(self.boundary_bytes(b, batch, seq_len, compression)
                     for b in range(self.n_stages - 1))

    def link_boundary_costs(self, batch: int, seq_len: int, *,
                            regions, links,
                            compression: str = "none"
                            ) -> tuple[float, ...]:
        """Per-boundary transfer seconds under an inter-region link
        model: boundary ``b``'s bytes priced over the link between the
        regions homing stages ``b`` and ``b+1`` (``links`` is a
        :class:`repro_torch.core.square_cube.LinkTable`, ``regions`` one
        region name per stage), so the span planners fuse across slow
        links first."""
        return tuple(links.edge_costs(
            [self.boundary_bytes(b, batch, seq_len, compression)
             for b in range(self.n_stages - 1)], list(regions)))

    # ---- span fusion -------------------------------------------------
    def fusion_groups(self, span=None) -> list[tuple[int, int]]:
        """``(start, count)`` groups of structurally identical
        consecutive stages within ``span`` (default: the whole
        pipeline); groups never cross a kind boundary."""
        lo, hi = (0, self.n_stages) if span is None else (span[0], span[1])
        groups: list[list] = []
        for s in range(lo, hi):
            key = self.stages[s].structural_key
            if groups and groups[-1][2] == key:
                groups[-1][1] += 1
            else:
                groups.append([s, 1, key])
        return [(s, c) for s, c, _ in groups]


def make_stage_plan(cfg: ArchConfig, n_stages: int) -> StagePlan:
    """Build the plan, validating divisibility up front.

    Raises ``ValueError`` (never silently mis-assigns layers) when the
    stack cannot split: indivisible layer counts, ``share_groups`` with
    mixed ``block_kinds``, or an encoder-decoder at fewer than 2 stages.
    """
    if n_stages < 1:
        raise ValueError(f"{cfg.name}: n_stages must be >= 1, "
                         f"got {n_stages}")
    if cfg.encoder_layers:
        if n_stages < 2:
            raise ValueError(
                f"{cfg.name}: encoder-decoder needs >= 2 stages "
                "(encoder pod + decoder split)")
        dec_stages = n_stages - 1
        if cfg.n_layers % dec_stages:
            raise ValueError(
                f"{cfg.name}: {cfg.n_layers} decoder layers not "
                f"divisible over {dec_stages} decoder stages")
        per = cfg.n_layers // dec_stages
        stages = [StageSpec(
            index=0, kinds=(WHISPER_ENC,) * cfg.encoder_layers,
            runs=((WHISPER_ENC, cfg.encoder_layers),))]
        for s in range(dec_stages):
            stages.append(StageSpec(
                index=s + 1, kinds=(WHISPER_DEC,) * per,
                runs=((WHISPER_DEC, per),),
                owns_embed=(s == 0), owns_head=(s == dec_stages - 1),
                aux_slots=("kv",)))
        return StagePlan(cfg, n_stages, tuple(stages))

    kinds = cfg.block_kinds
    if cfg.share_groups:
        if len(set(kinds)) > 1:
            raise ValueError(
                f"{cfg.name}: share_groups={cfg.share_groups} requires "
                f"uniform block_kinds, got {sorted(set(kinds))} — "
                "parameter sharing across mixed kinds is undefined")
        if cfg.n_layers % cfg.share_groups:
            raise ValueError(
                f"{cfg.name}: n_layers={cfg.n_layers} not divisible by "
                f"share_groups={cfg.share_groups}")
        if cfg.share_groups % n_stages:
            raise ValueError(
                f"{cfg.name}: share_groups={cfg.share_groups} not "
                f"divisible over {n_stages} stages")
        per_groups = cfg.share_groups // n_stages
        reps = cfg.n_layers // cfg.share_groups
        per_stage = [((kinds[0], per_groups),)] * n_stages
        rep_list = [reps] * n_stages
    else:
        if cfg.n_layers % n_stages:
            raise ValueError(
                f"{cfg.name}: n_layers={cfg.n_layers} not divisible by "
                f"n_stages={n_stages}")
        per = cfg.n_layers // n_stages
        per_stage = [tuple(segments(kinds[s * per:(s + 1) * per]))
                     for s in range(n_stages)]
        rep_list = [1] * n_stages

    stages = []
    for s, runs in enumerate(per_stage):
        stage_kinds = tuple(k for k, n in runs for _ in range(n))
        aux = (("kv",) if any(k in RECURRENT_KINDS for k in stage_kinds)
               else ())
        stages.append(StageSpec(
            index=s, kinds=stage_kinds, runs=runs, reps=rep_list[s],
            owns_embed=(s == 0), owns_head=(s == n_stages - 1),
            aux_slots=aux))
    return StagePlan(cfg, n_stages, tuple(stages))


@functools.lru_cache(maxsize=None)
def get_stage_plan(cfg: ArchConfig, n_stages: int) -> StagePlan:
    """Process-wide cached plan — every layer shares one instance per
    ``(cfg, n_stages)`` so plan identity can key compile caches."""
    return make_stage_plan(cfg, n_stages)
