"""PipelineExecutor — a SWARM peer serving a contiguous span of stages
``[lo, hi)`` on one device (port of the serving half of
``repro.runtime.pipeline``).

Intra-span boundaries stay on the device; the wire codec
(``wire_fwd``) applies only at span edges.  State is per-stage-keyed
(``StageState.per_stage``), so a span peer's snapshots, KV hand-offs
and restores are ordinary single-stage ones.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.compression import codecs
from repro_torch.models.config import ArchConfig
from repro_torch.models import params as P
from repro_torch.runtime.base import StageState, host_snapshot, \
    install_snapshot, slot_export, slot_install, training_slice, \
    wire_fwd_codec
from repro_torch.runtime.stage_model import _stage_fwd_flops, _stage_specs

Tree = Any


class PipelineExecutor:
    """Run stages ``[lo, hi)`` fused on a single device."""

    device_count = 1

    def __init__(self, cfg: ArchConfig, n_stages: int, seq_len: int,
                 span: tuple[int, int], compress: Optional[str] = None,
                 quant_block: int = 64, device="cuda"):
        lo, hi = span
        if not (0 <= lo < hi <= n_stages):
            raise ValueError(f"span [{lo}, {hi}) outside [0, {n_stages})")
        self.cfg = cfg
        self.n_stages = n_stages
        self.seq_len = seq_len
        self.span = (lo, hi)
        self.stage = lo                       # entry stage
        from repro_torch.models.stage_plan import get_stage_plan
        self.plan = get_stage_plan(cfg, n_stages)
        self.compress_mode = codecs.resolve_mode(cfg, compress)
        self.quant_block = quant_block
        self.device = P.resolve_device(device)
        learned = self.compress_mode in codecs.LEARNED and n_stages > 1
        self.fwd_flops_per_token = sum(
            _stage_fwd_flops(cfg, s, n_stages, seq_len or 1,
                             self.compress_mode, learned)
            for s in range(lo, hi))
        self.bwd_flops_per_token = 3.0 * self.fwd_flops_per_token

    @property
    def stages(self) -> range:
        return range(*self.span)

    # ---------------------------------------------------------- lifecycle
    def init_state(self, seed: int) -> StageState:
        state = StageState(per_stage={})
        for i, s in enumerate(self.stages):
            sub = StageState(params=P.init(
                seed + i, _stage_specs(self.cfg, s, self.n_stages),
                self.device))
            sub.reset_progress()
            state.per_stage[s] = sub
        return state

    def for_span(self, span: range):
        if (span.start, span.stop) == self.span:
            return self
        if len(span) == 1:
            from repro_torch.runtime.numeric import build_numeric_executors
            return build_numeric_executors(
                self.cfg, self.n_stages, self.seq_len,
                compress=self.compress_mode, quant_block=self.quant_block,
                device=self.device)[span.start]
        return PipelineExecutor(self.cfg, self.n_stages, self.seq_len,
                                (span.start, span.stop),
                                compress=self.compress_mode,
                                quant_block=self.quant_block,
                                device=self.device)

    def for_stage(self, stage: int):
        return self.for_span(range(stage, stage + 1))

    def dp_shards(self, batch: int) -> int:
        del batch
        return 1

    def session_program(self, total_len: int):
        from repro_torch.serve.programs import get_session_program
        return get_session_program(self.cfg, self.n_stages, self.span,
                                   total_len, compress=self.compress_mode)

    def _require(self, stage: Optional[int]) -> int:
        if stage is None:
            raise ValueError(
                f"span executor [{self.span[0]}, {self.span[1]}) needs an "
                "explicit covered stage for per-stage state operations")
        if stage not in self.stages:
            raise ValueError(f"stage {stage} outside span {self.span}")
        return stage

    # ------------------------------------------------- training (stubbed)
    def run_fwd(self, *a, **k):
        training_slice("run_fwd")

    def run_bwd(self, *a, **k):
        training_slice("run_bwd")

    def accumulate(self, *a, **k):
        training_slice("accumulate")

    def adopt_step(self, *a, **k):
        training_slice("adopt_step")

    # --------------------------------------------------------- wire codec
    def wire_fwd(self, y: Tree) -> Tree:
        return wire_fwd_codec(self, y)          # span-edge only

    # ---------------------------------------------------- state transfer
    def snapshot(self, state: StageState, stage: Optional[int] = None,
                 slots=()) -> Tree:
        """Single-stage-format snapshot of one covered stage, or (with
        ``stage=None``) the whole span as ``{"per_stage": {s: snap}}``."""
        if stage is None:
            return {"per_stage": {
                s: host_snapshot(state.per_stage[s], slots=slots)
                for s in self.stages}}
        return host_snapshot(state.per_stage[self._require(stage)],
                             slots=slots)

    def restore(self, state: StageState, snap: Tree,
                stage: Optional[int] = None, slots=()) -> None:
        if state.per_stage is None:
            state.per_stage = {}
        if stage is None:
            for s, sub_snap in snap["per_stage"].items():
                self.restore(state, sub_snap, stage=int(s), slots=slots)
            return
        s = self._require(stage)
        sub = state.per_stage.setdefault(s, StageState())
        install_snapshot(sub, snap, self.device, slots=slots)

    # ------------------------------------------------------ keyed slots
    def export_slot(self, state: StageState, name: str, key,
                    stage: Optional[int] = None) -> Tree:
        return slot_export(state.per_stage[self._require(stage)], name, key)

    def install_slot(self, state: StageState, name: str, key, value: Tree,
                     stage: Optional[int] = None) -> None:
        slot_install(state.per_stage[self._require(stage)], name, key,
                     value, self.device)

    def drop_slot(self, state: StageState, name: str, key=None,
                  stage: Optional[int] = None) -> None:
        if stage is None:
            for sub in state.views():
                sub.drop_slot(name, key)
            return
        state.per_stage[self._require(stage)].drop_slot(name, key)
