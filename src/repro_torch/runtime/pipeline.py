"""PipelineExecutor — a SWARM peer serving a contiguous span of stages
``[lo, hi)`` on one device (port of ``repro.runtime.pipeline``).

SWARM's square-cube argument (paper §3.1) says a well-provisioned peer
should hold more of the model, not another replica of one slice.  This
backend is that lever: one peer runs stages ``[lo, hi)`` through one
fused :class:`repro_torch.runtime.stage_model.SpanProgram`, so

* intra-span boundaries stay on the device — under a learned codec the
  encode/decode pair still runs inside the span (the numbers are those
  of single-stage peers), but no byte crosses the host;
* the wire codec (``wire_fwd``/``wire_bwd``, the int8 quantize-on-send)
  applies only at span edges, where the tensor really crosses;
* one program per (span, codec) process-wide
  (:func:`repro_torch.runtime.numeric.get_span_program`).

State is per-stage-keyed (``StageState.per_stage``): every covered stage
keeps its own params, optimizer state, accumulator and version, so a
span peer joins one All-Reduce group per covered stage, checkpoint cuts
write single-stage snapshots, and span split/merge hand-offs move
single-stage snapshots between span and single-stage peers.
``dispatch_fwd``/``dispatch_bwd`` launch the fused program and hand back
a collect thunk (:func:`repro_torch.runtime.base.dispatched`).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.compression import codecs
from repro_torch.models.config import ArchConfig
from repro_torch.models import params as P
from repro_torch.runtime.base import StageState, dispatched, fold_into, \
    host_snapshot, install_snapshot, place, slot_export, slot_install, \
    wire_bwd_codec, wire_fwd_codec
from repro_torch.runtime.numeric import get_span_program

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
        self.prog = get_span_program(cfg, n_stages, seq_len or 1,
                                     (lo, hi), self.compress_mode)
        self.fwd_flops_per_token = self.prog.fwd_flops_per_token
        self.bwd_flops_per_token = self.prog.bwd_flops_per_token

    @property
    def stages(self) -> range:
        return range(*self.span)

    # ---------------------------------------------------------- lifecycle
    def init_state(self, seed: int) -> StageState:
        state = StageState(per_stage={})
        for i, s in enumerate(self.stages):
            sub = StageState(params=P.init(seed + i, self.prog.specs[s],
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

    # ------------------------------------------------------------ helpers
    def _params_tuple(self, state: StageState) -> tuple:
        return tuple(state.per_stage[s].params for s in self.stages)

    def _covers_last(self) -> bool:
        return self.span[1] == self.n_stages

    def _here(self, t):
        """A batch or boundary tensor on this executor's device."""
        return None if t is None else place(t, self.device)

    def _require(self, stage: Optional[int]) -> int:
        if stage is None:
            raise ValueError(
                f"span executor [{self.span[0]}, {self.span[1]}) needs an "
                "explicit covered stage for per-stage state operations")
        if stage not in self.stages:
            raise ValueError(f"stage {stage} outside span {self.span}")
        return stage

    # ---------------------------------------------------------- execution
    def run_fwd(self, state: StageState, inp: Tree,
                labels: Optional[torch.Tensor] = None) -> Tree:
        ps = self._params_tuple(state)
        if self._covers_last():
            return self.prog.fwd(ps, self._here(inp), self._here(labels))
        return self.prog.fwd(ps, self._here(inp))

    def run_bwd(self, state: StageState, inp: Tree,
                dy: Optional[Tree] = None,
                labels: Optional[torch.Tensor] = None):
        ps = self._params_tuple(state)
        if self._covers_last():
            loss, gx, gps = self.prog.bwd(ps, self._here(inp),
                                          self._here(labels))
        else:
            loss = None
            gx, gps = self.prog.bwd(ps, self._here(inp), self._here(dy))
        # per-stage gradients keyed by GLOBAL stage id: the scheduler
        # folds each covered stage on its own (the ledger may admit a
        # subset of them on a re-issued attempt)
        return loss, gx, dict(zip(self.stages, gps))

    # ------------------------------------------------- dispatch / collect
    def dispatch_fwd(self, state: StageState, inp: Tree,
                     labels: Optional[torch.Tensor] = None):
        # the fused span's launches are queued when run_fwd returns
        return dispatched(self.run_fwd(state, inp, labels), self.device)

    def dispatch_bwd(self, state: StageState, inp: Tree,
                     dy: Optional[Tree] = None,
                     labels: Optional[torch.Tensor] = None):
        # gradients keyed by global stage id, as run_bwd keys them
        return dispatched(self.run_bwd(state, inp, dy, labels), self.device)

    # --------------------------------------------------------- wire codec
    def wire_fwd(self, y: Tree) -> Tree:
        return wire_fwd_codec(self, y)          # span-edge only

    def wire_bwd(self, gx: Tree) -> Tree:
        return wire_bwd_codec(self, gx)

    # -------------------------------------------------------- accumulation
    def accumulate(self, state: StageState, gp: Optional[Tree],
                   loss: Optional[float], n_tokens: int,
                   stage: Optional[int] = None) -> None:
        fold_into(state.per_stage[self._require(stage)], gp, loss, n_tokens)

    def export_grads(self, state: StageState,
                     stage: Optional[int] = None) -> Tree:
        return state.per_stage[self._require(stage)].grad_acc

    def export_state(self, state: StageState,
                     stage: Optional[int] = None):
        sub = state.per_stage[self._require(stage)]
        return sub.params, sub.opt

    def adopt_step(self, state: StageState, new_params: Tree,
                   new_opt: Tree, stage: Optional[int] = None) -> None:
        sub = state.per_stage[self._require(stage)]
        sub.params = place(new_params, self.device)
        sub.opt = place(new_opt, self.device)
        sub.version += 1
        sub.reset_progress()

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
