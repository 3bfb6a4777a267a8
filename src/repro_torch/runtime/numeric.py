"""NumericExecutor — single-device stage execution (port of
``repro.runtime.numeric``).

PyTorch runs eagerly, so there is no jit to cache; the structure of the
JAX package stays: stage programs are built once per executor family
(one per stage, shared by every peer of the stage), span programs once
per ``(config, stages, seq, codec, span)`` process-wide
(:func:`get_span_program`), session programs once per ``(config,
stages, span, horizon, codec)`` process-wide
(``repro_torch.serve.programs.get_session_program``), and
``record_trace`` / ``compile_stats`` count one "trace" per span or
session program build and kind, where the JAX package counts XLA traces.

Inputs are placed on the executor's device as they arrive (a trainer
may hand host numpy batches or tensors); gradient accumulation adds in
place into the state's own accumulator.
"""
from __future__ import annotations

import sys
import threading
from typing import Any, Optional

import torch

from repro_torch.compression import codecs
from repro_torch.models.config import ArchConfig
from repro_torch.models import params as P
from repro_torch.models.stage_plan import get_stage_plan
from repro_torch.runtime.base import StageState, dispatched, fold_into, \
    place, host_snapshot, install_snapshot, single_stage, slot_export, \
    slot_install, wire_bwd_codec, wire_fwd_codec
from repro_torch.runtime.stage_model import SpanProgram, StageProgram, \
    build_span_program, build_stage_programs

Tree = Any

# (cfg, n_stages, seq_len, comp, (lo, hi)) -> SpanProgram: one program
# per (span, codec), shared by every peer serving that span
_SPANS: dict[tuple, SpanProgram] = {}
# (cfg, n_stages, seq_len, comp) -> [StageProgram]: the stage programs a
# mesh peer runs, shared with every other mesh peer of the configuration
_STAGES: dict[tuple, list[StageProgram]] = {}
# (span-or-stage, kind, shapes) per program key -> number of builds
_TRACES: dict[tuple, int] = {}
_LOCK = threading.Lock()


def record_trace(key: tuple) -> None:
    """Count one program build under ``key``."""
    with _LOCK:
        _TRACES[key] = _TRACES.get(key, 0) + 1


def reset_compile_stats() -> None:
    """Clear the counters and the span- and session-program caches."""
    with _LOCK:
        _TRACES.clear()
        _SPANS.clear()
        _STAGES.clear()
    serve_progs = sys.modules.get("repro_torch.serve.programs")
    if serve_progs is not None:
        serve_progs.reset_session_cache()


def compile_stats() -> dict:
    """``{"traces", "per_key"}`` since the last reset."""
    with _LOCK:
        return {"traces": sum(_TRACES.values()), "per_key": dict(_TRACES)}


def get_stage_programs(cfg: ArchConfig, n_stages: int, seq_len: int,
                       compress: Optional[str] = None
                       ) -> list[StageProgram]:
    """The shared stage programs of a configuration: one build per
    (configuration, seq, codec) process-wide, so N mesh peers of one
    configuration (each stage's executor) run the same program
    objects."""
    comp = codecs.resolve_mode(cfg, compress)
    key = (cfg, n_stages, seq_len, comp)
    with _LOCK:
        progs = _STAGES.get(key)
    if progs is None:
        progs = build_stage_programs(cfg, n_stages, seq_len, comp)
        with _LOCK:
            progs = _STAGES.setdefault(key, progs)
    return progs


def get_span_program(cfg: ArchConfig, n_stages: int, seq_len: int,
                     span: tuple[int, int],
                     compress: Optional[str] = None) -> SpanProgram:
    """The shared, counted fused program for a ``[lo, hi)`` span: one
    build per (configuration, span, codec) process-wide, recorded as one
    ``fwd`` and one ``bwd`` trace, so N span peers of one span (and a
    second same-shape runner) share it."""
    comp = codecs.resolve_mode(cfg, compress)
    key = (cfg, n_stages, seq_len, comp, tuple(span))
    with _LOCK:
        prog = _SPANS.get(key)
    if prog is not None:
        return prog
    prog = build_span_program(cfg, n_stages, seq_len, tuple(span),
                              compress=comp)
    with _LOCK:
        # first build wins if two threads raced; both are equivalent
        won = _SPANS.setdefault(key, prog)
    if won is prog:
        tag = (cfg.name, n_stages, seq_len, comp, tuple(span))
        for kind in ("fwd", "bwd"):
            record_trace(tag + (kind, ()))
    return won


class NumericExecutor:
    """Single-device execution of one stage."""

    device_count = 1

    def __init__(self, cfg: ArchConfig, stage: int, n_stages: int,
                 compress_mode: str, quant_block: int = 64,
                 family: Optional[list["NumericExecutor"]] = None,
                 seq_len: Optional[int] = None, device="cuda",
                 prog: Optional[StageProgram] = None):
        self.cfg = cfg
        self.stage = stage
        self.n_stages = n_stages
        self.plan = get_stage_plan(cfg, n_stages)
        self.seq_len = seq_len
        self.compress_mode = compress_mode
        self.quant_block = quant_block
        self.device = P.resolve_device(device)
        if prog is None:
            prog = build_stage_programs(cfg, n_stages, seq_len or 1,
                                        compress_mode)[stage]
        self.prog = prog
        self.fwd_flops_per_token = prog.fwd_flops_per_token
        self.bwd_flops_per_token = prog.bwd_flops_per_token
        # all executors of one pipeline, so migrations can swap stages
        self._family = family if family is not None else [self]

    @property
    def stages(self) -> range:
        return range(self.stage, self.stage + 1)

    # ---------------------------------------------------------- lifecycle
    def init_state(self, seed: int) -> StageState:
        state = StageState(params=P.init(seed, self.prog.specs,
                                         self.device))
        state.reset_progress()
        return state

    def for_stage(self, stage: int) -> "NumericExecutor":
        return self._family[stage]

    def for_span(self, span: range):
        """Width-1 spans stay in the numeric family; wider spans take
        the fused :class:`~repro_torch.runtime.pipeline.PipelineExecutor`
        backend."""
        if len(span) == 1:
            return self._family[span.start]
        from repro_torch.runtime.pipeline import PipelineExecutor
        return PipelineExecutor(self.cfg, self.n_stages, self.seq_len,
                                (span.start, span.stop),
                                compress=self.compress_mode,
                                quant_block=self.quant_block,
                                device=self.device)

    def dp_shards(self, batch: int) -> int:
        del batch
        return 1

    def session_program(self, total_len: int):
        from repro_torch.serve.programs import get_session_program
        return get_session_program(
            self.cfg, self.n_stages, (self.stage, self.stage + 1),
            total_len, compress=self.compress_mode)

    # ---------------------------------------------------------- execution
    def _here(self, t):
        """A batch or boundary tensor on this executor's device."""
        return None if t is None else place(t, self.device)

    def run_fwd(self, state: StageState, inp: Tree,
                labels: Optional[torch.Tensor] = None) -> Tree:
        if self.stage == self.n_stages - 1:
            return self.prog.fwd(state.params, self._here(inp),
                                 self._here(labels))
        return self.prog.fwd(state.params, self._here(inp))

    def run_bwd(self, state: StageState, inp: Tree,
                dy: Optional[Tree] = None,
                labels: Optional[torch.Tensor] = None):
        if self.stage == self.n_stages - 1:
            return self.prog.bwd(state.params, self._here(inp),
                                 self._here(labels))
        gx, gp = self.prog.bwd(state.params, self._here(inp),
                               self._here(dy))
        return None, gx, gp

    # ------------------------------------------------- dispatch / collect
    def dispatch_fwd(self, state: StageState, inp: Tree,
                     labels: Optional[torch.Tensor] = None):
        # the launches are asynchronous on the card: run_fwd returns with
        # the kernels queued, and collect orders the consumer behind them
        return dispatched(self.run_fwd(state, inp, labels), self.device)

    def dispatch_bwd(self, state: StageState, inp: Tree,
                     dy: Optional[Tree] = None,
                     labels: Optional[torch.Tensor] = None):
        return dispatched(self.run_bwd(state, inp, dy, labels), self.device)

    # --------------------------------------------------------- wire codec
    def wire_fwd(self, y: Tree) -> Tree:
        return wire_fwd_codec(self, y)

    def wire_bwd(self, gx: Tree) -> Tree:
        return wire_bwd_codec(self, gx)

    # -------------------------------------------------------- accumulation
    def accumulate(self, state: StageState, gp: Optional[Tree],
                   loss: Optional[float], n_tokens: int,
                   stage: Optional[int] = None) -> None:
        single_stage(self, stage)
        fold_into(state, gp, loss, n_tokens)

    def export_grads(self, state: StageState,
                     stage: Optional[int] = None) -> Tree:
        single_stage(self, stage)
        return state.grad_acc                   # already on this device

    def export_state(self, state: StageState,
                     stage: Optional[int] = None):
        single_stage(self, stage)
        return state.params, state.opt

    def adopt_step(self, state: StageState, new_params: Tree,
                   new_opt: Tree, stage: Optional[int] = None) -> None:
        single_stage(self, stage)
        state.params = place(new_params, self.device)
        state.opt = place(new_opt, self.device)
        state.version += 1
        state.reset_progress()

    # ---------------------------------------------------- state transfer
    def snapshot(self, state: StageState, stage: Optional[int] = None,
                 slots=()) -> Tree:
        single_stage(self, stage)
        return host_snapshot(state, slots=slots)

    def restore(self, state: StageState, snap: Tree,
                stage: Optional[int] = None, slots=()) -> None:
        single_stage(self, stage)
        install_snapshot(state, snap, self.device, slots=slots)

    # ------------------------------------------------------ keyed slots
    def export_slot(self, state: StageState, name: str, key,
                    stage: Optional[int] = None) -> Tree:
        single_stage(self, stage)
        return slot_export(state, name, key)

    def install_slot(self, state: StageState, name: str, key, value: Tree,
                     stage: Optional[int] = None) -> None:
        single_stage(self, stage)
        slot_install(state, name, key, value, self.device)

    def drop_slot(self, state: StageState, name: str, key=None,
                  stage: Optional[int] = None) -> None:
        single_stage(self, stage)
        state.drop_slot(name, key)


def build_numeric_executors(cfg: ArchConfig, n_stages: int, seq_len: int,
                            compress: Optional[str] = None,
                            quant_block: int = 64, device="cuda",
                            programs: Optional[list[StageProgram]] = None
                            ) -> list[NumericExecutor]:
    """One executor per stage, sharing one family list and one set of
    stage programs (built here, or an injected pre-built list)."""
    comp = codecs.resolve_mode(cfg, compress)
    get_stage_plan(cfg, n_stages)      # validates the split (ValueError)
    if programs is None:
        programs = build_stage_programs(cfg, n_stages, seq_len, comp)
    family: list[NumericExecutor] = []
    for s in range(n_stages):
        family.append(NumericExecutor(cfg, s, n_stages, comp, quant_block,
                                      family=family, seq_len=seq_len,
                                      device=device, prog=programs[s]))
    return family
