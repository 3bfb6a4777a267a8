"""NumericExecutor — single-device stage execution (port of the serving
half of ``repro.runtime.numeric``).

PyTorch runs eagerly, so there is no jit to cache; the structure of the
JAX package stays: programs are built once per ``(config, stages, span,
horizon, codec)`` and shared process-wide by every peer of a span
(``repro_torch.serve.programs.get_session_program``), and
``record_trace`` / ``compile_stats`` count one "trace" per program
build, where the JAX package counts XLA traces.

``run_fwd``, ``run_bwd``, ``accumulate`` and ``adopt_step`` raise
``NotImplementedError`` until the training slice.
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
from repro_torch.runtime.base import StageState, host_snapshot, \
    install_snapshot, single_stage, slot_export, slot_install, \
    training_slice, wire_fwd_codec
from repro_torch.runtime.stage_model import _stage_fwd_flops, _stage_specs

Tree = Any

# (span-or-stage, kind, shapes) per program key -> number of builds
_TRACES: dict[tuple, int] = {}
_LOCK = threading.Lock()


def record_trace(key: tuple) -> None:
    """Count one program build under ``key``."""
    with _LOCK:
        _TRACES[key] = _TRACES.get(key, 0) + 1


def reset_compile_stats() -> None:
    """Clear the counters and the session-program cache."""
    with _LOCK:
        _TRACES.clear()
    serve_progs = sys.modules.get("repro_torch.serve.programs")
    if serve_progs is not None:
        serve_progs.reset_session_cache()


def compile_stats() -> dict:
    """``{"traces", "per_key"}`` since the last reset."""
    with _LOCK:
        return {"traces": sum(_TRACES.values()), "per_key": dict(_TRACES)}


class NumericExecutor:
    """Single-device execution of one stage."""

    device_count = 1

    def __init__(self, cfg: ArchConfig, stage: int, n_stages: int,
                 compress_mode: str, quant_block: int = 64,
                 family: Optional[list["NumericExecutor"]] = None,
                 seq_len: Optional[int] = None, device="cuda"):
        self.cfg = cfg
        self.stage = stage
        self.n_stages = n_stages
        self.plan = get_stage_plan(cfg, n_stages)
        self.seq_len = seq_len
        self.compress_mode = compress_mode
        self.quant_block = quant_block
        self.device = P.resolve_device(device)
        learned = compress_mode in codecs.LEARNED and n_stages > 1
        self.fwd_flops_per_token = _stage_fwd_flops(
            cfg, stage, n_stages, seq_len or 1, compress_mode, learned)
        self.bwd_flops_per_token = 3.0 * self.fwd_flops_per_token
        # all executors of one pipeline, so migrations can swap stages
        self._family = family if family is not None else [self]

    @property
    def stages(self) -> range:
        return range(self.stage, self.stage + 1)

    # ---------------------------------------------------------- lifecycle
    def init_state(self, seed: int) -> StageState:
        state = StageState(params=P.init(
            seed, _stage_specs(self.cfg, self.stage, self.n_stages),
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
        return wire_fwd_codec(self, y)

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
                            quant_block: int = 64, device="cuda"
                            ) -> list[NumericExecutor]:
    """One executor per stage, sharing one family list."""
    comp = codecs.resolve_mode(cfg, compress)
    get_stage_plan(cfg, n_stages)      # validates the split (ValueError)
    family: list[NumericExecutor] = []
    for s in range(n_stages):
        family.append(NumericExecutor(cfg, s, n_stages, comp, quant_block,
                                      family=family, seq_len=seq_len,
                                      device=device))
    return family
