"""Stage-runtime layer (port of ``repro.runtime``): one executor
protocol, single-stage and span backends on one device, each training
and serving."""
from repro_torch.runtime.base import StageExecutor, StageState, \
    host_snapshot
from repro_torch.runtime.numeric import (NumericExecutor,
                                         build_numeric_executors,
                                         compile_stats,
                                         get_span_program,
                                         reset_compile_stats)
from repro_torch.runtime.pipeline import PipelineExecutor
from repro_torch.runtime.stage_model import SpanProgram, StageProgram, \
    build_span_program, build_stage_programs, init_stage_params, \
    split_whisper_params

__all__ = [
    "StageExecutor", "StageState", "host_snapshot", "NumericExecutor",
    "PipelineExecutor", "build_numeric_executors", "compile_stats",
    "get_span_program", "reset_compile_stats", "SpanProgram",
    "StageProgram", "build_span_program", "build_stage_programs",
    "init_stage_params", "split_whisper_params",
]
