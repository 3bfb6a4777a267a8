"""Stage-runtime layer (port of ``repro.runtime``): one executor
protocol, many peer backends — single-stage and span backends on one
device (``NumericExecutor``, ``PipelineExecutor``, each training and
serving) and on a device mesh (``MeshExecutor``, ``MeshSpanExecutor``,
training)."""
from repro_torch.runtime.base import StageExecutor, StageState, \
    host_snapshot
from repro_torch.runtime.numeric import (NumericExecutor,
                                         build_numeric_executors,
                                         compile_stats,
                                         get_span_program,
                                         get_stage_programs,
                                         reset_compile_stats)
from repro_torch.runtime.mesh import MeshExecutor, MeshSpanExecutor
from repro_torch.runtime.pipeline import PipelineExecutor
from repro_torch.runtime.stage_model import SpanProgram, StageProgram, \
    build_span_program, build_stage_programs, init_stage_params, \
    split_whisper_params

__all__ = [
    "StageExecutor", "StageState", "host_snapshot", "NumericExecutor",
    "MeshExecutor", "MeshSpanExecutor", "PipelineExecutor",
    "build_numeric_executors", "compile_stats", "get_span_program",
    "get_stage_programs", "reset_compile_stats", "SpanProgram",
    "StageProgram", "build_span_program", "build_stage_programs",
    "init_stage_params", "split_whisper_params",
]
