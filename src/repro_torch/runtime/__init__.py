"""Stage-runtime layer (port of ``repro.runtime``, serving half): one
executor protocol, single-stage and span backends on one device."""
from repro_torch.runtime.base import StageExecutor, StageState, \
    host_snapshot
from repro_torch.runtime.numeric import (NumericExecutor,
                                         build_numeric_executors,
                                         compile_stats,
                                         reset_compile_stats)
from repro_torch.runtime.pipeline import PipelineExecutor

__all__ = [
    "StageExecutor", "StageState", "host_snapshot", "NumericExecutor",
    "PipelineExecutor", "build_numeric_executors", "compile_stats",
    "reset_compile_stats",
]
