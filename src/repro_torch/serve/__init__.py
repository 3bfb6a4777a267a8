"""Elastic span serving over SWARM pipelines (port of ``repro.serve``)."""
from repro_torch.serve.programs import (KV_SLOT, SessionProgram,
                                        build_session_program,
                                        full_session_program,
                                        get_session_program)
from repro_torch.serve.runner import (Request, ServeConfig, ServeRunner,
                                      ServeStats, reference_generate)

__all__ = [
    "KV_SLOT", "SessionProgram", "build_session_program",
    "full_session_program", "get_session_program",
    "Request", "ServeConfig", "ServeRunner", "ServeStats",
    "reference_generate",
]
