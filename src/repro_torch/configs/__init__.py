"""Architecture registry: ``get_config(name)``.

The port registers each architecture with the slice that brings its
block kinds; the serving slice brings yi-6b only.
"""
from __future__ import annotations

from repro_torch.models.config import ArchConfig

from repro_torch.configs import yi_6b

_MODULES = [yi_6b]

REGISTRY: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]

