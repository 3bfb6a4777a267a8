"""Architecture registry: ``get_config(name)``.

The port registers each architecture with the slice that brings its
block kinds: yi-6b (serving slice), the paper's swarm-1b with its
int8, bottleneck and maxout boundaries (training slice), and
swarm-1b-span for span peers (spans slice).
"""
from __future__ import annotations

from repro_torch.models.config import ArchConfig

from repro_torch.configs import swarm1b, swarm1b_bottleneck, \
    swarm1b_maxout, swarm1b_span, yi_6b

_MODULES = [yi_6b, swarm1b, swarm1b_bottleneck, swarm1b_maxout,
            swarm1b_span]

REGISTRY: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]

