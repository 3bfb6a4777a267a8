"""Architecture registry: ``get_config(name)`` / ``get_reduced(name)``
(``--arch <id>`` resolution) and the dry-run cell shapes ``SHAPES``.

The port registers each architecture with the slice that brings its
block kinds: yi-6b (serving slice), the paper's swarm-1b with its
int8, bottleneck and maxout boundaries (training slice),
swarm-1b-span for span peers (spans slice), and the attention families
(gemma-2b, qwen1.5-4b, h2o-danube-3-4b, qwen2-vl-2b with M-RoPE,
llama4-scout's MoE and deepseek-v2's MLA + MoE), and the recurrent
families (xlstm-125m's mLSTM and sLSTM, hymba-1.5b's attention beside
mamba heads), and the encoder-decoder whisper-large-v3 (stubbed audio
frontend).  ``ASSIGNED`` and :func:`cell_supported` pick the dry
run's cells (:mod:`repro_torch.launch.dryrun`).
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ArchConfig, reduced

from repro_torch.configs import (
    deepseek_v2_236b, gemma_2b, h2o_danube_3_4b, hymba_1_5b,
    llama4_scout_17b_a16e, qwen15_4b, qwen2_vl_2b, swarm1b,
    swarm1b_bottleneck, swarm1b_maxout, swarm1b_span, whisper_large_v3,
    xlstm_125m, yi_6b)

_MODULES = [yi_6b, h2o_danube_3_4b, qwen15_4b, gemma_2b, qwen2_vl_2b,
            xlstm_125m, hymba_1_5b, llama4_scout_17b_a16e, deepseek_v2_236b,
            whisper_large_v3,
            swarm1b, swarm1b_bottleneck, swarm1b_maxout, swarm1b_span]

REGISTRY: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}

# The ten assigned architectures (the paper's own model is extra).
ASSIGNED = [
    "yi-6b", "h2o-danube-3-4b", "qwen1.5-4b", "gemma-2b", "qwen2-vl-2b",
    "xlstm-125m", "whisper-large-v3", "hymba-1.5b", "llama4-scout-17b-a16e",
    "deepseek-v2-236b",
]


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]

def get_reduced(name: str) -> ArchConfig:
    return reduced(get_config(name))


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Is (arch x shape) runnable? Returns (ok, reason-if-not)."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, ("pure full-attention arch: 500k context is "
                       "unservable (DESIGN.md §5)")
    return True, ""
