"""The paper's own model (§4.3): 1.01B-param Transformer LM, 3 stages of
16 shared layers each (ALBERT-style), d_model=4096, RoPE + GeGLU, trained
with 8-bit compressed activations on preemptible T4s.

Because of layer sharing this is compute-equivalent to a 13B model —
``share_groups=3`` stores one parameter group per SWARM pipeline stage.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="swarm-1b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=16384,
    vocab_size=50257, head_dim=128,
    rope="rope", act="geglu", norm="layernorm",
    share_groups=3,
    boundary_compression="int8",
)
