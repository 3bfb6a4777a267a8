"""llama4-scout-17b-a16e — MoE 16 experts top-1 + shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

bf16 parameters, as in the JAX package's config.
"""
from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab_size=202048, head_dim=128,
    rope="rope", rope_theta=500_000.0, act="swiglu", norm="rmsnorm",
    moe=MoEConfig(num_experts=16, num_shared=1, top_k=1, d_ff_expert=8192,
                  capacity_factor=1.25),
    param_dtype="bfloat16",
)
