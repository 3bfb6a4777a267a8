"""deepseek-v2-236b — MLA (kv_lora 512) + MoE 160e top-6 + 2 shared
[arXiv:2405.04434; hf].

Uniform mla_moe pattern: the original's first-layer dense FFN (<0.1% of
parameters) is folded into the uniform stack so SWARM pipeline stages are
structurally identical, as in the JAX package's config. bf16 params at
this scale.
"""
from repro_torch.models.config import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, d_ff=1536,
    vocab_size=102400, head_dim=128,
    rope="rope", rope_theta=10_000.0, act="swiglu", norm="rmsnorm",
    block_pattern=("mla_moe",) * 60,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=160, num_shared=2, top_k=6, d_ff_expert=1536,
                  capacity_factor=1.25),
    param_dtype="bfloat16",
)
