"""qwen2-vl-2b — M-RoPE, dynamic-resolution vision (frontend stub)
[arXiv:2409.12191; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab_size=151936, head_dim=128,
    rope="mrope", rope_theta=1_000_000.0, qkv_bias=True,
    act="swiglu", norm="rmsnorm", tie_embeddings=True,
    frontend="vision_stub",
)
