"""gemma-2b — GeGLU, head_dim 256, MQA (kv=1) [arXiv:2403.08295; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
    vocab_size=256000, head_dim=256,
    rope="rope", rope_theta=10_000.0, act="geglu", norm="rmsnorm",
    tie_embeddings=True, scale_embed=True,
)
