"""yi-6b — llama-arch GQA [arXiv:2403.04652; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, d_ff=11008,
    vocab_size=64000, head_dim=128,
    rope="rope", rope_theta=5_000_000.0, act="swiglu", norm="rmsnorm",
    param_dtype="float32",
)
