"""qwen1.5-4b — MHA with QKV bias [hf:Qwen/Qwen1.5-4B; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, d_ff=6912,
    vocab_size=151936, head_dim=128,
    rope="rope", rope_theta=5_000_000.0, qkv_bias=True,
    act="swiglu", norm="rmsnorm",
)
