"""whisper-large-v3 — enc-dec, conv frontend stubbed
[arXiv:2212.04356; unverified]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120,
    vocab_size=51866, head_dim=64,
    rope="none", act="gelu", norm="layernorm",
    encoder_layers=32, encoder_max_len=1500,
    frontend="audio_stub",
)
