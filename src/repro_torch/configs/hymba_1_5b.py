"""hymba-1.5b — parallel attention + mamba heads [arXiv:2411.13676; hf].

Meta-tokens are omitted (orthogonal to the systems study); the attention
path uses a 2048-token sliding window as in the bulk of Hymba's layers,
which is what makes the arch servable at long context.
"""
from repro_torch.models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab_size=32001, head_dim=64,
    rope="rope", act="swiglu", norm="rmsnorm",
    sliding_window=2048,
    ssm=SSMConfig(state_dim=16, expand=2, chunk=128),
)
