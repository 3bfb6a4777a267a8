"""xlstm-125m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

The 7:1 mLSTM:sLSTM mix is arranged as two identical (5×mLSTM, 1×sLSTM)
halves so that a 2-stage SWARM pipeline has structurally identical
stages; d_ff=0 — xLSTM blocks carry their own projections.
"""
from repro_torch.models.config import ArchConfig, SSMConfig

_PATTERN = ("mlstm",) * 5 + ("slstm",) + ("mlstm",) * 5 + ("slstm",)

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=50304, head_dim=192,
    rope="none", act="gelu", norm="layernorm",
    block_pattern=_PATTERN,
    ssm=SSMConfig(state_dim=16, chunk=128),
    tie_embeddings=True,
)
