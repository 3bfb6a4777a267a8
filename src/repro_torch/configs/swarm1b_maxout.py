"""swarm-1b with maxout_2 boundary compression (App. J.1, Goodfellow et
al. 2013): the sending stage pools non-overlapping pairs of features
(param-free, 2x fewer wire bytes), the receiving stage restores d_model
with a learned ``w_d``.
"""
from repro_torch.configs.swarm1b import CONFIG as _BASE

CONFIG = _BASE.with_overrides(
    name="swarm-1b-maxout",
    boundary_compression="maxout",
    maxout_k=2,
    pipeline_stages=3,
)
