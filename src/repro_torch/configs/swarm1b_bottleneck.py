"""swarm-1b with the paper's strongest learned boundary codec (App. J.1):
a linear bottleneck 4096 -> 1024 at each of the two stage boundaries.

``pipeline_stages=3`` (the paper's 3 stages of 16 shared layers) is the
declared pipeline depth; the elastic stage programs give each sending
stage its ``w_c`` and each receiving stage its ``w_d``.
"""
from repro_torch.configs.swarm1b import CONFIG as _BASE

CONFIG = _BASE.with_overrides(
    name="swarm-1b-bottleneck",
    boundary_compression="bottleneck",
    bottleneck_dim=1024,
    pipeline_stages=3,
)
