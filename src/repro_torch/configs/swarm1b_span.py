"""swarm-1b for span peers: the learned bottleneck codec and a pipeline
depth at which a well-provisioned peer fuses several consecutive stages
in one program (``repro_torch.runtime.PipelineExecutor``), the paper's
square-cube rebalancing made literal.  Every fused boundary keeps its
encode/decode pair on the device, so the c-dim wire tensor crosses the
host only at span edges: a peer serving 2 of the 3 stages moves half the
boundary bytes of three single-stage peers, with the same numbers.

The shapes and the stage params of swarm-1b-bottleneck; used by
``SwarmConfig(spans=True)`` runs, where Alg. 2 proposes span splits and
merges.
"""
from repro_torch.configs.swarm1b import CONFIG as _BASE

CONFIG = _BASE.with_overrides(
    name="swarm-1b-span",
    boundary_compression="bottleneck",
    bottleneck_dim=1024,
    pipeline_stages=3,
)
