"""The static intra-stage parallel layer (port of ``repro.dist``).

SWARM's elastic layer (``repro_torch.core``) decides which peers hold
which stage; this package runs one configuration once chosen:

* :mod:`repro_torch.dist.mesh` — single-process meshes of local devices
  and placed tensors (place, gather, reduce-scatter);
* :mod:`repro_torch.dist.constrain` — spec resolution and a layout hint
  that is the identity off a mesh;
* :mod:`repro_torch.dist.sharding` — logical-axis -> mesh-axis rules and
  the sharding builders for params, train state, batches and caches;
* :mod:`repro_torch.dist.pipeline` — the shifting-buffer pipeline train
  step over the ``pod`` axis, with all four boundary modes.

Submodules are imported explicitly, as in the JAX package.
"""
