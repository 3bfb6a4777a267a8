"""Mesh-aware layout hints that degrade to identity (port of
``repro.dist.constrain``).

Model code may annotate a tensor with the mesh axes it *would* occupy on
the production mesh, e.g.::

    x = constrain(x, ("pod", "data"), None, None)     # [B, S, d]

and the same line is right everywhere: off a mesh it is the identity;
inside ``with mesh:`` a :class:`~repro_torch.dist.mesh.Placed` tensor is
laid out again to the resolved spec (a plain tensor has no layout to
change and is returned as it is).

:func:`resolve_spec` applies the three rules the sharding rules share:
axes absent from the mesh are dropped (a ``("pod", "data")`` spec on a
``("data", "model")`` mesh becomes ``("data",)``), a dim whose size does
not divide the product of its surviving axes is replicated, and a mesh
axis may be used once per spec (first use wins).  It reads only
``mesh.axis_names`` and ``mesh.shape``, so any object with those two
(a duck-typed production mesh in the tests) resolves specs.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.dist.mesh import AxisSpec, Mesh, Placed, ambient_mesh, \
    axis_names_of, gather, place

__all__ = ["AxisSpec", "constrain", "current_mesh", "resolve_spec"]


def current_mesh() -> Optional[Mesh]:
    """The ambient ``with mesh:`` context's mesh, or None off-mesh."""
    mesh = ambient_mesh()
    return None if mesh is None or mesh.empty else mesh


def resolve_spec(axis_specs: Sequence[AxisSpec], shape: Sequence[int],
                 mesh) -> tuple:
    """Apply the drop-absent / drop-indivisible / first-use-wins rules:
    one entry a dim (an axis name, a tuple of them, or None), trailing
    Nones dropped, as ``PartitionSpec`` keeps them."""
    entries: list[AxisSpec] = []
    used: set[str] = set()
    for spec, size in zip(axis_specs, shape):
        axes = tuple(n for n in axis_names_of(spec)
                     if n in mesh.axis_names and n not in used)
        n_shards = 1
        for a in axes:
            n_shards *= mesh.shape[a]
        if not axes or n_shards == 1 or size % n_shards:
            entries.append(None)
            continue
        used.update(axes)
        entries.append(axes[0] if len(axes) == 1 else axes)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def constrain(x, *axis_specs: AxisSpec):
    """Lay a placed ``x`` out on the ambient mesh by ``axis_specs``;
    identity off a mesh, for a plain tensor, and where the spec resolves
    to full replication (nothing to say, as in JAX)."""
    if len(axis_specs) != x.ndim:
        raise ValueError(f"{len(axis_specs)} axis specs for rank-{x.ndim} "
                         f"array of shape {tuple(x.shape)}")
    mesh = current_mesh()
    if mesh is None or not isinstance(x, Placed):
        return x
    spec = resolve_spec(axis_specs, x.shape, mesh)
    if not spec or (x.mesh == mesh and x.spec == spec):
        return x
    return place(gather(x, x.mesh.devices.flat[0]), mesh, spec)
