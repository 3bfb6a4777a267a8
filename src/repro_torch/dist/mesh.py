"""Single-process device meshes and placed tensors: the port's
counterparts of ``jax.sharding.Mesh``, ``NamedSharding`` and a sharded
``jax.Array``.

JAX drives a mesh from one controller: one Python process owns every
device of it.  The port keeps that model.  A :class:`Mesh` is an
n-dimensional grid of local ``torch.device``s with named axes, driven by
the calling process; it is not ``torch.distributed``'s ``DeviceMesh``
(one rank a device), because a SWARM peer backed by a mesh is driven by
the one process that runs the whole swarm.  A mesh may list one device
more than once (a *virtual* mesh: ``[cpu] * 8`` in the CPU tests,
``[cuda:0] * 2`` on one card): it runs the same placement, splitting,
gathering and reduction code as distinct devices, only the copies
between distinct cards are then never made.

A :class:`Placed` tensor holds its global shape, its spec (one entry a
dim: ``None`` or a mesh axis name or a tuple of them, trailing ``None``s
dropped, as ``PartitionSpec``) and one shard a mesh coordinate.  A dim
split over axes ``(a, b)`` gives the coordinate ``(i_a, i_b)`` block
``i_a * |b| + i_b``, as JAX numbers them.  Along a replicated axis the
shards hold equal values.

Placement never copies what is already where it must be: a shard on the
source's device is a view of the source (the port's rule for a tensor
already on an executor's device), a shard elsewhere a copy.  So on a
virtual mesh placing costs nothing, and two shards of one tensor may
share storage; the in-place methods (``add_``, ``zero_``) refuse such a
tensor.  The accumulators they are meant for are made shard by shard
(:func:`reduce_scatter_tree`, ``torch.zeros_like``), never by
:func:`place`.

Moves between devices are plain ``Tensor.to`` copies: library copies,
no kernel of the port's.  Every helper is differentiable where its
inputs are (slices, copies and ``torch.cat``), so autograd carries a
gradient from a gathered tensor back to the shards, or to the tensor the
shards were placed from.

Under :func:`record_collectives` the helpers log the payload bytes each
destination coordinate receives, by kind in JAX's vocabulary:
:func:`gather` an ``all-gather``, :func:`reduce_scatter_tree` a
``reduce-scatter``, :func:`place` and :func:`send` (a point-to-point
copy, the pipeline's shifts) a ``collective-permute``.  A move counts
between distinct coordinates even where they list the same device (a
virtual or a ``meta`` mesh): the record is of the mesh the coordinates
stand for.  :func:`at` names the coordinate the caller runs as (the
source of a placement, the destination of a gather, the owner of what
is allocated meanwhile, which the dry run's live-bytes tracker reads).
With no recorder active the helpers run as they would without one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like

Tree = Any
AxisSpec = Union[None, str, Sequence[str]]

_AMBIENT = threading.local()


def norm_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index (``cuda`` is the
    current card), so that devices compare equal to tensors'."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def axis_names_of(entry: AxisSpec) -> tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


class Mesh:
    """Named axes over an object array of ``torch.device``s.

    ``mesh.shape[axis]`` is an axis size (an insertion-ordered mapping,
    as JAX's); ``with mesh:`` makes it the ambient mesh that
    :func:`repro_torch.dist.constrain.current_mesh` returns."""

    def __init__(self, devices, axis_names: Sequence[str]):
        src = np.array(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = norm_device(src[idx])
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d device array for axes "
                             f"{axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis in {axis_names}")
        self.devices = arr
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, arr.shape))
        self.size = int(arr.size)

    @property
    def empty(self) -> bool:
        return self.size == 0

    def coords(self) -> list[tuple[int, ...]]:
        return list(np.ndindex(self.devices.shape))

    def device(self, coord: tuple[int, ...]) -> torch.device:
        return self.devices[coord]

    def coord(self, **at: int) -> tuple[int, ...]:
        """The coordinate with ``at``'s axis indices, 0 on other axes."""
        return tuple(at.get(a, 0) for a in self.axis_names)

    def fingerprint(self) -> tuple:
        return (self.axis_names, tuple(self.devices.shape),
                tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and \
            self.fingerprint() == other.fingerprint()

    def __hash__(self) -> int:
        return hash(self.fingerprint())

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, devices="
                f"{[str(d) for d in self.devices.flat]})")

    def __enter__(self) -> "Mesh":
        stack = getattr(_AMBIENT, "stack", None)
        if stack is None:
            stack = _AMBIENT.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _AMBIENT.stack.pop()


def ambient_mesh() -> Optional[Mesh]:
    stack = getattr(_AMBIENT, "stack", None)
    return stack[-1] if stack else None


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a resolved spec: where each block of a tensor lives."""
    mesh: Any
    spec: tuple


# ------------------------------------------------- collective recording
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
_REC: dict = {"recorder": None, "coord": None}


class CollectiveRecorder:
    """Payload bytes (and moves) each mesh coordinate receives, by kind."""

    def __init__(self):
        self.bytes: dict[tuple, dict[str, float]] = {}
        self.counts: dict[tuple, dict[str, int]] = {}

    def log(self, kind: str, coord: tuple, nbytes: float,
            times: int = 1) -> None:
        """``times`` moves of ``nbytes`` in all reaching ``coord``."""
        if kind not in COLLECTIVE_KINDS:
            raise ValueError(f"not a collective kind: {kind!r}")
        coord = tuple(coord)
        by = self.bytes.setdefault(coord, dict.fromkeys(COLLECTIVE_KINDS,
                                                        0.0))
        n = self.counts.setdefault(coord, dict.fromkeys(COLLECTIVE_KINDS, 0))
        by[kind] += float(nbytes)
        n[kind] += int(times)


@contextlib.contextmanager
def record_collectives():
    """Log every move of the mesh helpers into a new
    :class:`CollectiveRecorder` (yielded) until the block ends."""
    prev, rec = _REC["recorder"], CollectiveRecorder()
    _REC["recorder"] = rec
    try:
        yield rec
    finally:
        _REC["recorder"] = prev


@contextlib.contextmanager
def at(coord: Optional[tuple]):
    """Run the block as mesh coordinate ``coord`` (None: none)."""
    prev = _REC["coord"]
    _REC["coord"] = None if coord is None else tuple(coord)
    try:
        yield
    finally:
        _REC["coord"] = prev


def current_coord() -> Optional[tuple]:
    return _REC["coord"]


def _recorder() -> Optional[CollectiveRecorder]:
    return _REC["recorder"]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _coord_of(mesh: "Mesh", device) -> Optional[tuple]:
    """The current coordinate, else the first of ``mesh`` on ``device``
    (None: off the mesh)."""
    if _REC["coord"] is not None:
        return _REC["coord"]
    device = norm_device(device)
    for c in mesh.coords():
        if mesh.devices[c] == device:
            return c
    return None


def send(x: torch.Tensor, mesh: "Mesh", coord: tuple) -> torch.Tensor:
    """``x`` on mesh coordinate ``coord``'s device: a point-to-point copy
    (none where ``x`` is there already), logged as a
    ``collective-permute`` under a recorder when ``coord`` is not the
    current coordinate."""
    rec, coord = _recorder(), tuple(coord)
    dev = mesh.devices[coord]
    if rec is None or coord == _REC["coord"]:
        return x.to(dev)
    rec.log("collective-permute", coord, _nbytes(x))
    with at(coord):
        return x.to(dev)


# ------------------------------------------------------------ geometry
def _check_spec(mesh: Mesh, spec: tuple, shape: Sequence[int]) -> None:
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} longer than shape {tuple(shape)}")
    used: set[str] = set()
    for entry, size in zip(spec, shape):
        n = 1
        for a in axis_names_of(entry):
            if a not in mesh.shape:
                raise ValueError(f"axis {a!r} not in mesh {mesh.axis_names}")
            if a in used:
                raise ValueError(f"axis {a!r} used twice in {spec}")
            used.add(a)
            n *= mesh.shape[a]
        if size % n:
            raise ValueError(f"dim of size {size} does not split {n} ways "
                             f"(spec {spec})")


def _blocks_per_dim(mesh: Mesh, spec: tuple, ndim: int) -> list[int]:
    out = []
    for d in range(ndim):
        entry = spec[d] if d < len(spec) else None
        out.append(math.prod(mesh.shape[a] for a in axis_names_of(entry)))
    return out


def block_index(mesh: Mesh, spec: tuple, coord: tuple[int, ...],
                ndim: int) -> tuple[int, ...]:
    """The block of each dim that ``coord``'s shard holds."""
    pos = {a: i for i, a in enumerate(mesh.axis_names)}
    out = []
    for d in range(ndim):
        entry = spec[d] if d < len(spec) else None
        i = 0
        for a in axis_names_of(entry):
            i = i * mesh.shape[a] + coord[pos[a]]
        out.append(i)
    return tuple(out)


def _block_slices(shape: Sequence[int], nblocks: list[int],
                  bidx: tuple[int, ...]) -> tuple[slice, ...]:
    sl = []
    for size, n, i in zip(shape, nblocks, bidx):
        step = size // n
        sl.append(slice(i * step, (i + 1) * step))
    return tuple(sl)


def shard_slices(shape: Sequence[int], mesh: Mesh, spec: tuple,
                 coord: tuple[int, ...]) -> tuple[slice, ...]:
    """The global index slices of ``coord``'s shard."""
    n = _blocks_per_dim(mesh, spec, len(shape))
    return _block_slices(shape, n, block_index(mesh, spec, coord,
                                               len(shape)))


# ------------------------------------------------------------- tensors
class Placed:
    """A tensor laid out over a mesh: ``shards[coord]`` lies on
    ``mesh.devices[coord]`` and holds that coordinate's block."""

    def __init__(self, mesh: Mesh, spec: tuple, shape: Sequence[int],
                 dtype: torch.dtype, shards: np.ndarray):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.shards = shards

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return math.prod(self.shape)

    def element_size(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    def _map(self, fn) -> "Placed":
        out = np.empty(self.shards.shape, dtype=object)
        for c in np.ndindex(out.shape):
            out[c] = fn(self.shards[c])
        first = out[(0,) * out.ndim]
        return Placed(self.mesh, self.spec, self.shape, first.dtype, out)

    def to(self, dtype: torch.dtype) -> "Placed":
        """Every shard in ``dtype`` (this tensor itself when it is)."""
        if dtype == self.dtype:
            return self
        return self._map(lambda t: t.to(dtype))

    def _own_storage(self, what: str) -> None:
        seen = set()
        for t in self.shards.flat:
            key = (t.device, t.data_ptr())
            if key in seen:
                raise ValueError(
                    f"{what} on a placed tensor whose shards share "
                    "storage (a placement of views); in-place updates "
                    "need shards of their own")
            seen.add(key)

    def add_(self, other: "Placed") -> "Placed":
        if other.mesh != self.mesh or other.spec != self.spec or \
                other.shape != self.shape:
            raise ValueError("add_ needs the same mesh, spec and shape")
        self._own_storage("add_")
        for c in np.ndindex(self.shards.shape):
            self.shards[c].add_(other.shards[c])
        return self

    def zero_(self) -> "Placed":
        self._own_storage("zero_")
        for t in self.shards.flat:
            t.zero_()
        return self

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        """``torch.zeros_like`` shard by shard (the accumulators the
        stage state makes); every other torch function is refused."""
        kwargs = kwargs or {}
        if func is torch.zeros_like and isinstance(args[0], Placed):
            return args[0]._map(lambda t: torch.zeros_like(t, **kwargs))
        raise TypeError(f"{getattr(func, '__name__', func)} is not "
                        "defined on placed tensors; gather first")

    def __repr__(self) -> str:
        return (f"Placed(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"spec={self.spec}, mesh={dict(self.mesh.shape)})")


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    from repro_torch.models.params import tensor_from_numpy
    return tensor_from_numpy(x, "cpu")


def place(x, mesh: Mesh, spec: tuple) -> Placed:
    """Lay ``x`` (a tensor or a host array) out over ``mesh`` by
    ``spec``: a view where a shard's device is ``x``'s, a copy
    elsewhere."""
    x = _as_tensor(x)
    spec = tuple(spec)
    _check_spec(mesh, spec, x.shape)
    out = np.empty(mesh.devices.shape, dtype=object)
    full = tuple(slice(0, n) for n in x.shape)
    rec = _recorder()
    src = None if rec is None else _coord_of(mesh, x.device)
    for c in mesh.coords():
        sl = shard_slices(x.shape, mesh, spec, c)
        piece = x if sl == full else x[sl]
        dev = mesh.devices[c]
        if rec is not None and c != src:
            rec.log("collective-permute", c, _nbytes(piece))
            with at(c):
                piece = piece.to(dev)
        elif piece.device != dev:
            piece = piece.to(dev)
        out[c] = piece
    return Placed(mesh, spec, x.shape, x.dtype, out)


def place_as(x, sharding: NamedSharding) -> Placed:
    """:func:`place` by a :class:`NamedSharding`; a tensor already laid
    out so is returned as is, one laid out otherwise is re-placed."""
    if isinstance(x, Placed):
        if x.mesh == sharding.mesh and x.spec == tuple(sharding.spec):
            return x
        x = gather(x, x.mesh.devices.flat[0])
    return place(x, sharding.mesh, sharding.spec)


def _assemble(chosen: dict, src: dict, ndim: int, prefix: tuple,
              device: torch.device, rec, dst) -> torch.Tensor:
    """The blocks of ``chosen`` under ``prefix`` joined into one tensor
    on ``device`` (a module-level function, not a closure over
    ``chosen``: a closure that calls itself is a reference cycle, which
    keeps the gathered blocks alive until the garbage collector runs)."""
    d = len(prefix)
    if d == ndim:
        t = chosen[prefix]
        if rec is not None and src[prefix] != dst:
            rec.log("all-gather", dst, _nbytes(t))
        return t if t.device == device else t.to(device)
    idx = sorted({k[d] for k in chosen if k[:d] == prefix})
    parts = [_assemble(chosen, src, ndim, prefix + (i,), device, rec, dst)
             for i in idx]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=d)


def gather(p: Placed, device, rows: Optional[tuple[int, int]] = None,
           where: Optional[dict[str, int]] = None) -> torch.Tensor:
    """The full tensor on ``device``, or only rows ``[lo, hi)`` of dim 0,
    or only the blocks the coordinates with ``where``'s axis indices hold
    (a data shard's rows of a batch-sharded tensor): one shard a block
    (a shard already on ``device`` where there is one), copied over and
    concatenated.  A block held whole on ``device`` comes back as that
    shard itself (no copy)."""
    device = norm_device(device)
    nb = _blocks_per_dim(p.mesh, p.spec, p.ndim)
    lo, hi = rows if rows is not None else (0, p.shape[0] if p.ndim else 0)
    step0 = p.shape[0] // nb[0] if p.ndim else 1
    rec = _recorder()
    dst = None if rec is None else _coord_of(p.mesh, device)
    pos = {a: i for i, a in enumerate(p.mesh.axis_names)}
    chosen: dict[tuple[int, ...], torch.Tensor] = {}
    src: dict[tuple[int, ...], tuple] = {}
    for c in p.mesh.coords():
        if where and any(c[pos[a]] != i for a, i in where.items()):
            continue
        b = block_index(p.mesh, p.spec, c, p.ndim)
        if rows is not None and not (b[0] * step0 < hi
                                     and (b[0] + 1) * step0 > lo):
            continue
        cur = chosen.get(b)
        t = p.shards[c]
        if rec is not None:
            better = cur is None or (src[b] != dst and c == dst)
        else:
            better = cur is None or (cur.device != device
                                     and t.device == device)
        if better:
            chosen[b], src[b] = t, c

    out = _assemble(chosen, src, p.ndim, (), device, rec, dst)
    if rows is not None:
        origin = min(k[0] for k in chosen) * step0
        if (lo - origin, hi - origin) != (0, out.shape[0]):
            out = out[lo - origin:hi - origin]
    return out


def scatter_block(x: torch.Tensor, sharding: NamedSharding,
                  shape: Sequence[int], where: dict[str, int],
                  out: Optional[Placed] = None) -> dict:
    """Lay ``x`` -- the part of a tensor of global ``shape`` that the
    coordinates with ``where``'s axis indices hold together (a data
    shard's rows) -- out onto those coordinates by ``sharding``: each
    coordinate gets a copy of its block (a ``collective-permute`` under
    a recorder, but for the current coordinate), written into ``out``'s
    shards in place where ``out`` is given.  Returns ``{coord: block}``
    (the inverse of :func:`gather` with ``where``)."""
    mesh, spec = sharding.mesh, tuple(sharding.spec)
    pos = {a: i for i, a in enumerate(mesh.axis_names)}
    group = [c for c in mesh.coords()
             if all(c[pos[a]] == i for a, i in where.items())]
    nb = _blocks_per_dim(mesh, spec, len(shape))
    blocks = {c: block_index(mesh, spec, c, len(shape)) for c in group}
    origin = [min(b[d] for b in blocks.values()) for d in range(len(shape))]
    rec, here = _recorder(), _REC["coord"]
    placed = {}
    for c in group:
        sl = tuple(slice((b - o) * (n // k), (b - o + 1) * (n // k))
                   for b, o, n, k in zip(blocks[c], origin, shape, nb))
        piece = x[sl]
        if rec is not None and c != here:
            rec.log("collective-permute", c, _nbytes(piece))
        with at(c):
            if out is not None:
                placed[c] = out.shards[c].copy_(piece)
            else:
                placed[c] = piece.to(mesh.devices[c], copy=True)
    return placed


def log_collective(kind: str, coords: Iterable[tuple], nbytes: float
                   ) -> None:
    """Under a recorder, log a collective the caller makes by other
    means (a scalar all-reduce) as received by each of ``coords``."""
    rec = _recorder()
    if rec is not None:
        for c in coords:
            rec.log(kind, c, nbytes)


def gather_tree(tree: Tree, device) -> Tree:
    """Every placed leaf gathered onto ``device``; other leaves as
    they are."""
    return tree_map(lambda a: gather(a, device) if isinstance(a, Placed)
                    else a, tree)


def reduce_scatter_tree(parts: Iterable[Tree], shardings: Tree,
                        dtype: torch.dtype = torch.float64,
                        sources: Optional[Sequence[tuple]] = None,
                        wheres: Optional[Sequence[dict]] = None,
                        shapes: Optional[Tree] = None) -> Tree:
    """Sum partial trees (one a device that computed a part, e.g. a data
    shard's gradients) into placed trees laid out by ``shardings``:
    shard ``c`` of a leaf is the sum of every part's block ``c``, added
    in ``dtype`` in the order the parts come.  The default f64 holds the
    sum of a few f32 parts exactly, so the order of the parts does not
    matter.  ``parts`` may be a generator: each part is folded in and
    dropped before the next is made.  ``sources`` (for the recorder)
    names the coordinate each part was computed on: a block a part
    holds for its own coordinate is not a move.

    Parts are full-shape, unless ``wheres`` names the block each part
    holds (a model shard's gradients, tensor-parallel): part ``k``'s
    leaf is then either the whole leaf or the block that the
    coordinates with ``wheres[k]``'s axis indices hold together, told
    apart by ``shapes`` (a tree of the leaves' global ``torch.Size``),
    or None (a leaf the part's coordinate did not compute with, or a
    subtree it does not hold).  Each coordinate whose shard lies inside
    a part's block adds its piece of it; the sums start at zero."""
    if wheres is not None:
        return _reduce_scatter_blocks(parts, shardings, dtype, sources,
                                      wheres, shapes)
    acc: Optional[Tree] = None
    rec = _recorder()
    src = None

    def moved(c, t: torch.Tensor):
        """The recorder's entry of ``t`` (a part's block) reaching ``c``,
        and the coordinate to run its copy as."""
        if rec is None:
            return contextlib.nullcontext()
        if c != src:
            rec.log("reduce-scatter", c, _nbytes(t))
        return at(c)

    def first(t: torch.Tensor, s: NamedSharding) -> Placed:
        out = np.empty(s.mesh.devices.shape, dtype=object)
        for c in s.mesh.coords():
            sl = shard_slices(t.shape, s.mesh, tuple(s.spec), c)
            with moved(c, t[sl]):
                out[c] = t[sl].to(s.mesh.devices[c], dtype, copy=True)
        return Placed(s.mesh, tuple(s.spec), t.shape, dtype, out)

    def fold(a: Placed, t: torch.Tensor) -> Placed:
        for c in a.mesh.coords():
            sl = shard_slices(t.shape, a.mesh, a.spec, c)
            with moved(c, t[sl]):
                a.shards[c].add_(t[sl].to(a.mesh.devices[c], dtype))
        return a

    for k, part in enumerate(parts):
        src = None if sources is None else tuple(sources[k])
        if acc is None:
            _check_tree(part, shardings)
            acc = tree_map(first, part, shardings)
        else:
            tree_map(fold, acc, part)
        del part                 # dropped before the next part is made
    if acc is None:
        raise ValueError("reduce_scatter_tree got no parts")
    return acc


def _is_sharding(x) -> bool:
    return isinstance(x, NamedSharding)


def _leaves_like(tree: Tree, template: Tree, is_leaf,
                 out: Optional[list] = None) -> list:
    """``tree``'s leaves at ``template``'s leaf positions, None where
    ``tree`` holds no such subtree."""
    out = [] if out is None else out
    if is_leaf(template):
        out.append(tree)
    elif isinstance(template, dict):
        for k in sorted(template):
            _leaves_like(None if tree is None else tree.get(k),
                         template[k], is_leaf, out)
    elif isinstance(template, (list, tuple)):
        for i, v in enumerate(template):
            _leaves_like(None if tree is None else tree[i], v, is_leaf,
                         out)
    return out


def _block_region(shape: Sequence[int], mesh: Mesh, spec: tuple,
                 where: dict[str, int]) -> tuple[slice, ...]:
    """The global slices of the block that the coordinates with
    ``where``'s axis indices hold together (what :func:`gather` with
    ``where`` returns)."""
    pos = {a: i for i, a in enumerate(mesh.axis_names)}
    sls = [shard_slices(shape, mesh, spec, c) for c in mesh.coords()
           if all(c[pos[a]] == i for a, i in where.items())]
    return tuple(slice(min(s[d].start for s in sls),
                       max(s[d].stop for s in sls))
                 for d in range(len(shape)))


def _reduce_scatter_blocks(parts, shardings, dtype, sources, wheres,
                           shapes) -> Tree:
    """:func:`reduce_scatter_tree` over parts that hold blocks."""
    rec = _recorder()
    shs = tree_leaves(shardings, is_leaf=_is_sharding)
    sizes = tree_leaves(shapes, is_leaf=lambda x: isinstance(x, torch.Size))
    acc = []
    for s, shape in zip(shs, sizes):
        out = np.empty(s.mesh.devices.shape, dtype=object)
        for c in s.mesh.coords():
            sl = shard_slices(shape, s.mesh, tuple(s.spec), c)
            with at(c) if rec is not None else contextlib.nullcontext():
                out[c] = torch.zeros([x.stop - x.start for x in sl],
                                     dtype=dtype, device=s.mesh.devices[c])
        acc.append(Placed(s.mesh, tuple(s.spec), shape, dtype, out))
    n = 0
    for k, part in enumerate(parts):
        n += 1
        src = None if sources is None else tuple(sources[k])
        for t, a in zip(_leaves_like(part, shardings, _is_sharding), acc):
            if t is None:
                continue
            region = (tuple(slice(0, d) for d in a.shape)
                      if tuple(t.shape) == tuple(a.shape) else
                      _block_region(a.shape, a.mesh, a.spec, wheres[k]))
            for c in a.mesh.coords():
                sl = shard_slices(a.shape, a.mesh, a.spec, c)
                if any(x.start < r.start or x.stop > r.stop
                       for x, r in zip(sl, region)):
                    continue
                piece = t[tuple(slice(x.start - r.start, x.stop - r.start)
                                for x, r in zip(sl, region))]
                if rec is not None and c != src:
                    rec.log("reduce-scatter", c, _nbytes(piece))
                with at(c) if rec is not None else contextlib.nullcontext():
                    a.shards[c].add_(piece.to(a.mesh.devices[c], dtype))
        del part                 # dropped before the next part is made
    if not n:
        raise ValueError("reduce_scatter_tree got no parts")
    return tree_unflatten_like(shardings, acc, is_leaf=_is_sharding)


def _check_tree(part: Tree, shardings: Tree) -> None:
    tree_map(lambda t, s: _check_spec(s.mesh, tuple(s.spec), t.shape),
             part, shardings)
