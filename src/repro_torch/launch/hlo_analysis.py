"""The dry run's accounting (port of ``repro.launch.hlo_analysis``):
collective bytes, live bytes and counted work a device, and the layer
FLOP probe.

JAX's dry run reads a compiled program: ``compiled.as_text()`` (the
partitioned HLO, whose collectives it parses with their ``while`` trip
counts), ``memory_analysis()`` and ``cost_analysis()``.  The port has no
HLO: it analyses its own step as the step runs on ``meta`` tensors, so
JAX's HLO parsing (``shape_bytes``, ``_while_trip_counts``) has no
counterpart.  Three instruments take its place:

* :func:`collective_bytes` reads a
  :class:`~repro_torch.dist.mesh.CollectiveRecorder`: the payload bytes
  each mesh coordinate receives from the port's mesh helpers, by JAX's
  kinds (:data:`COLLECTIVES`).
* :class:`DeviceLedger` is a ``TorchDispatchMode`` over a call: the live
  bytes of every storage made during the call, held per device (the
  mesh coordinate the call runs as, :func:`repro_torch.dist.mesh.at`, or
  in a backward pass the one its inputs were made on) until the storage
  is freed, rounded as the CUDA caching allocator rounds a block
  (512-byte multiples); their peak; the FLOPs of every aten op that
  ``torch.utils.flop_counter``'s table prices (FlopCounterMode's own
  counts: matmuls, convolutions, attention); the bytes every other op
  reads and writes; and the work the kernels' meta routes report
  (``repro_torch.kernels.meta_call``).  Given ``watch=(device, bytes)``
  (a device and its peak, from a first run of the same step), it also
  keeps what that device holds the first time its live bytes reach
  ``bytes``: each storage's bytes with the op that made it, its shape,
  dtype and pass (:meth:`DeviceLedger.breakdown`).
* :func:`layer_flop_probe` counts one layer of each block kind on meta
  under ``models.probe.probe_mode``, as JAX's does.

JAX corrects its raw counts because XLA counts a ``while`` body once
(:func:`corrected_flops`: ``graph + (n - 1) x layer``).  The port unrolls
its loops in Python, so the ledger sees every op of a step: its counts
need no trip-count correction, and the dry run's record names them
``flops_per_device`` / ``bytes_per_device`` for that reason.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Any, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import kernels
from repro_torch.dist import mesh as mesh_lib
from repro_torch.dist.mesh import COLLECTIVE_KINDS as COLLECTIVES

BLOCK_ROUND = 512          # the CUDA caching allocator's block multiple


def rounded(nbytes: int) -> int:
    """Bytes of the allocator block that holds ``nbytes`` (none for 0)."""
    if nbytes <= 0:
        return 0
    return -(-nbytes // BLOCK_ROUND) * BLOCK_ROUND


def collective_bytes(recorder, coord: Optional[tuple] = None) -> dict:
    """JAX's dict (``counts``, ``bytes``, ``total_bytes``, ``n_ops``) for
    the bytes mesh coordinate ``coord`` receives; None: the coordinate
    that receives the most (named under ``device``)."""
    if coord is None and recorder.bytes:
        coord = max(recorder.bytes,
                    key=lambda c: (sum(recorder.bytes[c].values()), c))
    by = recorder.bytes.get(coord, dict.fromkeys(COLLECTIVES, 0.0))
    n = recorder.counts.get(coord, dict.fromkeys(COLLECTIVES, 0))
    return {"counts": dict(n), "bytes": dict(by),
            "total_bytes": float(sum(by.values())),
            "n_ops": int(sum(n.values())),
            "device": None if coord is None else list(coord)}


def _tensors(items) -> list:
    """The tensors among ``items`` and the lists / tuples in them (an
    aten op's arguments nest no deeper)."""
    out = []
    for a in items:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):    # no storage (sparse)
        return None


class DeviceLedger(TorchDispatchMode):
    """Live bytes, their peak and the counted work a device over the
    block it is entered for (see the module docstring).  Devices are
    mesh coordinates (tuples) where the step runs on a mesh, else the
    tensors' device names; ``home`` stands for a meta tensor made off
    any coordinate."""

    def __init__(self, home: Any = "meta",
                 watch: Optional[tuple] = None):
        super().__init__()
        self.home = home
        self.watch = watch
        self._tags: dict = {}           # storage -> (bytes, tag), watched
        self.at_watch: Optional[list] = None
        self.live: dict = defaultdict(int)
        self.peak: dict = defaultdict(int)
        # every device's live bytes together, and their peak: what one
        # card holds where a virtual mesh lists it for every coordinate
        self.live_total = self.peak_total = 0
        self.flops: dict = defaultdict(float)
        self.bytes: dict = defaultdict(float)
        self.kernel_flops: dict = defaultdict(float)
        self.work_bytes: dict = defaultdict(float)
        self._owner: dict[int, Any] = {}        # storage -> device

    # -------------------------------------------------------- attribution
    def _device_of(self, ins: list, example: torch.Tensor):
        """The coordinate the caller runs as; in a backward pass outside
        any, the device of the largest input made during the call (the
        slot whose saved tensors the op reads); else ``home`` (a meta
        tensor) or the tensor's device."""
        coord = mesh_lib.current_coord()
        if coord is not None:
            return coord
        if torch._C._current_graph_task_id() == -1:
            return self.home if example.device.type == "meta" else \
                str(example.device)
        best, size = None, -1
        for t in ins:
            st = _storage(t)
            if st is None:
                continue
            owner = self._owner.get(st._cdata)
            if owner is not None and st.nbytes() > size:
                best, size = owner, st.nbytes()
        if best is not None:
            return best
        return self.home if example.device.type == "meta" else \
            str(example.device)

    def _free(self, key: int, dev, nbytes: int) -> None:
        self._owner.pop(key, None)
        self._tags.pop(key, None)
        self.live[dev] -= nbytes
        self.live_total -= nbytes

    def _track(self, t: torch.Tensor, dev, seen: set, op: str) -> None:
        st = _storage(t)
        if st is None or st._cdata in seen or st._cdata in self._owner:
            return
        nbytes = rounded(st.nbytes())
        self._owner[st._cdata] = dev
        self.live[dev] += nbytes
        self.peak[dev] = max(self.peak[dev], self.live[dev])
        if self.watch is not None and dev == self.watch[0]:
            backward = torch._C._current_graph_task_id() != -1
            self._tags[st._cdata] = (nbytes, (
                op, tuple(t.shape), str(t.dtype).replace("torch.", ""),
                "backward" if backward else "forward"))
            if self.at_watch is None and self.live[dev] >= self.watch[1]:
                self.at_watch = list(self._tags.values())
        self.live_total += nbytes
        self.peak_total = max(self.peak_total, self.live_total)
        weakref.finalize(st, self._free, st._cdata, dev, nbytes)

    def _work(self, name: str, flops: float, nbytes: float) -> None:
        del name
        dev = mesh_lib.current_coord()
        dev = self.home if dev is None else dev
        self.kernel_flops[dev] += flops
        self.work_bytes[dev] += nbytes

    # ----------------------------------------------------------- the mode
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors((out,))
        if not outs:
            return out
        ins = _tensors(args) + _tensors(kwargs.values())
        dev = self._device_of(ins, outs[0])
        seen = {st._cdata for st in map(_storage, ins) if st is not None}
        packet = func._overloadpacket
        for o in outs:
            self._track(o, dev, seen, packet.__name__)
        if packet in flop_registry:
            if func._overloadname == "dtype":   # mm / bmm with out_dtype
                args, kwargs = args[:2], {}
            self.flops[dev] += float(flop_registry[packet](
                *args, **kwargs, out_val=out))
        if not func.is_view:
            self.bytes[dev] += float(sum(t.numel() * t.element_size()
                                         for t in ins + outs))
        return out

    def __enter__(self):
        kernels.WORK_COUNTERS.append(self._work)
        return super().__enter__()

    def __exit__(self, *exc):
        kernels.WORK_COUNTERS.remove(self._work)
        return super().__exit__(*exc)

    # ------------------------------------------------------------ results
    def total_flops(self, dev) -> float:
        return self.flops.get(dev, 0.0) + self.kernel_flops.get(dev, 0.0)

    def total_bytes(self, dev) -> float:
        return self.bytes.get(dev, 0.0) + self.work_bytes.get(dev, 0.0)

    def breakdown(self) -> list:
        """What the watched device held at its watched bytes, grouped by
        ``(op, shape, dtype, pass)``: ``[bytes, count, op, shape, dtype,
        pass]`` rows, the largest first (empty where it never got
        there)."""
        groups: dict = defaultdict(lambda: [0, 0])
        for nbytes, tag in self.at_watch or []:
            groups[tag][0] += nbytes
            groups[tag][1] += 1
        return sorted(([b, n, op, list(shape), dt, ps] for (
            op, shape, dt, ps), (b, n) in groups.items()), reverse=True)


def active_ledgers() -> list:
    """The :class:`DeviceLedger` s whose block is open."""
    return [fn.__self__ for fn in kernels.WORK_COUNTERS
            if isinstance(getattr(fn, "__self__", None), DeviceLedger)]


# -------------------------------------------------------------- FLOP probe
def layer_flop_probe(cfg, shape) -> dict:
    """One layer of each distinct block kind on meta under
    ``probe_mode`` at the cell's global batch, one device: forward for
    prefill, ``torch.autograd.grad`` of the summed output for train, one
    decode step for decode; per-kind FLOPs (aten + kernels) and the
    reconstruction constants, JAX's keys.  The sLSTM recurrence is added
    analytically (``flops._slstm_flops``), as JAX's is."""
    from repro_torch.models import flops as F
    from repro_torch.models import model as model_lib
    from repro_torch.models import params as P
    from repro_torch.models.blocks import REGISTRY
    from repro_torch.models.probe import probe_mode
    from repro_torch.tree import tree_leaves

    B, S = shape.global_batch, shape.seq_len
    runs = model_lib.segments(cfg.block_kinds)
    kinds = sorted({k for k, _ in runs})
    out = {"kinds": {}, "runs": [[k, n] for k, n in runs],
           "n_layers": cfg.n_layers}
    decode = shape.kind == "decode"
    cd, d = cfg.compute_jdtype, cfg.d_model

    with probe_mode():
        for kind in kinds:
            p = P.abstract(REGISTRY[kind][0](cfg))
            ledger = DeviceLedger()
            with ledger:
                if decode:
                    cache = P.abstract(REGISTRY[kind][3](cfg, B, S))
                    x = torch.empty((B, 1, d), dtype=cd, device="meta")
                    pos = model_lib.decode_positions(cfg, B, S - 1, "meta")
                    y, _ = REGISTRY[kind][2](cfg, p, x, cache, S - 1, pos)
                    y.to(torch.float32).sum()
                else:
                    train = shape.kind == "train"
                    x = torch.empty((B, S, d), dtype=cd, device="meta",
                                    requires_grad=train)
                    leaves = [a.requires_grad_(train) for a in
                              tree_leaves(p)]
                    pos = model_lib.default_positions(cfg, B, S,
                                                      device="meta")
                    with torch.set_grad_enabled(train):
                        y, aux = REGISTRY[kind][1](cfg, p, x, pos)
                        loss = y.to(torch.float32).sum() + aux
                        if train:
                            torch.autograd.grad(loss, [x] + leaves,
                                                allow_unused=True)
            out["kinds"][kind] = ledger.total_flops(ledger.home)
            if kind == "slstm":   # time recurrence: analytic, as JAX's
                mult = 3.0 if shape.kind == "train" else 1.0
                out["kinds"][kind] = F._slstm_flops(cfg) * B * \
                    (1 if decode else S) * mult
    if cfg.encoder_layers:
        out["encoder_note"] = "enc layers approximated by attn kind"
    return out


def corrected_flops(record: dict, chips: int) -> Optional[float]:
    """JAX's reconstruction, ``graph + (n_r - 1) x layer_kind`` for every
    run (probe FLOPs are global, so divided by ``chips``), on a record
    of either dry run: the port's ``flops_per_device`` is already whole,
    so it comes back as it is."""
    if "flops_per_device" in record:
        return float(record["flops_per_device"])
    probe = record.get("probe")
    if not probe:
        return None
    total = float(record["hlo_flops_per_device_raw"])
    for kind, n in probe["runs"]:
        if n > 1:
            total += (n - 1) * probe["kinds"][kind] / chips
    return total
