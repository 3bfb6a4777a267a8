"""The stage-runtime layer: what a SWARM peer runs (port of
``repro.runtime.base``).

Executors are stateless with respect to progress: all mutable state
lives in the :class:`StageState` the scheduler hands in, so N peers of
one stage share one executor.  ``snapshot``/``restore`` speak host-side
numpy trees in the JAX package's format (``{"params", "opt", "version"}``
plus optional ``"slots"``), so a snapshot taken by either package
restores in the other.

Placement is the executor's device: a numpy leaf is copied onto it, a
tensor already there is installed as is (aliased, no copy — the torch
counterpart of ``jnp.asarray`` on a device array).  Serving peers of a
yi-6b chain therefore hold views of the one full parameter tree.

``fold_into`` folds microbatch gradients into a state's accumulator;
``wire_fwd_codec`` / ``wire_bwd_codec`` are the int8 wire of both
directions; ``dispatched`` is the collect half of the executors'
``dispatch_fwd`` / ``dispatch_bwd`` pair.
"""
from __future__ import annotations

from typing import Any, Callable, Hashable, Iterable, Optional, Protocol, \
    runtime_checkable

import numpy as np
import torch

from repro_torch.models.params import tensor_from_numpy, to_numpy_tree
from repro_torch.tree import tree_map

Tree = Any

# slot names with executor-protocol semantics of their own: "grads" is
# the per-stage gradient accumulator, "opt" the optimizer state.  They
# travel in the snapshot's TOP-LEVEL fields ("opt"; grads never travel),
# not under "slots".
GRADS_SLOT = "grads"
OPT_SLOT = "opt"
CORE_SLOTS = (GRADS_SLOT, OPT_SLOT)


class StageState:
    """Replicated executor-owned state for one pipeline stage — or, for
    a span backend, the per-stage-keyed bundle of them (``per_stage``).

    Besides ``params``, everything an executor owns for a stage lives in
    named keyed slots — ``slots[name]`` is a ``{key: tree}`` dict:
    ``slots["grads"]["acc"]`` (the gradient accumulator, ``grad_acc``),
    ``slots["opt"]["state"]`` (``opt``) and, for serving,
    ``slots["kv"]`` keyed by session id.  ``stage_view(s)`` returns
    ``self`` on single-stage states and the stage-``s`` sub-state on
    span states.
    """

    def __init__(self, params: Tree = None, opt: Tree = None,
                 grad_acc: Tree = None, loss_sum: float = 0.0,
                 token_count: int = 0, version: int = 0,
                 per_stage: Optional[dict[int, "StageState"]] = None):
        self.params = params
        self.slots: dict[str, dict[Hashable, Tree]] = {}
        if opt is not None:
            self.opt = opt
        if grad_acc is not None:
            self.grad_acc = grad_acc
        self.loss_sum = loss_sum
        self.token_count = token_count
        self.version = version
        self.per_stage = per_stage

    # ------------------------------------------------------------- slots
    def slot(self, name: str) -> dict[Hashable, Tree]:
        """The named keyed slot, created empty on first touch."""
        return self.slots.setdefault(name, {})

    def drop_slot(self, name: str, key: Optional[Hashable] = None) -> None:
        """Forget one entry (``key``) or the whole slot (``key=None``)."""
        if key is None:
            self.slots.pop(name, None)
            return
        ent = self.slots.get(name)
        if ent is not None:
            ent.pop(key, None)
            if not ent:
                del self.slots[name]

    @property
    def opt(self) -> Tree:
        return self.slots.get(OPT_SLOT, {}).get("state")

    @opt.setter
    def opt(self, value: Tree) -> None:
        if value is None:
            self.slots.pop(OPT_SLOT, None)
        else:
            self.slot(OPT_SLOT)["state"] = value

    @property
    def grad_acc(self) -> Tree:
        return self.slots.get(GRADS_SLOT, {}).get("acc")

    @grad_acc.setter
    def grad_acc(self, value: Tree) -> None:
        if value is None:
            self.slots.pop(GRADS_SLOT, None)
        else:
            self.slot(GRADS_SLOT)["acc"] = value

    # ------------------------------------------------------------- views
    def stage_view(self, stage: Optional[int] = None) -> "StageState":
        if self.per_stage is None or stage is None:
            return self
        return self.per_stage[stage]

    def views(self) -> list["StageState"]:
        return (list(self.per_stage.values()) if self.per_stage is not None
                else [self])

    def zero_grads(self):
        if self.per_stage is not None:
            for st in self.per_stage.values():
                st.zero_grads()
        if self.grad_acc is not None:
            tree_map(lambda g: g.zero_(), self.grad_acc)   # in place
        self.loss_sum = 0.0
        self.token_count = 0

    def reset_progress(self):
        """Fresh accumulator (zeros shaped/placed like ``params``) and
        cleared loss/token counters — the tail of every state install,
        as in the JAX package.  Non-core slots (serving KV) are
        untouched."""
        self.grad_acc = tree_map(torch.zeros_like, self.params)
        self.loss_sum = 0.0
        self.token_count = 0


@runtime_checkable
class StageExecutor(Protocol):
    """How a peer runs its pipeline stages (the JAX package's protocol).

    ``dispatch_fwd`` / ``dispatch_bwd`` launch the span's program NOW and
    return a zero-argument *collect* thunk for its result: the async
    tick's executor-side lever.  ``collect()`` equals ``run_fwd`` /
    ``run_bwd`` on the same arguments (same kernels, same order, same
    bits); see :func:`dispatched` for what it waits on."""

    stage: int
    stages: range
    n_stages: int
    compress_mode: str
    quant_block: int
    device: torch.device
    fwd_flops_per_token: float

    def for_span(self, span: range) -> "StageExecutor": ...

    def session_program(self, total_len: int): ...

    def run_fwd(self, state: StageState, inp: Tree,
                labels: Optional[torch.Tensor] = None) -> Tree: ...

    def run_bwd(self, state: StageState, inp: Tree,
                dy: Optional[Tree] = None,
                labels: Optional[torch.Tensor] = None): ...

    def dispatch_fwd(self, state: StageState, inp: Tree,
                     labels: Optional[torch.Tensor] = None
                     ) -> Callable[[], Tree]: ...

    def dispatch_bwd(self, state: StageState, inp: Tree,
                     dy: Optional[Tree] = None,
                     labels: Optional[torch.Tensor] = None
                     ) -> Callable[[], tuple]: ...

    def wire_fwd(self, y: Tree) -> Tree: ...

    def wire_bwd(self, gx: Tree) -> Tree: ...

    def accumulate(self, state: StageState, gp: Optional[Tree],
                   loss: Optional[float], n_tokens: int,
                   stage: Optional[int] = None) -> None: ...

    def export_grads(self, state: StageState,
                     stage: Optional[int] = None) -> Tree: ...

    def export_state(self, state: StageState,
                     stage: Optional[int] = None): ...

    def adopt_step(self, state: StageState, new_params: Tree,
                   new_opt: Tree, stage: Optional[int] = None) -> None: ...

    def snapshot(self, state: StageState, stage: Optional[int] = None,
                 slots: Iterable[str] = ()) -> Tree: ...

    def restore(self, state: StageState, snap: Tree,
                stage: Optional[int] = None,
                slots: Iterable[str] = ()) -> None: ...

    def export_slot(self, state: StageState, name: str, key: Hashable,
                    stage: Optional[int] = None) -> Tree: ...

    def install_slot(self, state: StageState, name: str, key: Hashable,
                     value: Tree, stage: Optional[int] = None) -> None: ...

    def drop_slot(self, state: StageState, name: str,
                  key: Optional[Hashable] = None,
                  stage: Optional[int] = None) -> None: ...


def dispatched(out: Any, device: torch.device) -> Callable[[], Any]:
    """The collect thunk of a launched program: ``out`` holds the results
    of kernels the caller has just launched on its current stream.

    On the card a ``torch.cuda.Event`` is recorded behind those launches
    and ``collect()`` makes the *consumer's* current stream wait on it
    (``wait_event``): device-side ordering, never a host wait — neither
    ``torch.cuda.synchronize`` nor ``.item()``.  The program runs on the
    caller's stream, not on a side stream: outputs made on a side stream
    would need ``record_stream`` for the caching allocator, and a side
    stream buys nothing here, since the trainer collects at once, as the
    JAX package's does.  (On one stream the wait is already satisfied;
    it keeps the thunk right for a consumer on another stream.)  On the
    CPU the work is done when the launch returns, so ``collect`` just
    hands ``out`` over, as JAX's synchronous backends do.  The event
    stays reachable as ``collect.event``."""
    if device.type != "cuda":
        return lambda: out
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))

    def collect():
        torch.cuda.current_stream(device).wait_event(ev)
        return out
    collect.event = ev
    return collect


def place(tree: Tree, device: torch.device) -> Tree:
    """Put every leaf of a numpy-or-tensor tree on ``device``.  A tensor
    already there is returned as is (aliased: no copy); numpy leaves
    and tensors elsewhere are copied over."""
    def one(a):
        if isinstance(a, torch.Tensor):
            return a if a.device == device else a.to(device)
        if isinstance(a, np.ndarray) or hasattr(a, "__array__"):
            return tensor_from_numpy(a, device)
        return a
    return tree_map(one, tree)


def host_snapshot(state: StageState, slots: Iterable[str] = ()) -> Tree:
    """Default single-stage ``snapshot``: params/opt as host numpy, plus
    any requested non-core ``slots`` present on the state."""
    snap = {"params": to_numpy_tree(state.params),
            "opt": to_numpy_tree(state.opt),
            "version": state.version}
    extra = {name: {k: to_numpy_tree(v)
                    for k, v in state.slots[name].items()}
             for name in slots
             if name not in CORE_SLOTS and name in state.slots}
    if extra:
        snap["slots"] = extra
    return snap


def install_snapshot(state: StageState, snap: Tree, device: torch.device,
                     slots: Iterable[str] = ()) -> None:
    """Default single-stage ``restore`` body: install params/opt/version
    on ``device`` (see :func:`place`), replace the state's non-core slots
    with the requested ones from the snapshot, and reset progress."""
    state.params = place(snap["params"], device)
    state.opt = (place(snap["opt"], device)
                 if snap.get("opt") is not None else None)
    state.version = int(snap.get("version", 0))
    for name in [n for n in state.slots if n not in CORE_SLOTS]:
        del state.slots[name]
    carried = snap.get("slots", {})
    for name in slots:
        if name in CORE_SLOTS or name not in carried:
            continue
        state.slot(name).update(
            {k: place(v, device) for k, v in carried[name].items()})
    state.reset_progress()


def slot_export(view: StageState, name: str, key: Hashable) -> Tree:
    """Default ``export_slot`` body over one stage view (host numpy)."""
    return to_numpy_tree(view.slot(name)[key])


def slot_install(view: StageState, name: str, key: Hashable, value: Tree,
                 device: torch.device) -> None:
    """Default ``install_slot`` body over one stage view."""
    view.slot(name)[key] = place(value, device)


def single_stage(ex: StageExecutor, stage: Optional[int]) -> None:
    """Guard for single-stage backends' ``stage=`` keywords."""
    if stage is not None and stage != ex.stage:
        raise ValueError(
            f"{type(ex).__name__} serves stage {ex.stage}, not {stage}")


def fold_into(state: StageState, gp: Optional[Tree],
              loss: Optional[float], n_tokens: int) -> None:
    """Default ``accumulate``: fold one microbatch gradient + bookkeeping
    into ``state``.

    The accumulator is f64 from a round's first fold on (the zeros
    ``reset_progress`` leaves, in the params' dtype, are replaced), and
    later folds add in place.  The f64 sum of a round's few f32
    gradients is order-independent: it is exact while an element's
    addends lie within f64's 29 extra bits of exponent spread, as a
    round's few microbatches do.  So its value does not depend on the
    order the microbatches arrive in or on how they split across a
    stage's peers: a round with a dead peer's microbatches recomputed by
    a survivor gives the fault-free round's gradient bit for bit.  This
    departs from the JAX package, which adds in f32 in arrival order
    (bf16 compute turns that last-bit difference into a visible loss
    difference within two steps), and costs the slots twice the params'
    f32 bytes.  ``SwarmRunner`` rounds the sum to the params' dtype
    before averaging."""
    if gp is not None:
        if state.token_count == 0:
            state.grad_acc = tree_map(lambda b: b.to(torch.float64), gp)
        else:
            tree_map(lambda a, b: a.add_(b), state.grad_acc, gp)
    state.token_count += n_tokens
    if loss is not None:
        state.loss_sum += loss


def _int8_roundtrip_tree(tree: Tree, quant_block: int) -> Tree:
    """int8-round-trip every floating leaf of a wire payload, passing
    integer leaves through: the CUDA single-launch round trip on CUDA
    tensors, the plain one on CPU tensors (same codes)."""
    from repro_torch.kernels.boundary.ops import int8_roundtrip
    return tree_map(lambda a: int8_roundtrip(a, quant_block, quant_block),
                    tree)


def wire_fwd_codec(ex: StageExecutor, y: Tree) -> Tree:
    """Shared ``wire_fwd`` codec step: int8 quantize-on-send on live
    span-edge boundaries.  Learned codecs already emitted the c-dim wire
    tensor inside the stage program; ``none`` crosses raw; a span ending
    at the pipeline's last stage emits tokens or a loss, not a
    boundary."""
    if ex.compress_mode == "int8" and ex.stages.stop < ex.n_stages:
        return _int8_roundtrip_tree(y, ex.quant_block)
    return y


def wire_bwd_codec(ex: StageExecutor, gx: Optional[Tree]
                   ) -> Optional[Tree]:
    """Shared ``wire_bwd`` codec step: int8 quantizes the boundary
    cotangent (None when the span starts at stage 0 — nothing crosses
    back)."""
    if gx is not None and ex.compress_mode == "int8":
        return _int8_roundtrip_tree(gx, ex.quant_block)
    return gx
