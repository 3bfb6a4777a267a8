"""Hand-written CUDA kernels for the Hopper port, each beside its plain
PyTorch version.

A wrapper given a CUDA tensor launches its kernel (built on first use by
:mod:`repro_torch.kernels._lib`) or raises; given a CPU tensor it runs
the plain version.  It never falls back from the card to the plain
version.  ``LAUNCHES`` counts the kernel launches of each wrapper; it
moves only where a kernel is launched.

Given a ``meta`` tensor (the dry run, :mod:`repro_torch.launch.dryrun`)
a wrapper takes its *meta route*: the CUDA route's argument checks, the
CUDA route's allocations (outputs and scratch) on ``meta``, no launch
and no computation.  It counts the call in ``META_CALLS`` and hands the
kernel's work (operations and bytes, the reckoning of the kernel
table's bound column) to every active work counter (:func:`meta_call`).
Meta holds no data, so nothing is computed and nothing is hidden: the
meta route is the kernel's account, not a fallback, and ``LAUNCHES``
never moves on it.  The plain version would be the wrong account: the
plain flash forward materialises score blocks that the kernel never
writes to memory.
"""
from __future__ import annotations

from typing import Callable

LAUNCHES: dict[str, int] = {"flash_attention_fwd": 0, "rmsnorm": 0,
                            "qdq_flat": 0, "encode": 0, "decode": 0,
                            "encode_quantize": 0, "dequantize_decode": 0,
                            "quant8_quantize": 0, "quant8_dequantize": 0}
META_CALLS: dict[str, int] = dict.fromkeys(LAUNCHES, 0)

# active work counters: called as fn(kernel, flops, nbytes) per meta call
WORK_COUNTERS: list[Callable[[str, float, float], None]] = []


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def reset_meta_calls() -> None:
    for k in META_CALLS:
        META_CALLS[k] = 0


def meta_call(name: str, flops: float, nbytes: float) -> None:
    """Count one meta-route call of kernel ``name`` and its work."""
    META_CALLS[name] += 1
    report_work(name, flops, nbytes)


def report_work(name: str, flops: float, nbytes: float) -> None:
    """Hand work done on meta without aten ops (a kernel's meta route, a
    stand-in of the models' own) to every active work counter."""
    for fn in WORK_COUNTERS:
        fn(name, float(flops), float(nbytes))


def route(t, name: str) -> str:
    """``"cpu"`` (the plain version), ``"cuda"`` (launch) or ``"meta"``
    (the meta route) for a call on ``t``'s device; any other device
    raises."""
    kind = t.device.type
    if kind not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return kind
