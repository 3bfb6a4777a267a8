"""FLOP-probe mode (port of ``repro.models.probe``).

The JAX dry run needs the probe because XLA's cost analysis counts a
``while``-loop body once: it lowers a single layer with every inner
chunk loop collapsed to one chunk and reconstructs totals as ``graph +
(L - 1) x layer``.  The port unrolls its loops in Python, so a whole
step's count is complete without it; the probe is kept for the per-layer
counts of :func:`repro_torch.launch.hlo_analysis.layer_flop_probe`, and
honoured where JAX honours it: chunked attention runs as one block
(``models/flash.py``), Mamba and mLSTM as one chunk (``models/ssm.py``).
Outputs are the same function of the inputs with and without it.

The sLSTM time recurrence is sequential by construction; the probe adds
its contribution analytically from :mod:`repro_torch.models.flops`, as
JAX's does.
"""
from __future__ import annotations

import contextlib

_FLAGS = {"probe": False}


def probe_enabled() -> bool:
    return _FLAGS["probe"]


@contextlib.contextmanager
def probe_mode():
    _FLAGS["probe"] = True
    try:
        yield
    finally:
        _FLAGS["probe"] = False
