"""Mesh construction (port of ``repro.launch.mesh``).

Functions, never module-level constants: importing this module touches
no device.  Each takes the local CUDA devices unless the caller passes
``devices``; where they are fewer than the mesh needs it raises a
``ValueError`` naming both counts, and never builds a smaller mesh or
moves to the CPU.  A caller that wants a virtual mesh passes the devices
itself: ``devices=[torch.device("cpu")] * 8``, ``[cuda:0] * 4``.  The
JAX package's ``enable_async_xla_flags`` has no counterpart (XLA only).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.dist.mesh import Mesh


def _devices(need: int, devices: Optional[Sequence], what: str) -> list:
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)]
        where = "local CUDA devices"
    else:
        devices = list(devices)
        where = "devices given"
    if need < 1 or len(devices) < need:
        raise ValueError(f"{what} needs {max(need, 1)} devices; "
                         f"{len(devices)} {where}")
    return devices[:need]


def _mesh(shape: tuple, axes: Sequence[str], devices: Optional[Sequence],
          what: str) -> Mesh:
    devs = _devices(math.prod(shape), devices, what)
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """16 x 16 = 256 devices a pod, 2 pods multi-pod.  Axes: ``pod``
    carries pipeline stages (training) or folds into data parallelism
    (inference), ``data`` is FSDP / batch, ``model`` TP storage / EP."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, devices, "the production mesh")


def make_debug_mesh(shape=(2, 2), axes=("data", "model"),
                    devices: Optional[Sequence] = None) -> Mesh:
    """A small mesh for tests."""
    return _mesh(tuple(shape), axes, devices, f"a {tuple(shape)} mesh")


def make_peer_mesh(n_devices: int = 0, axes=("data",),
                   devices: Optional[Sequence] = None) -> Mesh:
    """A mesh-backed SWARM peer's mesh
    (:class:`repro_torch.runtime.mesh.MeshExecutor`): the first
    ``n_devices`` devices (0: all of them) on the first of ``axes``, the
    others of size 1 — the peer runs its stage data-parallel over
    them."""
    what = f"a {n_devices}-device peer mesh" if n_devices else \
        "a peer mesh of every device"
    if n_devices == 0:
        n_devices = len(devices) if devices is not None else (
            torch.cuda.device_count() if torch.cuda.is_available() else 0)
    shape = (n_devices,) + (1,) * (len(axes) - 1)
    return _mesh(shape, axes, devices, what)
