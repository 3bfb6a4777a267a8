"""Checkpointing: atomic save/restore of host (numpy) trees (port of
``repro.ckpt.checkpoint``).

The on-disk format is the JAX package's, so a checkpoint written by
either package restores in the other: ``{directory}/step_XXXXXXXX/``
holds ``arrays.npz`` (leaf ``i`` under key ``a{i}``; bfloat16 stored as
float32, since npz has no bfloat16) and ``manifest.json`` (``step``,
``paths``, ``dtypes``).  Leaves are ordered as ``jax.tree`` flattens
(dict keys sorted, sequences in order, ``None`` an empty subtree) and
``paths`` are their ``"/"``-joined keys and indices, as JAX's
``_flatten_with_paths`` writes them.  A save goes to a ``.tmp_ckpt_``
directory and is renamed into place, so a reader never sees half of
one.

This module is numpy and file I/O only: device tensors reach it through
an executor's ``snapshot`` (host numpy).  ``restore_checkpoint`` reads
only the shape and dtype of ``like``'s leaves, so ``like`` may hold
tensors anywhere.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np

from repro_torch.tree import tree_unflatten_like

Tree = Any

_MANIFEST = "manifest.json"


def _flatten_with_paths(tree: Tree) -> tuple[list[str], list]:
    """Leaves in ``jax.tree`` order with their key paths."""
    paths, leaves = [], []

    def walk(t, path):
        if t is None:
            return
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (str(k),))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (str(i),))
        else:
            paths.append("/".join(path))
            leaves.append(t)

    walk(tree, ())
    return paths, leaves


def _np_dtype(leaf) -> np.dtype:
    """The numpy dtype of a numpy leaf or of a tensor leaf (read by name,
    so that this module needs no torch)."""
    dt = leaf.dtype
    if isinstance(dt, np.dtype):
        return dt
    name = str(dt).replace("torch.", "")
    if name == "bfloat16":
        import ml_dtypes
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


def save_checkpoint(directory: str, step: int, tree: Tree) -> str:
    """Atomically write ``{directory}/step_{step:08d}`` and return its
    path.  Leaves are numpy arrays or Python scalars."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        paths, leaves = _flatten_with_paths(tree)
        arrays, dtypes = {}, []
        for i, x in enumerate(leaves):
            a = np.asarray(x)
            dtypes.append(str(a.dtype))
            if a.dtype.name == "bfloat16":      # npz has no bf16 cast
                a = a.astype(np.float32)
            arrays[f"a{i}"] = a
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump({"step": step, "paths": paths, "dtypes": dtypes}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def stage_dir(root: str, stage: int) -> str:
    """Per-pipeline-stage checkpoint directory (stages fail, and resume,
    independently)."""
    return os.path.join(root, f"stage_{stage:03d}")


def _step_entries(directory: str) -> list[tuple[int, str]]:
    """``(step, entry_name)`` of the checkpoint dirs under ``directory``,
    sorted by step (an unpadded ``step_3`` is found too)."""
    if not os.path.isdir(directory):
        return []
    return sorted((int(d.split("_")[1]), d) for d in os.listdir(directory)
                  if d.startswith("step_") and d.split("_")[1].isdigit())


def latest_step(directory: str) -> Optional[int]:
    entries = _step_entries(directory)
    return entries[-1][0] if entries else None


def available_steps(directory: str) -> list[int]:
    """All checkpointed steps under ``directory``, ascending.  Consumers
    of one dir per pipeline stage intersect these, so that a cut torn by
    a process killed between per-stage saves is never resumed."""
    return [s for s, _ in _step_entries(directory)]


def _step_path(directory: str, step: int) -> str:
    for s, name in _step_entries(directory):
        if s == step:
            return os.path.join(directory, name)
    raise FileNotFoundError(f"no step_{step} checkpoint under {directory}")


def prune_checkpoints(directory: str, keep: int = 1) -> None:
    """Delete all but the newest ``keep`` step directories."""
    if keep < 1:
        return
    for _, name in _step_entries(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, name), ignore_errors=True)


def restore_checkpoint(directory: str, like: Tree,
                       step: Optional[int] = None) -> tuple[Tree, int]:
    """Restore ``step`` (default: the latest) into the structure of
    ``like``, as host numpy leaves in ``like``'s dtypes (shapes and
    paths validated).  Returns ``(tree, step)``."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = _step_path(directory, step)
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    paths, leaves = _flatten_with_paths(like)
    if paths != manifest["paths"]:
        raise ValueError("checkpoint tree structure mismatch")
    new_leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, leaf in enumerate(leaves):
            arr = data[f"a{i}"]
            want = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
            if tuple(arr.shape) != want:
                raise ValueError(f"shape mismatch at {paths[i]}: "
                                 f"{arr.shape} vs {want}")
            new_leaves.append(arr.astype(_np_dtype(leaf), copy=False)
                              if hasattr(leaf, "dtype") else arr)
    return tree_unflatten_like(like, new_leaves), step
