"""Minimal functional AdamW (optax-style init / update pair; port of
``repro.optim.adamw``).

Pure functions over parameter trees: ``update(grads, state, params)``
returns ``(updates, new_state)`` and the caller applies ``p +
u.to(p.dtype)``, as the JAX package does.  Moments are f32 (or
``state_dtype``), the step count a 0-d int32 tensor on the params'
device, and the arithmetic the JAX package's, in f32.  Delayed parameter
updates (DPU) wrap any of these (:mod:`repro_torch.optim.dpu`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.tree import tree_leaves, tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree], tuple[Tree, Tree]]


def _zeros_like(t: Tree, dtype=torch.float32) -> Tree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=dtype,
                                          device=p.device), t)


def _count0(params: Tree) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _bias_corr(b: float, count: torch.Tensor) -> torch.Tensor:
    """``1 - b ** count`` in f32, as jnp computes ``b ** count`` for an
    int32 count."""
    return 1 - torch.pow(torch.tensor(b, dtype=torch.float32,
                                      device=count.device),
                         count.to(torch.float32))


def adamw(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.01,
          grad_clip: float = 1.0, state_dtype=torch.float32) -> Optimizer:
    """``state_dtype=torch.bfloat16`` halves optimizer memory (moments
    tolerate bf16; the update math still runs in f32)."""
    def init(params: Tree) -> Tree:
        return {"m": _zeros_like(params, state_dtype),
                "v": _zeros_like(params, state_dtype),
                "count": _count0(params)}

    def update(grads: Tree, state: Tree, params: Tree):
        count = state["count"] + 1
        grads = tree_map(lambda g: g.to(torch.float32), grads)
        if grad_clip > 0:
            gnorm = torch.sqrt(sum((g * g).sum()
                                   for g in tree_leaves(grads)))
            scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        m = tree_map(lambda m, g: (b1 * m.to(torch.float32)
                                   + (1 - b1) * g).to(state_dtype),
                     state["m"], grads)
        v = tree_map(lambda v, g: (b2 * v.to(torch.float32)
                                   + (1 - b2) * g * g).to(state_dtype),
                     state["v"], grads)
        c1, c2 = _bias_corr(b1, count), _bias_corr(b2, count)
        updates = tree_map(
            lambda m, v, p: (-lr * ((m.to(torch.float32) / c1)
                                    / (torch.sqrt(v.to(torch.float32) / c2)
                                       + eps)
                                    + weight_decay * p.to(torch.float32))
                             ).to(p.dtype),
            m, v, params)
        return updates, {"m": m, "v": v, "count": count}

    return Optimizer(init, update)
