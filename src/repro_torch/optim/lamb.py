"""LAMB optimizer (You et al., 2020; port of ``repro.optim.lamb``) — the
paper trains its 1B model with LAMB at batch 16384 (App. G)."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.optim.adamw import Optimizer, _bias_corr, _count0, \
    _zeros_like
from repro_torch.tree import tree_map

Tree = Any


def lamb(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.95,
         eps: float = 1e-6, weight_decay: float = 0.01,
         trust_clip: float = 10.0) -> Optimizer:
    def init(params: Tree) -> Tree:
        return {"m": _zeros_like(params), "v": _zeros_like(params),
                "count": _count0(params)}

    def update(grads: Tree, state: Tree, params: Tree):
        count = state["count"] + 1
        grads = tree_map(lambda g: g.to(torch.float32), grads)
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g,
                     state["v"], grads)
        c1, c2 = _bias_corr(b1, count), _bias_corr(b2, count)

        def upd(m, v, p):
            u = (m / c1) / (torch.sqrt(v / c2) + eps) \
                + weight_decay * p.to(torch.float32)
            pn = torch.sqrt(torch.sum(torch.square(p.to(torch.float32))))
            un = torch.sqrt(torch.sum(torch.square(u)))
            trust = torch.where((pn > 0) & (un > 0),
                                torch.clamp(pn / un, 0.0, trust_clip),
                                torch.ones_like(pn))
            return (-lr * trust * u).to(p.dtype)

        updates = tree_map(upd, m, v, params)
        return updates, {"m": m, "v": v, "count": count}

    return Optimizer(init, update)
