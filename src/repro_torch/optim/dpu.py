"""Delayed Parameter Updates (Ren et al., 2021), as used by SWARM (§3.2;
port of ``repro.optim.dpu``).

The optimizer step for batch ``t`` is applied while batch ``t+1``
computes — semantically the model at step ``t+1`` still sees the
pre-update parameters of step ``t``.  ``update`` returns the update
computed from the *previous* step's gradients and banks the current
gradients for the next call.  With ``delay=0`` this is the wrapped
optimizer (App. E: disabling DPU makes SWARM fully synchronous).

The first step is selected by a 0-d bool tensor (``have_banked``) with
``torch.where``, as the JAX package selects it with ``jnp.where``: the
arithmetic runs on every call and no branch reads a device value (a
Python ``if`` on a CUDA tensor would wait for the card).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.optim.adamw import Optimizer
from repro_torch.tree import tree_leaves, tree_map

Tree = Any


def delayed_parameter_updates(inner: Optimizer, delay: int = 1
                              ) -> Optimizer:
    if delay == 0:
        return inner

    def init(params: Tree) -> Tree:
        device = tree_leaves(params)[0].device
        return {
            "inner": inner.init(params),
            "banked": tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params),
            "have_banked": torch.zeros((), dtype=torch.bool, device=device),
        }

    def update(grads: Tree, state: Tree, params: Tree):
        banked, have = state["banked"], state["have_banked"]
        upd, inner_state = inner.update(banked, state["inner"], params)
        # first step: no banked grads yet -> a zero update, and the
        # inner state (moments, step count) stays as it was
        upd = tree_map(lambda u: torch.where(have, u, torch.zeros_like(u)),
                       upd)
        new_state = {
            "inner": tree_map(lambda new, old: torch.where(have, new, old),
                              inner_state, state["inner"]),
            "banked": tree_map(lambda g: g.to(torch.float32), grads),
            "have_banked": torch.ones_like(have),
        }
        return upd, new_state

    return Optimizer(init, update)
