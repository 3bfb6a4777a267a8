"""The staged reference: fault-free, sequential, one stage at a time
(port of the JAX package's test oracle ``reference_losses``).

Same stage programs, same data order, same params, and the accumulation
and token-weighted averaging conventions of
``SwarmRunner._ar_plan``: per step, every microbatch's gradient is summed
into a per-stage f64 accumulator (order-independent, as
``runtime.base.fold_into``), rounded to the params' dtype, divided by the
step's token count, and the optimizer update is applied as
``p + u.to(p.dtype)``.  The boundary
tensors cross between stages as the stage programs emit them (learned
codecs live inside the programs); the executors' int8 wire codec is not
applied, as in the JAX oracle.  ``SwarmRunner`` runs under churn must
reproduce these per-step losses.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.runtime.stage_model import StageProgram, init_stage_params
from repro_torch.tree import tree_map

Tree = Any


def reference_losses(cfg, programs: list[StageProgram], opt, seed: int,
                     steps: int, seq: int, mb: int, gb: int,
                     data_seed: int = 17, *,
                     params: Optional[list[Tree]] = None,
                     data_fn: Optional[Callable[[int], dict]] = None,
                     device="cuda") -> list[float]:
    """Per-step mean token losses of ``steps`` optimizer steps of ``gb``
    sequences in microbatches of ``mb``.  ``params`` (per-stage trees)
    default to :func:`init_stage_params` from ``seed`` — what a
    ``SwarmRunner(seed=seed)`` installs at step 0; ``data_fn(index)``
    defaults to the port's ``SyntheticLM`` with ``data_seed``."""
    from repro_torch.models.params import resolve_device
    from repro_torch.runtime.base import place
    device = resolve_device(device)
    S = len(programs)
    assert S >= 2
    if params is None:
        params = init_stage_params(programs, seed, device)
    params = [place(p, device) for p in params]
    opt_states = [opt.init(p) for p in params]
    if data_fn is None:
        from repro_torch.data.synthetic import SyntheticLM
        data_fn = SyntheticLM(cfg.vocab_size, seq, mb, seed=data_seed).batch
    idx, losses = 0, []
    for _ in range(steps):
        grads = [tree_map(lambda a: torch.zeros_like(a, dtype=torch.float64),
                          p) for p in params]
        loss_sum, tok = 0.0, 0
        for _ in range(gb // mb):
            b = data_fn(idx)
            idx += 1
            tokens = place(b["tokens"], device)
            labels = place(b["labels"], device)
            xs = [tokens]                  # per-stage boundary inputs
            for s in range(S - 1):
                xs.append(programs[s].fwd(params[s], xs[-1]))
            loss, gx, gp = programs[S - 1].bwd(params[S - 1], xs[-1],
                                               labels)
            tree_map(lambda a, g: a.add_(g), grads[S - 1], gp)
            for s in range(S - 2, 0, -1):
                gx, gp = programs[s].bwd(params[s], xs[s], gx)
                tree_map(lambda a, g: a.add_(g), grads[s], gp)
            _, gp = programs[0].bwd(params[0], xs[0], gx)
            tree_map(lambda a, g: a.add_(g), grads[0], gp)
            del xs, gx, gp
            loss_sum += float(loss)
            tok += mb * seq
        losses.append(loss_sum / tok)
        for s in range(S):
            gm = tree_map(lambda g, p: g.to(p.dtype) / tok, grads[s],
                          params[s])
            upd, opt_states[s] = opt.update(gm, opt_states[s], params[s])
            params[s] = tree_map(lambda p, u: p + u.to(p.dtype),
                                 params[s], upd)
            del gm, upd
        del grads
    return losses
