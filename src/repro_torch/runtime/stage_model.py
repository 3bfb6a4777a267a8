"""Partition an ArchConfig into SWARM pipeline stages (port of the
serving half of ``repro.runtime.stage_model``).

Stage 0 owns the embedding, the last stage the final norm + LM head.
The training stage/span programs (forward + recompute backward) come
with the training slice; serving runs the session programs of
:mod:`repro_torch.serve.programs` over the per-stage trees cut here.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.compression import codecs
from repro_torch.models.config import ArchConfig
from repro_torch.models.stage_plan import get_stage_plan
from repro_torch.models import params as P
from repro_torch.models import layers as L
from repro_torch.models import model as model_lib
from repro_torch.models.blocks import REGISTRY
from repro_torch.tree import tree_map

Tree = Any


def _stage_runs(cfg: ArchConfig, s: int, n_stages: int):
    """(kinds, [per-run (kind, count)], reps) for one stage, read off the
    canonical :class:`~repro_torch.models.stage_plan.StagePlan`."""
    spec = get_stage_plan(cfg, n_stages).stages[s]
    return spec.kinds, list(spec.runs), spec.reps


def _stage_specs(cfg: ArchConfig, s: int, n_stages: int) -> Tree:
    """One stage's ParamSpec tree: blocks + edge extras (embed / head)."""
    _, runs, _ = _stage_runs(cfg, s, n_stages)
    specs: Tree = {"blocks": [
        model_lib.stack_specs(REGISTRY[k][0](cfg), n) for k, n in runs]}
    if s == 0:
        specs["embed"] = P.ParamSpec(
            (cfg.vocab_size, cfg.d_model), cfg.param_jdtype, "embed",
            ("vocab", "embed"))
    if s == n_stages - 1:
        specs["final_norm"] = L.norm_specs(cfg)
        if not cfg.tie_embeddings or s != 0:
            specs["head"] = P.ParamSpec(
                (cfg.d_model, cfg.vocab_size), cfg.param_jdtype,
                "normal", ("embed", "vocab"))
    return specs


def _head_logits(cfg: ArchConfig, params: Tree, x: torch.Tensor
                 ) -> torch.Tensor:
    """Final norm + LM head, f32 logits — the last stage's extra
    ownership, shared by the serving session programs."""
    x = L.apply_norm(cfg, params["final_norm"], x)
    w = (params["embed"].T if cfg.tie_embeddings and "head" not in
         params else params["head"])
    return (x @ w.to(x.dtype)).to(torch.float32)


def _stage_fwd_flops(cfg: ArchConfig, s: int, n_stages: int, seq_len: int,
                     comp: str, learned: bool) -> float:
    is_first, is_last = s == 0, s == n_stages - 1
    codec_f = codecs.codec_flops_per_token(
        cfg, comp, sender=learned and not is_last,
        receiver=learned and not is_first)
    return get_stage_plan(cfg, n_stages).stage_flops(s, seq_len) + codec_f


def split_lm_params(cfg: ArchConfig, n_stages: int, params: Tree,
                    compress: Optional[str] = None) -> list[Tree]:
    """Slice a full-model tree (``model.lm_specs`` layout) into per-stage
    trees shaped like :func:`_stage_specs`.

    Every leaf is a VIEW of the full tree: a stage's run of layers lies
    inside one model segment, so its stacked params are ``seg[a:b]``
    slices (the JAX version ``jnp.stack``s per-layer copies).  A staged
    yi-6b swarm therefore costs no parameter memory beyond the full
    tree, and staged prefill/decode see exactly the full model's
    numbers.
    """
    comp = codecs.resolve_mode(cfg, compress)
    if comp in codecs.LEARNED and n_stages > 1:
        raise NotImplementedError(
            "split_lm_params cannot split learned boundary-codec params")
    model_lib._no_sharing(cfg)
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} not "
                         f"divisible by n_stages={n_stages}")
    per = cfg.n_layers // n_stages
    # (segment index, offset within it) of every layer
    where = [(i, j) for i, (_, n) in
             enumerate(model_lib.segments(cfg.block_kinds))
             for j in range(n)]
    out: list[Tree] = []
    for s in range(n_stages):
        blocks, idx = [], s * per
        for _kind, n in model_lib.segments(
                cfg.block_kinds[s * per:(s + 1) * per]):
            seg, off = where[idx]
            blocks.append(tree_map(
                lambda a, _o=off, _n=n: a[_o:_o + _n],
                params["blocks"][seg]))
            idx += n
        st: Tree = {"blocks": blocks}
        if s == 0:
            st["embed"] = params["embed"]
        if s == n_stages - 1:
            st["final_norm"] = params["final_norm"]
            if not cfg.tie_embeddings:
                st["head"] = params["head"]
            elif s != 0:
                st["head"] = params["embed"].T      # view of the table
        out.append(st)
    return out
