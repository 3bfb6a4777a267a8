"""Decoder-LM assembly for serving: embed -> per-run layer walk -> head
(port of ``repro.models.model``).

Layer patterns are grouped into runs of identical block kinds, each run
one stacked ``[n, ...]`` parameter tree, exactly the JAX tree layout.
Where JAX scans over the stack, the port loops over layers and indexes
the stack (``a[i]`` is a view, no copy).  The GSPMD sharding hints
(``dist.constrain``) have no effect on one device and are left out;
``remat`` is accepted and ignored (serving computes no gradients).

ALBERT-style layer sharing (the paper's 1B model, §4.3) stores
``share_groups`` parameter groups and re-applies each ``reps = n_layers
/ share_groups`` times.  Decode caches stay one per application,
stacked group-major as the JAX package stacks them: application ``r``
of group ``g`` is cache row ``g * reps + r``.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.params import ParamSpec
from repro_torch.models import layers as L
from repro_torch.models import rope as rope_lib
from repro_torch.models.blocks import REGISTRY
from repro_torch.tree import tree_map

Tree = Any


def segments(pattern: tuple[str, ...]) -> list[tuple[str, int]]:
    runs: list[tuple[str, int]] = []
    for k in pattern:
        if runs and runs[-1][0] == k:
            runs[-1] = (k, runs[-1][1] + 1)
        else:
            runs.append((k, 1))
    return runs


def stack_specs(tree: Tree, n: int) -> Tree:
    def s(p: ParamSpec) -> ParamSpec:
        return ParamSpec((n,) + p.shape, p.dtype, p.init,
                         ("layers",) + p.axes, p.scale)
    return tree_map(s, tree, is_leaf=lambda x: isinstance(x, ParamSpec))


def _shared_kind(cfg: ArchConfig) -> str:
    """The single block kind of an ALBERT-shared stack."""
    kinds = set(cfg.block_kinds)
    if len(kinds) > 1:
        raise ValueError(
            f"{cfg.name}: share_groups={cfg.share_groups} requires "
            f"a homogeneous stack, got block kinds {sorted(kinds)}")
    return cfg.block_kinds[0]


def _shared_runs(cfg: ArchConfig) -> list[tuple[str, int]]:
    return [(_shared_kind(cfg), cfg.share_groups)]


def model_runs(cfg: ArchConfig) -> tuple[list[tuple[str, int]], int]:
    """The whole model's ``(runs, reps)``: one run of ``share_groups``
    groups applied ``reps`` times each for a shared stack, else the
    pattern's runs applied once."""
    if cfg.share_groups:
        return _shared_runs(cfg), cfg.n_layers // cfg.share_groups
    return segments(cfg.block_kinds), 1


# leaves read in f32 whatever the activation dtype: the norms' scales
# (apply_norm; the rmsnorm kernel takes an f32 scale), the MoE router
# (apply_moe routes in f32) and Mamba's f32 ``a_log`` / ``d_skip`` (used
# uncast by models.ssm, as the JAX package uses them); every other block
# weight is cast to the activation dtype at its matmul, so casting it
# once up front computes the same
_F32_KEYS = frozenset({"ln1", "ln2", "router", "a_log", "d_skip"})


def _cast_tree(tree: Tree, dtype: torch.dtype) -> Tree:
    if isinstance(tree, dict):
        return {key: sub if key in _F32_KEYS else _cast_tree(sub, dtype)
                for key, sub in tree.items()}
    return tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a,
                    tree)


def compute_cast(tree: Tree, dtype: torch.dtype) -> Tree:
    """A block's params with every floating leaf but the f32 ones
    (norms, the MoE router, Mamba's ``a_log`` / ``d_skip``) cast to
    ``dtype`` (a no-op, no copy, where it already has that dtype),
    outside autograd: what each of a shared layer's applications would
    cast at its matmuls, cast once."""
    with torch.no_grad():
        return _cast_tree(tree, dtype)


def lm_specs(cfg: ArchConfig) -> Tree:
    """The full model's parameter specs (an ALBERT-shared stack holds
    ``share_groups`` stacked layers)."""
    d, V, pd = cfg.d_model, cfg.vocab_size, cfg.param_jdtype
    specs: Tree = {
        "embed": ParamSpec((V, d), pd, "embed", ("vocab", "embed")),
        "final_norm": L.norm_specs(cfg),
    }
    if cfg.share_groups:
        if cfg.n_layers % cfg.share_groups:
            raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} not "
                             f"divisible by share_groups="
                             f"{cfg.share_groups}")
        specs["blocks"] = [stack_specs(REGISTRY[_shared_kind(cfg)][0](cfg),
                                       cfg.share_groups)]
    else:
        specs["blocks"] = [stack_specs(REGISTRY[k][0](cfg), n)
                           for k, n in segments(cfg.block_kinds)]
    if not cfg.tie_embeddings:
        specs["head"] = ParamSpec((d, V), pd, "normal", ("embed", "vocab"))
    return specs


def embed(cfg: ArchConfig, params: Tree, tokens: torch.Tensor
          ) -> torch.Tensor:
    x = params["embed"][tokens.long()].to(cfg.compute_jdtype)
    if cfg.scale_embed:
        x = x * (cfg.d_model ** 0.5)
    return x


def head(cfg: ArchConfig, params: Tree, x: torch.Tensor) -> torch.Tensor:
    x = L.apply_norm(cfg, params["final_norm"], x)
    w = (params["embed"].T if cfg.tie_embeddings else params["head"])
    return x @ w.to(x.dtype)


def default_positions(cfg: ArchConfig, batch: int, seq: int, offset=0,
                      device=None) -> torch.Tensor:
    """Prefill positions: ``[S]``, or M-RoPE's text-only ``[3, B, S]``."""
    if cfg.rope == "mrope":
        return rope_lib.default_mrope_positions(batch, seq, offset, device)
    return torch.arange(seq, device=device) + offset


def layer(tree: Tree, i: int) -> Tree:
    """Layer ``i`` of a stacked ``[n, ...]`` tree (views, no copies)."""
    return tree_map(lambda a: a[i], tree)


def n_stacked(tree: Tree) -> int:
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)[0].shape[0]


def _applied(seg_params: Tree, i: int, reps: int, dtype) -> Tree:
    """Layer ``i``'s params as its applications use them: a layer
    applied ``reps`` > 1 times is cast to the activation dtype once, not
    once per application (the same numbers)."""
    p = layer(seg_params, i)
    return compute_cast(p, dtype) if reps > 1 else p


def prefill_runs(cfg: ArchConfig, runs, blocks: list, x: torch.Tensor,
                 positions: torch.Tensor, cache_len: int, reps: int = 1):
    """Walk ``runs`` of stacked blocks over ``x`` (each layer applied
    ``reps`` times), emitting each run's decode caches stacked
    ``[n * reps, ...]`` group-major — shared by ``lm_prefill`` and the
    staged session programs."""
    caches = []
    for (kind, _), seg_params in zip(runs, blocks):
        prefill_fn = REGISTRY[kind][4]
        cs = []
        for i in range(n_stacked(seg_params)):
            p = _applied(seg_params, i, reps, x.dtype)
            for _ in range(reps):
                x, _, c = prefill_fn(cfg, p, x, positions, cache_len)
                cs.append(c)
        caches.append(tree_map(lambda *a: torch.stack(a), cs[0], *cs[1:]))
    return x, caches


def decode_runs(cfg: ArchConfig, runs, blocks: list, caches: list,
                x: torch.Tensor, pos: int, positions: torch.Tensor,
                reps: int = 1):
    """One-token walk of ``runs``; each application writes its cache row
    (``i * reps + r``) in place through a view of the stacked cache, so
    the stacked caches are returned as they came."""
    for (kind, _), seg_params, seg_cache in zip(runs, blocks, caches):
        decode_fn = REGISTRY[kind][2]
        for i in range(n_stacked(seg_params)):
            p = _applied(seg_params, i, reps, x.dtype)
            for r in range(reps):
                x, _ = decode_fn(cfg, p, x, layer(seg_cache, i * reps + r),
                                 pos, positions)
    return x, caches


def lm_prefill(cfg: ArchConfig, params: Tree, tokens: torch.Tensor,
               positions: Optional[torch.Tensor] = None,
               *, cache_len: Optional[int] = None, remat: bool = True,
               last_only: bool = True):
    """Prefill: forward pass + decode-cache emission.  Returns (logits
    [B,S|1,V], caches); caches hand off to ``lm_decode_step`` at
    ``pos = S``."""
    del remat
    B, S = tokens.shape
    cache_len = cache_len or S
    if positions is None:
        positions = default_positions(cfg, B, S, device=tokens.device)
    x = embed(cfg, params, tokens)
    runs, reps = model_runs(cfg)
    x, caches = prefill_runs(cfg, runs, params["blocks"], x, positions,
                             cache_len, reps)
    if last_only:
        x = x[:, -1:]
    return head(cfg, params, x), caches


def decode_positions(cfg: ArchConfig, batch: int, pos: int,
                     device) -> torch.Tensor:
    """One decode step's positions: ``[B, 1]``, or ``[3, B, 1]``
    (M-RoPE)."""
    shape = (3, batch, 1) if cfg.rope == "mrope" else (batch, 1)
    return torch.full(shape, pos, dtype=torch.int64, device=device)


def lm_decode_step(cfg: ArchConfig, params: Tree, token: torch.Tensor,
                   caches: Tree, pos: int,
                   positions: Optional[torch.Tensor] = None):
    """One-token decode. token [B,1] -> (logits [B,1,V], caches updated
    in place)."""
    B = token.shape[0]
    if positions is None:
        positions = decode_positions(cfg, B, pos, token.device)
    x = embed(cfg, params, token)
    runs, reps = model_runs(cfg)
    x, caches = decode_runs(cfg, runs, params["blocks"], caches, x, pos,
                            positions, reps)
    return head(cfg, params, x), caches
