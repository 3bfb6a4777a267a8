"""Decoder-LM assembly for serving: embed -> per-run layer walk -> head
(port of ``repro.models.model``).

Layer patterns are grouped into runs of identical block kinds, each run
one stacked ``[n, ...]`` parameter tree, exactly the JAX tree layout.
Where JAX scans over the stack, the port loops over layers and indexes
the stack (``a[i]`` is a view, no copy).  The GSPMD sharding hints
(``dist.constrain``) have no effect on one device and are left out;
``remat`` is accepted and ignored (serving computes no gradients).
ALBERT-shared stacks come with the swarm-1b slice.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.params import ParamSpec
from repro_torch.models import layers as L
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


def _no_sharing(cfg: ArchConfig) -> None:
    if cfg.share_groups:
        raise NotImplementedError(
            f"{cfg.name}: ALBERT-shared layers come with the swarm-1b slice")


def stack_specs(tree: Tree, n: int) -> Tree:
    def s(p: ParamSpec) -> ParamSpec:
        return ParamSpec((n,) + p.shape, p.dtype, p.init,
                         ("layers",) + p.axes, p.scale)
    return tree_map(s, tree, is_leaf=lambda x: isinstance(x, ParamSpec))


def lm_specs(cfg: ArchConfig) -> Tree:
    _no_sharing(cfg)
    d, V, pd = cfg.d_model, cfg.vocab_size, cfg.param_jdtype
    specs: Tree = {
        "embed": ParamSpec((V, d), pd, "embed", ("vocab", "embed")),
        "final_norm": L.norm_specs(cfg),
        "blocks": [stack_specs(REGISTRY[k][0](cfg), n)
                   for k, n in segments(cfg.block_kinds)],
    }
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
    if cfg.rope == "mrope":
        raise NotImplementedError("mrope comes with the VLM slice")
    return torch.arange(seq, device=device) + offset


def layer(tree: Tree, i: int) -> Tree:
    """Layer ``i`` of a stacked ``[n, ...]`` tree (views, no copies)."""
    return tree_map(lambda a: a[i], tree)


def n_stacked(tree: Tree) -> int:
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)[0].shape[0]


def prefill_runs(cfg: ArchConfig, runs, blocks: list, x: torch.Tensor,
                 positions: torch.Tensor, cache_len: int):
    """Walk ``runs`` of stacked blocks over ``x``, emitting each run's
    decode caches stacked ``[n, ...]`` — shared by ``lm_prefill`` and
    the staged session programs."""
    caches = []
    for (kind, _), seg_params in zip(runs, blocks):
        prefill_fn = REGISTRY[kind][4]
        cs = []
        for i in range(n_stacked(seg_params)):
            x, _, c = prefill_fn(cfg, layer(seg_params, i), x, positions,
                                 cache_len)
            cs.append(c)
        caches.append(tree_map(lambda *a: torch.stack(a), cs[0], *cs[1:]))
    return x, caches


def decode_runs(cfg: ArchConfig, runs, blocks: list, caches: list,
                x: torch.Tensor, pos: int, positions: torch.Tensor):
    """One-token walk of ``runs``; each layer writes its cache row in
    place through a view of the stacked cache, so the stacked caches are
    returned as they came."""
    for (kind, _), seg_params, seg_cache in zip(runs, blocks, caches):
        decode_fn = REGISTRY[kind][2]
        for i in range(n_stacked(seg_params)):
            x, _ = decode_fn(cfg, layer(seg_params, i), x,
                             layer(seg_cache, i), pos, positions)
    return x, caches


def lm_prefill(cfg: ArchConfig, params: Tree, tokens: torch.Tensor,
               positions: Optional[torch.Tensor] = None,
               *, cache_len: Optional[int] = None, remat: bool = True,
               last_only: bool = True):
    """Prefill: forward pass + decode-cache emission.  Returns (logits
    [B,S|1,V], caches); caches hand off to ``lm_decode_step`` at
    ``pos = S``."""
    del remat
    _no_sharing(cfg)
    B, S = tokens.shape
    cache_len = cache_len or S
    if positions is None:
        positions = default_positions(cfg, B, S, device=tokens.device)
    x = embed(cfg, params, tokens)
    x, caches = prefill_runs(cfg, segments(cfg.block_kinds),
                             params["blocks"], x, positions, cache_len)
    if last_only:
        x = x[:, -1:]
    return head(cfg, params, x), caches


def decode_positions(cfg: ArchConfig, batch: int, pos: int,
                     device) -> torch.Tensor:
    if cfg.rope == "mrope":
        raise NotImplementedError("mrope comes with the VLM slice")
    return torch.full((batch, 1), pos, dtype=torch.int64, device=device)


def lm_decode_step(cfg: ArchConfig, params: Tree, token: torch.Tensor,
                   caches: Tree, pos: int,
                   positions: Optional[torch.Tensor] = None):
    """One-token decode. token [B,1] -> (logits [B,1,V], caches updated
    in place)."""
    _no_sharing(cfg)
    B = token.shape[0]
    if positions is None:
        positions = decode_positions(cfg, B, pos, token.device)
    x = embed(cfg, params, token)
    x, caches = decode_runs(cfg, segments(cfg.block_kinds),
                            params["blocks"], caches, x, pos, positions)
    return head(cfg, params, x), caches
