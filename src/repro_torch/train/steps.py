"""Serving step builders (port of ``make_prefill_step`` and
``make_serve_step`` of ``repro.train.steps``; the training step comes
with the training slice)."""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models import model as model_lib
from repro_torch.models.config import ArchConfig

Tree = Any


def make_prefill_step(cfg: ArchConfig, remat: bool = True,
                      last_only: bool = True,
                      cache_len: Optional[int] = None):
    """Inference prefill: forward + decode-cache emission + first token.
    ``cache_len`` sizes the caches for the session's full horizon."""
    def prefill_step(params: Tree, batch: Tree):
        logits, caches = model_lib.lm_prefill(
            cfg, params, batch["tokens"], batch.get("positions"),
            cache_len=cache_len, remat=remat, last_only=last_only)
        nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return nxt, caches

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """One greedy decode step: (params, caches, token [B,1], pos) ->
    (next_token [B,1], caches)."""
    def serve_step(params: Tree, caches: Tree, token: torch.Tensor,
                   pos: int):
        logits, caches = model_lib.lm_decode_step(
            cfg, params, token, caches, pos)
        nxt = torch.argmax(logits[:, -1:], dim=-1).to(token.dtype)
        return nxt, caches

    return serve_step
