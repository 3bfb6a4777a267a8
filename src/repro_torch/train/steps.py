"""Serving step builders and the model's parameter specs (port of
``make_prefill_step``, ``make_serve_step`` and ``model_specs`` of
``repro.train.steps``, the audio family's whisper branches included;
the single-process training step comes with ROADMAP queue 1 item 8)."""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models import model as model_lib
from repro_torch.models import whisper as whisper_lib
from repro_torch.models.config import ArchConfig

Tree = Any


def model_specs(cfg: ArchConfig) -> Tree:
    """The whole model's parameter specs: ``whisper_specs`` for the audio
    family, else ``lm_specs`` plus, for a config that declares a
    pipeline depth and a learned codec, the stage-stacked codec pairs
    (``boundary``)."""
    if cfg.family == "audio":
        return whisper_lib.whisper_specs(cfg)
    specs = model_lib.lm_specs(cfg)
    from repro_torch.compression import codecs  # lazy: codecs imports params
    boundary = codecs.pipeline_boundary_specs(cfg)
    if boundary is not None:
        specs["boundary"] = boundary
    return specs


def make_prefill_step(cfg: ArchConfig, remat: bool = True,
                      last_only: bool = True,
                      cache_len: Optional[int] = None):
    """Inference prefill: forward + decode-cache emission + first token.
    ``cache_len`` sizes the caches for the session's full horizon.  An
    audio config's batch is ``{"audio_embed", "tokens"}``."""
    def prefill_step(params: Tree, batch: Tree):
        if cfg.family == "audio":
            logits, caches = whisper_lib.whisper_prefill(
                cfg, params, batch, cache_len=cache_len, remat=remat,
                last_only=last_only)
        else:
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
        if cfg.family == "audio":
            logits, caches = whisper_lib.whisper_decode_step(
                cfg, params, token, caches, pos)
        else:
            logits, caches = model_lib.lm_decode_step(
                cfg, params, token, caches, pos)
        nxt = torch.argmax(logits[:, -1:], dim=-1).to(token.dtype)
        return nxt, caches

    return serve_step
