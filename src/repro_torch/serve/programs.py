"""Session programs: span-parameterized prefill/decode for swarm serving
(port of ``repro.serve.programs``).

A :class:`SessionProgram` fuses stages ``[lo, hi)`` into one ``prefill``
and one ``decode``, parameterized by a tuple of per-stage param trees
(ordered ``lo..hi-1``), so the per-stage-keyed
:class:`~repro_torch.runtime.base.StageState` backs both; the KV caches
live in the state's ``"kv"`` keyed slot.

Caches are allocated at ``total_len`` (the session's full horizon) by
the prefill; decode steps write their row into them in place.  Every
program call runs under ``torch.inference_mode()``.

Programs are cached process-wide, one per ``(config, span, horizon,
codec)`` — N peers of a span share one — and each build is counted in
:func:`repro_torch.runtime.numeric.record_trace`, tagged ``"serve"``.
:func:`full_session_program` wraps the single-process model path in the
same interface: the token-for-token reference the staged swarm is held
against.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Any, Callable, Optional

import torch

from repro_torch.compression import codecs
from repro_torch.models import model as model_lib
from repro_torch.models.config import ArchConfig
from repro_torch.runtime import numeric as numeric_rt
from repro_torch.runtime.stage_model import (_head_logits, _stage_fwd_flops,
                                             _stage_runs)

Tree = Any

# the StageState keyed slot serving KV caches live in (keyed by session)
KV_SLOT = "kv"


@dataclasses.dataclass
class SessionProgram:
    """Stages ``[lo, hi)`` fused into one prefill + one decode.

    ``prefill(params, inp) -> (out, kv)`` — ``inp`` is the token batch
    ``[B, S]`` when the span covers stage 0, the inbound wire tensor
    otherwise; ``out`` is the first generated token ``[B, 1]`` (int32)
    when the span covers the last stage, the full-sequence outbound wire
    tensor otherwise.  ``kv`` is a tuple of per-covered-stage cache
    trees, allocated at ``total_len``.

    ``decode(params, kv, inp, pos) -> (out, kv)`` — one token step at
    write position ``pos`` (an int), the caches updated in place.
    """
    span: tuple[int, int]
    n_stages: int
    total_len: int
    prefill: Callable
    decode: Callable
    flops_per_token: float        # forward flops, summed over the span

    @property
    def stages(self) -> range:
        return range(*self.span)

    @property
    def covers_first(self) -> bool:
        return self.span[0] == 0

    @property
    def covers_last(self) -> bool:
        return self.span[1] == self.n_stages


_SESSIONS: dict[tuple, SessionProgram] = {}
_LOCK = threading.Lock()


def reset_session_cache() -> None:
    with _LOCK:
        _SESSIONS.clear()


def _inference(fn: Callable) -> Callable:
    @functools.wraps(fn)
    def call(*args):
        with torch.inference_mode():
            return fn(*args)
    return call


def _embed_in(cfg: ArchConfig, params: Tree, tokens) -> torch.Tensor:
    return model_lib.embed(cfg, params, tokens)


def _make_stage_prefill(cfg: ArchConfig, s: int, n_stages: int
                        ) -> Callable:
    """Stage ``s``'s wire-to-wire prefill (embed at stage 0) plus
    decode-cache emission at ``cache_len``."""
    _, runs, _ = _stage_runs(cfg, s, n_stages)
    is_first = s == 0

    def stage_prefill(params: Tree, inp, cache_len: int):
        x = (_embed_in(cfg, params, inp) if is_first
             else inp.to(cfg.compute_jdtype))
        positions = torch.arange(x.shape[1], device=x.device)
        return model_lib.prefill_runs(cfg, runs, params["blocks"], x,
                                      positions, cache_len)

    return stage_prefill


def _make_stage_decode(cfg: ArchConfig, s: int, n_stages: int
                       ) -> Callable:
    """Stage ``s``'s one-token decode against its caches."""
    _, runs, _ = _stage_runs(cfg, s, n_stages)
    is_first = s == 0

    def stage_decode(params: Tree, caches: Tree, inp, pos: int):
        x = (_embed_in(cfg, params, inp) if is_first
             else inp.to(cfg.compute_jdtype))
        positions = model_lib.decode_positions(cfg, x.shape[0], pos,
                                               x.device)
        return model_lib.decode_runs(cfg, runs, params["blocks"], caches,
                                     x, pos, positions)

    return stage_decode


def _next_token(cfg: ArchConfig, params: Tree, x: torch.Tensor
                ) -> torch.Tensor:
    logits = _head_logits(cfg, params, x)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def build_session_program(cfg: ArchConfig, n_stages: int,
                          span: tuple[int, int], total_len: int,
                          compress: Optional[str] = None
                          ) -> SessionProgram:
    lo, hi = span
    if not (0 <= lo < hi <= n_stages):
        raise ValueError(f"span [{lo}, {hi}) outside [0, {n_stages})")
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} not "
                         f"divisible by n_stages={n_stages}")
    if cfg.family == "audio":
        raise NotImplementedError(
            "staged serving covers the LM families; audio comes with the "
            "whisper slice")
    model_lib._no_sharing(cfg)
    comp = codecs.resolve_mode(cfg, compress)
    learned = comp in codecs.LEARNED and n_stages > 1
    if learned:
        raise NotImplementedError(
            f"codec {comp!r}: learned codecs come with their slice")
    covers_last = hi == n_stages
    prefs = {s: _make_stage_prefill(cfg, s, n_stages)
             for s in range(lo, hi)}
    decs = {s: _make_stage_decode(cfg, s, n_stages) for s in range(lo, hi)}
    flops = sum(_stage_fwd_flops(cfg, s, n_stages, total_len, comp,
                                 learned) for s in range(lo, hi))

    def prefill_fn(params_by_stage, inp):
        x, kv = inp, []
        for i, s in enumerate(range(lo, hi)):
            x, caches = prefs[s](params_by_stage[i], x, total_len)
            kv.append(caches)
        if covers_last:
            return _next_token(cfg, params_by_stage[-1], x[:, -1:]), \
                tuple(kv)
        return x, tuple(kv)

    def decode_fn(params_by_stage, kv, inp, pos):
        x = inp
        for i, s in enumerate(range(lo, hi)):
            x, _ = decs[s](params_by_stage[i], kv[i], x, int(pos))
        if covers_last:
            return _next_token(cfg, params_by_stage[-1], x), kv
        return x, kv

    return SessionProgram(
        span=(lo, hi), n_stages=n_stages, total_len=total_len,
        prefill=_inference(prefill_fn), decode=_inference(decode_fn),
        flops_per_token=flops)


def get_session_program(cfg: ArchConfig, n_stages: int,
                        span: tuple[int, int], total_len: int,
                        compress: Optional[str] = None) -> SessionProgram:
    """The shared session program for one span and horizon — one build
    per ``(config, span, total_len, codec)`` process-wide."""
    comp = codecs.resolve_mode(cfg, compress)
    key = (cfg, n_stages, tuple(span), total_len, comp)
    with _LOCK:
        prog = _SESSIONS.get(key)
    if prog is not None:
        return prog
    prog = build_session_program(cfg, n_stages, tuple(span), total_len,
                                 compress=comp)
    with _LOCK:
        fresh = key not in _SESSIONS
        prog = _SESSIONS.setdefault(key, prog)
    if fresh:
        tag = (cfg.name, n_stages, total_len, comp, "serve", tuple(span))
        for kind in ("prefill", "decode"):
            numeric_rt.record_trace(tag + (kind,))
    return prog


def full_session_program(cfg: ArchConfig, total_len: int,
                         remat: bool = True) -> SessionProgram:
    """The whole model as one session program — the single-process
    reference path (``make_prefill_step``/``make_serve_step``).  ``kv``
    is a 1-tuple (the model as one "stage")."""
    key = (cfg, "full", total_len, remat)
    with _LOCK:
        prog = _SESSIONS.get(key)
    if prog is not None:
        return prog
    from repro_torch.train.steps import make_prefill_step, make_serve_step
    prefill_step = make_prefill_step(cfg, remat=remat, last_only=True,
                                     cache_len=total_len)
    serve_step = make_serve_step(cfg)

    def prefill_fn(params, tokens):
        nxt, caches = prefill_step(params, {"tokens": tokens})
        return nxt, (caches,)

    def decode_fn(params, kv, token, pos):
        nxt, caches = serve_step(params, kv[0], token, int(pos))
        return nxt.to(torch.int32), (caches,)

    prog = SessionProgram(
        span=(0, 1), n_stages=1, total_len=total_len,
        prefill=_inference(prefill_fn), decode=_inference(decode_fn),
        flops_per_token=_stage_fwd_flops(cfg, 0, 1, total_len, "none",
                                         False))
    with _LOCK:
        fresh = key not in _SESSIONS
        prog = _SESSIONS.setdefault(key, prog)
    if fresh:
        tag = (cfg.name, 1, total_len, "none", "serve", (0, 1))
        for kind in ("prefill", "decode"):
            numeric_rt.record_trace(tag + (kind,))
    return prog
