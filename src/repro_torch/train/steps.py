"""Step functions and no-allocation input specs (port of
``repro.train.steps``).

Training: :func:`make_train_step` is the single-process step over the
whole model (``lm_apply`` or, for the audio family, ``whisper_apply``),
with gradient accumulation over microbatches; :func:`make_state` builds
its ``{"params", "opt", "step"}`` state.  Serving:
:func:`make_prefill_step` / :func:`make_serve_step`.  Specs:
:func:`input_specs` gives every input of a cell's step as meta-device
tensors (shapes and dtypes, no storage) where the JAX package has
``ShapeDtypeStruct``s.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs import ShapeSpec
from repro_torch.models import model as model_lib
from repro_torch.models import params as P
from repro_torch.models import whisper as whisper_lib
from repro_torch.models.config import ArchConfig
from repro_torch.optim.adamw import Optimizer
from repro_torch.runtime.stage_model import _grad_leaves, _grads_like
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like

Tree = Any


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Stable mean token CE in f32; logits [B, S, V] (any float), labels
    [B, S] int.  JAX takes the gold logit by a one-hot contraction (it
    partitions under GSPMD); that sum has one non-zero term, so a gather
    gives it bit for bit without a [B, S, V] f32 one-hot."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


def model_specs(cfg: ArchConfig) -> Tree:
    """The whole model's parameter specs: ``whisper_specs`` for the audio
    family, else ``lm_specs`` plus, for a config that declares a
    pipeline depth and a learned codec, the stage-stacked codec pairs
    (``boundary``).  The single-process step carries those with zero
    gradients, but the optimizer still decays them."""
    if cfg.family == "audio":
        return whisper_lib.whisper_specs(cfg)
    specs = model_lib.lm_specs(cfg)
    from repro_torch.compression import codecs  # lazy: codecs imports params
    boundary = codecs.pipeline_boundary_specs(cfg)
    if boundary is not None:
        specs["boundary"] = boundary
    return specs


def cross_entropy_tp(cfg: ArchConfig, ps: list, x: torch.Tensor,
                     labels: torch.Tensor, group) -> torch.Tensor:
    """:func:`cross_entropy` of the head over a data shard's model shards
    (``ps[j]`` shard ``j``'s tree, ``x`` the final hidden state at
    home): vocab-parallel where the head splits
    (``dist.tensor_parallel.vocab_parallel_nll``: no shard holds the
    whole ``[B, S, V]``), else the one-device head and loss at home."""
    from repro_torch.dist import tensor_parallel as tp
    parts = model_lib.head_tp(cfg, ps, x, group)
    if parts is None:
        with group.scope(0):
            return cross_entropy(model_lib.head(cfg, ps[0], x), labels)
    return tp.vocab_parallel_nll(parts, labels, group).mean()


def make_loss_fn(cfg: ArchConfig, remat: bool | str = True, group=None):
    """``loss_fn(params, batch) -> (ce + aux, ce)``; with a
    ``dist.tensor_parallel.Group``, ``params`` is the list of its model
    shards' trees and the step computes tensor-parallel."""
    def loss_fn(params: Tree, batch: Tree):
        if group is not None:
            x, aux = model_lib.lm_apply_tp(
                cfg, params, group, batch["tokens"], batch.get("positions"),
                remat=remat)
            ce = cross_entropy_tp(cfg, params, x, batch["labels"], group)
            return ce + aux, ce
        if cfg.family == "audio":
            logits, aux = whisper_lib.whisper_apply(cfg, params, batch, remat)
        else:
            logits, aux = model_lib.lm_apply(
                cfg, params, batch["tokens"], batch.get("positions"),
                remat=remat)
        ce = cross_entropy(logits, batch["labels"])
        return ce + aux, ce
    return loss_fn


def _split_microbatches(batch: Tree, accum: int) -> Tree:
    """Every leaf ``[B, ...]`` as ``[accum, B / accum, ...]`` (microbatch
    ``j`` the rows ``j * B / accum`` on); M-RoPE ``positions [3, B, S]``
    as ``[accum, 3, B / accum, S]``."""
    def split(name, a):
        if name == "positions":                       # [3, B, S]
            return a.reshape(a.shape[0], accum, a.shape[1] // accum,
                             *a.shape[2:]).transpose(0, 1)
        return a.reshape(accum, a.shape[0] // accum, *a.shape[1:])

    def walk(t, name):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        return split(name, t)
    return walk(batch, None)


def _value_and_grad(loss_fn, params: Tree, batch: Tree):
    """``(loss, ce, grads)``: gradients for every leaf of ``params``
    (``torch.autograd.grad`` over fresh leaves, as the stage programs
    take them; a leaf the loss does not reach gets zeros)."""
    leaves = _grad_leaves(params)
    with torch.enable_grad():
        loss, ce = loss_fn(tree_unflatten_like(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), ce.detach(), _grads_like(params, leaves, grads)


def make_grad_fn(cfg: ArchConfig, remat: bool | str = True,
                 accum: int = 1, group=None):
    """``grad_fn(params, batch) -> (loss, ce, grads)``: the gradients of
    :func:`make_train_step`, with its accumulation over ``accum``
    microbatches.  With a ``dist.tensor_parallel.Group`` the params and
    gradients are lists of its model shards' trees (each shard's
    gradients on its own device)."""
    loss_fn = make_loss_fn(cfg, remat, group)

    def grad_fn(params: Tree, batch: Tree):
        if accum == 1:
            return _value_and_grad(loss_fn, params, batch)
        mbs = _split_microbatches(batch, accum)
        grads = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        ls, cs = [], []
        for j in range(accum):
            l, c, g = _value_and_grad(
                loss_fn, params, tree_map(lambda a: a[j], mbs))
            tree_map(lambda a, g: a.add_(g), grads, g)
            del g
            ls.append(l)
            cs.append(c)
        for a in tree_leaves(grads):
            a.div_(accum)
        return torch.stack(ls).mean(), torch.stack(cs).mean(), grads

    return grad_fn


def make_train_step(cfg: ArchConfig, optimizer: Optimizer,
                    remat: bool | str = True, accum: int = 1):
    """``train_step(state, batch) -> (new_state, {"loss", "ce"})``.

    ``accum > 1``: gradient accumulation over ``accum`` microbatches of
    ``B / accum`` rows, summed in an f32 tree (each microbatch's
    gradients freed once added) and divided by ``accum``; the loss and
    CE are the microbatches' means.  The activation working set scales
    with ``B / accum``.  The step is functional: the new state is new
    storage, and the input state is left as it was (a caller that drops
    it frees it)."""
    grad_fn = make_grad_fn(cfg, remat, accum)

    def train_step(state: Tree, batch: Tree):
        params = state["params"]
        loss, ce, grads = grad_fn(params, batch)
        updates, opt = optimizer.update(grads, state["opt"], params)
        del grads
        new_params = tree_map(lambda p, u: p + u.to(p.dtype),
                              params, updates)
        new_state = {"params": new_params, "opt": opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, "ce": ce}

    return train_step


def _data_shards(group, *cols):
    """``(groups, cols a data shard each, one)``: a ``Group`` is one data
    shard (each of ``cols`` its entry), a list of them the data shards
    of one batch in row order (each of ``cols`` a list a data shard)."""
    if isinstance(group, (list, tuple)):
        return list(group), [list(c) for c in cols], False
    return [group], [[c] for c in cols], True


def _serving_group(cfg: ArchConfig) -> None:
    """Raise unless ``cfg`` serves over model shards: every block kind in
    ``dist.tensor_parallel.SUPPORTED_KINDS``, no encoder."""
    from repro_torch.dist import tensor_parallel as tp
    kinds = set(cfg.block_kinds)
    if cfg.encoder_layers or not kinds <= tp.SUPPORTED_KINDS:
        raise ValueError(f"{cfg.name}: block kinds {sorted(kinds)}, "
                         f"encoder layers {cfg.encoder_layers}: serving "
                         f"over model shards takes "
                         f"{sorted(tp.SUPPORTED_KINDS)} and no encoder")


def make_prefill_step(cfg: ArchConfig, remat: bool = True,
                      last_only: bool = True,
                      cache_len: Optional[int] = None, group=None):
    """Inference prefill: forward + decode-cache emission + first token.
    ``cache_len`` sizes the caches for the session's full horizon.  An
    audio config's batch is ``{"audio_embed", "tokens"}``.

    With a ``dist.tensor_parallel.Group`` the step computes over its
    model shards (``models.model.lm_prefill_tp``): ``params`` is the
    list of their trees and the caches come back as one tree a model
    shard (its block or copy of each cache, as JAX's layout holds it);
    the greedy token is taken at home without gathering the logits
    (``dist.tensor_parallel.vocab_parallel_argmax``).  With a list of
    groups (a batch's data shards, row order) ``params``, ``batch`` and
    both outputs are lists a data shard, and MoE layers route as the
    whole batch would.  Without a group the step is as it was."""
    if group is not None:
        _serving_group(cfg)

    def prefill_step(params: Tree, batch: Tree):
        if group is not None:
            return _prefill_tp(cfg, group, params, batch, cache_len,
                               last_only)
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


def _prefill_tp(cfg: ArchConfig, group, params, batch, cache_len,
                last_only):
    from repro_torch.dist import tensor_parallel as tp
    groups, (pss, batches), one = _data_shards(group, params, batch)
    logits, caches = model_lib.lm_prefill_tp(
        cfg, pss, groups, [b["tokens"] for b in batches],
        [b.get("positions") for b in batches], cache_len=cache_len,
        last_only=last_only)
    nxt = []
    for parts, g in zip(logits, groups):
        tok = tp.vocab_parallel_argmax(
            g.per_shard(lambda j, x: x[:, -1:], parts), g)
        with g.scope(0):
            nxt.append(tok.to(torch.int32))
    return (nxt[0], caches[0]) if one else (nxt, caches)


def _decode_tp(cfg: ArchConfig, group, params, caches, token, pos):
    from repro_torch.dist import tensor_parallel as tp
    groups, (pss, cs, toks), one = _data_shards(group, params, caches,
                                                token)
    logits, cs = model_lib.lm_decode_step_tp(cfg, pss, groups, toks, cs,
                                             pos)
    nxt = []
    for parts, g, t in zip(logits, groups, toks):
        tok = tp.vocab_parallel_argmax(parts, g)
        with g.scope(0):
            nxt.append(tok.to(t.dtype))
    return (nxt[0], cs[0]) if one else (nxt, cs)


def make_serve_step(cfg: ArchConfig, group=None):
    """One greedy decode step: (params, caches, token [B,1], pos) ->
    (next_token [B,1], caches).  With a ``dist.tensor_parallel.Group``
    (or a list of them) as :func:`make_prefill_step` takes one: each
    model shard reads and writes its own caches in place."""
    if group is not None:
        _serving_group(cfg)

    def serve_step(params: Tree, caches: Tree, token: torch.Tensor,
                   pos: int):
        if group is not None:
            return _decode_tp(cfg, group, params, caches, token, pos)
        if cfg.family == "audio":
            logits, caches = whisper_lib.whisper_decode_step(
                cfg, params, token, caches, pos)
        else:
            logits, caches = model_lib.lm_decode_step(
                cfg, params, token, caches, pos)
        nxt = torch.argmax(logits[:, -1:], dim=-1).to(token.dtype)
        return nxt, caches

    return serve_step


def make_state(cfg: ArchConfig, optimizer: Optimizer, seed: int,
               device="cuda") -> Tree:
    """``{"params", "opt", "step"}``: params drawn by ``P.init`` from
    ``seed`` on ``device`` (the card unless the caller names another;
    asking for the card where there is none raises)."""
    params = P.init(seed, model_specs(cfg), device)
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=P.resolve_device(device))}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def make_abstract_state(cfg: ArchConfig) -> Tree:
    """The AdamW train state as meta tensors (no allocation)."""
    aparams = P.abstract(model_specs(cfg))

    def moments():
        return tree_map(lambda p: _meta(p.shape, torch.float32), aparams)
    return {"params": aparams,
            "opt": {"m": moments(), "v": moments(),
                    "count": _meta((), torch.int32)},
            "step": _meta((), torch.int32)}


# ------------------------------------------------------------ input specs
def train_batch_specs(cfg: ArchConfig, shape: ShapeSpec,
                      labels: bool = True) -> Tree:
    B, S = shape.global_batch, shape.seq_len
    batch: Tree = {"tokens": _meta((B, S), torch.int32)}
    if labels:
        batch["labels"] = _meta((B, S), torch.int32)
    if cfg.rope == "mrope":
        batch["positions"] = _meta((3, B, S), torch.int32)
    if cfg.family == "audio":
        # the frontend stub hands over precomputed frame embeddings
        enc = min(S, cfg.encoder_max_len)
        batch["audio_embed"] = _meta((B, enc, cfg.d_model),
                                     cfg.compute_jdtype)
    return batch


def decode_cache_param_specs(cfg: ArchConfig, shape: ShapeSpec) -> Tree:
    """The decode caches' ParamSpec tree (with logical axes)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "audio":
        return whisper_lib.whisper_cache_specs(cfg, B, S)
    return model_lib.lm_cache_specs(cfg, B, S)


def decode_cache_specs(cfg: ArchConfig, shape: ShapeSpec) -> Tree:
    return P.abstract(decode_cache_param_specs(cfg, shape))


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Tree:
    """Every input of the cell's step function, as meta tensors."""
    if shape.kind == "train":
        return {"state": make_abstract_state(cfg),
                "batch": train_batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"params": P.abstract(model_specs(cfg)),
                "batch": train_batch_specs(cfg, shape, labels=False)}
    return {"params": P.abstract(model_specs(cfg)),
            "caches": decode_cache_specs(cfg, shape),
            "token": _meta((shape.global_batch, 1), torch.int32),
            "pos": _meta((), torch.int32)}
