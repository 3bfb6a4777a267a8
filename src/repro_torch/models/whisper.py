"""Whisper-style encoder-decoder backbone (port of
``repro.models.whisper``).

The conv audio frontend is a stub, as in the JAX package: the caller
supplies precomputed frame embeddings ``[B, S_enc, d]``.  Sinusoidal
positions are added to both streams.  Decode caches the decoder
self-attention KV ring plus the *precomputed* cross-attention K/V.

Where JAX scans the stacked ``enc_blocks`` / ``dec_blocks``, the port
loops over layers and indexes the stack (views), as
:mod:`repro_torch.models.model` walks its stacks.  Under autograd
``encode`` / ``dec_scan`` / ``decode_train`` checkpoint each block
unless ``remat`` is ``False`` or ``"none"`` (JAX's
``jax.checkpoint(body)``); the stage programs pass ``False`` (a stage's
``bwd`` is itself the recompute), and ``whisper_prefill`` computes no
gradient and ignores it.  Every attention over a full sequence goes through
:func:`repro_torch.models.flash.flash_attention` (the CUDA kernel on a
CUDA tensor): the encoder's bidirectional self-attention, the decoder's
causal self-attention and its cross-attention (``causal=False``, Sq
decoder tokens against Sk encoder frames).  A decode step's
cross-attention reads the cached K/V of every frame through the plain
:func:`~repro_torch.models.attention.decode_attention`, as the JAX
package's does.
"""
from __future__ import annotations

import functools
from typing import Any, Optional

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import flash as flash_lib
from repro_torch.models import layers as L
from repro_torch.models import model as model_lib
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import ParamSpec
from repro_torch.tree import tree_map

Tree = Any

# the decode step's position table is capped here (JAX slices a row of
# a table of this many rows, or of max_seq_len when that is smaller)
DECODE_TABLE_ROWS = 1 << 16


def _sinusoid_rows(pos: torch.Tensor, d: int, dtype) -> torch.Tensor:
    """Rows ``pos`` (f32 column ``[n, 1]``) of the sinusoid table: the
    same elementwise f32 ops for any set of rows, so a row computed
    alone equals that row of the whole table."""
    c = torch.log(torch.tensor(10000.0, device=pos.device)) / d
    div = torch.exp(torch.arange(0, d, 2, device=pos.device,
                                 dtype=torch.float32) * -c)
    pe = torch.zeros((pos.shape[0], d), dtype=torch.float32,
                     device=pos.device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


def sinusoid(seq: int, d: int, dtype, device=None) -> torch.Tensor:
    """The ``[seq, d]`` sinusoid position table in ``dtype``."""
    pos = torch.arange(seq, device=device, dtype=torch.float32)[:, None]
    return _sinusoid_rows(pos, d, dtype)


def _xattn_specs(cfg: ArchConfig) -> Tree:
    d, H, hd, pd = cfg.d_model, cfg.n_heads, cfg.hd, cfg.param_jdtype
    return {
        "wq": ParamSpec((d, H, hd), pd, axes=("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, H, hd), pd, axes=("embed", "heads", "head_dim")),
        "wv": ParamSpec((d, H, hd), pd, axes=("embed", "heads", "head_dim")),
        "wo": ParamSpec((H, hd, d), pd, axes=("heads", "head_dim", "embed")),
    }


def enc_block_specs(cfg: ArchConfig) -> Tree:
    return {"ln1": L.norm_specs(cfg), "attn": L.attn_specs(cfg),
            "ln2": L.norm_specs(cfg), "mlp": L.ffn_specs(cfg)}


def dec_block_specs(cfg: ArchConfig) -> Tree:
    return {"ln1": L.norm_specs(cfg), "attn": L.attn_specs(cfg),
            "lnx": L.norm_specs(cfg), "xattn": _xattn_specs(cfg),
            "ln2": L.norm_specs(cfg), "mlp": L.ffn_specs(cfg)}


def whisper_specs(cfg: ArchConfig) -> Tree:
    d, V, pd = cfg.d_model, cfg.vocab_size, cfg.param_jdtype
    return {
        "embed": ParamSpec((V, d), pd, "embed", ("vocab", "embed")),
        "enc_blocks": model_lib.stack_specs(enc_block_specs(cfg),
                                            cfg.encoder_layers),
        "enc_norm": L.norm_specs(cfg),
        "dec_blocks": model_lib.stack_specs(dec_block_specs(cfg),
                                            cfg.n_layers),
        "final_norm": L.norm_specs(cfg),
        "head": ParamSpec((d, V), pd, "normal", ("embed", "vocab")),
    }


def _cross_kv(cfg: ArchConfig, p: Tree, enc_out: torch.Tensor):
    """Cross-attention K, V ``[B, S_enc, H, hd]`` from the encoder
    output."""
    return L._proj(enc_out, p["wk"]), L._proj(enc_out, p["wv"])


def _cross_attend(cfg: ArchConfig, p: Tree, x: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    q = L._proj(x, p["wq"])
    out = flash_lib.flash_attention(q, k, v, causal=False)
    return L._out_proj(out, p["wo"], x.dtype)


def _walk(body, x: torch.Tensor, stack: Tree, remat) -> torch.Tensor:
    """``x = body(x, p_l)`` over every layer of ``stack``, each block
    under its own checkpoint where ``remat`` asks for one."""
    on = model_lib.remat_mode(remat) != "none"
    for p_l in model_lib.layers(stack):
        step = functools.partial(body, p_l=p_l)
        x = model_lib.checkpointed(step)(x) if on else step(x)
    return x


def encode(cfg: ArchConfig, params: Tree, audio_embed: torch.Tensor,
           remat: bool = True) -> torch.Tensor:
    """audio_embed [B, S_enc, d] (the frontend stub's output) -> the
    normed encoder output, in ``audio_embed``'s dtype."""
    B, S, d = audio_embed.shape
    x = audio_embed + sinusoid(S, d, audio_embed.dtype, audio_embed.device)
    positions = torch.arange(S, device=x.device)

    def body(x, p_l):
        h = L.apply_norm(cfg, p_l["ln1"], x)
        x = x + L.apply_attn(cfg, p_l["attn"], h, positions, causal=False)
        return x + L.apply_ffn(cfg, p_l["mlp"],
                               L.apply_norm(cfg, p_l["ln2"], x))

    x = _walk(body, x, params["enc_blocks"], remat)
    return L.apply_norm(cfg, params["enc_norm"], x)


def embed_tokens(cfg: ArchConfig, embed: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Decoder token embedding + sinusoidal positions."""
    S = tokens.shape[1]
    x = embed[tokens.long()].to(cfg.compute_jdtype)
    return x + sinusoid(S, cfg.d_model, x.dtype, x.device)


def _dec_block(cfg: ArchConfig, p_l: Tree, x: torch.Tensor,
               enc_out: torch.Tensor, positions: torch.Tensor):
    """One decoder block: causal self-attention, cross-attention into
    ``enc_out``, FFN.  Returns (x, self K/V, cross K/V)."""
    h = L.apply_norm(cfg, p_l["ln1"], x)
    y, kv = L.apply_attn(cfg, p_l["attn"], h, positions, causal=True,
                         return_kv=True)
    x = x + y
    ck, cv = _cross_kv(cfg, p_l["xattn"], enc_out)
    x = x + _cross_attend(cfg, p_l["xattn"],
                          L.apply_norm(cfg, p_l["lnx"], x), ck, cv)
    x = x + L.apply_ffn(cfg, p_l["mlp"], L.apply_norm(cfg, p_l["ln2"], x))
    return x, kv, (ck, cv)


def dec_scan(cfg: ArchConfig, dec_blocks: Tree, x: torch.Tensor,
             enc_out: torch.Tensor, positions: torch.Tensor,
             remat: bool = True) -> torch.Tensor:
    """Walk a stacked slice of decoder blocks.  The whole-model
    ``decode_train`` walks all ``n_layers``; a pipeline stage only its
    own slice."""
    def body(x, p_l):
        return _dec_block(cfg, p_l, x, enc_out, positions)[0]

    return _walk(body, x, dec_blocks, remat)


def decode_train(cfg: ArchConfig, params: Tree, tokens: torch.Tensor,
                 enc_out: torch.Tensor, remat: bool = True) -> torch.Tensor:
    S = tokens.shape[1]
    x = embed_tokens(cfg, params["embed"], tokens)
    x = dec_scan(cfg, params["dec_blocks"], x, enc_out,
                 torch.arange(S, device=x.device), remat)
    return model_lib.head(cfg, params, x)


def whisper_apply(cfg: ArchConfig, params: Tree, batch: Tree,
                  remat: bool = True):
    """batch {"audio_embed", "tokens"} -> (logits [B, S, V], aux 0)."""
    enc_out = encode(cfg, params, batch["audio_embed"], remat)
    logits = decode_train(cfg, params, batch["tokens"], enc_out, remat)
    return logits, torch.zeros((), dtype=torch.float32,
                               device=logits.device)


def whisper_cache_specs(cfg: ArchConfig, batch: int, seq: int) -> Tree:
    """Decoder self-KV rings of ``seq`` slots and cross K/V of
    ``encoder_max_len`` frames, stacked over the decoder layers."""
    H, hd, dt = cfg.n_heads, cfg.hd, cfg.compute_jdtype
    enc = cfg.encoder_max_len
    self_kv = model_lib.stack_specs(L.attn_cache_specs(cfg, batch, seq),
                                    cfg.n_layers)
    cross = model_lib.stack_specs(
        {"k": ParamSpec((batch, enc, H, hd), dt, "zeros",
                        ("batch", "kv_seq", "heads", "head_dim")),
         "v": ParamSpec((batch, enc, H, hd), dt, "zeros",
                        ("batch", "kv_seq", "heads", "head_dim"))},
        cfg.n_layers)
    return {"self": self_kv, "cross": cross}


def _stacked(trees: list) -> Tree:
    return tree_map(lambda *a: torch.stack(a), trees[0], *trees[1:])


def prefill_cross_cache(cfg: ArchConfig, params: Tree,
                        enc_out: torch.Tensor) -> Tree:
    """Per-layer cross K/V from the encoder output, stacked
    ``[n_layers, B, S_enc, H, hd]``."""
    kv = []
    for p_l in model_lib.layers(params["dec_blocks"]):
        k, v = _cross_kv(cfg, p_l["xattn"], enc_out)
        kv.append({"k": k, "v": v})
    return _stacked(kv)


def whisper_prefill(cfg: ArchConfig, params: Tree, batch: Tree,
                    cache_len: Optional[int] = None, remat: bool = True,
                    last_only: bool = True):
    """Encoder pass + decoder prefill; returns (logits, caches) with
    caches ``{"self": ring of cache_len slots, "cross": K/V}`` stacked
    over the decoder layers, handed to :func:`whisper_decode_step` at
    ``pos = S``."""
    del remat
    enc_out = encode(cfg, params, batch["audio_embed"], remat=False)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    cache_len = cache_len or S
    x = embed_tokens(cfg, params["embed"], tokens)
    positions = torch.arange(S, device=x.device)
    selfs, crosses = [], []
    for p_l in model_lib.layers(params["dec_blocks"]):
        x, (k, v), (ck, cv) = _dec_block(cfg, p_l, x, enc_out, positions)
        selfs.append({"k": L.ring_place(k, cache_len),
                      "v": L.ring_place(v, cache_len)})
        crosses.append({"k": ck, "v": cv})
    if last_only:
        x = x[:, -1:]          # norm is per-position: commutes with the slice
    logits = model_lib.head(cfg, params, x)
    return logits, {"self": _stacked(selfs), "cross": _stacked(crosses)}


def decode_position_row(cfg: ArchConfig, pos: int, dtype,
                        device=None) -> torch.Tensor:
    """The sinusoid row a decode step at ``pos`` adds, ``[1, d]``: the
    JAX package slices row ``min(pos, rows - 1)`` of a table of ``rows =
    min(max_seq_len, 2^16)`` rows; the port computes that row alone
    (the same f32 ops, so the same bits as the table's row)."""
    rows = min(cfg.max_seq_len, DECODE_TABLE_ROWS)
    p = torch.full((1, 1), float(min(int(pos), rows - 1)),
                   dtype=torch.float32, device=device)
    return _sinusoid_rows(p, cfg.d_model, dtype)


def whisper_decode_step(cfg: ArchConfig, params: Tree, token: torch.Tensor,
                        caches: Tree, pos: int):
    """One decoder token.  token [B, 1] -> (logits [B, 1, V], caches);
    the self-KV rows are written in place (``apply_attn_decode``), the
    cross K/V read as they are."""
    B = token.shape[0]
    x = params["embed"][token.long()].to(cfg.compute_jdtype)
    x = x + decode_position_row(cfg, pos, x.dtype, x.device)[None]
    positions = torch.full((B, 1), int(pos), dtype=torch.int64,
                           device=x.device)
    for i, p_l in enumerate(model_lib.layers(params["dec_blocks"])):
        c_self = model_lib.layer(caches["self"], i)
        c_cross = model_lib.layer(caches["cross"], i)
        h = L.apply_norm(cfg, p_l["ln1"], x)
        y, _ = L.apply_attn_decode(cfg, p_l["attn"], h, c_self, int(pos),
                                   positions)
        x = x + y
        q = L._proj(L.apply_norm(cfg, p_l["lnx"], x), p_l["xattn"]["wq"])
        out = attn_lib.decode_attention(q, c_cross["k"], c_cross["v"],
                                        c_cross["k"].shape[1] - 1)
        x = x + L._out_proj(out, p_l["xattn"]["wo"], x.dtype)
        x = x + L.apply_ffn(cfg, p_l["mlp"],
                            L.apply_norm(cfg, p_l["ln2"], x))
    logits = model_lib.head(cfg, params, x)
    return logits, caches

