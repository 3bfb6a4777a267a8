"""Analytic FLOP / byte accounting shared by the SWARM cost model (port
of ``repro.models.flops``, copied: plain arithmetic over the config;
the parameter counts that need the training specs come with the
training slice).

Conventions: matmul = 2mnk FLOPs; forward-only counts are per token;
``train_flops = 3x forward`` (fwd + 2x bwd, Kaplan et al.) and activation
checkpointing adds one forward recompute where stated.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.models.config import ArchConfig


def _attn_proj_flops(cfg: ArchConfig) -> float:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return 2 * d * hd * (2 * H + 2 * KV)        # q,o: H; k,v: KV


def _attn_ctx_flops(cfg: ArchConfig, ctx: float) -> float:
    H, hd = cfg.n_heads, cfg.hd
    return 2 * 2 * ctx * H * hd                  # scores + weighted sum


def _ffn_flops(cfg: ArchConfig, d_ff: Optional[int] = None) -> float:
    f = cfg.d_ff if d_ff is None else d_ff
    mults = 3 if cfg.act in ("swiglu", "geglu") else 2
    return 2 * mults * cfg.d_model * f


def _moe_flops(cfg: ArchConfig) -> float:
    m = cfg.moe
    d = cfg.d_model
    per_expert = 2 * 3 * d * m.d_ff_expert
    shared = 2 * 3 * d * (m.num_shared * m.d_ff_expert) if m.num_shared else 0
    router = 2 * d * m.num_experts
    return router + m.top_k * per_expert + shared


def _mla_flops(cfg: ArchConfig, ctx: float) -> float:
    a = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qd = a.qk_nope_dim + a.qk_rope_dim
    q = (2 * d * a.q_lora_rank + 2 * a.q_lora_rank * H * qd
         if a.q_lora_rank else 2 * d * H * qd)
    kv = 2 * d * a.kv_lora_rank + 2 * d * a.qk_rope_dim
    expand = 2 * a.kv_lora_rank * H * (a.qk_nope_dim + a.v_head_dim)
    attn = 2 * ctx * H * (qd + a.v_head_dim)
    out = 2 * H * a.v_head_dim * d
    return q + kv + expand + attn + out


def _mamba_flops(cfg: ArchConfig) -> float:
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    dtr = s.dt_rank or -(-d // 16)
    proj = 2 * d * 2 * di + 2 * di * (dtr + 2 * s.state_dim) \
        + 2 * dtr * di + 2 * di * d
    scan = 10 * di * s.state_dim                 # discretize+scan+readout
    conv = 2 * s.conv_kernel * di
    return proj + scan + conv


def _mlstm_flops(cfg: ArchConfig, chunk: int) -> float:
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    proj = 2 * d * (3 * H * hd + 2 * H) + 2 * d * d + 2 * H * hd * d
    # chunkwise: intra-chunk attention ~2*2*chunk*H*hd + state update
    intra = 4 * chunk * H * hd
    state = 6 * H * hd * (hd + 1)
    return proj + intra + state


def _slstm_flops(cfg: ArchConfig) -> float:
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    return 2 * d * 4 * d + 2 * H * hd * 4 * hd + 2 * d * d + 20 * d


def cross_attn_flops(cfg: ArchConfig, enc_ctx: float) -> float:
    """Per decoder token: cross-attention scores/values over ``enc_ctx``
    encoder frames plus the q/o projections."""
    return (2 * 2 * enc_ctx * cfg.n_heads * cfg.hd
            + 4 * cfg.d_model * cfg.n_heads * cfg.hd)


def per_token_layer_flops(cfg: ArchConfig, kind: str, ctx: float,
                          enc_ctx: Optional[float] = None) -> float:
    """Forward FLOPs for one token through one block of ``kind`` with
    attention context ``ctx`` (= kv length actually attended).

    Whisper kinds: ``whisper_enc`` is a non-causal encoder block priced
    per encoder frame (pass ``ctx`` = encoder frames); ``whisper_dec``
    adds cross-attention over ``enc_ctx`` frames (defaults to
    ``cfg.encoder_max_len``) to a causal decoder block.
    """
    if kind == "whisper_enc":
        return _attn_proj_flops(cfg) + _attn_ctx_flops(cfg, ctx) \
            + _ffn_flops(cfg)
    if kind == "whisper_dec":
        ec = float(cfg.encoder_max_len) if enc_ctx is None else enc_ctx
        return _attn_proj_flops(cfg) + _attn_ctx_flops(cfg, ctx) \
            + _ffn_flops(cfg) + cross_attn_flops(cfg, ec)
    if kind == "attn":
        return _attn_proj_flops(cfg) + _attn_ctx_flops(cfg, ctx) \
            + _ffn_flops(cfg)
    if kind == "moe":
        return _attn_proj_flops(cfg) + _attn_ctx_flops(cfg, ctx) \
            + _moe_flops(cfg)
    if kind == "mla":
        return _mla_flops(cfg, ctx) + _ffn_flops(cfg)
    if kind == "mla_moe":
        return _mla_flops(cfg, ctx) + _moe_flops(cfg)
    if kind == "mlstm":
        return _mlstm_flops(cfg, cfg.ssm.chunk if cfg.ssm else 128)
    if kind == "slstm":
        return _slstm_flops(cfg)
    if kind == "hymba":
        return (_attn_proj_flops(cfg) + _attn_ctx_flops(cfg, ctx)
                + _mamba_flops(cfg) + _ffn_flops(cfg))
    if kind == "mamba":
        return _mamba_flops(cfg)
    raise KeyError(kind)


def _ctx_for(cfg: ArchConfig, seq: int, causal_avg: bool) -> float:
    ctx = seq / 2 if (causal_avg and cfg.causal) else seq
    if cfg.sliding_window:
        ctx = min(ctx, cfg.sliding_window)
    return float(ctx)


def forward_flops_per_token(cfg: ArchConfig, seq: int) -> float:
    """Whole-model forward FLOPs per token at train/prefill time."""
    ctx = _ctx_for(cfg, seq, causal_avg=True)
    total = sum(per_token_layer_flops(cfg, k, ctx) for k in cfg.block_kinds)
    if cfg.encoder_layers:       # whisper: encoder runs over its own frames
        enc_ctx = min(seq, cfg.encoder_max_len)
        total += cfg.encoder_layers * per_token_layer_flops(
            cfg, "whisper_enc", enc_ctx)
        # decoder cross-attention
        total += cfg.n_layers * cross_attn_flops(cfg, enc_ctx)
    total += 2 * cfg.d_model * cfg.vocab_size    # lm head
    return total


def boundary_bytes(cfg: ArchConfig, batch: int, seq: int,
                   compression: str = "none") -> float:
    """Bytes crossing one pipeline-stage boundary, one direction.

    Per-codec wire formulas (T = batch * seq tokens, d = d_model, 2-byte
    bf16 wire elements; one source of truth with what the execution paths
    actually emit — asserted by ``benchmarks/bench_compression.py``):

    * ``none``        2 * T * d
    * ``int8``        ``quant8.compressed_nbytes(T * d)``
                      = T*d codes + 4 bytes per ceil(T*d / BLOCK) block
    * ``bottleneck``  2 * T * c,       c = ``cfg.bottleneck_dim`` (0 => d/2)
    * ``maxout``      2 * T * (d / k), k = ``cfg.maxout_k`` (0 => derived —
                      see ``repro_torch.compression.codecs.maxout_k``)

    Under ``cfg.wire_quant`` the learned codecs' c-dim wire additionally
    crosses as int8 codes + f32 per-block scales (block =
    ``codecs.wire_qblock``): T*c + 4 * T * (c / qb) bytes.
    """
    from repro_torch.compression import codecs, quant8   # lazy
    tokens = batch * seq
    if compression == "int8":
        return float(quant8.compressed_nbytes(tokens * cfg.d_model))
    c = codecs.wire_dim(cfg, compression)
    if compression in codecs.LEARNED and cfg.wire_quant:
        qb = codecs.wire_qblock(cfg, compression)
        return float(tokens * c + 4.0 * tokens * (c // qb))
    return 2.0 * tokens * c


def wire_nbytes(n_elements: float, compression: str = "none") -> float:
    """Wire bytes for ``n_elements`` hidden-state elements under a
    codec — the per-leaf primitive behind ``StagePlan.boundary_bytes``
    (2-byte bf16 elements; int8 adds per-block scales).  Learned codecs
    reshape a specific tensor, so they are priced by ``boundary_bytes``
    only."""
    from repro_torch.compression import quant8          # lazy
    if compression == "int8":
        return float(quant8.compressed_nbytes(int(n_elements)))
    return 2.0 * n_elements

