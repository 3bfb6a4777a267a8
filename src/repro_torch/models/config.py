"""Unified architecture configuration (port of ``repro.models.config``).

Same fields and defaults as the JAX package, so a config maps 1:1.
``kernels`` is kept for that parity (and the weight converter) but
selects nothing: the tensor's device does — the hand-written CUDA
kernels of ``repro_torch.kernels`` on a CUDA tensor, their plain PyTorch
versions on a CPU tensor.  The ``*_jdtype`` properties return
``torch.dtype``s here."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Routed-experts config.

    ``expert_sharded`` opts a swarm pipeline into treating MoE stages
    as expert-sharded: the ``StagePlan`` then prices boundaries that
    *enter* such a stage per-token-routed (``top_k`` copies of every
    token cross the wire to the expert shards) instead of one uniform
    hidden-state transfer.  Off by default — dense-replica MoE stages
    keep the uniform pricing.
    """
    num_experts: int = 0              # routed experts
    num_shared: int = 0               # always-on shared experts (DeepSeek)
    top_k: int = 1
    d_ff_expert: int = 0              # per-expert FFN hidden size
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01
    expert_sharded: bool = False      # expert-parallel stage placement


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0              # 0 => dense q projection
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16               # per-channel SSM state (Mamba N)
    expand: int = 2                   # d_inner = expand * d_model
    conv_kernel: int = 4
    dt_rank: int = 0                  # 0 => ceil(d_model/16)
    chunk: int = 128                  # chunkwise-scan block for mLSTM/GLA forms


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Unified architecture config.

    Stage-plan inputs: ``block_kinds`` (derived from ``family`` or an
    explicit ``block_pattern``), ``share_groups``, and
    ``encoder_layers`` fully determine the per-stage structure a swarm
    pipeline runs — ``repro_torch.models.stage_plan.make_stage_plan(cfg,
    n_stages)`` turns them into per-stage kind runs, boundary payload
    pricing, and aux-state slot ownership.  Mixed ``block_kinds`` with
    ``share_groups`` set is rejected (sharing across kinds is
    undefined); encoder-decoder configs plan stage 0 as the encoder pod
    and split decoder layers over the remaining stages.

    ``kernels`` is the JAX package's backend switch, kept for parity; in
    the port the device routes (see the module docstring).
    ``wire_quant`` additionally int8-quantizes the learned codec's wire
    tensor (a *semantic* switch: it changes what crosses the boundary,
    identically on both backends).
    """
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 => d_model // n_heads
    # --- attention flavor ---
    rope: str = "rope"               # rope | mrope | none
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    sliding_window: int = 0          # 0 => full attention
    attn_logit_softcap: float = 0.0
    causal: bool = True
    # --- ffn flavor ---
    act: str = "swiglu"              # swiglu | geglu | gelu
    # --- structure ---
    tie_embeddings: bool = False
    share_groups: int = 0            # ALBERT-style sharing (paper §4.3): 0=off
    scale_embed: bool = False        # gemma-style sqrt(d) embedding scale
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    block_pattern: Optional[tuple[str, ...]] = None  # per-layer block kinds
    # --- sub-configs ---
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # --- enc-dec (whisper) ---
    encoder_layers: int = 0          # >0 => encoder-decoder
    encoder_max_len: int = 1500      # whisper conv-stub frame cap
    # --- modality frontend stub ---
    frontend: str = "none"           # none | audio_stub | vision_stub
    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # --- SWARM integration (paper technique knobs) ---
    boundary_compression: str = "int8"   # none | int8 | bottleneck | maxout
    bottleneck_dim: int = 0          # learned-codec wire width c (0 => d/2)
    maxout_k: int = 0                # maxout pool width (0 => derived; see
                                     # repro_torch.compression.codecs.maxout_k)
    pipeline_stages: int = 0         # declared pipeline depth: >1 attaches
                                     # the stage-stacked learned-codec params
                                     # to model_specs (one pair per boundary)
    kernels: str = "jnp"             # the JAX package's backend switch,
                                     # kept for parity: selects nothing
                                     # here (a CUDA tensor takes the CUDA
                                     # kernels, a CPU tensor the plain
                                     # versions)
    wire_quant: bool = False         # blockwise-int8 quantize the LEARNED
                                     # codec's c-dim wire tensor in both
                                     # directions (activations fwd,
                                     # cotangents bwd, straight-through
                                     # across rounding) — the paper's §4.3
                                     # quantize-on-send applied on top of
                                     # bottleneck/maxout; no-op for
                                     # none/int8 boundary modes
    # --- max positions for serving ---
    max_seq_len: int = 1 << 20

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def param_jdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def compute_jdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def is_subquadratic(self) -> bool:
        """True if the arch can serve a 500k-token context (see DESIGN.md §5)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    @property
    def block_kinds(self) -> tuple[str, ...]:
        if self.block_pattern is not None:
            return self.block_pattern
        kind = {
            "dense": "attn",
            "vlm": "attn",
            "audio": "attn",
            "moe": "moe",
            "ssm": "ssm",
            "hybrid": "hymba",
        }[self.family]
        return (kind,) * self.n_layers

    def with_overrides(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke runs (``--reduced``): the
    JAX package's ``reduced``, field for field."""
    n_layers = min(cfg.n_layers, 2)
    kv = max(1, min(cfg.n_kv_heads, 2))
    heads = max(kv, 4)
    heads = (heads // kv) * kv
    kw = dict(
        n_layers=n_layers,
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=512,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_max_len=16,
        compute_dtype="float32",
        param_dtype="float32",
        max_seq_len=4096,
    )
    if cfg.sliding_window:
        kw["sliding_window"] = 8
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2),
            num_shared=min(cfg.moe.num_shared, 1), d_ff_expert=32)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                              v_head_dim=16)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, state_dim=8, chunk=16)
    if cfg.block_pattern is not None:
        kw["block_pattern"] = cfg.block_pattern[:n_layers]
    if cfg.share_groups:
        kw["share_groups"] = n_layers  # one layer per group
    if cfg.bottleneck_dim:
        kw["bottleneck_dim"] = 32      # keeps the 64 -> c compression
    if cfg.pipeline_stages:
        kw["pipeline_stages"] = 2      # matches the 2-layer stack
    return cfg.with_overrides(**kw)
