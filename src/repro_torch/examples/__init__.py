"""The JAX package's ``examples/`` as modules of the port, each run as
``python -m repro_torch.examples.<name>`` and on the card unless
``--device cpu`` is passed (asking for the card where there is none
raises):

* ``quickstart`` — a 4-layer LM over 2 stages x 2 peers, int8 wire, one
  preemption; the loss must fall.
* ``elastic_failures`` — timing-only replays of a 24-peer preemption
  trace without and with Alg. 2 rebalancing, then with the async tick.
* ``serve_pipeline`` — batched prefill and greedy decode of an assigned
  LM architecture at its reduced size through ``full_session_program``.
* ``train_swarm_lm`` — the paper's Fig. 4 in miniature: SWARM against
  synchronous data-parallel ``make_train_step`` on the same data.

Each has ``main(argv=None)``, which returns what it printed as data.
On the card a model's attention head dims are widened to ones the
flash kernel takes (:func:`card_sized`): the examples' small configs
use 32 and 16, which the kernel refuses, and the card never falls back
to the plain version."""
from __future__ import annotations

import dataclasses

ATTENTION = ("attn", "moe", "hymba")
LATENT = ("mla", "mla_moe")


def card_sized(cfg, device):
    """``cfg`` as it runs on ``device``: on the card with head dims the
    flash kernel takes (``HEAD_DIMS``), 64 for attention and MLA's (192,
    128) for latent attention; elsewhere as it is."""
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
    if getattr(device, "type", device) != "cuda":
        return cfg
    kinds = set(cfg.block_kinds)
    if kinds & set(LATENT):
        m = cfg.mla
        if (m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim) not in HEAD_DIMS:
            return cfg.with_overrides(mla=dataclasses.replace(
                m, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128))
    elif kinds & set(ATTENTION) and (cfg.hd, cfg.hd) not in HEAD_DIMS:
        return cfg.with_overrides(head_dim=64)
    return cfg
