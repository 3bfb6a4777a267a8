"""Deterministic synthetic LM data (port of ``repro.data.synthetic``).

The same learnable stream as the JAX package — an order-2 Markov chain
over a small state space embedded into the vocab — drawn from a
``torch.Generator`` instead of jax's threefry, which PyTorch cannot
replay: the port's batches differ from the JAX package's for the same
seed, so parity tests hand JAX's batches in (``SwarmRunner(data_fn=)``).
Batches are a pure function of ``(seed, step, host)`` — any peer can
regenerate any microbatch, the property SWARM's fault tolerance relies
on (App. A).  They are int32 CPU tensors; executors place them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

Tree = Any


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_states: int = 64          # markov states (mapped into vocab)
    curriculum_steps: int = 0   # paper App. G: linear seq-len warmup

    def _seq_len_at(self, step: int) -> int:
        if self.curriculum_steps and step < self.curriculum_steps:
            frac = (step + 1) / self.curriculum_steps
            s = max(16, int(self.seq_len * frac))
            return max(16, 1 << (s - 1).bit_length() >> 1)  # pow2 floor
        return self.seq_len

    def batch(self, step: int, host_index: int = 0,
              host_count: int = 1) -> Tree:
        assert self.global_batch % host_count == 0
        b = self.global_batch // host_count
        seq = self._seq_len_at(step)
        gen = torch.Generator().manual_seed(
            (int(self.seed) << 40) ^ (int(step) << 12) ^ int(host_index))
        n = min(self.n_states, self.vocab_size)
        # order-2 markov: next = (a*prev + b*prev2 + noise) mod n
        x0 = torch.randint(0, n, (b, 2), generator=gen)
        noise = torch.randint(0, 3, (b, seq + 1), generator=gen)
        p1, p2 = x0[:, 0], x0[:, 1]
        toks = torch.empty((b, seq + 1), dtype=torch.int64)
        for t in range(seq + 1):
            nxt = (5 * p1 + 3 * p2 + noise[:, t]) % n
            toks[:, t] = nxt
            p1, p2 = nxt, p1
        toks = toks.to(torch.int32)                     # [b, seq+1]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_batch(vocab_size: int, seq_len: int, batch: int, step: int = 0,
               seed: int = 0) -> Tree:
    return SyntheticLM(vocab_size, seq_len, batch, seed).batch(step)
