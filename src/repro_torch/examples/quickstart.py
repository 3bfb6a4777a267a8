"""Quickstart: train a small LM with SWARM parallelism (port of the JAX
package's ``examples/quickstart.py``).

Spins up 2 pipeline stages x 2 peers + 3 trainers on the virtual clock,
with real PyTorch math and 8-bit compressed stage boundaries, shows the
loss falling, and kills a peer one virtual second in to show nothing
breaks.  On the card the heads are 64 wide (``examples.card_sized``).

    python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.core.faults import TraceEvent
from repro_torch.core.swarm import SwarmConfig, SwarmRunner
from repro_torch.examples import card_sized
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import resolve_device
from repro_torch.optim import adamw

MODEL = ArchConfig(name="quickstart-lm", family="dense", n_layers=4,
                   d_model=128, n_heads=4, n_kv_heads=2, d_ff=512,
                   vocab_size=512, head_dim=32,
                   compute_dtype="float32", param_dtype="float32")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = card_sized(MODEL, device)
    scfg = SwarmConfig(n_stages=2, microbatch_size=4, seq_len=64,
                       global_batch=16, n_trainers=3,
                       rebalance_period=30.0, codec="int8",
                       max_steps=args.steps)
    runner = SwarmRunner(cfg, scfg, adamw(lr=3e-3), numeric=True, seed=0,
                         device=device)
    runner.build(peers_per_stage=2)
    # a preemption one virtual second in: SWARM reroutes and keeps going
    runner.apply_trace([TraceEvent(1.0, -1)])

    print(f"training a 4-layer LM across a 2-stage swarm on {device} "
          "(int8 boundaries, 1 preemption)...")
    metrics = runner.run(until=1e9)
    losses = list(metrics["loss"])
    for i, loss in enumerate(losses):
        print(f"  step {i + 1}: loss {loss:.4f}")
    print(f"peers failed: {metrics['failures']}, "
          f"migrations: {metrics['migrations']}, "
          f"throughput: {runner.throughput():.2f} samples/s (virtual)")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    print("OK — loss fell despite the failure.")
    return {"losses": losses, "failures": metrics["failures"],
            "migrations": metrics["migrations"],
            "throughput": runner.throughput()}


if __name__ == "__main__":
    main()
