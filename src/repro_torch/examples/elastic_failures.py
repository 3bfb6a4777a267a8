"""Elasticity demo (paper Fig. 5 in miniature; port of the JAX package's
``examples/elastic_failures.py``): replay a synthetic preemption trace
over a 24-peer swarm and compare throughput without and with adaptive
rebalancing, then with the async tick.

The replays are timing-only (analytic compute times, no tensors), so
they equal the JAX package's event for event.

    python -m repro_torch.examples.elastic_failures [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.core.faults import active_counts, synth_preemptible_trace
from repro_torch.core.swarm import SwarmConfig, SwarmRunner
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import resolve_device
from repro_torch.optim import adamw

MODEL = ArchConfig(name="elastic-demo", family="dense", n_layers=4,
                   d_model=4096, n_heads=32, n_kv_heads=32, d_ff=16384,
                   vocab_size=50257, tie_embeddings=True)
HORIZON = 3600.0
SETTINGS = ((0.0, False, "no rebalancing "),
            (60.0, False, "rebalance T=60 "),
            (60.0, True, "T=60 + overlap "))


def run(rebalance_T: float, trace, overlap: bool = False,
        horizon: float = HORIZON) -> SwarmRunner:
    scfg = SwarmConfig(n_stages=4, microbatch_size=1, seq_len=512,
                       global_batch=1024, n_trainers=72,
                       rebalance_period=rebalance_T, codec="int8",
                       overlap=overlap)
    r = SwarmRunner(MODEL, scfg, adamw(), numeric=False, seed=0)
    r.build(peers_per_stage=6)
    r.apply_trace(trace)
    r.run(until=horizon)
    return r


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="checked as every example checks it; the "
                         "replays themselves run no tensor")
    ap.add_argument("--horizon", type=float, default=HORIZON)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    trace = synth_preemptible_trace(horizon_s=args.horizon, target_peers=24,
                                    mean_lifetime_s=1200.0, seed=3)
    counts = active_counts(trace, 24, args.horizon, dt=600.0)
    print("active peers over the run:", list(counts))
    rows = []
    for T, overlap, tag in SETTINGS:
        r = run(T, trace, overlap=overlap, horizon=args.horizon)
        m = r.metrics
        print(f"{tag}: {r.throughput():.2f} samples/s, "
              f"{m['failures']} failures, {m['joins']} joins, "
              f"{m['migrations']} migrations, "
              f"{m['recomputed_microbatches']} recomputed "
              f"microbatches (exactly-once ledger)")
        idle = m["peer_idle_s"]
        mean_idle = sum(idle.values()) / max(len(idle), 1)
        print(f"{' ' * len(tag)}  overlap fraction "
              f"{m['overlap_fraction']:.2f}, "
              f"{m['inflight_bytes'] / 1e9:.2f} GB in flight, "
              f"mean peer idle {mean_idle:.0f}s")
        rows.append({"setting": tag.strip(), "throughput": r.throughput(),
                     **{k: m[k] for k in (
                         "failures", "joins", "migrations",
                         "recomputed_microbatches", "overlap_fraction",
                         "inflight_bytes")}})
    return rows


if __name__ == "__main__":
    main()
