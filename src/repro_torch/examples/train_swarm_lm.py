"""End-to-end run (port of the JAX package's
``examples/train_swarm_lm.py``): train an LM with SWARM parallelism and
set its loss curve beside plain synchronous data-parallel training —
the paper's Fig. 4 convergence-parity experiment in miniature.

The default model is small (a few seconds on the CPU); ``--model 100m``
selects a ~100M-parameter model sized for the card.  Both runs take the
same data: step ``i`` of either trains on the same ``--batch`` rows
(``SyntheticLM(seed=17).batch(i)``, which the swarm's trainers take in
microbatches of ``batch / 4``), and the JAX example's optimizer, AdamW
at 3e-3 with a global-norm clip of 1.0.  The clip is not the same
function in the two arms: SWARM's All-Reduce clips each stage by its own
gradient norm, ``make_train_step`` the whole model by its norm, and at
``--model 100m`` the arms part in either package (SWARM falls faster).
``--grad-clip 0`` gives both arms AdamW unclipped, which is elementwise,
so SWARM's per-stage step is then the synchronous step.

    python -m repro_torch.examples.train_swarm_lm [--steps 12]
        [--model 100m] [--grad-clip 0] [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from repro_torch.core.swarm import SwarmConfig, SwarmRunner
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.examples import card_sized
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import resolve_device
from repro_torch.optim import adamw, delayed_parameter_updates
from repro_torch.train.steps import make_state, make_train_step

SMALL = ArchConfig(name="lm-small", family="dense", n_layers=4,
                   d_model=128, n_heads=4, n_kv_heads=4, d_ff=512,
                   vocab_size=512, head_dim=32, compute_dtype="float32",
                   param_dtype="float32")
LM100M = ArchConfig(name="lm-100m", family="dense", n_layers=12,
                    d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
                    vocab_size=50304, compute_dtype="float32",
                    param_dtype="float32")
PARITY = 0.25          # the example's criterion: last losses this close


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--model", choices=["small", "100m"], default="small")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--dpu", action="store_true",
                    help="delayed parameter updates (paper §3.2)")
    ap.add_argument("--overlap", action="store_true",
                    help="async tick: in-flight boundary transfers")
    ap.add_argument("--staleness", type=int, default=0,
                    help="bounded-staleness All-Reduce windows (implies "
                         "DPU inside the runner)")
    ap.add_argument("--grad-clip", type=float, default=1.0,
                    help="AdamW's global-norm clip in both arms (per "
                         "stage in SWARM; see the module docstring)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = card_sized(SMALL if args.model == "small" else LM100M, device)
    ds = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=17)

    opt = adamw(lr=3e-3, grad_clip=args.grad_clip)
    if args.dpu:
        opt = delayed_parameter_updates(opt)

    # --- SWARM run (2 stages x 2 peers, int8 boundaries, real math)
    mb = args.batch // 4
    per_step = args.batch // mb

    def data_fn(idx: int) -> dict:
        """Microbatch ``idx``: its rows of the step's batch."""
        step, j = divmod(idx, per_step)
        b = ds.batch(step)
        return {k: v[j * mb:(j + 1) * mb] for k, v in b.items()}

    scfg = SwarmConfig(n_stages=2, microbatch_size=mb, seq_len=args.seq,
                       global_batch=args.batch, n_trainers=4,
                       rebalance_period=0.0, codec="int8",
                       max_steps=args.steps, overlap=args.overlap,
                       staleness=args.staleness)
    t0 = time.time()
    runner = SwarmRunner(cfg, scfg, opt, numeric=True, seed=0,
                         data_fn=data_fn, device=device)
    runner.build(peers_per_stage=2)
    metrics = runner.run(until=1e12)
    _sync(device)
    swarm_losses = list(metrics["loss"])
    t_swarm = time.time() - t0
    del runner

    # --- synchronous reference (same data, same optimizer; a
    # staleness > 0 runner wraps its optimizer in DPU itself, so the
    # reference must too)
    opt_ref = adamw(lr=3e-3, grad_clip=args.grad_clip)
    if args.dpu or args.staleness > 0:
        opt_ref = delayed_parameter_updates(opt_ref)
    state = make_state(cfg, opt_ref, 0, device)
    step_fn = make_train_step(cfg, opt_ref)
    ref_losses = []
    t0 = time.time()
    for i in range(args.steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in ds.batch(i).items()}
        state, m = step_fn(state, batch)
        ref_losses.append(float(m["ce"]))
    _sync(device)
    t_ref = time.time() - t0
    del state

    print(f"{'step':>5} {'SWARM':>9} {'sync-DP':>9}")
    for i, (a, b) in enumerate(zip(swarm_losses, ref_losses)):
        print(f"{i + 1:>5} {a:>9.4f} {b:>9.4f}")
    print(f"\nSWARM wall {t_swarm:.1f}s (simulated cluster on {device}), "
          f"reference wall {t_ref:.1f}s")
    idle = metrics["peer_idle_s"]
    mean_idle = sum(idle.values()) / max(len(idle), 1)
    print(f"async tick: overlap fraction "
          f"{metrics['overlap_fraction']:.2f}, "
          f"{metrics['inflight_bytes'] / 1e6:.2f} MB in flight, "
          f"mean peer idle {mean_idle:.1f}s (virtual)")
    parity = ("OK" if abs(swarm_losses[-1] - ref_losses[-1]) < PARITY
              else "DIVERGED")
    print("convergence parity (Fig. 4):", parity)
    return {"swarm_losses": swarm_losses, "ref_losses": ref_losses,
            "swarm_s": t_swarm, "ref_s": t_ref, "parity": parity,
            "overlap_fraction": metrics["overlap_fraction"],
            "inflight_bytes": metrics["inflight_bytes"]}


if __name__ == "__main__":
    main()
