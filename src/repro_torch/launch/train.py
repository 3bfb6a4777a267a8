"""Production training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \
        --steps 100 --batch 16 --seq 256 --ckpt-dir CKPT [--reduced] \
        [--accum 2] [--remat 2level] [--dpu] [--device cpu]

It trains on the card unless ``--device`` names another device; asking
for the card where there is none raises.  ``--reduced`` takes the
architecture's tiny same-family config (``configs.get_reduced``).  One
process, one device: the whole model's step (``train.steps``), data from
``SyntheticLM(seed=17)`` as host 0 of 1.  Fault tolerance: the launcher
checkpoints every ``--ckpt-every`` steps and at the end, and resumes
from the latest checkpoint on restart; with an external supervisor
that restarts it on failure, this is the slice-granular half of SWARM's
fault tolerance (DESIGN.md §3), the peer-granular half being
``repro_torch.core.swarm``.

:func:`main` returns the per-step losses and the run's summary, so that
other programs call it in-process.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.ckpt import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config, get_reduced
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import (from_numpy_tree, resolve_device,
                                       to_numpy_tree)
from repro_torch.optim import adamw, delayed_parameter_updates, lamb
from repro_torch.train.steps import make_state, make_train_step

Tree = Any


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", choices=["adamw", "lamb"],
                    default="adamw")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--remat", default="block",
                    choices=["block", "2level", "none"])
    ap.add_argument("--dpu", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def step_batch(cfg: ArchConfig, ds: SyntheticLM, step: int,
               device: torch.device) -> Tree:
    """Step ``step``'s global batch on ``device``: the synthetic tokens
    and labels, M-RoPE's text positions (``arange`` on all three axes)
    and, for the audio family, frame embeddings drawn from a generator
    seeded with (7, step)."""
    batch = {k: v.to(device) for k, v in ds.batch(step).items()}
    B, S = batch["tokens"].shape
    if cfg.rope == "mrope":
        batch["positions"] = torch.arange(
            S, dtype=torch.int32, device=device).expand(3, B, S)
    if cfg.family == "audio":
        gen = torch.Generator(device=device).manual_seed((7 << 32) ^ step)
        batch["audio_embed"] = torch.randn(
            (B, cfg.encoder_max_len, cfg.d_model), generator=gen,
            device=device).to(cfg.compute_jdtype)
    return batch


def run(args: argparse.Namespace) -> tuple[list[float], dict, Tree]:
    """Train as ``args`` say.  Returns (the losses of the steps run, the
    summary, the final state)."""
    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    opt = (adamw(lr=args.lr) if args.optimizer == "adamw"
           else lamb(lr=args.lr))
    if args.dpu:
        opt = delayed_parameter_updates(opt)

    state = make_state(cfg, opt, args.seed, device)
    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        host, start = restore_checkpoint(args.ckpt_dir, state)
        del state
        state = from_numpy_tree(host, device)
        del host
        print(f"resumed from step {start}")

    step_fn = make_train_step(cfg, opt, remat=args.remat, accum=args.accum)
    ds = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=17)

    losses, step_s = [], []
    t0 = time.time()
    for i in range(start, args.steps):
        t_step = time.time()
        state, metrics = step_fn(state, step_batch(cfg, ds, i, device))
        loss = float(metrics["loss"])     # waits for the step
        step_s.append(time.time() - t_step)
        if not np.isfinite(loss):
            raise FloatingPointError(f"loss diverged at step {i}")
        losses.append(loss)
        if i % 5 == 0 or i == args.steps - 1:
            dt = (time.time() - t0) / max(i - start + 1, 1)
            print(f"step {i:5d}  loss {loss:8.4f}  {dt:6.2f}s/step")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, i + 1, to_numpy_tree(state))
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, args.steps, to_numpy_tree(state))
    print("done")
    # the first step includes the kernels' build and the allocator's
    # warm-up: the rate is read from the later steps where there are any
    timed = step_s[1:] or step_s
    summary = {"arch": cfg.name, "reduced": args.reduced,
               "device": str(device), "start": start, "steps": args.steps,
               "batch": args.batch, "seq": args.seq, "accum": args.accum,
               "remat": args.remat, "step_seconds": step_s,
               "tokens_per_s": (args.batch * args.seq * len(timed)
                                / sum(timed)) if timed else None}
    return losses, summary, state


def main(argv: Optional[Sequence[str]] = None
         ) -> tuple[list[float], dict]:
    losses, summary, _ = run(parse_args(argv))
    return losses, summary


if __name__ == "__main__":
    main()
