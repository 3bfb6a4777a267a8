"""Serving demo (port of the JAX package's ``examples/serve_pipeline.py``):
batched prefill, then greedy decode through the session program API
(``repro_torch.serve``).  The prefill allocates its decode caches at the
full session horizon, so decoding writes in place — no cache re-padding
between prefill and decode.

    python -m repro_torch.examples.serve_pipeline [--arch yi-6b] [--device cpu]

The model is the architecture's reduced config (``configs.get_reduced``:
same family, tiny widths) with random weights from a seed.  On the card
its attention head dims are widened to ones the flash kernel takes
(``examples.card_sized``: the reduced 16 is not among them).  An audio
config is refused, as the JAX example refuses it.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Optional, Sequence

import torch

from repro_torch.configs import ASSIGNED, get_reduced
from repro_torch.examples import card_sized
from repro_torch.models import model as model_lib
from repro_torch.models import params as P
from repro_torch.serve import full_session_program
from repro_torch.tree import tree_leaves, tree_map

Tree = Any
def main(argv: Optional[Sequence[str]] = None, params: Optional[Tree] = None,
         prompts=None) -> torch.Tensor:
    """Returns the generated ids ``[batch, new_tokens]``.  ``params`` (a
    tree shaped like ``model.lm_specs``) and ``prompts`` (``[batch,
    prompt_len]`` ids) replace the seeded ones where given: numpy or
    tensors, moved to the device."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="yi-6b", choices=ASSIGNED)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch)          # small, same family
    if cfg.family == "audio":
        sys.exit("audio serving needs the encoder frontend batch — pick "
                 "an LM arch (whisper serves through "
                 "train.steps.make_prefill_step / make_serve_step)")
    device = P.resolve_device(args.device)
    cfg = card_sized(cfg, device)
    print(f"serving {args.arch} on {device} (reduced config: "
          f"{cfg.n_layers}L d={cfg.d_model} head dim {cfg.hd})")
    if params is None:
        params = P.init(0, model_lib.lm_specs(cfg), device)
    elif isinstance(tree_leaves(params)[0], torch.Tensor):
        params = tree_map(lambda a: a.to(device), params)
    else:
        params = P.from_numpy_tree(params, device)
    if prompts is None:
        gen = torch.Generator(device=device).manual_seed(1)
        prompts = torch.randint(0, cfg.vocab_size,
                                (args.batch, args.prompt_len),
                                generator=gen, device=device)
    prompts = torch.as_tensor(prompts, device=device)
    batch, prompt_len = prompts.shape

    # one program per session horizon: caches are born at total_len
    total = prompt_len + args.new_tokens
    prog = full_session_program(cfg, total)

    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    t0 = time.time()
    tok, kv = prog.prefill(params, prompts)
    sync()
    t_prefill = time.time() - t0

    out = [tok]
    t0 = time.time()
    for i in range(args.new_tokens - 1):
        tok, kv = prog.decode(params, kv, tok, prompt_len + i)
        out.append(tok)
    sync()
    t_decode = time.time() - t0

    gen_ids = torch.cat(out, dim=1)
    print(f"prefill {batch}x{prompt_len} tokens: {t_prefill * 1e3:.0f} ms")
    print(f"decode {gen_ids.shape[1]} tokens/seq: "
          f"{t_decode * 1e3 / max(gen_ids.shape[1], 1):.1f} ms/token "
          f"({device.type})")
    print("generated token ids (seq 0):", gen_ids[0].tolist())
    return gen_ids


if __name__ == "__main__":
    main()
