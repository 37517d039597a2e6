"""End-to-end training entry point of the port:
``python -m repro_torch.launch.train --arch <id>``.

Runs the remat'd train step with grad accumulation, the synthetic token
pipeline and periodic checkpointing -- the reference's
``repro/launch/train.py`` with the same flags, on a reduced config.
Restart-safe: rerun with the same ``--ckpt-dir`` and it resumes from the
latest checkpoint there (parameters, AdamW state and the data cursor) and
replays the same batches. ``--device`` picks where it runs: ``cuda`` by
default, which raises without a card; ``--device cpu`` runs on the CPU.
The step updates its state in place.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.configs import REGISTRY, list_archs, reduced
from repro_torch.data.tokens import TokenDataset
from repro_torch.device import resolve_device
from repro_torch.distributed.checkpoint import (checkpoint_path,
                                                latest_checkpoint,
                                                load_checkpoint,
                                                save_checkpoint)
from repro_torch.models import make_model
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train import init_training, make_train_step


def main(argv: list[str] | None = None) -> float:
    """Runs the training loop; returns the last step's loss (NaN when no step
    ran)."""
    ap = argparse.ArgumentParser(description="FIRST training entry point")
    ap.add_argument("--arch", default="llama3.2-3b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda: raises without a "
                         "card)")
    args = ap.parse_args(argv)
    # "cuda" means the current card, and raises when there is none
    dev = resolve_device(None if args.device == "cuda" else args.device)

    cfg = reduced(REGISTRY[args.arch])
    model = make_model(cfg)
    data = TokenDataset(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                        global_batch=args.batch, seed=args.seed)
    step_fn = make_train_step(model, AdamWConfig(lr=args.lr),
                              num_microbatches=args.microbatches,
                              in_place=True)
    params, opt_state = init_training(
        model, torch.Generator(device=dev).manual_seed(args.seed))

    start = 0
    if args.ckpt_dir:
        os.makedirs(args.ckpt_dir, exist_ok=True)
        latest = latest_checkpoint(args.ckpt_dir)
        if latest:
            state, start, meta = load_checkpoint(
                latest, target={"params": params, "opt": opt_state},
                device=dev)
            params, opt_state = state["params"], state["opt"]
            data.restore(meta["data"])
            print(f"[train] resumed from {latest} at step {start}")

    print(f"[train] arch={args.arch} (reduced) device={dev} "
          f"steps {start}..{args.steps}")
    t0 = time.time()
    loss = float("nan")
    for step in range(start, args.steps):
        params, opt_state, metrics = step_fn(params, opt_state,
                                             data.next_batch())
        loss = float(metrics["loss"])
        if step % 10 == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d}  loss {loss:.4f}  "
                  f"{time.time() - t0:6.1f}s")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            path = checkpoint_path(args.ckpt_dir, step + 1)
            save_checkpoint(path, {"params": params, "opt": opt_state},
                            step=step + 1,
                            metadata={"step": step + 1,
                                      "data": data.state()})
            print(f"[train] checkpoint -> {path}")
    print(f"[train] done: {args.steps - start} steps in "
          f"{time.time() - t0:.1f}s; last loss {loss!r}")
    return loss


if __name__ == "__main__":
    main()
