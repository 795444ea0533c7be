"""LM training launcher (the reference's ``repro.launch.train``), on one
device.

Usage:
  python -m repro_torch.launch.train --arch qwen1.5-0.5b --steps 50 \
      --seq-len 256 --batch 8 [--reduced] [--ckpt DIR] [--device cuda]
"""
from __future__ import annotations

import argparse
import time
from functools import partial
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config, reduced
from repro_torch.data import synthetic as syn
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import AdamWConfig, cosine_warmup_schedule
from repro_torch.training import lm as T
from repro_torch.tree import tree_leaves


def train(arch: str, *, steps: int = 50, seq_len: int = 256,
          batch: int = 8, lr: float = 3e-4, use_reduced: bool = False,
          ckpt: Optional[str] = None, device: str = "cuda",
          log: bool = True) -> Dict[str, Any]:
    """Train ``arch`` on the synthetic LM stream with remat -> {"state",
    "losses", "step_s": [wall seconds a step, each ended by its loss
    read]}. The parameters come from a generator seeded 0 on ``device``;
    the warmup is a tenth of ``steps``."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg)
    opt = AdamWConfig(lr=lr)
    state = T.make_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0), opt, device=dev)
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    if log:
        print(f"[train] {cfg.name}: {n_params / 1e6:.1f}M params, "
              f"device {dev}")
    data_cfg = syn.LMStreamConfig(vocab_size=cfg.vocab_size,
                                  seq_len=seq_len,
                                  num_codebooks=cfg.num_codebooks)
    it = syn.ShardedIterator(partial(syn.lm_batch, data_cfg), batch)
    every = max(steps // 10, 1)
    sched = cosine_warmup_schedule(every, steps)
    losses: List[float] = []
    step_s: List[float] = []
    t0 = time.time()
    for step in range(steps):
        ts = time.perf_counter()
        b = {k: v.to(dev, non_blocking=True) for k, v in next(it).items()}
        state, metrics = T.train_step(cfg, opt, state, b, sched(step))
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - ts)
        if log and (step % every == 0 or step == steps - 1):
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"ce {float(metrics['ce']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"({time.time() - t0:.1f}s)")
    if ckpt:
        save_checkpoint(ckpt, state["params"], step=steps)
        if log:
            print(f"[train] saved checkpoint to {ckpt}")
    return {"state": state, "losses": losses, "step_s": step_s}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale variant of the arch")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    train(args.arch, steps=args.steps, seq_len=args.seq_len,
          batch=args.batch, lr=args.lr, use_reduced=args.reduced,
          ckpt=args.ckpt, device=args.device)


if __name__ == "__main__":
    main()
