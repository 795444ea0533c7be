"""Diffusion training loop for the DiTs (the reference's
``repro.training.diffusion_trainer``): the diffusion loss's gradients
by ``torch.autograd.grad`` over the parameter leaves, then one AdamW
step."""
from __future__ import annotations

import time
from functools import partial
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import DiffusionConfig, ModelConfig, TrainConfig
from repro_torch.data import synthetic as syn
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.diffusion.loss import diffusion_loss
from repro_torch.layers import model as M
from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                     cosine_warmup_schedule, init_opt_state)
from repro_torch.training.autodiff import value_and_grad


def diffusion_train_step(cfg: ModelConfig, dcfg: DiffusionConfig,
                         opt: AdamWConfig, state: Dict[str, Any],
                         batch: Dict[str, torch.Tensor], *,
                         generator: Optional[torch.Generator] = None,
                         t: Optional[torch.Tensor] = None,
                         noise: Optional[torch.Tensor] = None,
                         lr_scale=1.0):
    """One optimizer step on ``batch`` (``latents``, and ``labels`` and/or
    ``cond`` as the model is conditioned) -> (new state, metrics
    {"mse", "aux", "loss", "grad_norm"}). The loss's draws come from
    ``generator`` unless ``t``/``noise`` are given."""
    cond = {}
    if cfg.num_classes:
        cond["labels"] = batch["labels"]
    if cfg.cond_dim:
        cond["cond"] = batch["cond"]

    def loss_fn(p):
        return diffusion_loss(cfg, dcfg, p, batch["latents"], cond,
                              generator=generator, t=t, noise=noise)

    (loss, metrics), grads = value_and_grad(loss_fn, state["params"])
    params, opt_state, om = adamw_update(opt, state["params"], grads,
                                         state["opt"], lr_scale)
    return ({"params": params, "opt": opt_state, "step": state["step"] + 1},
            dict(metrics, loss=loss, **om))


def train_diffusion(cfg: ModelConfig, dcfg: DiffusionConfig,
                    tcfg: TrainConfig, *, device: DeviceLike = "cuda",
                    verbose: bool = True) -> Dict[str, Any]:
    """Train a DiT on the synthetic class-conditional latents from
    ``init_params`` (a generator seeded by ``tcfg.seed`` on ``device``)
    -> {"state": {"params", "opt", "step"}, "losses": [float a step],
    "step_s": [wall seconds a step, each ended by its loss read]}. The
    loss's draws come from a second generator seeded ``tcfg.seed + 1`` on
    ``device``."""
    dev = resolve_device(device)
    init_gen = torch.Generator(device=dev).manual_seed(tcfg.seed)
    params = M.init_params(cfg, init_gen, device=dev)
    opt = AdamWConfig(lr=tcfg.lr, weight_decay=tcfg.weight_decay,
                      clip_norm=tcfg.clip_norm)
    state = {"params": params, "opt": init_opt_state(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    sched = cosine_warmup_schedule(tcfg.warmup, tcfg.steps)
    data_cfg = syn.GMLatentConfig(num_classes=max(cfg.num_classes, 1),
                                  latent_size=dcfg.latent_size,
                                  channels=cfg.in_channels)
    it = syn.ShardedIterator(partial(syn.gm_latent_batch, data_cfg),
                             tcfg.global_batch)
    loop_gen = torch.Generator(device=dev).manual_seed(tcfg.seed + 1)
    losses, step_s = [], []
    t0 = time.time()
    for step in range(tcfg.steps):
        ts = time.perf_counter()
        batch = {k: v.to(dev, non_blocking=True)
                 for k, v in next(it).items()}
        if cfg.cond_dim:
            idx = range(step * tcfg.global_batch,
                        (step + 1) * tcfg.global_batch)
            batch["cond"] = syn.cond_stub_batch(
                tcfg.global_batch, 8, cfg.cond_dim, list(idx)).to(dev)
        state, metrics = diffusion_train_step(
            cfg, dcfg, opt, state, batch, generator=loop_gen,
            lr_scale=sched(step))
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - ts)
        if verbose and (step % tcfg.log_every == 0
                        or step == tcfg.steps - 1):
            print(f"step {step:4d} loss {losses[-1]:.4f} "
                  f"({time.time() - t0:.1f}s)")
    return {"state": state, "losses": losses, "step_s": step_s}
