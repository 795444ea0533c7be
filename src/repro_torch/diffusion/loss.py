"""Diffusion training losses (the reference's ``repro.diffusion.loss``):
ε-prediction under the DDPM schedules and the rectified-flow velocity
target."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import DiffusionConfig, ModelConfig
from repro_torch.diffusion import schedule as sch
from repro_torch.layers import model as M


def diffusion_loss(cfg: ModelConfig, dcfg: DiffusionConfig,
                   params: Dict[str, Any], x0: torch.Tensor,
                   cond: Dict[str, Any], *,
                   generator: Optional[torch.Generator] = None,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The denoiser's mean squared error on x0 [B, (F,) H, W, C] f32 ->
    (loss, {"mse", "aux"}). ``t`` (DDPM: int timesteps [B]; rectified
    flow: σ ∈ [0, 1) [B]) and ``noise`` (x0's shape) are drawn from
    ``generator`` on x0's device unless given (the tests hand in the
    reference's draws)."""
    B, dev = x0.shape[0], x0.device
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator,
                            dtype=torch.float32, device=dev)
    if dcfg.schedule == "rectified_flow":
        sigma = t if t is not None else torch.rand(
            (B,), generator=generator, dtype=torch.float32, device=dev)
        x_t = sch.rf_interpolate(x0, noise, sigma)
        target = sch.rf_velocity_target(x0, noise)
        t_model = sigma * 1000.0
    else:
        sched = sch.make_schedule(dcfg.schedule, dcfg.num_train_timesteps,
                                  dev)
        if t is None:
            t = torch.randint(0, dcfg.num_train_timesteps, (B,),
                              generator=generator, device=dev)
        x_t = sch.q_sample(sched, x0, t, noise)
        target = noise
        t_model = t.to(torch.float32)
    inputs: Dict[str, Any] = {"latents": x_t, "t": t_model}
    inputs.update(cond)
    pred, extras = M.dit_forward(cfg, params, inputs)
    loss = torch.mean(torch.square(pred.to(torch.float32) - target))
    return loss, {"mse": loss, "aux": extras["aux_loss"]}
