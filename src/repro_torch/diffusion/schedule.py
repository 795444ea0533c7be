"""Noise schedules: DDPM (linear/cosine) with DDIM, and rectified flow.

The tables are built in float64 with numpy and stored as f32, exactly as
the reference does, so both packages index identical values.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DDPMSchedule:
    betas: torch.Tensor            # [T] f32
    alphas_bar: torch.Tensor       # [T] f32

    @property
    def num_steps(self) -> int:
        return int(self.betas.shape[0])


def make_schedule(kind: str, num_steps: int,
                  device: torch.device) -> DDPMSchedule:
    if kind == "linear":
        betas = np.linspace(1e-4, 0.02, num_steps, dtype=np.float64)
    elif kind == "cosine":
        s = 0.008
        ts = np.arange(num_steps + 1, dtype=np.float64) / num_steps
        f = np.cos((ts + s) / (1 + s) * math.pi / 2) ** 2
        ab = f / f[0]
        betas = np.clip(1 - ab[1:] / ab[:-1], 0, 0.999)
    else:
        raise ValueError(f"unknown schedule {kind!r}")
    alphas_bar = np.cumprod(1.0 - betas)
    return DDPMSchedule(
        betas=torch.tensor(betas.astype(np.float32), device=device),
        alphas_bar=torch.tensor(alphas_bar.astype(np.float32),
                                device=device))


def inference_timesteps(num_train: int, num_inference: int,
                        device: torch.device) -> torch.Tensor:
    """Evenly spaced decreasing timestep indices, e.g. 50 of 1000."""
    step = num_train // num_inference
    ts = (np.arange(num_inference) * step)[::-1].copy()
    return torch.tensor(ts, dtype=torch.int64, device=device)


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (ndim - 1)) if v.dim() else v


def ddim_step(sched: DDPMSchedule, x: torch.Tensor, eps: torch.Tensor,
              t: torch.Tensor, t_prev: torch.Tensor) -> torch.Tensor:
    """Deterministic DDIM (η=0) update from timestep t to t_prev; t may be
    a scalar or per-lane [B]."""
    ab_t = sched.alphas_bar[t]
    ab_p = torch.where(t_prev >= 0, sched.alphas_bar[t_prev.clamp(min=0)],
                       torch.ones_like(ab_t))
    ab_t, ab_p = _bcast(ab_t, x.dim()), _bcast(ab_p, x.dim())
    x = x.to(torch.float32)
    eps = eps.to(torch.float32)
    x0 = (x - torch.sqrt(1.0 - ab_t) * eps) / torch.sqrt(ab_t)
    return torch.sqrt(ab_p) * x0 + torch.sqrt(1.0 - ab_p) * eps


# --- rectified flow -------------------------------------------------------

def q_sample(sched: DDPMSchedule, x0: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward process: x_t = √ᾱ_t·x0 + √(1−ᾱ_t)·ε; t [B] ints."""
    ab = sched.alphas_bar[t].reshape((-1,) + (1,) * (x0.dim() - 1))
    return torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * noise


def rf_timesteps(num_inference: int, device: torch.device) -> torch.Tensor:
    """σ grid 1 → 0 (exclusive of the final 0), FLUX-style uniform:
    σ_i = 1 − i·(1/n) in f32 — the arithmetic XLA compiles
    ``jnp.linspace(1, 0, n+1)`` to (a product with the reciprocal), so
    both packages hold the same grid bit for bit."""
    i = torch.arange(num_inference, dtype=torch.float32, device=device)
    return 1.0 - i * torch.tensor(1.0 / num_inference, dtype=torch.float32,
                                  device=device)


def rf_interpolate(x0: torch.Tensor, noise: torch.Tensor,
                   sigma: torch.Tensor) -> torch.Tensor:
    """x_σ = (1−σ)·x_data + σ·ε."""
    s = sigma.reshape((-1,) + (1,) * (x0.dim() - 1))
    return (1.0 - s) * x0 + s * noise


def rf_velocity_target(x0: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """dx/dσ = ε − x_data (the model regresses this)."""
    return noise - x0


def rf_euler_step(x: torch.Tensor, v: torch.Tensor, sigma: torch.Tensor,
                  sigma_next: torch.Tensor) -> torch.Tensor:
    dt = _bcast(sigma_next - sigma, x.dim())
    return x.to(torch.float32) + dt * v.to(torch.float32)
