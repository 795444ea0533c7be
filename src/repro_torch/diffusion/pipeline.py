"""Diffusion sampling pipeline — the non-accelerated reference path.

``make_stepper`` abstracts DDIM vs rectified flow so the SpeCa lane step
and the reference sampler share one stepping interface.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import DiffusionConfig, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.diffusion import schedule as sch
from repro_torch.layers import model as M


@dataclasses.dataclass(frozen=True)
class Stepper:
    """Per-step tensors for a fixed inference schedule of S steps."""

    num_steps: int
    t_model: torch.Tensor     # [S] value fed to the model's t input
    t_frac: torch.Tensor      # [S] t/T in [0, 1] (τ schedule; 1 = start)
    _advance: Callable        # (x, out, s) -> x_next

    def advance(self, x, out, s):
        return self._advance(x, out, s)


def make_stepper(dcfg: DiffusionConfig, device: torch.device) -> Stepper:
    S = dcfg.num_inference_steps
    if dcfg.schedule == "rectified_flow":
        sigmas = sch.rf_timesteps(S, device)
        sigmas_next = torch.cat([sigmas[1:],
                                 torch.zeros((1,), device=device)])

        def advance(x, v, s):
            return sch.rf_euler_step(x, v, sigmas[s], sigmas_next[s])

        return Stepper(num_steps=S, t_model=sigmas * 1000.0,
                       t_frac=sigmas, _advance=advance)

    sched = sch.make_schedule(dcfg.schedule, dcfg.num_train_timesteps,
                              device)
    ts = sch.inference_timesteps(dcfg.num_train_timesteps, S, device)
    ts_prev = torch.cat([ts[1:], torch.full((1,), -1, dtype=ts.dtype,
                                            device=device)])

    def advance(x, eps, s):
        return sch.ddim_step(sched, x, eps, ts[s], ts_prev[s])

    return Stepper(num_steps=S, t_model=ts.to(torch.float32),
                   t_frac=ts.to(torch.float32)
                   / float(dcfg.num_train_timesteps), _advance=advance)


def latent_shape(cfg: ModelConfig, dcfg: DiffusionConfig,
                 batch: int) -> Tuple[int, ...]:
    """[B, H, W, C], or [B, F, H, W, C] for video (``num_frames`` > 1)."""
    s = dcfg.latent_size
    if dcfg.num_frames > 1:
        return (batch, dcfg.num_frames, s, s, cfg.in_channels)
    return (batch, s, s, cfg.in_channels)


def model_inputs(cfg: ModelConfig, x: torch.Tensor, t_model: torch.Tensor,
                 cond: Dict[str, Any]) -> Dict[str, Any]:
    B = x.shape[0]
    inputs: Dict[str, Any] = {"latents": x,
                              "t": torch.broadcast_to(t_model, (B,))}
    inputs.update(cond)
    return inputs


def null_cond_like(cfg: ModelConfig,
                   cond: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The unconditional counterpart of a conditioning dict (CFG ∅): class
    labels map to the null class (the last label row), continuous
    conditioning zeros out."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in cond.items():
        if k == "labels":
            out[k] = torch.full_like(v, cfg.num_classes)
        else:
            out[k] = torch.zeros_like(v)
    return out


def guided_output(out_c: torch.Tensor, out_u: torch.Tensor,
                  guidance_scale) -> torch.Tensor:
    """Classifier-free guidance combination ``u + s·(c − u)``: ``s = 1``
    recovers the conditional stream, ``s > 1`` extrapolates away from the
    unconditional one. ``guidance_scale`` is a number or a tensor whose
    shape leads ``out_c``'s (one scale per row).

    The reference's type promotion: ``c − u`` in the outputs' dtype, then
    the product and the sum in f32 (or wider), three IEEE roundings as
    three eager ops. Neither ``torch.lerp`` nor ``addcmul``: they round
    differently. The kernel's planes restate it (``kernels.ref.
    mixed_planes_ref``, the ``verify_accept_mixed`` entry)."""
    dt = torch.promote_types(torch.promote_types(out_c.dtype, out_u.dtype),
                             torch.float32)
    s = torch.as_tensor(guidance_scale, dtype=torch.float32,
                        device=out_c.device)
    s = s.reshape(tuple(s.shape) + (1,) * (out_c.dim() - s.dim())).to(dt)
    return out_u.to(dt) + s * (out_c - out_u).to(dt)


def sample_full(cfg: ModelConfig, params: Dict[str, Any],
                dcfg: DiffusionConfig, cond: Dict[str, torch.Tensor],
                batch: int, *, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                guidance_scale: Optional[float] = None,
                null_cond: Optional[Dict[str, torch.Tensor]] = None,
                device: DeviceLike = "cuda") -> torch.Tensor:
    """Reference sampler: a full forward at every step (the 1.00×
    baseline). The initial latent comes from ``noise`` when given, else
    from ``generator``.

    ``guidance_scale`` switches on two-pass classifier-free guidance:
    every step runs the denoiser on ``cond`` and on ``null_cond``
    (:func:`null_cond_like` of ``cond`` when not given) and advances on
    :func:`guided_output` — the unaccelerated oracle of the paired-lane
    guided paths."""
    dev = resolve_device(device)
    stepper = make_stepper(dcfg, dev)
    shape = latent_shape(cfg, dcfg, batch)
    if noise is None:
        gen_dev = generator.device if generator is not None else "cpu"
        noise = torch.randn(shape, generator=generator, device=gen_dev)
    x = noise.to(device=dev, dtype=torch.float32)
    ncond = None
    if guidance_scale is not None:
        ncond = null_cond if null_cond is not None \
            else null_cond_like(cfg, cond)
    for s in range(stepper.num_steps):
        inputs = model_inputs(cfg, x, stepper.t_model[s], cond)
        out, _ = M.dit_forward(cfg, params, inputs)
        if ncond is not None:
            out_u, _ = M.dit_forward(
                cfg, params, model_inputs(cfg, x, stepper.t_model[s], ncond))
            out = guided_output(out, out_u, guidance_scale)
        x = stepper.advance(x, out, s)
    return x
