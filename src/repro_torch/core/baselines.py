"""Baseline acceleration methods the paper compares against (Tables 1–3),
the reference's ``repro.core.baselines``.

All share the cached-sampling loop; they differ only in (a) the anchor
schedule and (b) the draft used on non-anchor steps:

  * ``step_reduction`` — plain DDIM/RF with fewer steps (no caching).
  * ``fora``       — full compute every N steps, order-0 reuse between.
  * ``taylorseer`` — anchors every N steps, m-th order Taylor forecast
                     between, no verification.
  * ``ab2``        — Adams–Bashforth-2 draft, anchors every N steps.
  * ``teacache``   — order-0 reuse with a dynamic anchor schedule driven
                     by the accumulated relative change of the timestep
                     embedding (threshold ``l``).

None of them verifies. The reference decides each step's branch with a
``lax.cond`` on device values; here the decision is a host branch: the
anchor count is a host counter, and TeaCache's accumulated change is a
function of the schedule alone (``timestep_embedding`` of the model
timesteps), computed on the host in f32 before the loop, so no step
waits on the device. The draft uses the plain whole-batch
``taylor.predict``/``update``, as the reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs import DiffusionConfig, ModelConfig
from repro_torch.core import taylor
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.diffusion.pipeline import (latent_shape, make_stepper,
                                            model_inputs, sample_full)
from repro_torch.layers import embeddings as emb
from repro_torch.layers import model as M


@dataclasses.dataclass(frozen=True)
class CachePolicy:
    name: str
    interval: int = 5          # N: anchor period (static policies)
    order: int = 2             # Taylor order m
    draft_mode: str = "taylor"  # taylor | reuse | ab2 | newton
    tea_threshold: float = 0.3  # TeaCache accumulated-change threshold


def fora(interval: int) -> CachePolicy:
    return CachePolicy(name="fora", interval=interval, order=0,
                       draft_mode="reuse")


def taylorseer(interval: int, order: int = 2,
               draft_mode: str = "taylor") -> CachePolicy:
    return CachePolicy(name="taylorseer", interval=interval, order=order,
                       draft_mode=draft_mode)


def ab2(interval: int) -> CachePolicy:
    return CachePolicy(name="ab2", interval=interval, order=2,
                       draft_mode="ab2")


def teacache(threshold: float) -> CachePolicy:
    return CachePolicy(name="teacache", interval=10_000, order=0,
                       draft_mode="reuse", tea_threshold=threshold)


def tea_deltas(cfg: ModelConfig, t_model: torch.Tensor) -> List[torch.Tensor]:
    """TeaCache's per-step change signal: ‖e(t_s) − e(t_{s−1})‖ /
    (‖e(t_{s−1})‖ + 1e-8) of the timestep embeddings, f32 CPU scalars
    (step 0 compares with itself: 0)."""
    t = t_model.detach().to("cpu", torch.float32)
    out = []
    for s in range(t.shape[0]):
        prev = emb.timestep_embedding(t[max(s - 1, 0)][None], cfg.d_model)
        cur = emb.timestep_embedding(t[s][None], cfg.d_model)
        out.append(torch.linalg.norm(cur - prev)
                   / (torch.linalg.norm(prev) + 1e-8))
    return out


def full_schedule(cfg: ModelConfig, policy: CachePolicy,
                  t_model: torch.Tensor) -> List[bool]:
    """Which steps of the schedule ``t_model`` [S] run a full forward: the
    first ``order + 1`` (the table warms up), then every ``interval``-th
    step past an anchor, or (TeaCache) the steps whose accumulated change
    since the last anchor passes the threshold."""
    deltas = tea_deltas(cfg, t_model) if policy.name == "teacache" else None
    n_anchors, since = 0, 0
    tea_acc = torch.zeros((), dtype=torch.float32)
    out = []
    for s in range(t_model.shape[0]):
        cold = n_anchors <= policy.order
        if deltas is not None:
            tea_acc = tea_acc + deltas[s]
            do_full = cold or bool(tea_acc > policy.tea_threshold)
        else:
            do_full = cold or since >= policy.interval - 1
        if do_full:
            n_anchors, since = n_anchors + 1, 0
            tea_acc = torch.zeros((), dtype=torch.float32)
        else:
            since += 1
        out.append(do_full)
    return out


@torch.no_grad()
def cached_sample(cfg: ModelConfig, params: Dict[str, Any],
                  dcfg: DiffusionConfig, policy: CachePolicy,
                  cond: Dict[str, Any], batch: int, *,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None,
                  collect_trajectory: bool = False,
                  use_flash: bool = False,
                  device: DeviceLike = "cuda"
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run a non-verifying cache-accelerated sampler -> (x0, stats). The
    initial latent is ``noise`` when given, else drawn from ``generator``
    (``speca_sample``'s convention). ``use_flash`` is accepted for the
    reference's signature: DiT attention is bidirectional and never
    reaches the flash kernel."""
    del use_flash
    dev = resolve_device(device)
    stepper = make_stepper(dcfg, dev)
    S, L = stepper.num_steps, cfg.num_layers
    per_frame = (dcfg.latent_size // cfg.patch_size) ** 2
    n_tok = per_frame * max(dcfg.num_frames, 1)
    if noise is None:
        gen_dev = generator.device if generator is not None else "cpu"
        noise = torch.randn(latent_shape(cfg, dcfg, batch),
                            generator=generator, device=gen_dev)
    x = noise.to(device=dev, dtype=torch.float32)
    feat_shape = taylor.feature_shape_for(L, batch, n_tok, cfg.d_model)
    tstate = taylor.init_state(policy.order, feat_shape, cfg.torch_dtype,
                               device=dev)
    no_compute = [False] * L
    full_step = full_schedule(cfg, policy, stepper.t_model)
    traj = []
    for s in range(S):
        inputs = model_inputs(cfg, x, stepper.t_model[s], cond)
        if full_step[s]:
            out, extras = M.dit_forward(cfg, params, inputs,
                                        collect_branches=True)
            tstate = taylor.update(tstate, extras["branches"], s)
        else:
            preds = taylor.predict(tstate, s, mode=policy.draft_mode)
            out, _ = M.dit_forward(cfg, params, inputs, branch_preds=preds,
                                   compute_mask=no_compute)
        x = stepper.advance(x, out.to(torch.float32), s)
        if collect_trajectory:
            traj.append(x)
    num_full = sum(full_step)
    stats: Dict[str, Any] = {
        "num_steps": S, "num_full": num_full, "num_spec": S - num_full,
        "full_step": torch.tensor(full_step),
        "alpha": 1.0 - num_full / S}
    if collect_trajectory:
        stats["trajectory"] = torch.stack(traj)
    return x, stats


@torch.no_grad()
def step_reduction_sample(cfg: ModelConfig, params: Dict[str, Any],
                          dcfg: DiffusionConfig, fraction: float,
                          cond: Dict[str, Any], batch: int, *,
                          generator: Optional[torch.Generator] = None,
                          noise: Optional[torch.Tensor] = None,
                          use_flash: bool = False,
                          device: DeviceLike = "cuda"
                          ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The plain sampler at a reduced step count (e.g. 25 of 50)."""
    del use_flash
    steps = max(int(round(dcfg.num_inference_steps * fraction)), 2)
    dcfg2 = dataclasses.replace(dcfg, num_inference_steps=steps)
    x = sample_full(cfg, params, dcfg2, cond, batch, generator=generator,
                    noise=noise, device=device)
    return x, {"num_steps": steps, "num_full": steps, "num_spec": 0}
