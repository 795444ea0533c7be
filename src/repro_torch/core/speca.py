"""SpeCa forecast-then-verify sampling (paper §3.2–3.4).

A loop over the lane step of ``repro_torch.core.lane_step``: the sample
batch is the lane batch, every sample occupies one always-active lane,
and the paper's two acceptance semantics are the two accept combiners —
``"batch"`` (the whole batch accepts iff every sample passes) and
``"per_sample"`` (each sample on its own decision).

Classifier-free guidance (``guidance_scale=``): every sample's cond and
uncond streams occupy a lane pair, verification happens once per pair on
the guided residual ``u + s·(c − u)``, and the latent advances on the
guided model output — the lane step's ``guidance=True`` mode, which the
serving engine's paired slots share.

``stats["err"]`` is NaN at (step, sample) entries where that sample did
not draft; NaN fails every ``err ≤ τ`` comparison and keeps
``nanmean``/``nanpercentile`` usable.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import DiffusionConfig, ModelConfig, SpeCaConfig
from repro_torch.core import lane_step as LS
from repro_torch.core.workload import DiffusionWorkload
from repro_torch.device import DeviceLike
from repro_torch.diffusion.pipeline import latent_shape, null_cond_like


def _interleave_cond(cfg: ModelConfig, cond: Dict[str, Any],
                     null_cond: Optional[Dict[str, Any]],
                     batch: int) -> Dict[str, torch.Tensor]:
    """Pack cond/uncond rows into the (2k, 2k+1) lane-pair layout."""
    ncond = null_cond if null_cond is not None \
        else null_cond_like(cfg, cond)
    out: Dict[str, torch.Tensor] = {}
    for k, v in cond.items():
        v, n = torch.as_tensor(v), torch.as_tensor(ncond[k])
        c = torch.broadcast_to(v, (batch,) + tuple(v.shape[1:]))
        u = torch.broadcast_to(n, (batch,) + tuple(n.shape[1:]))
        out[k] = torch.stack([c, u], dim=1).reshape((2 * batch,)
                                                    + tuple(c.shape[1:]))
    return out


def speca_sample(cfg: ModelConfig, params: Dict[str, Any],
                 dcfg: DiffusionConfig, scfg: SpeCaConfig,
                 cond: Dict[str, torch.Tensor], batch: int, *,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None,
                 draft_mode: str = "taylor",
                 accept_mode: str = "batch",
                 guidance_scale: Optional[float] = None,
                 null_cond: Optional[Dict[str, torch.Tensor]] = None,
                 device: DeviceLike = "cuda"
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run SpeCa-accelerated sampling; returns (x0, stats). The initial
    latent is ``noise`` when given, else drawn from ``generator``.

    ``guidance_scale`` switches on classifier-free guidance: sample k
    occupies lanes 2k (``cond``) and 2k+1 (``null_cond``, else
    ``null_cond_like`` of ``cond``), and its noise seeds both. Latents and
    per-sample stats come back indexed by SAMPLE (the pairs folded to
    their cond lanes: every flag is pair-equal)."""
    if accept_mode not in LS.ACCEPT_MODES:
        raise ValueError(f"unknown accept_mode {accept_mode!r}")
    guided = guidance_scale is not None
    lanes = 2 * batch if guided else batch
    wl = DiffusionWorkload(cfg, params, dcfg, scfg, device=device)
    S = wl.num_steps
    step = LS.build_workload_step(wl, lanes=lanes, draft_mode=draft_mode,
                                  accept_mode=accept_mode,
                                  verify_backend="jnp", guidance=guided)
    if noise is None:
        gen_dev = generator.device if generator is not None else "cpu"
        noise = torch.randn(latent_shape(cfg, dcfg, batch),
                            generator=generator, device=gen_dev)
    if guided:
        lane_cond = _interleave_cond(cfg, cond, null_cond, batch)
        # both lanes of a pair share the sample's latent trajectory
        lane_x = torch.repeat_interleave(noise, 2, dim=0)
    else:
        lane_cond, lane_x = cond, noise
    state = LS.init_workload_state(wl, lanes, lane_cond, x=lane_x,
                                   active=True, guidance=guided)
    if guided:
        state["gscale"] = torch.full((lanes,), float(guidance_scale),
                                     dtype=torch.float32, device=wl.device)
    rows = {k: [] for k in ("accept_b", "accepted", "spec_attempted", "err",
                            "tau")}
    for _ in range(S):
        state, flags = step(state)
        # per-sample pass bits, independent of the combiner
        rows["accept_b"].append(flags["attempted"] & flags["ok"])
        rows["accepted"].append(flags["accepted"])
        rows["spec_attempted"].append(torch.any(flags["attempted"]))
        rows["err"].append(flags["err"])
        rows["tau"].append(flags["tau"][0])   # lanes share the step
    ys = {k: torch.stack(v) for k, v in rows.items()}
    x_out = state["x"]
    if guided:
        # fold the pairs back to samples: flags and x are pair-equal
        for k in ("accept_b", "accepted", "err"):
            ys[k] = ys[k][:, 0::2]
        x_out = x_out[0::2]
    # "spec step" = no full forward ran: every lane accepted
    spec_step = torch.all(ys["accepted"], dim=-1)
    num_spec = torch.sum(spec_step.to(torch.int32))
    stats = {
        "num_steps": S,
        "num_spec": num_spec,
        "num_full": S - num_spec,
        "num_attempted": torch.sum(ys["spec_attempted"].to(torch.int32)),
        "alpha": torch.mean(spec_step.to(torch.float32)),
        "per_sample_accepts": torch.sum(ys["accept_b"].to(torch.int32),
                                        dim=0),
        "alpha_b": torch.mean(ys["accept_b"].to(torch.float32), dim=0),
        "err": ys["err"],
        "tau": ys["tau"],
        "spec_step": spec_step,
        "spec_attempted": ys["spec_attempted"],
        "accept_b": ys["accept_b"],
        "host_syncs": step.host_syncs,
    }
    return x_out, stats
