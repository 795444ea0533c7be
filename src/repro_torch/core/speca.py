"""SpeCa forecast-then-verify sampling (paper §3.2–3.4), unguided.

A loop over the lane step of ``repro_torch.core.lane_step``: the sample
batch is the lane batch, every sample occupies one always-active lane,
and the paper's two acceptance semantics are the two accept combiners —
``"batch"`` (the whole batch accepts iff every sample passes) and
``"per_sample"`` (each sample on its own decision).

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
from repro_torch.diffusion.pipeline import latent_shape


def speca_sample(cfg: ModelConfig, params: Dict[str, Any],
                 dcfg: DiffusionConfig, scfg: SpeCaConfig,
                 cond: Dict[str, torch.Tensor], batch: int, *,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None,
                 draft_mode: str = "taylor",
                 accept_mode: str = "batch",
                 device: DeviceLike = "cuda"
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run SpeCa-accelerated sampling; returns (x0, stats). The initial
    latent is ``noise`` when given, else drawn from ``generator``."""
    if accept_mode not in LS.ACCEPT_MODES:
        raise ValueError(f"unknown accept_mode {accept_mode!r}")
    wl = DiffusionWorkload(cfg, params, dcfg, scfg, device=device)
    S = wl.num_steps
    step = LS.build_workload_step(wl, lanes=batch, draft_mode=draft_mode,
                                  accept_mode=accept_mode,
                                  verify_backend="jnp")
    if noise is None:
        gen_dev = generator.device if generator is not None else "cpu"
        noise = torch.randn(latent_shape(cfg, dcfg, batch),
                            generator=generator, device=gen_dev)
    state = LS.init_workload_state(wl, batch, cond, x=noise, active=True)
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
    return state["x"], stats
