"""The one forecast-then-verify step (paper §3.2–3.4) over a lane batch.

Both execution paths — the sampler (``repro_torch.core.speca``, where the
sample batch is the lane batch) and the serving engine — advance their
state through the step built here, at depth 1 and without guidance:

  1. *Draft* (runs iff ANY lane is warm and under its draft budget): the
     fused per-lane predict kernel forecasts every lane's residual
     increments from its own anchor, and the backbone runs with compute
     masked to the verify layer.
  2. *Verify*: each lane's relative error against its own τ_t — the fused
     verify kernel (``verify_backend="fused"``, rel-L2 only) or the
     metric-general path (``"jnp"``, named after the reference's).
  3. *Accept combiner*: ``per_sample`` accepts each lane on its own bit;
     ``batch`` accepts iff every drafting lane passes.
  4. *Masked refresh* (runs iff ANY active lane rejected): the full
     forward serves the rejected lanes and the refresh kernel updates only
     their table slices; accepted lanes advance on the speculative output.

The reference decides the two "runs iff" branches on the device with
``lax.cond``. Eager PyTorch decides them on the host, which costs one
device sync per branch per tick; :attr:`LaneStep.host_syncs` counts them.
Both branches are never computed.

State (all on the device): ``since`` [W] i32 consecutive accepted drafts,
``step`` [W] i32 schedule step, ``active`` [W] bool occupancy, ``tau0``
[W] f32 per-lane base threshold, ``cond`` {k: [W, …]}, the workload
payload (diffusion: ``x`` [W, H, W, C] f32) and the table
(``diffs`` [m+1, L, 2, W, T, D], ``n_anchors``/``anchor_step``/``gap``
[W]).

Flags per tick ([W]): ``attempted``, ``ok``, ``accepted``, ``full``,
``err`` (NaN where the lane did not draft), ``tau``, and the counters
``n_spec``/``n_drafted``/``advanced``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import (DiffusionConfig, ModelConfig, SpeCaConfig,
                                 torch_dtype)
from repro_torch.core import taylor
from repro_torch.core.forecaster import TaylorForecaster
from repro_torch.core.verify import relative_error, threshold_schedule
from repro_torch.kernels import ops

ACCEPT_MODES = ("batch", "per_sample")
VERIFY_BACKENDS = ("fused", "jnp")

# the per-tick [W] counters the engine's accounting reads
COUNTER_FLAGS = ("attempted", "accepted", "full",
                 "n_spec", "n_drafted", "advanced")

State = Dict[str, Any]


def verify_layer(cfg: ModelConfig, scfg: SpeCaConfig) -> int:
    """Resolved verify-layer index (negative config values wrap)."""
    return scfg.verify_layer % cfg.num_layers


def num_tokens(cfg: ModelConfig, dcfg: DiffusionConfig) -> int:
    """Backbone sequence length: patches per latent."""
    return (dcfg.latent_size // cfg.patch_size) ** 2


def table_dtype(cfg: ModelConfig, scfg: SpeCaConfig) -> torch.dtype:
    """Difference-table dtype: ``scfg.table_dtype`` or the model dtype."""
    return torch_dtype(scfg.table_dtype or cfg.dtype)


def init_workload_state(wl, lanes: int, cond_template: Dict[str, Any], *,
                        x: Optional[torch.Tensor] = None,
                        active: bool = False) -> State:
    """Fresh lane-batch state on the workload's device. ``cond_template``
    supplies per-key shapes (its leading axis is replaced by ``lanes``);
    pass ``x`` to start from a concrete latent (the sampler) instead of
    zeros (the engine)."""
    W, dev = lanes, wl.device
    fc = TaylorForecaster()
    feat_shape = taylor.feature_shape_for(wl.cfg.num_layers, W,
                                          wl.num_tokens, wl.cfg.d_model)
    tstate = fc.init_state(wl.scfg.taylor_order, feat_shape, wl.table_dtype,
                           W, dev)
    cond = {}
    for k, v in cond_template.items():
        v = torch.as_tensor(v, device=dev)
        cond[k] = torch.broadcast_to(v, (W,) + tuple(v.shape[1:])).clone()
    return {
        "since": torch.zeros((W,), dtype=torch.int32, device=dev),
        "step": torch.zeros((W,), dtype=torch.int32, device=dev),
        "active": torch.full((W,), bool(active), device=dev),
        "tau0": torch.full((W,), float(wl.scfg.tau0), dtype=torch.float32,
                           device=dev),
        "cond": cond,
        **wl.init_payload(W, x=x),
        **tstate,
    }


class LaneStep:
    """The built lane step: ``step(state) -> (state, flags)``. Counts the
    host syncs its two data-dependent branches cost in ``host_syncs``."""

    def __init__(self, wl, *, lanes: int, draft_mode: str,
                 accept_mode: str, verify_backend: str) -> None:
        if accept_mode not in ACCEPT_MODES:
            raise ValueError(f"unknown accept_mode {accept_mode!r}")
        if verify_backend not in VERIFY_BACKENDS:
            raise ValueError(f"unknown verify_backend {verify_backend!r}")
        if wl.scfg.error_metric != "rel_l2":
            verify_backend = "jnp"   # the fused kernel implements eq. 4 only
        self.wl, self.W = wl, lanes
        self.fc = TaylorForecaster()
        self.draft_mode = draft_mode
        self.accept_mode = accept_mode
        self.verify_backend = verify_backend
        self.host_syncs = 0

    def _any(self, t: torch.Tensor) -> bool:
        self.host_syncs += 1
        return bool(t.any())

    def verify(self, pred_vl, real_vl, tau):
        """(err [W], ok [W]) — the same math on every execution path."""
        W, scfg = self.W, self.wl.scfg
        if self.verify_backend == "fused":
            return ops.verify_accept(pred_vl.reshape(W, -1),
                                     real_vl.reshape(W, -1), tau,
                                     eps=scfg.eps)
        err = relative_error(pred_vl, real_vl, metric=scfg.error_metric,
                             eps=scfg.eps, batch_axis=0)
        return err, err <= tau

    def __call__(self, state: State) -> Tuple[State, Dict[str, Any]]:
        wl, fc, W = self.wl, self.fc, self.W
        scfg, vl = wl.scfg, wl.verify_layer
        dyn = {k: state[k] for k in wl.dyn_keys}
        since, s, active = state["since"], state["step"], state["active"]
        cond = state["cond"]
        tstate = {k: state[k] for k in fc.state_keys}
        s_eff = torch.clamp(s, max=wl.num_steps - 1)
        ctx = wl.step_context(state, s_eff)
        warm = fc.warm(tstate, scfg)
        want = active & warm & (since < scfg.max_draft)
        # per-lane τ_t = τ0·β^((T−t)/T) at each lane's own step
        tau = threshold_schedule(wl.t_frac(s_eff), state["tau0"], scfg.beta)
        nan = torch.full((W,), float("nan"), dtype=torch.float32,
                         device=wl.device)

        if self._any(want):
            preds = fc.predict_lanes(tstate, s_eff, mode=self.draft_mode)
            out_spec, real_vl = wl.spec_forward(dyn, cond, ctx, preds)
            pred_vl = preds[vl][0] + preds[vl][1]
            err, ok = self.verify(pred_vl, real_vl, tau)
            # NaN marks "did not draft": it fails every `err <= tau`
            err, ok = torch.where(want, err, nan), ok & want
        else:
            out_spec = wl.zero_out(W)
            err, ok = nan, torch.zeros_like(want)
        if self.accept_mode == "batch":
            # parity mode: every drafting lane must pass or all reject
            accept = want & torch.all(ok | ~want)
        else:
            accept = want & ok
        full = active & ~accept

        if self._any(full):
            out_full, branches = wl.full_forward(dyn, cond, ctx)
            tstate = fc.update_lanes(tstate, branches, s_eff, full)
        else:
            out_full = wl.zero_out(W)
        out = wl.select_out(accept, out_spec, out_full)
        dyn = wl.select_dyn(active, wl.advance(dyn, out, ctx, s_eff), dyn)
        since = torch.where(accept, since + 1,
                            torch.where(active, torch.zeros_like(since),
                                        since))
        new_state = dict(state)
        new_state.update(since=since, step=s + active.to(torch.int32),
                         **dyn, **tstate)
        flags = {"attempted": want, "ok": ok, "accepted": accept,
                 "full": full, "err": err, "tau": tau,
                 "n_spec": accept.to(torch.int32),
                 "n_drafted": want.to(torch.int32),
                 "advanced": active.to(torch.int32)}
        return new_state, flags


def build_workload_step(wl, *, lanes: int, draft_mode: str = "taylor",
                        accept_mode: str = "per_sample",
                        verify_backend: str = "jnp") -> LaneStep:
    """Build the depth-1, unguided lane step (Taylor forecaster) for a
    ``Workload``; ``draft_mode`` picks the weights of
    ``taylor.prediction_weights``."""
    return LaneStep(wl, lanes=lanes, draft_mode=draft_mode,
                    accept_mode=accept_mode, verify_backend=verify_backend)
