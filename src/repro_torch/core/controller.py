"""Closed-loop per-lane τ/depth/order controller (sample-adaptive SpeCa;
the counterpart of ``repro.core.controller``).

A request that carries a ``ControllerPolicy`` (``RequestPolicy.controller``)
gets a per-lane feedback controller that adapts τ0, the draft depth and the
forecast order in flight from the lane's own accept statistics, as
lane-local ``[W]`` state tensors updated on the device after every tick (no
host sync).

``slo="accept"`` (default) holds the lane's per-drafted-position accept rate
at ``target_accept``: above it ``draft_k`` steps up and τ0 relaxes back
toward, never above, the request's base τ0; below it ``draft_k`` and the
order cap step down and τ0 tightens by ``1 − gain·(target − rate)``.
Sustained rejects therefore never raise speculation, and τ0 ≤ base always.

``slo="deadline"`` paces the lane to finish within ``deadline_ticks``
ticks: behind its pace it speculates deeper and relaxes τ0 up to
``tau_max`` (which may exceed the base); well ahead it tightens τ0 and
steps ``draft_k`` down.

Every adapted value is clamped to the policy's bounds each tick. Lanes that
are finished, controller-off, or drafted nothing this tick keep their state
unchanged, so controller-off requests sharing a batch with controlled ones
are bitwise unaffected.

The reference runs the update inside a jitted step, where XLA contracts a
product followed by an add into one fused multiply-add. :func:`_fma`
rounds those expressions once, as the fused instruction does, so the f32
state matches the reference's (``1 − 0.5·gain`` needs no care: halving is
exact)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

#: state keys the controller adds to the lane batch (all [W])
CONTROLLER_KEYS: Tuple[str, ...] = (
    "ctl_on", "ctl_dl", "ctl_rate", "ctl_adv", "ctl_target", "ctl_gain",
    "ctl_ema", "ctl_tau_lo", "ctl_tau_hi", "ctl_tau_base", "ctl_k_lo",
    "ctl_k_hi", "ctl_order", "ctl_order_lo", "ctl_order_hi", "ctl_ticks",
    "ctl_deadline",
)

SLO_MODES = ("accept", "deadline")


@dataclass(frozen=True)
class ControllerPolicy:
    """Per-request closed-loop adaptation policy (see the module docstring).

    ``tau_max=None`` bounds τ0 by the request's base τ0 (accept mode always
    does); ``order_max=None`` bounds the forecast-order cap by the config's
    ``taylor_order``; ``k_max`` is also clamped by the engine's
    ``max_draft_depth`` at fill time."""

    slo: str = "accept"
    target_accept: float = 0.6
    gain: float = 0.25
    ema: float = 0.8
    tau_min: float = 1e-4
    tau_max: Optional[float] = None
    k_min: int = 1
    k_max: int = 8
    order_min: int = 0
    order_max: Optional[int] = None
    deadline_ticks: Optional[float] = None

    def __post_init__(self) -> None:
        if self.slo not in SLO_MODES:
            raise ValueError(f"unknown controller slo {self.slo!r} "
                             f"(have {SLO_MODES})")
        if not 0.0 < self.target_accept <= 1.0:
            raise ValueError("target_accept must be in (0, 1], "
                             f"got {self.target_accept}")
        if not 0.0 < self.gain <= 1.0:
            raise ValueError(f"gain must be in (0, 1], got {self.gain}")
        if not 0.0 <= self.ema < 1.0:
            raise ValueError(f"ema must be in [0, 1), got {self.ema}")
        if self.tau_min < 0.0:
            raise ValueError(f"tau_min must be >= 0, got {self.tau_min}")
        if self.tau_max is not None and self.tau_max < self.tau_min:
            raise ValueError(f"tau_max={self.tau_max} < "
                             f"tau_min={self.tau_min}")
        if self.k_min < 1 or self.k_max < self.k_min:
            raise ValueError(f"need 1 <= k_min <= k_max, got "
                             f"k_min={self.k_min}, k_max={self.k_max}")
        if self.order_min < 0:
            raise ValueError(f"order_min must be >= 0, "
                             f"got {self.order_min}")
        if self.order_max is not None and self.order_max < self.order_min:
            raise ValueError(f"order_max={self.order_max} < "
                             f"order_min={self.order_min}")
        if self.slo == "deadline":
            if self.deadline_ticks is None or self.deadline_ticks <= 0:
                raise ValueError("slo='deadline' needs deadline_ticks > 0")


def init_controller_state(lanes: int, order: int,
                          device: DeviceLike = "cuda"
                          ) -> Dict[str, torch.Tensor]:
    """Fresh (all-off) controller state tensors for a lane batch on
    ``device`` (the card unless the caller passes ``device="cpu"``). Off
    lanes carry ``ctl_order = order`` (the full forecast order), so the
    order cap leaves their prediction weights as the controller-free
    program's."""
    W, device = lanes, resolve_device(device)

    def full(v, dtype):
        return torch.full((W,), v, dtype=dtype, device=device)

    f32, i32 = torch.float32, torch.int32
    return {
        "ctl_on": full(False, torch.bool),
        "ctl_dl": full(False, torch.bool),
        **{k: full(0.0, f32) for k in (
            "ctl_rate", "ctl_adv", "ctl_target", "ctl_gain", "ctl_ema",
            "ctl_tau_lo", "ctl_tau_hi", "ctl_tau_base")},
        "ctl_k_lo": full(1, i32),
        "ctl_k_hi": full(1, i32),
        "ctl_order": full(int(order), i32),
        "ctl_order_lo": full(int(order), i32),
        "ctl_order_hi": full(int(order), i32),
        "ctl_ticks": full(0, i32),
        "ctl_deadline": full(0.0, f32),
    }


def lane_values(pol: Optional[ControllerPolicy], *, tau0: float,
                order: int, max_draft_depth: int) -> Dict[str, Any]:
    """Host-side per-lane controller state for one filled request.
    ``pol=None`` writes the all-off row; ``tau0`` is the lane's resolved
    base threshold, ``order`` the config's forecast order and
    ``max_draft_depth`` the engine's chain bound."""
    if pol is None:
        return {"ctl_on": False, "ctl_dl": False, "ctl_rate": 0.0,
                "ctl_adv": 0.0, "ctl_target": 0.0, "ctl_gain": 0.0,
                "ctl_ema": 0.0, "ctl_tau_lo": 0.0, "ctl_tau_hi": 0.0,
                "ctl_tau_base": 0.0, "ctl_k_lo": 1, "ctl_k_hi": 1,
                "ctl_order": int(order), "ctl_order_lo": int(order),
                "ctl_order_hi": int(order), "ctl_ticks": 0,
                "ctl_deadline": 0.0}
    o_hi = int(order) if pol.order_max is None else min(int(pol.order_max),
                                                        int(order))
    o_lo = min(int(pol.order_min), o_hi)
    k_hi = max(1, min(int(pol.k_max), int(max_draft_depth)))
    k_lo = max(1, min(int(pol.k_min), k_hi))
    tau_lo = min(float(pol.tau_min), float(tau0))
    if pol.slo == "deadline" and pol.tau_max is not None:
        tau_hi = max(float(pol.tau_max), float(tau0))
    else:
        # the accept-SLO quality guarantee: τ0 never exceeds its base
        tau_hi = float(tau0)
    deadline = float(pol.deadline_ticks or 0.0)
    return {"ctl_on": True, "ctl_dl": pol.slo == "deadline",
            "ctl_rate": float(pol.target_accept), "ctl_adv": 1.0,
            "ctl_target": float(pol.target_accept),
            "ctl_gain": float(pol.gain), "ctl_ema": float(pol.ema),
            "ctl_tau_lo": tau_lo, "ctl_tau_hi": tau_hi,
            "ctl_tau_base": float(tau0), "ctl_k_lo": k_lo,
            "ctl_k_hi": k_hi, "ctl_order": o_hi, "ctl_order_lo": o_lo,
            "ctl_order_hi": o_hi, "ctl_ticks": 0,
            "ctl_deadline": deadline}


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a·b + c rounded once to f32, as a fused multiply-add rounds it: the
    f32 product is exact in f64, so only the sum rounds there first."""
    return (a.to(torch.float64) * b + c).to(torch.float32)


def controller_update(state: Dict[str, Any], *, step_new, n_spec,
                      n_drafted, advanced, active) -> Dict[str, Any]:
    """One controller tick over the lane batch.

    Reads the lane-batch ``state`` (controller tensors and ``tau0`` /
    ``draft_k`` / ``max_step``) and this tick's [W] i32 counters (accepted
    drafted steps, drafted positions, total schedule advance); returns the
    adapted ``{tau0, draft_k, ctl_rate, ctl_adv, ctl_order, ctl_ticks}``.
    Lane b's outputs depend on lane b's inputs alone."""
    f32, i32 = torch.float32, torch.int32
    on = state["ctl_on"] & active
    ticks = torch.where(on, state["ctl_ticks"] + 1, state["ctl_ticks"])
    adapt = on & (n_drafted > 0)
    inst = n_spec.to(f32) / torch.clamp(n_drafted, min=1).to(f32)
    ema = state["ctl_ema"]
    rate = torch.where(adapt, _fma(ema, state["ctl_rate"],
                                   (1.0 - ema) * inst), state["ctl_rate"])
    adv = torch.where(on, _fma(ema, state["ctl_adv"],
                               (1.0 - ema) * advanced.to(f32)),
                      state["ctl_adv"])
    target, gain = state["ctl_target"], state["ctl_gain"]
    # accept SLO: easy lanes (rate >= target) speculate deeper and relax τ
    # back toward base; hard lanes back off on every axis
    dl_mode = state["ctl_dl"]
    hi_a = adapt & ~dl_mode & (rate >= target)
    lo_a = adapt & ~dl_mode & (rate < target)
    # deadline SLO: steps still owed per remaining tick vs achieved pace
    dl = on & dl_mode
    remaining = torch.clamp(state["ctl_deadline"] - ticks.to(f32), min=1.0)
    need = (state["max_step"] - step_new).to(f32) / remaining
    behind = dl & (need > adv)
    ahead = dl & ~behind & (need <= 0.5 * adv)
    up = hi_a | behind
    down = lo_a | ahead
    move = up | down
    d_adj = state["draft_k"] + up.to(i32) - down.to(i32)
    draft_k = torch.where(on, torch.clamp(d_adj, state["ctl_k_lo"],
                                          state["ctl_k_hi"]),
                          state["draft_k"])
    o_adj = state["ctl_order"] + up.to(i32) - down.to(i32)
    ctl_order = torch.where(on, torch.clamp(o_adj, state["ctl_order_lo"],
                                            state["ctl_order_hi"]),
                            state["ctl_order"])
    relax = torch.where(hi_a, _fma(gain, rate - target, 1.0),
                        torch.where(behind, 1.0 + gain, 1.0))
    tighten = torch.where(lo_a, _fma(-gain, target - rate, 1.0),
                          torch.where(ahead, 1.0 - 0.5 * gain, 1.0))
    tau_adj = state["tau0"] * relax * tighten
    tau0 = torch.where(move, torch.clamp(tau_adj, state["ctl_tau_lo"],
                                         state["ctl_tau_hi"]),
                       state["tau0"])
    return {"tau0": tau0, "draft_k": draft_k, "ctl_rate": rate,
            "ctl_adv": adv, "ctl_order": ctl_order, "ctl_ticks": ticks}
