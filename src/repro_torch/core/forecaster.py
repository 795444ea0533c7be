"""The forecaster seam of the lane step (the draft model).

A ``Forecaster`` owns the table layout, the fused per-lane prediction
(one step and a draft-K chain) and the lane-masked anchor refresh; the
lane step calls only this surface. The table never rolls back: a draft-K
chain restores only the payload (``Workload.rollback``). Two ship, as in
the reference:

``TaylorForecaster`` (default)
    TaylorSeer difference tables (``repro_torch.core.taylor``).
``SpectralForecaster``
    Damped-DFT band extrapolation over a ring of the last m+1 raw anchor
    snapshots, in the same ``[m+1, L, 2, W, T, D]`` layout and anchor
    metadata as the Taylor table (row 0 = the newest anchor). Its refresh
    is the ring-shift kernel; its predictions run the Taylor predict
    kernels with other weight columns (:func:`spectral_weights`).

``order_cap`` (both forecasters): an optional per-lane [B] i32 tensor that
caps the forecast order — Taylor trusts only Δ⁰..Δ^cap, spectral keeps only
the bands ν_k ≤ cap. ``None`` leaves the weights as they are; the
controller (``repro_torch.core.controller``) passes its per-lane order.

``mesh=`` (both forecasters, as ``repro_torch.core.taylor``'s): the table
is lane-sharded, every per-lane argument is a sequence of D per-shard
values, the kernels run once per shard through their ``ops.*_sharded``
routings, and the result is one value per shard.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import taylor
from repro_torch.kernels import ops


class Forecaster:
    """The lane-step forecaster protocol: ``init_state`` returns a dict
    with exactly ``state_keys`` — the feature table under ``"diffs"``
    (layout ``[m+1, *feat_shape]``) plus the per-lane anchor metadata."""

    name: str = "?"
    state_keys: Tuple[str, ...] = ("diffs", "n_anchors", "anchor_step",
                                   "gap")

    def init_state(self, order: int, feat_shape, dtype: torch.dtype,
                   lanes: int, device: torch.device
                   ) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def warm(self, tstate: Dict[str, torch.Tensor], scfg) -> torch.Tensor:
        """[B] bool — lanes whose table holds enough anchors to draft."""
        raise NotImplementedError

    def predict_lanes(self, tstate, step, *, mode: str = "taylor",
                      order_cap: Optional[torch.Tensor] = None,
                      mesh: Optional[Any] = None) -> torch.Tensor:
        raise NotImplementedError

    def predict_chain_lanes(self, tstate, steps, *, mode: str = "taylor",
                            order_cap: Optional[torch.Tensor] = None,
                            mesh: Optional[Any] = None) -> torch.Tensor:
        raise NotImplementedError

    def update_lanes(self, tstate, feats, step, mask, *,
                     mesh: Optional[Any] = None) -> Dict[str, torch.Tensor]:
        raise NotImplementedError


class TaylorForecaster(Forecaster):
    """TaylorSeer difference tables (``repro_torch.core.taylor``)."""

    name = "taylor"

    def init_state(self, order, feat_shape, dtype, lanes, device):
        return taylor.init_state(order, feat_shape, dtype, lanes, device)

    def warm(self, tstate, scfg):
        return tstate["n_anchors"] > scfg.taylor_order

    def predict_lanes(self, tstate, step, *, mode="taylor", order_cap=None,
                      mesh=None):
        return taylor.predict_lanes(tstate, step, mode=mode,
                                    order_cap=order_cap, mesh=mesh)

    def predict_chain_lanes(self, tstate, steps, *, mode="taylor",
                            order_cap=None, mesh=None):
        return taylor.predict_chain_lanes(tstate, steps, mode=mode,
                                          order_cap=order_cap, mesh=mesh)

    def update_lanes(self, tstate, feats, step, mask, *, mesh=None):
        return taylor.update_lanes(tstate, feats, step, mask, mesh=mesh)


def spectral_weights(order: int, d: torch.Tensor, gap: torch.Tensor,
                     n_anchors: torch.Tensor, *,
                     band_decay: float = 0.85,
                     order_cap: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Per-ring-row spectral extrapolation weights with validity masking.

    The rows are the last M = order+1 anchor snapshots at relative
    positions 0, −1, …, −(M−1) anchor gaps. Extrapolating to τ = d/gap
    through the length-M DFT gives

        w_j(τ) = (1/M) · Σ_k  ρ^(ν_k·τ) · cos(ω_k·(τ + j)),
        ω_k = 2πk/M,  ν_k = min(k, M−k),

    each band damped by ``band_decay`` ρ per gap of extrapolation times
    its folded frequency; at τ = 0 the weights are δ_{j0}. ``d``/``gap``/
    ``n_anchors`` may be scalars, [B] or [K, B] (weights [m+1, ...]);
    rows with no anchor behind them (j ≥ n_anchors) get 0; ``order_cap``
    [B] (the controller's) zeroes the bands with ν_k > cap. The operations
    follow the reference's order; ``cos`` and ``pow`` are PyTorch's, so
    the weights agree with the reference's to f32 rounding, not bitwise.
    """
    d = d.to(torch.float32)
    gap = gap.to(torch.float32)
    shape = torch.broadcast_shapes(d.shape, gap.shape)
    tau = torch.broadcast_to(d / gap, shape)
    rho = torch.tensor(float(band_decay), dtype=torch.float32,
                       device=d.device)
    M = order + 1
    ws = []
    for j in range(M):
        acc = torch.zeros(shape, dtype=torch.float32, device=d.device)
        for k in range(M):
            nu = min(k, M - k)
            damp = rho ** (nu * tau)
            if order_cap is not None:
                damp = torch.where(nu <= order_cap, damp,
                                   torch.zeros_like(damp))
            acc = acc + damp * torch.cos((2.0 * math.pi * k / M)
                                         * (tau + j))
        ws.append(acc / M)
    w = torch.stack(ws)
    rows = torch.arange(M, device=d.device).reshape((-1,) + (1,) * len(shape))
    return torch.where(rows < n_anchors, w, torch.zeros_like(w))


class SpectralForecaster(Forecaster):
    """Frequency-band extrapolation over a raw-anchor ring table.
    ``band_decay`` ρ ∈ (0, 1] is the per-band damping base; ``mode`` is
    accepted for lane-step symmetry and ignored (draft modes are Taylor
    concepts)."""

    name = "spectral"

    def __init__(self, band_decay: float = 0.85) -> None:
        if not 0.0 < band_decay <= 1.0:
            raise ValueError(f"band_decay must be in (0, 1], "
                             f"got {band_decay}")
        self.band_decay = float(band_decay)

    def init_state(self, order, feat_shape, dtype, lanes, device):
        return taylor.init_state(order, feat_shape, dtype, lanes, device)

    def warm(self, tstate, scfg):
        # every ring row filled: the same gate as the Taylor table
        return tstate["n_anchors"] > scfg.taylor_order

    def _weights(self, tstate, steps, order_cap):
        d = (steps.to(torch.int32) - tstate["anchor_step"]).to(torch.float32)
        order = tstate["diffs"].shape[0] - 1
        w = spectral_weights(order, d, tstate["gap"], tstate["n_anchors"],
                             band_decay=self.band_decay, order_cap=order_cap)
        return w.to(torch.float32).contiguous()

    def _shard_weights(self, tstate, steps, order_cap):
        return [self._weights(t, s, c) for t, s, c in zip(
            tstate, steps, taylor.per_shard(order_cap, len(tstate)))]

    def predict_lanes(self, tstate, step, *, mode="taylor", order_cap=None,
                      mesh=None):
        if mesh is not None:
            return ops.spectral_predict_lanes_sharded(
                [t["diffs"] for t in tstate],
                self._shard_weights(tstate, step, order_cap), mesh=mesh)
        return ops.spectral_predict_lanes(
            tstate["diffs"], self._weights(tstate, step, order_cap))

    def predict_chain_lanes(self, tstate, steps, *, mode="taylor",
                            order_cap=None, mesh=None):
        if mesh is not None:
            return ops.spectral_predict_chain_lanes_sharded(
                [t["diffs"] for t in tstate],
                self._shard_weights(tstate, steps, order_cap), mesh=mesh)
        return ops.spectral_predict_chain_lanes(
            tstate["diffs"], self._weights(tstate, steps, order_cap))

    def update_lanes(self, tstate, feats, step, mask, *, mesh=None):
        # the anchor metadata refreshes exactly as the Taylor table's (so
        # does each shard's)
        if mesh is not None:
            diffs = ops.spectral_update_lanes_sharded(
                [t["diffs"] for t in tstate], feats, mask, mesh=mesh)
            return [{"diffs": d, **taylor.update_lanes_meta(t, s, m)}
                    for d, t, s, m in zip(diffs, tstate, step, mask)]
        diffs = ops.spectral_update_lanes(tstate["diffs"], feats, mask)
        meta = taylor.update_lanes_meta(tstate, step, mask)
        return {"diffs": diffs, **meta}


FORECASTERS = ("taylor", "spectral")


def get_forecaster(forecaster) -> Forecaster:
    """Resolve ``None`` / a name / a ``Forecaster`` instance; ``None`` and
    ``"taylor"`` give the default ``TaylorForecaster``."""
    if forecaster is None:
        return TaylorForecaster()
    if isinstance(forecaster, Forecaster):
        return forecaster
    if isinstance(forecaster, str):
        if forecaster == "taylor":
            return TaylorForecaster()
        if forecaster == "spectral":
            return SpectralForecaster()
        raise ValueError(f"unknown forecaster {forecaster!r} "
                         f"(have {FORECASTERS})")
    raise TypeError(f"forecaster must be None, a name in {FORECASTERS} "
                    f"or a Forecaster instance, got {type(forecaster)}")
