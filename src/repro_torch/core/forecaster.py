"""The forecaster seam of the lane step (the draft model).

A ``Forecaster`` owns the table layout, the fused per-lane prediction and
the lane-masked anchor refresh; the lane step calls only this surface.
The port ships the reference's default, :class:`TaylorForecaster`.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import taylor


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

    def predict_lanes(self, tstate, step, *,
                      mode: str = "taylor") -> torch.Tensor:
        raise NotImplementedError

    def update_lanes(self, tstate, feats, step, mask
                     ) -> Dict[str, torch.Tensor]:
        raise NotImplementedError


class TaylorForecaster(Forecaster):
    """TaylorSeer difference tables (``repro_torch.core.taylor``)."""

    name = "taylor"

    def init_state(self, order, feat_shape, dtype, lanes, device):
        return taylor.init_state(order, feat_shape, dtype, lanes, device)

    def warm(self, tstate, scfg):
        return tstate["n_anchors"] > scfg.taylor_order

    def predict_lanes(self, tstate, step, *, mode="taylor"):
        return taylor.predict_lanes(tstate, step, mode=mode)

    def update_lanes(self, tstate, feats, step, mask):
        return taylor.update_lanes(tstate, feats, step, mask)
