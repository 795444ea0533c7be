"""TaylorSeer draft model: finite-difference feature forecasting (§3.3).

The difference table holds Δ⁰..Δᵐ of the cached features at each lane's
most recent anchor (fully computed) step. A refresh applies

    Δ⁰_new = F,    Δⁱ_new = Δⁱ⁻¹_new − Δⁱ⁻¹_old   (i = 1..m)

and a forecast ``d`` sampler steps past the anchor evaluates eq. (2),

    F_pred(d) = Σ_{i=0}^{m}  Δⁱ / (i! · Nᵉᶠᶠⁱ) · dⁱ,

with Nᵉᶠᶠ the measured spacing of the lane's last two anchors. Anchor
metadata (``n_anchors``, ``anchor_step``, ``gap``) is held per lane for
serving, and the per-lane table work runs through the fused kernels of
``repro_torch.kernels.ops`` (their plain versions for CPU tensors). A
table with scalar metadata (``init_state(..., lanes=None)``) refreshes and
forecasts the whole batch at once through :func:`update` and
:func:`predict`, in plain PyTorch as in the reference.

``mesh=`` (a ``repro_torch.launch.mesh.LaneMesh``) on the per-lane
functions: the table is lane-sharded, so ``state`` (and every per-lane
argument) is a sequence of D per-shard values, and the kernel runs once
per shard through its ``ops.*_sharded`` routing; the result is one value
per shard.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.device import DeviceLike
from repro_torch.kernels import ops
from repro_torch.sharding import specs

State = Dict[str, torch.Tensor]


def init_state(order: int, feat_shape, dtype: torch.dtype,
               lanes: Optional[int] = None,
               device: DeviceLike = "cuda") -> State:
    """A zero table of order+1 difference planes and its anchor metadata:
    per lane ([lanes]) for serving, or scalar (``lanes=None``: whole-batch
    anchors, the reproduction path of :func:`update`/:func:`predict`)."""
    meta = () if lanes is None else (int(lanes),)
    return {
        "diffs": torch.zeros((order + 1,) + tuple(feat_shape), dtype=dtype,
                             device=device),
        "n_anchors": torch.zeros(meta, dtype=torch.int32, device=device),
        "anchor_step": torch.full(meta, -1, dtype=torch.int32,
                                  device=device),
        "gap": torch.ones(meta, dtype=torch.float32, device=device),
    }


def update(state: State, feats: torch.Tensor, step) -> State:
    """Whole-batch anchor refresh of a scalar-metadata table: Δ⁰ = F,
    Δⁱ = Δⁱ⁻¹_new − Δⁱ⁻¹_old, each subtraction in the table dtype (the
    reference's plain ``update``, not its scalar kernel)."""
    old = state["diffs"]
    rows = [feats.to(old.dtype)]
    for i in range(1, old.shape[0]):
        rows.append(rows[i - 1] - old[i - 1])
    step = torch.as_tensor(step, dtype=torch.int32, device=old.device)
    anchor = state["anchor_step"]
    gap = torch.where(anchor >= 0, (step - anchor).to(torch.float32),
                      torch.ones_like(state["gap"]))
    return {"diffs": torch.stack(rows),
            "n_anchors": state["n_anchors"] + 1,
            "anchor_step": step,
            "gap": torch.clamp(gap, min=1.0)}


def update_lanes(state: State, feats: torch.Tensor, step: torch.Tensor,
                 mask: torch.Tensor, *, mesh: Optional[Any] = None) -> State:
    """Masked per-lane anchor refresh: lanes in ``mask`` [B] refresh their
    table slice and metadata; the others keep both untouched. ``feats``
    has the (L, 2, B, T, D) feature layout; ``step`` is a scalar or
    per-lane [B] step index. With ``mesh``, every argument is per shard
    and so is the result."""
    if mesh is not None:
        diffs = ops.taylor_update_lanes_sharded(
            [s["diffs"] for s in state], feats, mask, mesh=mesh)
        return [{"diffs": d, **update_lanes_meta(s, st, m)}
                for d, s, st, m in zip(diffs, state, step, mask)]
    diffs = ops.taylor_update_lanes(state["diffs"], feats, mask)
    return {"diffs": diffs, **update_lanes_meta(state, step, mask)}


def update_lanes_meta(state: State, step: torch.Tensor,
                      mask: torch.Tensor) -> State:
    """The anchor metadata of a masked refresh (``n_anchors``,
    ``anchor_step``, ``gap``), shared by every forecaster."""
    step = torch.broadcast_to(step.to(torch.int32), mask.shape)
    anchor = state["anchor_step"]
    gap = torch.where(anchor >= 0, (step - anchor).to(torch.float32),
                      torch.ones_like(state["gap"]))
    return {
        "n_anchors": torch.where(mask, state["n_anchors"] + 1,
                                 state["n_anchors"]),
        "anchor_step": torch.where(mask, step, anchor),
        "gap": torch.where(mask, torch.clamp(gap, min=1.0), state["gap"]),
    }


def _ipow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x**n by binary expansion, the multiplications of ``lax.integer_pow``
    in the same order (so the weights match the reference bit for bit)."""
    if n == 0:
        return torch.ones_like(x)
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def prediction_weights(order: int, d: torch.Tensor, gap: torch.Tensor,
                       n_anchors: torch.Tensor, mode: str = "taylor", *,
                       order_cap: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Per-order weights [m+1, *shape] with validity masking: only Δⁱ built
    from ≥ i+1 anchors are trusted, higher orders get exactly 0.
    ``order_cap`` (per-lane ints) additionally zeroes orders above it.
    Modes: ``taylor`` (eq. 2), ``newton`` (binomial extrapolation),
    ``reuse`` (order-0 feature reuse), ``ab2`` (Adams–Bashforth-2)."""
    d = d.to(torch.float32)
    gap = gap.to(torch.float32)
    shape = torch.broadcast_shapes(d.shape, gap.shape)

    def const(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=d.device)

    ws = []
    for i in range(order + 1):
        if mode == "newton":
            # C(d/gap + i - 1, i) — product form, exact for polynomials
            x = d / gap
            w = const(1.0)
            for j in range(i):
                w = w * (x + i - 1 - j) / (j + 1)
        elif mode == "reuse":
            w = const(1.0 if i == 0 else 0.0)
        elif mode == "ab2":
            if i == 0:
                w = const(1.0)
            elif i == 1:
                w = d / gap
            elif i == 2:
                w = 0.5 * d / gap
            else:
                w = const(0.0)
        elif mode == "taylor":
            w = _ipow(d, i) / (math.factorial(i) * _ipow(gap, i))
        else:
            raise ValueError(f"unknown draft mode {mode!r}")
        ws.append(torch.broadcast_to(w, shape))
    w = torch.stack(ws)
    orders = torch.arange(order + 1, device=d.device).reshape(
        (-1,) + (1,) * len(shape))
    valid = orders < n_anchors
    if order_cap is not None:
        valid = valid & (orders <= order_cap)
    return torch.where(valid, w, torch.zeros_like(w))


# cuBLAS faults (an illegal address) on the f32 product [1, 3] x [3, N] of
# N = 1,912,602,624 columns (5,737,807,872 elements: FLUX-like's table at
# batch 2 and 4,096 tokens) and runs at N = 956,301,312 (2,868,903,936
# elements) on an NVIDIA H100 with torch 2.11 and CUDA 12.8: the forecast
# contracts at most the elements of that run a product.
MAX_ELEMENTS = 2_868_903_936


def _contract(w: torch.Tensor, diffs: torch.Tensor,
              max_elements: int = MAX_ELEMENTS) -> torch.Tensor:
    """Σ_i w_i·Δⁱ of a table [m+1, ...] in its own dtype: the f32
    ``tensordot(w, diffs, ([0], [0]))`` over blocks of columns of at most
    ``max_elements`` table elements, each cast to f32 from the stored
    table (each column is the same dot product of m+1 terms; a table that
    fits is one block, one product)."""
    rows = diffs.shape[0]
    flat = diffs.reshape(rows, -1)
    cols = max_elements // rows
    out = torch.empty(flat.shape[1], dtype=diffs.dtype, device=diffs.device)
    for lo in range(0, flat.shape[1], cols):
        # one statement: a block's f32 copy is freed before the next
        out[lo:lo + cols] = torch.tensordot(
            w, flat[:, lo:lo + cols].to(
                torch.float32, memory_format=torch.contiguous_format),
            dims=([0], [0]))
    return out.reshape(diffs.shape[1:])


def predict(state: State, step, mode: str = "taylor") -> torch.Tensor:
    """Whole-batch forecast of a scalar-metadata table at ``step``:
    Σ_i w_i·Δⁱ as an f32 ``tensordot`` over the order axis, cast to the
    table dtype (the reference's plain ``predict``); a DTensor table is
    contracted shard by shard."""
    diffs = state["diffs"]
    step = torch.as_tensor(step, dtype=torch.int32, device=diffs.device)
    d = (step - state["anchor_step"]).to(torch.float32)
    w = prediction_weights(diffs.shape[0] - 1, d, state["gap"],
                           state["n_anchors"], mode).to(torch.float32)
    if specs.is_dtensor(diffs):
        return specs.contract_leading(w, diffs, _contract)
    return _contract(w, diffs)


def _lane_weights(state: State, steps: torch.Tensor, mode: str,
                  order_cap: Optional[torch.Tensor]) -> torch.Tensor:
    """f32 Taylor weights [m+1, *steps.shape] of each lane's table at
    ``steps``, contiguous for the kernels."""
    d = (steps.to(torch.int32) - state["anchor_step"]).to(torch.float32)
    order = state["diffs"].shape[0] - 1
    w = prediction_weights(order, d, state["gap"], state["n_anchors"], mode,
                           order_cap=order_cap)
    return w.to(torch.float32).contiguous()


def per_shard(value, n: int):
    """A per-shard argument of n shards that may be ``None`` for all."""
    return [None] * n if value is None else value


def predict_lanes(state: State, step: torch.Tensor,
                  mode: str = "taylor", *,
                  order_cap: Optional[torch.Tensor] = None,
                  mesh: Optional[Any] = None) -> torch.Tensor:
    """Per-lane forecast: each lane extrapolates its own table to ``step``
    (scalar or per-lane [B]) through the fused predict kernel.
    ``order_cap`` [B] (the controller's) zeroes each lane's orders above
    it. With ``mesh``, every argument is per shard (``order_cap`` may be
    ``None``) and so is the result."""
    if mesh is not None:
        w = [_lane_weights(s, st, mode, c) for s, st, c in
             zip(state, step, per_shard(order_cap, len(state)))]
        return ops.taylor_predict_lanes_sharded([s["diffs"] for s in state],
                                                w, mesh=mesh)
    return ops.taylor_predict_lanes(state["diffs"],
                                    _lane_weights(state, step, mode,
                                                  order_cap))


def predict_chain_lanes(state: State, steps: torch.Tensor,
                        mode: str = "taylor", *,
                        order_cap: Optional[torch.Tensor] = None,
                        mesh: Optional[Any] = None) -> torch.Tensor:
    """Per-lane forecast of a whole drafted chain: ``steps`` [K, B] (chain
    position k of lane b extrapolates to step ``steps[k, b]``) ->
    [K, ...feat] from one read of the table; position k is bitwise
    :func:`predict_lanes` called with ``steps[k]`` (and the same
    ``order_cap``). ``mesh`` as in :func:`predict_lanes`."""
    if mesh is not None:
        w = [_lane_weights(s, st, mode, c) for s, st, c in
             zip(state, steps, per_shard(order_cap, len(state)))]
        return ops.taylor_predict_chain_lanes_sharded(
            [s["diffs"] for s in state], w, mesh=mesh)
    return ops.taylor_predict_chain_lanes(state["diffs"],
                                          _lane_weights(state, steps, mode,
                                                        order_cap))


def _int32(idx: torch.Tensor) -> torch.Tensor:
    if idx.dtype != torch.int32 or not idx.is_contiguous():
        idx = idx.to(torch.int32).contiguous()
    return idx


def lane_rollback(chain, idx: torch.Tensor, *, lane_axis: int = 2,
                  mesh: Optional[Any] = None) -> torch.Tensor:
    """Per-lane snapshot restore: ``chain`` holds the snapshots before and
    after each drafted chain position, as one [K+1, ...feat] tensor or a
    sequence of K+1 [...feat] tensors (handed to the kernel as they are),
    ``idx`` [B] (0..K) is each lane's accepted-prefix length ->
    chain[idx[lane]] per lane, exact copies. ``lane_axis`` is the lane
    axis of the feature layout. With ``mesh``, ``chain`` and ``idx`` are
    per shard (each shard's snapshots read where they lie) and so is the
    result."""
    if mesh is not None:
        return ops.lane_rollback_sharded(chain, [_int32(i) for i in idx],
                                         mesh=mesh, lane_axis=lane_axis)
    return ops.lane_rollback(chain, _int32(idx), lane_axis=lane_axis)


def feature_shape_for(num_layers: int, batch: int, tokens: int,
                      d_model: int):
    """Cached-feature layout: per-layer, per-branch increments."""
    return (num_layers, 2, batch, tokens, d_model)
