"""Plain PyTorch versions of the kernels.

The wrappers in ``ops`` use these for tensors that lie on the CPU; the
chip check compares each kernel with its plain version on the card. Each
computes the same function as its kernel in the same precision: the
predict accumulates in f32 in the order i = 0..m (separate multiply and
add, so it differs from the kernel's FMA chain by FMA rounding), the
lane refresh rounds every subtraction to the table dtype and the scalar
refresh chains its subtractions in f32 and rounds once (each bitwise
equal to its kernel), the verify sums in f32 in PyTorch's own order, and
attention materialises its f32 scores.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

NEG_INF = -1e30


def _lane_shape(ndim: int, lane_axis: int, lanes: int):
    shape = [1] * ndim
    shape[lane_axis] = lanes
    return shape


def taylor_predict_lanes_ref(diffs: torch.Tensor, weights: torch.Tensor, *,
                             lane_axis: int = 2) -> torch.Tensor:
    """diffs [m+1, ...feat], weights [m+1, B] f32 with ``lane_axis`` the lane
    axis of the feature layout -> Σ_i w[i, lane]·Δⁱ [...feat], accumulated
    in f32 and cast to the table dtype."""
    wshape = _lane_shape(diffs.dim() - 1, lane_axis, weights.shape[1])
    w = weights.to(torch.float32)
    acc = w[0].reshape(wshape) * diffs[0].to(torch.float32)
    for i in range(1, diffs.shape[0]):
        acc = acc + w[i].reshape(wshape) * diffs[i].to(torch.float32)
    return acc.to(diffs.dtype)


def taylor_predict_chain_lanes_ref(diffs: torch.Tensor,
                                   weights: torch.Tensor, *,
                                   lane_axis: int = 2) -> torch.Tensor:
    """diffs [m+1, ...feat], weights [m+1, K, B] f32 -> [K, ...feat];
    position k is :func:`taylor_predict_lanes_ref` with weights[:, k]."""
    return torch.stack([
        taylor_predict_lanes_ref(diffs, weights[:, k], lane_axis=lane_axis)
        for k in range(weights.shape[1])])


def lane_rollback_ref(chain, idx: torch.Tensor, *,
                      lane_axis: int = 0) -> torch.Tensor:
    """chain [K+1, ...feat] (or a sequence of K+1 [...feat] snapshots),
    idx [B] integer -> [...feat] with each lane's rows from
    chain[idx[lane]]: a where-chain over the snapshots, so an index below
    0 selects snapshot 0 and one above K snapshot K. Exact copies."""
    sel = idx.to(torch.int32).reshape(
        _lane_shape(chain[0].dim(), lane_axis, idx.shape[0]))
    out = chain[0]
    for k in range(1, len(chain)):
        out = torch.where(sel >= k, chain[k], out)
    return out


def taylor_update_lanes_ref(old_diffs: torch.Tensor, feats: torch.Tensor,
                            mask: torch.Tensor, *,
                            lane_axis: int = 2) -> torch.Tensor:
    """Masked per-lane refresh: Δ⁰ = F, Δⁱ = Δⁱ⁻¹_new − Δⁱ⁻¹_old in the
    table dtype for lanes in ``mask`` [B]; the other lanes keep their
    rows."""
    rows = [feats.to(old_diffs.dtype)]
    for i in range(1, old_diffs.shape[0]):
        rows.append(rows[i - 1] - old_diffs[i - 1])
    new = torch.stack(rows)
    mshape = _lane_shape(old_diffs.dim(), lane_axis + 1, mask.shape[0])
    return torch.where(mask.to(torch.bool).reshape(mshape), new, old_diffs)


def spectral_update_lanes_ref(old_ring: torch.Tensor, feats: torch.Tensor,
                              mask: torch.Tensor, *,
                              lane_axis: int = 2) -> torch.Tensor:
    """Masked per-lane ring shift: lanes in ``mask`` [B] get row 0 = feats
    (in the ring dtype) and row i = old row i−1; the other lanes keep
    their rows. Exact copies."""
    new = torch.cat([feats.to(old_ring.dtype)[None], old_ring[:-1]], dim=0)
    mshape = _lane_shape(old_ring.dim(), lane_axis + 1, mask.shape[0])
    return torch.where(mask.to(torch.bool).reshape(mshape), new, old_ring)


def verify_accept_ref(pred: torch.Tensor, ref: torch.Tensor,
                      tau: torch.Tensor, *, eps: float = 1e-8
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pred/ref [W, ...], tau [W] -> (err [W] f32, accept [W] bool) with
    err = ‖p−r‖₂ / (‖r‖₂ + ε) from f32 sums and accept = err ≤ τ."""
    W = pred.shape[0]
    p = pred.reshape(W, -1).to(torch.float32)
    r = ref.reshape(W, -1).to(torch.float32)
    d = p - r
    num = torch.sum(d * d, dim=-1)
    den = torch.sum(r * r, dim=-1)
    err = torch.sqrt(num) / (torch.sqrt(den) + eps)
    return err, err <= tau.to(torch.float32)


def mixed_planes_ref(pred: torch.Tensor, ref: torch.Tensor,
                     gscale: torch.Tensor, paired: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The verification planes of a mixed guided/unguided batch (the
    reference's ``kernels.ops._mixed_planes``): pred/ref [W, ...] -> f32
    [W, N]. Lanes (2k, 2k+1) form pair slot k; a row whose ``paired``
    flag is set carries its pair's guided residual ``u + s·(c − u)``
    (c = row 2k, u = row 2k+1, s = ``gscale[2k]``), formed in f32 as three
    eager ops (three roundings, as ``pipeline.guided_output``); other rows
    pass through. A trailing odd lane is never paired."""
    W = pred.shape[0]
    p = pred.reshape(W, -1).to(torch.float32)
    r = ref.reshape(W, -1).to(torch.float32)
    NP = W // 2
    if NP == 0:
        return p, r
    F = p.shape[1]
    p2 = p[:2 * NP].reshape(NP, 2, F)
    r2 = r[:2 * NP].reshape(NP, 2, F)
    s = gscale.to(torch.float32)[0:2 * NP:2].reshape(NP, 1, 1)
    pg = p2[:, 1:2] + s * (p2[:, 0:1] - p2[:, 1:2])       # [NP, 1, F]
    rg = r2[:, 1:2] + s * (r2[:, 0:1] - r2[:, 1:2])
    pm = paired[:2 * NP].to(torch.bool).reshape(NP, 2, 1)
    pe = torch.where(pm, pg, p2).reshape(2 * NP, F)
    re = torch.where(pm, rg, r2).reshape(2 * NP, F)
    if W % 2:
        pe = torch.cat([pe, p[2 * NP:]], dim=0)
        re = torch.cat([re, r[2 * NP:]], dim=0)
    return pe, re


def verify_accept_mixed_ref(pred: torch.Tensor, ref: torch.Tensor,
                            tau: torch.Tensor, gscale: torch.Tensor,
                            paired: torch.Tensor, *, eps: float = 1e-8
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`verify_accept_ref` on :func:`mixed_planes_ref`'s planes:
    one guided-residual decision for each paired row, each unpaired row
    on its own stream."""
    p, r = mixed_planes_ref(pred, ref, gscale, paired)
    return verify_accept_ref(p, r, tau, eps=eps)


def taylor_predict_ref(diffs: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """Whole-table (scalar-anchor) prediction: diffs [m+1, ...feat],
    weights [m+1] f32 -> Σ_i w_i·Δⁱ accumulated in f32 in the order
    i = 0..m and cast to the table dtype; :func:`taylor_predict_lanes_ref`
    with one weight column."""
    w = weights.to(torch.float32)
    acc = w[0] * diffs[0].to(torch.float32)
    for i in range(1, diffs.shape[0]):
        acc = acc + w[i] * diffs[i].to(torch.float32)
    return acc.to(diffs.dtype)


def taylor_update_ref(old_diffs: torch.Tensor,
                      feats: torch.Tensor) -> torch.Tensor:
    """Whole-table refresh as the scalar TPU kernel computes it: Δ⁰ = F,
    Δⁱ = Δⁱ⁻¹_new − Δⁱ⁻¹_old chained in f32 (from the features in their
    own dtype) and rounded to the table dtype once per plane, at the
    store. For bf16 tables this differs from the lane refresh, which
    rounds every Δ before the next subtraction."""
    cur = feats.to(torch.float32)
    rows = [cur]
    for i in range(1, old_diffs.shape[0]):
        cur = cur - old_diffs[i - 1].to(torch.float32)
        rows.append(cur)
    return torch.stack(rows).to(old_diffs.dtype)


def verify_sums_ref(pred: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """pred/ref [B, ...] -> [B, 2] f32 = (Σ(p−r)², Σr²) per row."""
    B = pred.shape[0]
    p = pred.reshape(B, -1).to(torch.float32)
    r = ref.reshape(B, -1).to(torch.float32)
    d = p - r
    return torch.stack([torch.sum(d * d, dim=-1),
                        torch.sum(r * r, dim=-1)], dim=-1)


def verify_error_ref(pred: torch.Tensor, ref: torch.Tensor, *,
                     eps: float = 1e-8) -> torch.Tensor:
    """Per-row relative L2 error √num / (√den + ε) [B] f32."""
    sums = verify_sums_ref(pred, ref)
    return torch.sqrt(sums[:, 0]) / (torch.sqrt(sums[:, 1]) + eps)


def attention_mask(sq: int, sk: int, causal: bool, window: int,
                   device) -> torch.Tensor:
    """[sq, sk] bool: key k visible from query q — k <= q when
    ``causal``, q − k < window when ``window > 0`` (also without
    ``causal``)."""
    qi = torch.arange(sq, device=device)[:, None]
    ki = torch.arange(sk, device=device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (ki <= qi)
    if window > 0:
        ok = ok & ((qi - ki) < window)
    return ok


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """q/k/v [B, S, H, hd] (equal head counts) -> [B, S, H, hd] in q's
    dtype: f32 scores q·k/√hd, masked with −1e30, softmax, f32 product
    with v."""
    s = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(q.shape[-1])
    if causal or window > 0:
        ok = attention_mask(s, s, causal, window, q.device)
        scores = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(torch.float32))
    return out.to(q.dtype)
