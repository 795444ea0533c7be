"""Wrappers around the three Hopper kernels of the serving path.

Each wrapper checks its arguments, runs the plain PyTorch version
(``ref``) when the tensors lie on the CPU, and otherwise launches its
CUDA kernel on the current stream — a CUDA tensor never falls back to
the plain version. A launch that is refused raises. Every launch adds one
to the wrapper's entry in :data:`LAUNCHES`; the plain path counts
nothing, so a count shows which runs went through a kernel.

The table layout is the reference's ``[m+1, L, 2, W, T, D]``, folded to
``[m+1, G·W, C]`` with ``G = L·2`` and ``lane = row % W``
(``repro.kernels.ops._lane_fold``). In PyTorch that fold is a view: no
pad, the kernels mask the ragged tail of C themselves.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

LAUNCHES: Dict[str, int] = {"taylor_predict_lanes": 0,
                            "taylor_update_lanes": 0,
                            "verify_accept": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ORDERS = 8          # kMaxOrders in taylor_predict_lanes.cu
_MAX_ROWS = 65535        # gridDim.y
_VERIFY_CHUNK = 8192     # elements per pass-1 block of verify_accept


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _lane_fold(shape, lane_axis: int) -> Tuple[int, int, int]:
    """(G, B, C) row/lane/column factorisation of a feature layout."""
    B = shape[lane_axis]
    G = 1
    for s in shape[:lane_axis]:
        G *= s
    C = 1
    for s in shape[lane_axis + 1:]:
        C *= s
    return G, B, C


def _on_cpu(*ts: torch.Tensor) -> bool:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError("tensors on different devices: "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def _kernel_dtype(t: torch.Tensor, what: str) -> int:
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} must be float32 or bfloat16, got {t.dtype}")
    return _DTYPE_CODES[t.dtype]


def _contiguous(what: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")


def _vec_ok(n: int, elem: int, *ts: torch.Tensor) -> int:
    """1 when rows of n elements allow 16-byte vector access."""
    return int(n % (16 // elem) == 0
               and all(t.data_ptr() % 16 == 0 for t in ts))


def _stream(t: torch.Tensor) -> Tuple[int, int]:
    return torch.cuda.current_stream(t.device).cuda_stream, t.device.index


def taylor_predict_lanes(diffs: torch.Tensor, weights: torch.Tensor, *,
                         lane_axis: int = 2) -> torch.Tensor:
    """Per-lane fused Taylor evaluation: diffs [m+1, ...feat] with
    ``lane_axis`` the lane axis of the feature part, weights [m+1, B] f32
    -> Σ_i w[i, lane]·Δⁱ [...feat] in the table dtype."""
    m1, feat = diffs.shape[0], tuple(diffs.shape[1:])
    G, B, C = _lane_fold(feat, lane_axis)
    if tuple(weights.shape) != (m1, B):
        raise ValueError(f"weights shape {tuple(weights.shape)} != "
                         f"{(m1, B)}")
    if weights.dtype != torch.float32:
        raise TypeError(f"weights must be float32, got {weights.dtype}")
    if _on_cpu(diffs, weights):
        return ref.taylor_predict_lanes_ref(diffs, weights,
                                            lane_axis=lane_axis)
    code = _kernel_dtype(diffs, "the table")
    _contiguous("diffs and weights", diffs, weights)
    if not 1 <= m1 <= _MAX_ORDERS:
        raise ValueError(f"the kernel takes 1..{_MAX_ORDERS} orders, got {m1}")
    R = G * B
    if R > _MAX_ROWS:
        raise ValueError(f"{R} table rows exceed the kernel's {_MAX_ROWS}")
    out = torch.empty(feat, dtype=diffs.dtype, device=diffs.device)
    if out.numel() == 0:
        return out
    lib = build.library("taylor_predict_lanes")
    stream, dev = _stream(diffs)
    rc = lib.taylor_predict_lanes(
        diffs.data_ptr(), weights.data_ptr(), out.data_ptr(), code, m1, R, C,
        B, _vec_ok(C, diffs.element_size(), diffs, out), stream, dev)
    build.check("taylor_predict_lanes", lib, rc)
    LAUNCHES["taylor_predict_lanes"] += 1
    return out


def taylor_update_lanes(old_diffs: torch.Tensor, feats: torch.Tensor,
                        mask: torch.Tensor, *,
                        lane_axis: int = 2) -> torch.Tensor:
    """Masked per-lane recursive difference refresh: old_diffs
    [m+1, ...feat], feats [...feat], mask [B] bool -> new diffs; lanes
    outside the mask keep their rows bit for bit."""
    m1, feat = old_diffs.shape[0], tuple(old_diffs.shape[1:])
    G, B, C = _lane_fold(feat, lane_axis)
    if tuple(feats.shape) != feat:
        raise ValueError(f"feats shape {tuple(feats.shape)} != {feat}")
    if tuple(mask.shape) != (B,) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be a [{B}] bool tensor")
    if _on_cpu(old_diffs, feats, mask):
        return ref.taylor_update_lanes_ref(old_diffs, feats, mask,
                                           lane_axis=lane_axis)
    code = _kernel_dtype(old_diffs, "the table")
    feats = feats.to(old_diffs.dtype).contiguous()
    _contiguous("old_diffs and mask", old_diffs, mask)
    R = G * B
    if R > _MAX_ROWS:
        raise ValueError(f"{R} table rows exceed the kernel's {_MAX_ROWS}")
    out = torch.empty_like(old_diffs)
    if out.numel() == 0:
        return out
    lib = build.library("taylor_update_lanes")
    stream, dev = _stream(old_diffs)
    rc = lib.taylor_update_lanes(
        old_diffs.data_ptr(), feats.data_ptr(), mask.data_ptr(),
        out.data_ptr(), code, m1, R, C, B,
        _vec_ok(C, old_diffs.element_size(), old_diffs, feats, out),
        stream, dev)
    build.check("taylor_update_lanes", lib, rc)
    LAUNCHES["taylor_update_lanes"] += 1
    return out


def verify_accept(pred: torch.Tensor, ref_: torch.Tensor,
                  tau: torch.Tensor, *, eps: float = 1e-8
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused per-lane verification: pred/ref [W, ...], tau [W] f32 ->
    (err [W] f32, accept [W] bool) with err = ‖p−r‖₂/(‖r‖₂+ε) and
    accept = err ≤ τ, finished on the device."""
    W = pred.shape[0]
    if tuple(ref_.shape) != tuple(pred.shape):
        raise ValueError(f"pred {tuple(pred.shape)} and ref "
                         f"{tuple(ref_.shape)} differ in shape")
    if tuple(tau.shape) != (W,) or tau.dtype != torch.float32:
        raise ValueError(f"tau must be a [{W}] float32 tensor")
    if _on_cpu(pred, ref_, tau):
        return ref.verify_accept_ref(pred, ref_, tau, eps=eps)
    _kernel_dtype(pred, "pred")
    _kernel_dtype(ref_, "ref")
    if pred.dtype != ref_.dtype:
        # a table dtype other than the model's: widen both (exact)
        pred, ref_ = pred.to(torch.float32), ref_.to(torch.float32)
    code = _DTYPE_CODES[pred.dtype]
    _contiguous("pred, ref and tau", pred, ref_, tau)
    N = pred.numel() // max(W, 1)
    if W == 0 or N == 0 or W > _MAX_ROWS:
        raise ValueError(f"verify_accept needs 1..{_MAX_ROWS} lanes of "
                         f"N >= 1 elements, got W={W}, N={N}")
    nchunks = -(-N // _VERIFY_CHUNK)
    partials = torch.empty((W, nchunks, 2), dtype=torch.float32,
                           device=pred.device)
    err = torch.empty((W,), dtype=torch.float32, device=pred.device)
    accept = torch.empty((W,), dtype=torch.bool, device=pred.device)
    lib = build.library("verify_accept")
    stream, dev = _stream(pred)
    rc = lib.verify_accept(
        pred.data_ptr(), ref_.data_ptr(), tau.data_ptr(),
        partials.data_ptr(), err.data_ptr(), accept.data_ptr(), code, W, N,
        _VERIFY_CHUNK, nchunks, float(eps),
        _vec_ok(N, pred.element_size(), pred, ref_), stream, dev)
    build.check("verify_accept", lib, rc)
    LAUNCHES["verify_accept"] += 1
    return err, accept
