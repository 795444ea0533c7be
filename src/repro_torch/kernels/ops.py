"""Wrappers around the Hopper kernels of the serving path.

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
                            "verify_accept": 0,
                            "taylor_predict_chain_lanes": 0,
                            "lane_rollback": 0,
                            "spectral_update_lanes": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ORDERS = 8          # kMaxOrders in taylor_predict_lanes.cu
_MAX_CHAIN_WEIGHTS = 12288   # (m+1)·K f32 in 48 KB of shared memory
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


def taylor_predict_chain_lanes(diffs: torch.Tensor, weights: torch.Tensor,
                               *, lane_axis: int = 2) -> torch.Tensor:
    """Per-lane fused Taylor chain evaluation (draft-K): diffs [m+1,
    ...feat], weights [m+1, K, B] f32 -> [K, ...feat] from one read of
    the table; position k is bitwise :func:`taylor_predict_lanes` called
    with ``weights[:, k]``."""
    m1, feat = diffs.shape[0], tuple(diffs.shape[1:])
    G, B, C = _lane_fold(feat, lane_axis)
    if weights.dim() != 3 or weights.shape[0] != m1 \
            or weights.shape[2] != B:
        raise ValueError(f"weights shape {tuple(weights.shape)} != "
                         f"{(m1, 'K', B)}")
    if weights.dtype != torch.float32:
        raise TypeError(f"weights must be float32, got {weights.dtype}")
    K = weights.shape[1]
    if _on_cpu(diffs, weights):
        return ref.taylor_predict_chain_lanes_ref(diffs, weights,
                                                  lane_axis=lane_axis)
    code = _kernel_dtype(diffs, "the table")
    _contiguous("diffs and weights", diffs, weights)
    if not 1 <= m1 <= _MAX_ORDERS:
        raise ValueError(f"the kernel takes 1..{_MAX_ORDERS} orders, got {m1}")
    if not 1 <= m1 * K <= _MAX_CHAIN_WEIGHTS:
        raise ValueError(f"(m+1)·K = {m1 * K} weights exceed the kernel's "
                         f"{_MAX_CHAIN_WEIGHTS}")
    R = G * B
    if R > _MAX_ROWS:
        raise ValueError(f"{R} table rows exceed the kernel's {_MAX_ROWS}")
    out = torch.empty((K,) + feat, dtype=diffs.dtype, device=diffs.device)
    if out.numel() == 0:
        return out
    lib = build.library("taylor_predict_chain")
    stream, dev = _stream(diffs)
    rc = lib.taylor_predict_chain(
        diffs.data_ptr(), weights.data_ptr(), out.data_ptr(), code, m1, K,
        R, C, B, _vec_ok(C, diffs.element_size(), diffs, out), stream, dev)
    build.check("taylor_predict_chain", lib, rc)
    LAUNCHES["taylor_predict_chain_lanes"] += 1
    return out


def lane_rollback(chain: torch.Tensor, idx: torch.Tensor, *,
                  lane_axis: int = 2) -> torch.Tensor:
    """Per-lane snapshot restore (draft-K rollback): chain [K+1, ...feat]
    of any dtype, idx [B] int32 -> [...feat] with each lane's rows copied
    from ``chain[clamp(idx[lane], 0, K)]``, bit for bit."""
    K1, feat = chain.shape[0], tuple(chain.shape[1:])
    G, B, C = _lane_fold(feat, lane_axis)
    if tuple(idx.shape) != (B,) or idx.dtype != torch.int32:
        raise ValueError(f"idx must be a [{B}] int32 tensor")
    if K1 < 1:
        raise ValueError("the chain needs at least one snapshot")
    if _on_cpu(chain, idx):
        return ref.lane_rollback_ref(chain, idx, lane_axis=lane_axis)
    _contiguous("chain and idx", chain, idx)
    R = G * B
    if R > _MAX_ROWS:
        raise ValueError(f"{R} rows exceed the kernel's {_MAX_ROWS}")
    out = torch.empty(feat, dtype=chain.dtype, device=chain.device)
    if out.numel() == 0:
        return out
    lib = build.library("lane_rollback")
    stream, dev = _stream(chain)
    rc = lib.lane_rollback(chain.data_ptr(), idx.data_ptr(), out.data_ptr(),
                           K1 - 1, R, C * chain.element_size(), B, stream,
                           dev)
    build.check("lane_rollback", lib, rc)
    LAUNCHES["lane_rollback"] += 1
    return out


def spectral_update_lanes(old_ring: torch.Tensor, feats: torch.Tensor,
                          mask: torch.Tensor, *,
                          lane_axis: int = 2) -> torch.Tensor:
    """Masked per-lane ring shift of the spectral raw-anchor table:
    old_ring [m+1, ...feat], feats [...feat], mask [B] bool -> new ring
    with row 0 = feats and row i = old row i−1 for lanes in the mask;
    the other lanes keep their rows bit for bit."""
    m1, feat = old_ring.shape[0], tuple(old_ring.shape[1:])
    G, B, C = _lane_fold(feat, lane_axis)
    if tuple(feats.shape) != feat:
        raise ValueError(f"feats shape {tuple(feats.shape)} != {feat}")
    if tuple(mask.shape) != (B,) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be a [{B}] bool tensor")
    if _on_cpu(old_ring, feats, mask):
        return ref.spectral_update_lanes_ref(old_ring, feats, mask,
                                             lane_axis=lane_axis)
    code = _kernel_dtype(old_ring, "the ring")
    feats = feats.to(old_ring.dtype).contiguous()
    _contiguous("old_ring and mask", old_ring, mask)
    R = G * B
    if R > _MAX_ROWS:
        raise ValueError(f"{R} table rows exceed the kernel's {_MAX_ROWS}")
    out = torch.empty_like(old_ring)
    if out.numel() == 0:
        return out
    lib = build.library("spectral_update_lanes")
    stream, dev = _stream(old_ring)
    rc = lib.spectral_update_lanes(
        old_ring.data_ptr(), feats.data_ptr(), mask.data_ptr(),
        out.data_ptr(), code, m1, R, C, B,
        _vec_ok(C, old_ring.element_size(), old_ring, feats, out),
        stream, dev)
    build.check("spectral_update_lanes", lib, rc)
    LAUNCHES["spectral_update_lanes"] += 1
    return out


# The spectral prediction is the same per-lane contraction Σ_j w_j·row_j
# as the Taylor predict — only the weight columns differ — so it runs the
# same kernels under the reference's names (repro.kernels.ops).
spectral_predict_lanes = taylor_predict_lanes
spectral_predict_chain_lanes = taylor_predict_chain_lanes
