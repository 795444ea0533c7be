"""Wrappers around the Hopper kernels: the serving path's, the
reference's public kernel surface (scalar-anchor Taylor predict and
refresh, the τ-less verify sums and error, flash attention), and the
lane-sharded routings of the serving path's kernels (``*_sharded``).

Each wrapper checks its arguments, runs the plain PyTorch version
(``ref``) when the tensors lie on the CPU, and otherwise launches its
CUDA kernel on the current stream — a CUDA tensor never falls back to
the plain version. A launch that is refused raises. Every launch adds one
to the wrapper's entry in :data:`LAUNCHES`; the plain path counts
nothing, so a count shows which runs went through a kernel.

The lane table layout is the reference's ``[m+1, L, 2, W, T, D]``, folded to
``[m+1, G·W, C]`` with ``G = L·2`` and ``lane = row % W``
(``repro.kernels.ops._lane_fold``). In PyTorch that fold is a view: no
pad, the kernels mask the ragged tail of C themselves.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref
from repro_torch.sharding.specs import LANE_AXIS, lane_shard_count

LAUNCHES: Dict[str, int] = {"taylor_predict_lanes": 0,
                            "taylor_update_lanes": 0,
                            "verify_accept": 0,
                            "verify_accept_mixed": 0,
                            "taylor_predict_chain_lanes": 0,
                            "lane_rollback": 0,
                            "spectral_update_lanes": 0,
                            "taylor_predict": 0,
                            "taylor_update": 0,
                            "verify_sums": 0,
                            "verify_error": 0,
                            "flash_attention": 0,
                            "flash_attention_sm90": 0}
# the lane-sharded routings: one count per shard that launched its kernel
# (the kernel's own key above counts the same launch)
SHARDED_ROUTINGS = ("taylor_predict_lanes_sharded",
                    "taylor_predict_chain_lanes_sharded",
                    "lane_rollback_sharded", "taylor_update_lanes_sharded",
                    "spectral_update_lanes_sharded", "verify_accept_sharded",
                    "verify_accept_mixed_sharded",
                    "verify_accept_pairs_sharded")
LAUNCHES.update({k: 0 for k in SHARDED_ROUTINGS})

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ORDERS = 8          # kMaxOrders in csrc/predict_tiles.cuh
_MAX_ROWS = 65535        # gridDim.y (the refreshes, ring shift, rollback,
                         # verify; the predicts walk a 1-D tile index)
_MAX_SNAPSHOTS = 256     # kMaxSnapshots in lane_rollback.cu
_VERIFY_CHUNK = 2048     # elements per verify block: fixed, never a
                         # function of W (verify_accept.cu)
_FLASH_HEAD_DIMS = (16, 32, 64, 72, 128)   # instantiated in both flash files


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
    """(the current raw stream of t's device, its index), without making a
    torch.cuda.Stream object."""
    dev = t.device.index
    return torch._C._cuda_getCurrentRawStream(dev), dev


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
    return _launch_predict(diffs, weights, G * B, C, B, feat,
                           "taylor_predict_lanes")


def _predict_args(diffs: torch.Tensor, weights: torch.Tensor, R: int,
                  C: int, B: int, out: torch.Tensor) -> Tuple[str, tuple]:
    """The predict library's name and the arguments of its C entries for
    the lane predict (weights [m+1, B] f32) or the chain predict (weights
    [m+1, K, B]) on diffs folded to [m+1, R, C] (lane = row % B), writing
    ``out``. Both kernels walk a 1-D tile index (below 2^32 tiles of 2,048
    bytes a plane), not rows on gridDim.y. Raises on arguments the kernel
    does not take."""
    m1 = diffs.shape[0]
    code = _kernel_dtype(diffs, "the table")
    _contiguous("diffs and weights", diffs, weights)
    if not 1 <= m1 <= _MAX_ORDERS:
        raise ValueError(f"the kernel takes 1..{_MAX_ORDERS} orders, got {m1}")
    chain = weights.dim() == 3
    K = (weights.shape[1],) if chain else ()
    stream, dev = _stream(diffs)
    return ("taylor_predict_chain" if chain else "taylor_predict_lanes",
            (diffs.data_ptr(), weights.data_ptr(), out.data_ptr(), code, m1,
             *K, R, C, B, _vec_ok(C, diffs.element_size(), diffs, out),
             stream, dev))


def _launch_predict(diffs: torch.Tensor, weights: torch.Tensor, R: int,
                    C: int, B: int, out_shape, key: str) -> torch.Tensor:
    """The predict kernel of :func:`_predict_args` into a new tensor of
    ``out_shape``; counts the launch under ``key``. Raises on a refused
    launch."""
    out = torch.empty(out_shape, dtype=diffs.dtype, device=diffs.device)
    name, args = _predict_args(diffs, weights, R, C, B, out)
    if out.numel() == 0:
        return out
    lib = build.library(name)
    build.check(name, lib, getattr(lib, name)(*args))
    LAUNCHES[key] += 1
    return out


def predict_launch_floor(diffs: torch.Tensor, weights: torch.Tensor, *,
                         lane_axis: int = 2) -> None:
    """The launch floor of :func:`taylor_predict_lanes` (weights [m+1, B])
    or :func:`taylor_predict_chain_lanes` (weights [m+1, K, B]) on these
    CUDA arguments: the library's empty kernel on the grid, block and
    shared memory the kernel would take (the table stands in for the
    output: as aligned as one, and nothing writes it). Reads and writes
    nothing and counts no launch; for timing beside the kernel."""
    G, B, C = _lane_fold(tuple(diffs.shape[1:]), lane_axis)
    if _on_cpu(diffs, weights):
        raise ValueError("the launch floor is a CUDA kernel's")
    name, args = _predict_args(diffs, weights, G * B, C, B, diffs)
    if diffs.numel() == 0:
        return
    lib = build.library(name)
    build.check(name, lib, getattr(lib, name + "_floor")(*args))


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


def _same_shape(pred: torch.Tensor, ref_: torch.Tensor) -> None:
    if tuple(ref_.shape) != tuple(pred.shape):
        raise ValueError(f"pred {tuple(pred.shape)} and ref "
                         f"{tuple(ref_.shape)} differ in shape")


def _verify_planes(pred: torch.Tensor, ref_: torch.Tensor):
    """pred/ref [B, ...] of one shape on the card -> (pred, ref, B, N):
    one kernel dtype (a mixed pair widens both to f32, exactly),
    contiguous."""
    _kernel_dtype(pred, "pred")
    _kernel_dtype(ref_, "ref")
    if pred.dtype != ref_.dtype:
        pred, ref_ = pred.to(torch.float32), ref_.to(torch.float32)
    _contiguous("pred and ref", pred, ref_)
    W = pred.shape[0]
    N = pred.numel() // max(W, 1)
    if W == 0 or N == 0 or W > _MAX_ROWS:
        raise ValueError(f"verify needs 1..{_MAX_ROWS} rows of N >= 1 "
                         f"elements, got B={W}, N={N}")
    return pred, ref_, W, N


def verify_accept(pred: torch.Tensor, ref_: torch.Tensor,
                  tau: torch.Tensor, *, eps: float = 1e-8
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused per-lane verification: pred/ref [W, ...], tau [W] f32 ->
    (err [W] f32, accept [W] bool) with err = ‖p−r‖₂/(‖r‖₂+ε) and
    accept = err ≤ τ, finished on the device."""
    W = pred.shape[0]
    _same_shape(pred, ref_)
    if tuple(tau.shape) != (W,) or tau.dtype != torch.float32:
        raise ValueError(f"tau must be a [{W}] float32 tensor")
    if _on_cpu(pred, ref_, tau):
        return ref.verify_accept_ref(pred, ref_, tau, eps=eps)
    _contiguous("tau", tau)
    pred, ref_, W, N = _verify_planes(pred, ref_)
    err = torch.empty((W,), dtype=torch.float32, device=pred.device)
    accept = torch.empty((W,), dtype=torch.bool, device=pred.device)
    lib, args = _verify_args(pred, ref_, W, N)
    rc = lib.verify_accept(*args[:2], tau.data_ptr(), *args[2:4],
                           err.data_ptr(), accept.data_ptr(), *args[4:-3],
                           float(eps), *args[-3:])
    build.check("verify_accept", lib, rc)
    LAUNCHES["verify_accept"] += 1
    return err, accept


def verify_accept_mixed(pred: torch.Tensor, ref_: torch.Tensor,
                        tau: torch.Tensor, gscale: torch.Tensor,
                        paired: torch.Tensor, *, eps: float = 1e-8
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slot-width fused verification (mixed guided/unguided serving):
    pred/ref [W, ...], tau/gscale [W] f32, paired [W] bool -> (err [W] f32,
    accept [W] bool). Lanes (2k, 2k+1) form pair slot k; a paired row
    verifies its pair's guided residual ``u + s·(c − u)`` (s =
    ``gscale[2k]``), so a pair-equal mask gives one decision per pair on
    both rows; an unpaired row (and the tail lane of an odd W) verifies its
    own stream. ``tau`` may differ between a pair's rows (each row's
    accept is against its own), ``gscale`` is read at the even row.

    On the card one launch of the verify kernel's mixed entry, with no
    host read of ``paired``: bitwise :func:`verify_accept` where
    ``paired`` is all false, and a paired row bitwise
    :func:`verify_accept` on the f32 planes of
    ``ref.mixed_planes_ref``."""
    W = pred.shape[0]
    _same_shape(pred, ref_)
    for name, t in (("tau", tau), ("gscale", gscale)):
        if tuple(t.shape) != (W,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be a [{W}] float32 tensor")
    if tuple(paired.shape) != (W,) or paired.dtype != torch.bool:
        raise ValueError(f"paired must be a [{W}] bool tensor")
    if _on_cpu(pred, ref_, tau, gscale, paired):
        return ref.verify_accept_mixed_ref(pred, ref_, tau, gscale, paired,
                                           eps=eps)
    _contiguous("tau, gscale and paired", tau, gscale, paired)
    pred, ref_, W, N = _verify_planes(pred, ref_)
    err = torch.empty((W,), dtype=torch.float32, device=pred.device)
    accept = torch.empty((W,), dtype=torch.bool, device=pred.device)
    lib, args = _verify_args(pred, ref_, W, N)
    # the paired rows sum in 4-element groups where rows allow such loads
    pvec = int(N % 4 == 0
               and (pred.data_ptr() | ref_.data_ptr())
               % (4 * pred.element_size()) == 0)
    rc = lib.verify_accept_mixed(*args[:2], tau.data_ptr(),
                                 gscale.data_ptr(), paired.data_ptr(),
                                 *args[2:4], err.data_ptr(),
                                 accept.data_ptr(), *args[4:-3], float(eps),
                                 args[-3], pvec, *args[-2:])
    build.check("verify_accept_mixed", lib, rc)
    LAUNCHES["verify_accept_mixed"] += 1
    return err, accept


def verify_accept_pairs(pred: torch.Tensor, ref_: torch.Tensor,
                        tau: torch.Tensor, gscale: torch.Tensor, *,
                        eps: float = 1e-8
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pair-reduced verification (the reference's all-paired reduction of
    :func:`verify_accept_mixed`): pred/ref [W, ...] with cond rows 2k and
    uncond rows 2k+1 (W even), tau/gscale per PAIR [W/2] -> (err [W/2],
    accept [W/2]), one τ comparison per pair."""
    W = pred.shape[0]
    if W % 2 != 0:
        raise ValueError(f"pair verification needs interleaved cond/"
                         f"uncond lane pairs: got odd lane count {W}")
    tau_l = torch.repeat_interleave(tau.to(torch.float32), 2)
    gs_l = torch.repeat_interleave(gscale.to(torch.float32), 2)
    paired = torch.ones((W,), dtype=torch.bool, device=pred.device)
    err, acc = verify_accept_mixed(pred, ref_, tau_l, gs_l, paired, eps=eps)
    return err[0::2], acc[0::2]


# (device index, stream) -> (tickets int32, partials f32): the verify
# kernel's scratch, one per stream, since calls on a stream run in order;
# every launch leaves its tickets at 0 for the next
_VERIFY_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _verify_args(pred: torch.Tensor, ref_: torch.Tensor, W: int, N: int):
    """(library, arguments) of a verify entry on planes [W, N]: pred, ref,
    partials, tickets, dtype, W, N, chunk, nchunks, vec, stream, device —
    the entries take their other arguments in between."""
    nchunks = -(-N // _VERIFY_CHUNK)
    stream, dev = _stream(pred)
    scratch = _VERIFY_SCRATCH.get((dev, stream))
    if scratch is None or scratch[0].numel() < W \
            or scratch[1].numel() < 2 * W * nchunks:
        old = scratch or (torch.empty(0), torch.empty(0))
        scratch = (torch.zeros(max(W, old[0].numel()), dtype=torch.int32,
                               device=pred.device),
                   torch.empty(max(2 * W * nchunks, old[1].numel()),
                               dtype=torch.float32, device=pred.device))
        _VERIFY_SCRATCH[(dev, stream)] = scratch
    tickets, partials = scratch
    p, r = pred.data_ptr(), ref_.data_ptr()
    vec = int(N % (16 // pred.element_size()) == 0 and (p | r) % 16 == 0)
    return build.library("verify_accept"), (
        p, r, partials.data_ptr(), tickets.data_ptr(),
        _DTYPE_CODES[pred.dtype], W, N, _VERIFY_CHUNK, nchunks, vec, stream,
        dev)


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
    return _launch_predict(diffs, weights, G * B, C, B, (K,) + feat,
                           "taylor_predict_chain_lanes")


def _snapshots(chain) -> Tuple[Tuple[torch.Tensor, ...], torch.device]:
    """(the snapshots of a sequence chain, their device), checked: at
    least one, each a contiguous tensor of snapshot 0's shape, dtype and
    device."""
    snaps = tuple(chain)
    if not snaps:
        raise ValueError("the chain needs at least one snapshot")
    first = snaps[0]
    if not isinstance(first, torch.Tensor):
        raise TypeError(f"snapshot 0 is a {type(first).__name__}, not a "
                        "tensor")
    shape, dtype, dev = first.shape, first.dtype, first.device
    if not first.is_contiguous():
        raise ValueError("snapshot 0 must be contiguous")
    for k, t in enumerate(snaps[1:], 1):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"snapshot {k} is a {type(t).__name__}, not a "
                            "tensor")
        if t.shape != shape:
            raise ValueError(f"snapshot {k} has shape {tuple(t.shape)}, "
                             f"snapshot 0 {tuple(shape)}")
        if t.dtype != dtype:
            raise TypeError(f"snapshot {k} is {t.dtype}, snapshot 0 {dtype}")
        if t.device != dev:
            raise ValueError(f"tensors on different devices: snapshot {k} "
                             f"on {t.device}, snapshot 0 on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"snapshot {k} must be contiguous")
    return snaps, dev


def lane_rollback(chain, idx: torch.Tensor, *,
                  lane_axis: int = 2) -> torch.Tensor:
    """Per-lane snapshot restore (draft-K rollback): ``chain`` is the K+1
    snapshots, either one [K+1, ...feat] tensor (the reference's
    signature) or a sequence of K+1 contiguous [...feat] tensors of one
    shape, dtype and device; any dtype. idx [B] int32 -> [...feat] with
    each lane's rows copied from snapshot ``clamp(idx[lane], 0, K)``, bit
    for bit.

    A sequence is read where its tensors lie: the kernel takes their base
    pointers, up to ``_MAX_SNAPSHOTS`` (256) of them. A longer chain is
    stacked and goes through the kernel's stacked entry; no serving
    configuration comes near that (a chain of depth K holds K+1
    snapshots; the chip check serves depth 4). Either way the call
    counts under ``LAUNCHES["lane_rollback"]``."""
    if isinstance(chain, torch.Tensor):
        if chain.dim() == 0 or chain.shape[0] == 0:
            raise ValueError("the chain needs at least one snapshot")
        snaps, dev, K1, feat = None, chain.device, chain.shape[0], \
            chain.shape[1:]
    else:
        snaps, dev = _snapshots(chain)
        K1, feat = len(snaps), snaps[0].shape
    G, B, C = _lane_fold(feat, lane_axis)
    if idx.shape != (B,) or idx.dtype != torch.int32:
        raise ValueError(f"idx must be a [{B}] int32 tensor")
    if idx.device != dev:
        raise ValueError(f"tensors on different devices: the chain on {dev}, "
                         f"idx on {idx.device}")
    if dev.type == "cpu":
        return ref.lane_rollback_ref(chain if snaps is None else snaps, idx,
                                     lane_axis=lane_axis)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _contiguous("idx", idx)
    if snaps is None:
        _contiguous("chain", chain)
    R = G * B
    if R > _MAX_ROWS:
        raise ValueError(f"{R} rows exceed the kernel's {_MAX_ROWS}")
    if snaps is not None and K1 > _MAX_SNAPSHOTS:
        chain, snaps = torch.stack(snaps), None
    # empty_like of a contiguous snapshot is contiguous, and costs the
    # host less than torch.empty with a shape, dtype and device
    out = torch.empty(feat, dtype=chain.dtype, device=dev) if snaps is None \
        else torch.empty_like(snaps[0])
    if out.numel() == 0:
        return out
    lib = build.library("lane_rollback")
    stream, devi = _stream(out)
    row_bytes = C * out.element_size()
    if snaps is None:
        rc = lib.lane_rollback(chain.data_ptr(), idx.data_ptr(),
                               out.data_ptr(), K1 - 1, R, row_bytes, B,
                               stream, devi)
    else:
        table = (ctypes.c_void_p * K1)(*[t.data_ptr() for t in snaps])
        rc = lib.lane_rollback_snapshots(table, K1, idx.data_ptr(),
                                         out.data_ptr(), R, row_bytes, B,
                                         stream, devi)
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


def taylor_predict(diffs: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """Whole-table (scalar-anchor) Taylor evaluation: diffs [m+1, ...feat],
    weights [m+1] (cast to f32, as the reference does) -> Σ_i w_i·Δⁱ
    [...feat] in the table dtype.

    On the card this is the lane predict kernel on a one-lane fold
    (G = 1, one lane, C = numel, weights [m+1, 1]): the reference's scalar
    body is its lane body with one weight column, so the result is
    bitwise :func:`taylor_predict_lanes` called with the weights broadcast
    to every lane."""
    m1, feat = diffs.shape[0], tuple(diffs.shape[1:])
    if tuple(weights.shape) != (m1,):
        raise ValueError(f"weights shape {tuple(weights.shape)} != {(m1,)}")
    if _on_cpu(diffs, weights):
        return ref.taylor_predict_ref(diffs, weights)
    w = weights.to(torch.float32).reshape(m1, 1).contiguous()
    n = torch.Size(feat).numel()
    return _launch_predict(diffs, w, 1, n, 1, feat, "taylor_predict")


def taylor_update(old_diffs: torch.Tensor,
                  feats: torch.Tensor) -> torch.Tensor:
    """Whole-table recursive difference refresh: old_diffs [m+1, ...feat],
    feats [...feat] -> new diffs, Δ⁰ = F and Δⁱ = Δⁱ⁻¹_new − Δⁱ⁻¹_old
    chained in f32 and rounded to the table dtype once per plane (the
    reference's scalar kernel; the lane refresh rounds every Δ)."""
    m1, feat = old_diffs.shape[0], tuple(old_diffs.shape[1:])
    if tuple(feats.shape) != feat:
        raise ValueError(f"feats shape {tuple(feats.shape)} != {feat}")
    if _on_cpu(old_diffs, feats):
        return ref.taylor_update_ref(old_diffs, feats)
    code = _kernel_dtype(old_diffs, "the table")
    if not feats.is_floating_point():
        raise TypeError(f"feats must be floating point, got {feats.dtype}")
    if feats.dtype != old_diffs.dtype:
        # the chain starts from the features in f32 (exact for bf16/f16)
        feats = feats.to(torch.float32)
    feats = feats.contiguous()
    _contiguous("old_diffs", old_diffs)
    if m1 < 1:
        raise ValueError("the table needs at least one plane")
    out = torch.empty_like(old_diffs)
    n = feats.numel()
    if n == 0:
        return out
    lib = build.library("taylor_update")
    stream, dev = _stream(old_diffs)
    rc = lib.taylor_update(
        old_diffs.data_ptr(), feats.data_ptr(), out.data_ptr(), code,
        _DTYPE_CODES[feats.dtype], m1, n,
        _vec_ok(n, old_diffs.element_size(), old_diffs, feats, out),
        stream, dev)
    build.check("taylor_update", lib, rc)
    LAUNCHES["taylor_update"] += 1
    return out


def verify_sums(pred: torch.Tensor, ref_: torch.Tensor) -> torch.Tensor:
    """Per-row verification sums: pred/ref [B, ...] -> [B, 2] f32 =
    (Σ(p−r)², Σr²), summed in f32 (the reference's ``verify_sums``
    without τ)."""
    _same_shape(pred, ref_)
    if _on_cpu(pred, ref_):
        return ref.verify_sums_ref(pred, ref_)
    pred, ref_, W, N = _verify_planes(pred, ref_)
    sums = torch.empty((W, 2), dtype=torch.float32, device=pred.device)
    lib, args = _verify_args(pred, ref_, W, N)
    rc = lib.verify_sums(*args[:4], sums.data_ptr(), *args[4:])
    build.check("verify_sums", lib, rc)
    LAUNCHES["verify_sums"] += 1
    return sums


def verify_error(pred: torch.Tensor, ref_: torch.Tensor, *,
                 eps: float = 1e-8) -> torch.Tensor:
    """Per-row relative L2 error (eq. 4): pred/ref [B, ...] -> [B] f32 =
    √num / (√den + ε) over the f32 sums, finished in the verify kernel in
    one launch: bitwise :func:`verify_accept`'s err on the same planes,
    and the two-step finish over :func:`verify_sums`."""
    _same_shape(pred, ref_)
    if _on_cpu(pred, ref_):
        return ref.verify_error_ref(pred, ref_, eps=eps)
    pred, ref_, W, N = _verify_planes(pred, ref_)
    err = torch.empty((W,), dtype=torch.float32, device=pred.device)
    lib, args = _verify_args(pred, ref_, W, N)
    rc = lib.verify_error(*args[:4], err.data_ptr(), *args[4:-3],
                          float(eps), *args[-3:])
    build.check("verify_error", lib, rc)
    LAUNCHES["verify_error"] += 1
    return err


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Online-softmax attention in f32: q/k/v [B, S, H, hd] with equal
    head counts (repeat GQA heads first) -> [B, S, H, hd] in q's dtype.
    Key k is visible from query q when k <= q (``causal``) and when
    q − k < ``window`` (``window > 0``, also without ``causal``).

    On the card both dtypes run tensor-core kernels fed by TMA (bases
    16-byte aligned, strides multiples of 16 bytes; anything else
    raises), picked by dtype: bf16 ``flash_attention_sm90.cu``, f32
    ``flash_attention.cu``, whose 3×TF32 products keep the f32 function's
    tolerance. Each counts its launches under its own key."""
    if q.dim() != 4 or tuple(k.shape) != tuple(q.shape) \
            or tuple(v.shape) != tuple(q.shape):
        raise ValueError(f"q/k/v must be [B, S, H, hd] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    window = int(window)
    if _on_cpu(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window)
    _kernel_dtype(q, "q")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    B, S, H, hd = q.shape
    if hd not in _FLASH_HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in the kernel's "
                         f"{_FLASH_HEAD_DIMS}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q/k/v need a contiguous last (head-dim) axis")
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = [s for t in (q, k, v) for s in _tma_strides(t)]
    key = "flash_attention_sm90" if q.dtype == torch.bfloat16 \
        else "flash_attention"
    lib = build.library(key)
    stream, dev = _stream(q)
    rc = getattr(lib, key)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
        hd, *strides, int(bool(causal)), max(min(window, S), 0),
        1.0 / (hd ** 0.5), stream, dev)
    build.check(key, lib, rc)
    LAUNCHES[key] += 1
    return out


def _tma_strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """The (b, s, h) element strides of a [B, S, H, hd] operand for its
    TMA map. TMA needs a 16-byte-aligned base and strides that are
    multiples of 16 bytes; anything else raises. A dimension of size 1 is
    never stepped over, so its stride is replaced by a dense one."""
    if t.data_ptr() % 16:
        raise ValueError("flash attention needs q/k/v bases aligned to "
                         f"16 bytes (TMA); got address {t.data_ptr():#x}")
    B, S, H, hd = t.shape
    dense = (S * H * hd, H * hd, hd)
    out = []
    for size, stride, alt in zip((B, S, H), t.stride()[:3], dense):
        stride = alt if size == 1 else stride
        if stride * t.element_size() % 16:
            raise ValueError("flash attention needs q/k/v strides that "
                             "are multiples of 16 bytes (TMA); got "
                             f"{tuple(t.stride())}")
        out.append(stride)
    return tuple(out)


# The spectral prediction is the same per-lane contraction Σ_j w_j·row_j
# as the Taylor predict — only the weight columns differ — so it runs the
# same kernels under the reference's names (repro.kernels.ops).
spectral_predict_lanes = taylor_predict_lanes
spectral_predict_chain_lanes = taylor_predict_chain_lanes


# ---------------------------------------------------------------------------
# Lane-sharded routings
# ---------------------------------------------------------------------------
# The reference routes each per-lane kernel through ``shard_map``, so every
# device runs the kernel on its own lane block (``repro.kernels.ops``,
# "Mesh-sharded lane wrappers"). Here a lane-sharded operand is the list of
# its D blocks, block i a tensor on ``mesh.devices[i]`` (the per-shard
# state of ``repro_torch.sharding.specs``). Each routing calls the wrapper
# above once per shard on that shard's block — on the card one launch per
# shard, which raises on a non-contiguous block as the wrapper does; the
# plain version for a CPU block — and never gathers. The kernels are
# per-lane independent, so the blocks' results are bitwise the unsharded
# call's lanes.

def _block_device(block) -> torch.device:
    """A block's device (a sequence of snapshots: its first's)."""
    t = block if isinstance(block, torch.Tensor) else next(iter(block))
    return t.device


def _shard_devices(mesh, axis_name: str, *operands) -> None:
    """Every operand holds one block per shard, block i on shard i's
    device."""
    D = lane_shard_count(mesh, axis_name)
    for blocks in operands:
        if len(blocks) != D:
            raise ValueError(f"{len(blocks)} blocks for a mesh of {D} "
                             "shards")
        for i, (b, dev) in enumerate(zip(blocks, mesh.devices)):
            if _block_device(b) != dev:
                raise ValueError(f"block {i} lies on {_block_device(b)}, "
                                 f"shard {i} on {dev}")


def _count_shards(key: str, blocks) -> None:
    """One count per block that launched (a CUDA block)."""
    LAUNCHES[key] += sum(_block_device(b).type == "cuda" for b in blocks)


def taylor_predict_lanes_sharded(diffs: Sequence[torch.Tensor],
                                 weights: Sequence[torch.Tensor], *, mesh,
                                 lane_axis: int = 2,
                                 axis_name: str = LANE_AXIS
                                 ) -> List[torch.Tensor]:
    """:func:`taylor_predict_lanes` per shard: diffs[i] [m+1, ...feat_i]
    (lane axis ``lane_axis`` of the feature part), weights[i] [m+1, B_i]
    -> predictions [...feat_i], one per shard."""
    _shard_devices(mesh, axis_name, diffs, weights)
    out = [taylor_predict_lanes(d, w, lane_axis=lane_axis)
           for d, w in zip(diffs, weights)]
    _count_shards("taylor_predict_lanes_sharded", diffs)
    return out


def taylor_predict_chain_lanes_sharded(diffs: Sequence[torch.Tensor],
                                       weights: Sequence[torch.Tensor], *,
                                       mesh, lane_axis: int = 2,
                                       axis_name: str = LANE_AXIS
                                       ) -> List[torch.Tensor]:
    """:func:`taylor_predict_chain_lanes` per shard: weights[i]
    [m+1, K, B_i] -> predictions [K, ...feat_i], one per shard."""
    _shard_devices(mesh, axis_name, diffs, weights)
    out = [taylor_predict_chain_lanes(d, w, lane_axis=lane_axis)
           for d, w in zip(diffs, weights)]
    _count_shards("taylor_predict_chain_lanes_sharded", diffs)
    return out


def lane_rollback_sharded(chain: Sequence, idx: Sequence[torch.Tensor], *,
                          mesh, lane_axis: int = 2,
                          axis_name: str = LANE_AXIS) -> List[torch.Tensor]:
    """:func:`lane_rollback` per shard: chain[i] is shard i's K+1
    snapshots (one stacked tensor or a sequence read where it lies),
    idx[i] [B_i] int32 -> restored [...feat_i], one per shard."""
    _shard_devices(mesh, axis_name, chain, idx)
    out = [lane_rollback(c, i, lane_axis=lane_axis)
           for c, i in zip(chain, idx)]
    _count_shards("lane_rollback_sharded", chain)
    return out


def taylor_update_lanes_sharded(old_diffs: Sequence[torch.Tensor],
                                feats: Sequence[torch.Tensor],
                                mask: Sequence[torch.Tensor], *, mesh,
                                lane_axis: int = 2,
                                axis_name: str = LANE_AXIS
                                ) -> List[torch.Tensor]:
    """:func:`taylor_update_lanes` per shard: each shard refreshes its own
    lanes' table block; the table is never gathered."""
    _shard_devices(mesh, axis_name, old_diffs, feats, mask)
    out = [taylor_update_lanes(d, f, m, lane_axis=lane_axis)
           for d, f, m in zip(old_diffs, feats, mask)]
    _count_shards("taylor_update_lanes_sharded", old_diffs)
    return out


def spectral_update_lanes_sharded(old_ring: Sequence[torch.Tensor],
                                  feats: Sequence[torch.Tensor],
                                  mask: Sequence[torch.Tensor], *, mesh,
                                  lane_axis: int = 2,
                                  axis_name: str = LANE_AXIS
                                  ) -> List[torch.Tensor]:
    """:func:`spectral_update_lanes` per shard: each shard shifts its own
    lanes' ring block."""
    _shard_devices(mesh, axis_name, old_ring, feats, mask)
    out = [spectral_update_lanes(r, f, m, lane_axis=lane_axis)
           for r, f, m in zip(old_ring, feats, mask)]
    _count_shards("spectral_update_lanes_sharded", old_ring)
    return out


# the sharded spectral prediction: the shared contraction, spectral weights
spectral_predict_lanes_sharded = taylor_predict_lanes_sharded
spectral_predict_chain_lanes_sharded = taylor_predict_chain_lanes_sharded


def verify_accept_sharded(pred: Sequence[torch.Tensor],
                          ref_: Sequence[torch.Tensor],
                          tau: Sequence[torch.Tensor], *, mesh,
                          axis_name: str = LANE_AXIS, eps: float = 1e-8
                          ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """:func:`verify_accept` per shard: pred[i]/ref[i] [B_i, ...],
    tau[i] [B_i] -> (errs, accepts), one block each; every lane's
    reduction is shard-local."""
    _shard_devices(mesh, axis_name, pred, ref_, tau)
    out = [verify_accept(p, r, t, eps=eps) for p, r, t in zip(pred, ref_, tau)]
    _count_shards("verify_accept_sharded", pred)
    return [e for e, _ in out], [a for _, a in out]


def _whole_pairs(pred: Sequence[torch.Tensor], D: int, what: str) -> None:
    """The pair rule: W lanes in D equal blocks, W a multiple of 2·D."""
    widths = [p.shape[0] for p in pred]
    W = sum(widths)
    if W % (2 * D) != 0 or len(set(widths)) != 1:
        raise ValueError(
            f"lane count {W} in blocks {widths} must be a multiple of "
            f"2·D={2 * D} in equal blocks so {what} never straddle a shard "
            "boundary")


def verify_accept_mixed_sharded(pred: Sequence[torch.Tensor],
                                ref_: Sequence[torch.Tensor],
                                tau: Sequence[torch.Tensor],
                                gscale: Sequence[torch.Tensor],
                                paired: Sequence[torch.Tensor], *, mesh,
                                axis_name: str = LANE_AXIS,
                                eps: float = 1e-8
                                ) -> Tuple[List[torch.Tensor],
                                           List[torch.Tensor]]:
    """:func:`verify_accept_mixed` per shard. W must be a multiple of
    ``2·D`` (the engine's mixed-session width rounding guarantees it) so
    each shard holds whole pair slots and the guided residual stays
    shard-local; anything else raises ``ValueError``."""
    _shard_devices(mesh, axis_name, pred, ref_, tau, gscale, paired)
    _whole_pairs(pred, len(pred), "pair slots")
    out = [verify_accept_mixed(p, r, t, g, m, eps=eps)
           for p, r, t, g, m in zip(pred, ref_, tau, gscale, paired)]
    _count_shards("verify_accept_mixed_sharded", pred)
    return [e for e, _ in out], [a for _, a in out]


def verify_accept_pairs_sharded(pred: Sequence[torch.Tensor],
                                ref_: Sequence[torch.Tensor],
                                tau: Sequence[torch.Tensor],
                                gscale: Sequence[torch.Tensor], *, mesh,
                                axis_name: str = LANE_AXIS,
                                eps: float = 1e-8
                                ) -> Tuple[List[torch.Tensor],
                                           List[torch.Tensor]]:
    """:func:`verify_accept_pairs` per shard: tau[i]/gscale[i] per pair
    [B_i/2] -> (errs, accepts) per pair. W must be a multiple of ``2·D``
    so cond/uncond pairs never straddle a shard; anything else raises
    ``ValueError``."""
    _shard_devices(mesh, axis_name, pred, ref_, tau, gscale)
    _whole_pairs(pred, len(pred), "cond/uncond pairs")
    out = [verify_accept_pairs(p, r, t, g, eps=eps)
           for p, r, t, g in zip(pred, ref_, tau, gscale)]
    _count_shards("verify_accept_pairs_sharded", pred)
    return [e for e, _ in out], [a for _, a in out]
