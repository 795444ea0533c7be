"""Lane-axis rules of sharded serving (the port's copy of the reference's
``repro.sharding.specs`` lane rules).

The serving engine packs W concurrent requests into a lane batch; every
per-lane computation (draft, verify, refresh, advance) is lane-independent,
so the lane axis splits over the mesh's ``"data"`` axis and one engine
serves W lanes as D blocks of W/D. What splits and what replicates:

  array                  | layout               | lane axis
  -----------------------|----------------------|----------
  latents ``x``          | [W, (F,) H, W, C]    | 0
  difference table       | [m+1, L, 2, W, T, D] | 3
  per-lane vectors       | [W]                  | 0
  conditioning values    | [W, ...]             | 0
  decode caches          | [L, W, ...]          | 1
  model params           | (tree)               | replicated per device

Shard i owns lanes [i·W/D, (i+1)·W/D) as its own contiguous tensors on
``mesh.devices[i]``: a lane block of the table is not a contiguous view
of a whole table (its lane axis is position 3), and the kernels take
contiguous operands only, so the port never keeps one global table.

CFG pair rule: a guided request occupies the lane pair (2k, 2k+1), and
the guided combination and the pair verify are cross-lane operations
within a pair. Whenever guided requests can be admitted the lane width is
a multiple of ``2·D`` (:func:`lane_width_multiple` with ``streams=2``),
so every pair lies inside one shard.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

LANE_AXIS = "data"

# lane-state key -> lane axis (the reference's table, key by key):
# ``diffs`` [m+1, L, 2, W, T, D] at 3; decode's caches [L, W, ...] at 1;
# every other entry, the controller's ``ctl_*`` vectors included, at 0
LANE_STATE_AXES = {
    "x": 0, "since": 0, "step": 0, "active": 0,
    "diffs": 3, "n_anchors": 0, "anchor_step": 0, "gap": 0,
    "gscale": 0, "paired": 0, "tau0": 0,
    "draft_k": 0, "max_step": 0,
    "tok": 0, "tokens": 0, "pos0": 0,
    "k": 1, "v": 1, "ssm_state": 1, "conv_state": 1,
    "ctl_on": 0, "ctl_dl": 0, "ctl_rate": 0, "ctl_adv": 0,
    "ctl_target": 0, "ctl_gain": 0, "ctl_ema": 0,
    "ctl_tau_lo": 0, "ctl_tau_hi": 0, "ctl_tau_base": 0,
    "ctl_k_lo": 0, "ctl_k_hi": 0,
    "ctl_order": 0, "ctl_order_lo": 0, "ctl_order_hi": 0,
    "ctl_ticks": 0, "ctl_deadline": 0,
}


def lane_shard_count(mesh: Optional[Any], axis: str = LANE_AXIS) -> int:
    """How many ways the lane axis splits on ``mesh`` (1 for no mesh)."""
    if mesh is None:
        return 1
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no {axis!r} axis (axes "
                         f"{mesh.axis_names})")
    return mesh.shape[axis]


def lane_width_multiple(mesh: Optional[Any], *, streams: int = 1,
                        axis: str = LANE_AXIS) -> int:
    """The serving lane width must be a multiple of this: ``streams``
    (lanes a request occupies: 1, or 2 for a CFG pair) times the shard
    count, so every shard owns an equal block and no request's lanes
    straddle a shard boundary."""
    return streams * lane_shard_count(mesh, axis)


def lane_block(lanes: int, shards: int) -> int:
    """Lanes a shard owns: ``lanes / shards``, which must divide."""
    if lanes % shards:
        raise ValueError(f"lanes={lanes} not divisible by the lane-shard "
                         f"count {shards}")
    return lanes // shards


def split_lanes(t: torch.Tensor, mesh, lane_axis: int = 0
                ) -> List[torch.Tensor]:
    """``t``'s lane axis in D contiguous blocks, block i a contiguous copy
    on ``mesh.devices[i]``."""
    n = lane_block(t.shape[lane_axis], mesh.size)
    return [t.narrow(lane_axis, i * n, n).to(dev, copy=True)
            .contiguous() for i, dev in enumerate(mesh.devices)]


def gather_lanes(blocks: Sequence[torch.Tensor], lane_axis: int = 0,
                 device=None) -> torch.Tensor:
    """The blocks joined along their lane axis on ``device`` (default: the
    first block's)."""
    dev = blocks[0].device if device is None else torch.device(device)
    return torch.cat([b.to(dev) for b in blocks], dim=lane_axis)


def split_lane_state(state: Dict[str, Any], mesh) -> List[Dict[str, Any]]:
    """A lane-state dict as D per-shard dicts (the counterpart of the
    reference's ``lane_state_shardings`` + ``device_put``): every key of
    :data:`LANE_STATE_AXES` splits its lane axis, ``cond`` splits each
    value's axis 0, unknown keys replicate (copied to each shard)."""
    out: List[Dict[str, Any]] = [{} for _ in mesh.devices]
    for key, leaf in state.items():
        if key == "cond":
            parts = {k: split_lanes(v, mesh, 0) for k, v in leaf.items()}
            for i, shard in enumerate(out):
                shard[key] = {k: p[i] for k, p in parts.items()}
        elif key in LANE_STATE_AXES:
            for shard, block in zip(out, split_lanes(
                    leaf, mesh, LANE_STATE_AXES[key])):
                shard[key] = block
        else:
            for shard, dev in zip(out, mesh.devices):
                shard[key] = leaf.to(dev, copy=True) \
                    if isinstance(leaf, torch.Tensor) else leaf
    return out


def gather_lane_state(shards: Sequence[Dict[str, Any]],
                      device=None) -> Dict[str, Any]:
    """The inverse of :func:`split_lane_state`, on ``device`` (default:
    shard 0's): lane keys joined in shard order, unknown keys from shard
    0. For tests and host reads; the engine never gathers its state."""
    out: Dict[str, Any] = {}
    for key, leaf in shards[0].items():
        if key == "cond":
            out[key] = {k: gather_lanes([s[key][k] for s in shards], 0,
                                        device) for k in leaf}
        elif key in LANE_STATE_AXES:
            out[key] = gather_lanes([s[key] for s in shards],
                                    LANE_STATE_AXES[key], device)
        else:
            out[key] = leaf.to(device or leaf.device) \
                if isinstance(leaf, torch.Tensor) else leaf
    return out
