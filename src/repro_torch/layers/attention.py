"""Dot-product attention: the DiT's bidirectional core, the causal,
optionally windowed, full-sequence entry point, and one-token decode
against a KV cache (one shared position, or one per lane, or a ring
buffer of the last ``window`` positions) with the cache writes.

The reference (``repro.layers.attention``) computes ``attention_core`` in
plain jnp, not in a Pallas kernel: scores and softmax in f32. The port
computes the same function with ``scaled_dot_product_attention`` on f32
operands. ``full_attention(..., use_flash=True)`` with a Python ``int``
window goes to the flash attention kernel (``kernels.ops``), as the
reference's does; the DiT blocks keep ``attention_core``, as the
reference's do. Decode attention is ``attention_core`` under a per-lane
mask, as the reference's plain jnp.

The cache writes return new tensors and leave their inputs as they were:
the lane step keeps the payload of every chain position as a snapshot and
selects between two forwards' outputs, so a cache written in place would
change a snapshot or the other branch.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.sharding import specs

NEG_INF = -1e30


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, KV, hd] -> [B, S, KV·n_rep, hd] (GQA head duplication)."""
    if n_rep == 1:
        return x
    b, s, kv, hd = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(
        b, s, kv * n_rep, hd)


def _visible_diff(diff: torch.Tensor,
                  window: Union[int, torch.Tensor]) -> torch.Tensor:
    """Key visible from query where diff = q − k: causal (diff >= 0) plus
    the sliding window (diff < window) when window > 0. A Python int
    window is decided on the host; a tensor one (the reference's traced
    window) on the device. No Python scalar becomes a device tensor here:
    on the card that is a blocking host-to-device copy, a stream sync."""
    ok = diff >= 0
    if isinstance(window, int):
        return ok & (diff < window) if window > 0 else ok
    windowed = ok & (diff < torch.clamp(window, min=1))
    return torch.where(window > 0, windowed, ok)


def _bias(ok: torch.Tensor) -> torch.Tensor:
    """Additive f32 bias: 0 where visible, −1e30 elsewhere."""
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
               window: Union[int, torch.Tensor]) -> torch.Tensor:
    """Additive mask bias [Sq, Sk] f32 from absolute positions: causal
    (k <= q) plus the sliding window (q − k < window) when window > 0."""
    return _bias(_visible_diff(q_pos[:, None] - k_pos[None, :], window))


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention in f32: q [B, Sq, H, hd], k/v [B, Sk, H, hd], an optional
    additive f32 bias broadcast to [B, H, Sq, Sk] -> [B, Sq, H, hd] in q's
    dtype."""
    if specs.is_dtensor(q):
        return specs.attention(q, k, v, bias, attention_core)
    dtype = q.dtype
    out = F.scaled_dot_product_attention(
        q.to(torch.float32).transpose(1, 2),
        k.to(torch.float32).transpose(1, 2),
        v.to(torch.float32).transpose(1, 2), attn_mask=bias)
    return out.transpose(1, 2).to(dtype)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   window: Union[int, torch.Tensor], *,
                   q_offset: int = 0, use_flash: bool = False
                   ) -> torch.Tensor:
    """Causal (optionally windowed) self-attention over a full sequence:
    q [B, S, H, hd], k/v [B, S, KV, hd] with H a multiple of KV;
    ``window <= 0`` is global attention.

    The reference scans over query chunks at S >= 4096 to bound XLA's
    transient [chunk, S] score memory. The port needs no such branch:
    the flash kernel holds no score matrix at all, and off the flash path
    ``scaled_dot_product_attention``'s fused CUDA kernels stream the scores
    themselves, so the [Sq, Sk] f32 bias (64 MiB at S = 4096) is the only
    quadratic tensor."""
    n_rep = q.shape[2] // k.shape[2]
    if use_flash and isinstance(window, int):
        return ops.flash_attention(q, repeat_kv(k, n_rep),
                                   repeat_kv(v, n_rep), causal=True,
                                   window=window)
    k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    q_pos = torch.arange(q.shape[1], dtype=torch.int32,
                         device=q.device) + q_offset
    k_pos = torch.arange(k.shape[1], dtype=torch.int32, device=q.device)
    bias = _mask_bias(q_pos, k_pos, window)[None, None]
    return attention_core(q, k, v, bias)


def decode_attention_lanes(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, cur_pos: torch.Tensor,
                           window: Union[int, torch.Tensor]) -> torch.Tensor:
    """One-token decode with a per-lane query position: q [B, 1, H, hd]
    against the cache [B, S, KV, hd]; ``cur_pos`` [B] is each lane's own
    position. Slots after it (or outside the window) are masked with
    −1e30; at B = 1 this is :func:`decode_attention`."""
    n_rep = q.shape[2] // k_cache.shape[2]
    k, v = repeat_kv(k_cache, n_rep), repeat_kv(v_cache, n_rep)
    k_pos = torch.arange(k.shape[1], dtype=torch.int32, device=q.device)
    diff = cur_pos.to(torch.int32)[:, None] - k_pos[None, :]     # [B, Sk]
    return attention_core(q, k, v,
                          _bias(_visible_diff(diff, window))[:, None, None])


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_pos: int,
                     window: Union[int, torch.Tensor]) -> torch.Tensor:
    """One-token decode at one shared position ``cur_pos``: q [B, 1, H, hd]
    against the cache [B, S, KV, hd]."""
    pos = torch.full((q.shape[0],), int(cur_pos), dtype=torch.int32,
                     device=q.device)
    return decode_attention_lanes(q, k_cache, v_cache, pos, window)


def decode_attention_ring(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, cur_pos: int
                          ) -> torch.Tensor:
    """Ring-buffer decode for fully windowed attention: the cache holds
    only the last W = cache length positions, slot i the most recent
    absolute position congruent to i, p_i = cur_pos − ((cur_pos − i) mod
    W). Slots with p_i < 0 (not written yet) are masked."""
    n_rep = q.shape[2] // k_cache.shape[2]
    k, v = repeat_kv(k_cache, n_rep), repeat_kv(v_cache, n_rep)
    w = k.shape[1]
    i = torch.arange(w, dtype=torch.int32, device=q.device)
    pos = int(cur_pos)
    abs_pos = pos - torch.remainder(pos - i, w)
    return attention_core(q, k, v, _bias(abs_pos >= 0)[None, None, None])


def update_kv_cache_ring(k_cache: torch.Tensor, v_cache: torch.Tensor,
                         k_new: torch.Tensor, v_new: torch.Tensor, pos: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """New caches with one-token K/V [B, 1, KV, hd] written at slot
    pos mod cache length; the inputs are left as they were."""
    slot = int(pos) % k_cache.shape[1]
    k_cache, v_cache = k_cache.clone(), v_cache.clone()
    if specs.is_dtensor(k_cache):
        return (specs.write_rows(k_cache, k_new, slot),
                specs.write_rows(v_cache, v_new, slot))
    k_cache[:, slot:slot + 1] = k_new.to(k_cache.dtype)
    v_cache[:, slot:slot + 1] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def update_kv_cache_lanes(k_cache: torch.Tensor, v_cache: torch.Tensor,
                          k_new: torch.Tensor, v_new: torch.Tensor,
                          pos: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """New caches [B, S, KV, hd] with one-token K/V ([B, 1, KV, hd]) written
    at each lane's own position ``pos`` [B]; the inputs are left as they
    were. A position past the cache writes nothing, as the reference's
    scatter drops it (a lane that is not active can sit there; its result
    is never selected)."""
    S = k_cache.shape[1]
    pos = pos.to(torch.long)
    inside = (pos < S)[:, None, None]
    at = torch.clamp(pos, max=S - 1)
    b = torch.arange(k_cache.shape[0], device=k_cache.device)
    out = []
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        row = torch.where(inside, new[:, 0].to(cache.dtype), cache[b, at])
        cache = cache.clone()
        cache[b, at] = row
        out.append(cache)
    return out[0], out[1]


def update_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor, pos: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """New caches with K/V [B, S_new, KV, hd] written at positions
    pos..pos+S_new−1 of every row; the inputs are left as they were. The
    start clamps into [0, S − S_new], as the reference's
    ``lax.dynamic_update_slice`` does: a write past the end lands on the
    last S_new rows."""
    k_cache, v_cache = k_cache.clone(), v_cache.clone()
    n = k_new.shape[1]
    pos = max(min(int(pos), k_cache.shape[1] - n), 0)
    if specs.is_dtensor(k_cache):
        return (specs.write_rows(k_cache, k_new, pos),
                specs.write_rows(v_cache, v_new, pos))
    k_cache[:, pos:pos + n] = k_new.to(k_cache.dtype)
    v_cache[:, pos:pos + n] = v_new.to(v_cache.dtype)
    return k_cache, v_cache
