"""Dot-product attention: the DiT's bidirectional core and the causal,
optionally windowed, full-sequence entry point.

The reference (``repro.layers.attention``) computes ``attention_core`` in
plain jnp, not in a Pallas kernel: scores and softmax in f32. The port
computes the same function with ``scaled_dot_product_attention`` on f32
operands. ``full_attention(..., use_flash=True)`` with a Python ``int``
window goes to the flash attention kernel (``kernels.ops``), as the
reference's does; the DiT blocks keep ``attention_core``, as the
reference's do.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

NEG_INF = -1e30


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, KV, hd] -> [B, S, KV·n_rep, hd] (GQA head duplication)."""
    if n_rep == 1:
        return x
    b, s, kv, hd = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(
        b, s, kv * n_rep, hd)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
               window: Union[int, torch.Tensor]) -> torch.Tensor:
    """Additive mask bias [Sq, Sk] f32 from absolute positions: causal
    (k <= q) plus the sliding window (q − k < window) when window > 0."""
    diff = q_pos[:, None] - k_pos[None, :]
    ok = diff >= 0
    window = torch.as_tensor(window, device=diff.device)
    windowed = ok & (diff < torch.clamp(window, min=1))
    ok = torch.where(window > 0, windowed, ok)
    return torch.where(ok, torch.tensor(0.0, device=diff.device),
                       torch.tensor(NEG_INF, device=diff.device)
                       ).to(torch.float32)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention in f32: q [B, Sq, H, hd], k/v [B, Sk, H, hd], an optional
    additive f32 bias broadcast to [B, H, Sq, Sk] -> [B, Sq, H, hd] in q's
    dtype."""
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
