"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE.

Angles are f32; the rotation runs in f32 and casts back to the input
dtype (``repro.layers.rope``)."""
from __future__ import annotations

from typing import Tuple

import torch


def rope_freqs(head_dim: int, theta: float,
               device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """Inverse frequencies [head_dim // 2] f32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> torch.Tensor:
    """positions [...] -> angles [..., head_dim // 2] f32."""
    inv = rope_freqs(head_dim, theta, positions.device)
    return positions.to(torch.float32)[..., None] * inv


def mrope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                 sections: Tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: ``positions`` [..., 3] carries the
    (temporal, height, width) index of each token and ``sections``
    partitions the head_dim // 2 frequency slots into (t, h, w) groups;
    slot j takes its angle from its group's axis. Text tokens carry one
    index in all three channels, where M-RoPE is 1-D RoPE."""
    if sum(sections) != head_dim // 2:
        raise ValueError(f"mrope sections {sections} do not sum to "
                         f"head_dim // 2 = {head_dim // 2}")
    inv = rope_freqs(head_dim, theta, positions.device)
    ang = positions.to(torch.float32)[..., None, :] * inv[:, None]  # [..,h,3]
    axis = torch.cat([torch.full((s,), i, dtype=torch.long,
                                 device=positions.device)
                      for i, s in enumerate(sections)])
    sel = torch.nn.functional.one_hot(axis, len(sections)).to(torch.float32)
    return torch.sum(ang * sel, dim=-1)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of each head: x [B, S, H, hd], angles
    [B, S, hd // 2] or [S, hd // 2] -> x's shape and dtype."""
    dtype = x.dtype
    half = x.shape[-1] // 2
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    if angles.dim() == 2:                   # [S, half] -> every batch row
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(dtype)
