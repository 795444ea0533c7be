"""Bidirectional dot-product attention of the DiT blocks.

The reference (``repro.layers.attention.attention_core``) is plain jnp,
not a Pallas kernel: scores and softmax in f32. The port computes the
same function with ``scaled_dot_product_attention`` on f32 operands.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def attention_core(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Bidirectional attention in f32. q/k/v [B, S, H, hd] -> [B, S, H, hd]
    in q's dtype."""
    dtype = q.dtype
    out = F.scaled_dot_product_attention(
        q.to(torch.float32).transpose(1, 2),
        k.to(torch.float32).transpose(1, 2),
        v.to(torch.float32).transpose(1, 2))
    return out.transpose(1, 2).to(dtype)
