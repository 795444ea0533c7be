"""The DiT feed-forward layer."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
             b_up: Optional[torch.Tensor] = None,
             b_down: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w_up -> GELU (tanh approximation, as the reference) -> @ w_down."""
    h = x @ w_up
    if b_up is not None:
        h = h + b_up
    h = F.gelu(h, approximate="tanh")
    out = h @ w_down
    if b_down is not None:
        out = out + b_down
    return out
