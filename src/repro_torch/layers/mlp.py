"""Feed-forward layers: SwiGLU (``act="silu"``) and the GELU MLP."""
from __future__ import annotations

from typing import Dict, Optional

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


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """(silu(x @ w_gate) · (x @ w_up)) @ w_down."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def mlp_forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
                act: str) -> torch.Tensor:
    """The LM feed-forward branch: SwiGLU for ``act="silu"``, else the
    GELU MLP."""
    if act == "silu":
        return swiglu(x, params["w_gate"], params["w_up"], params["w_down"])
    return gelu_mlp(x, params["w_up"], params["w_down"])
