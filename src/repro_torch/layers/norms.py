"""RMSNorm, LayerNorm and AdaLN modulation."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding import specs

# cuBLAS products and torch's row reductions pick their kernels by the
# number of rows and sum one row in another order than several: a decode
# step's few rows (one a lane) are padded with zeros to a multiple of
# DECODE_ROWS where they meet one, so that every lane width up to it runs
# the same kernels and a lane's result does not depend on how many lanes
# run beside it.
DECODE_ROWS = 8


def pad_lanes(x: torch.Tensor) -> torch.Tensor:
    """``x`` with zero entries appended on axis 0 up to a multiple of
    DECODE_ROWS."""
    return F.pad(x, (0, 0) * (x.dim() - 1) + (0, -x.shape[0] % DECODE_ROWS))


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in f32 with the weight applied as ``(1 + w)`` (the LM init
    leaves ``w`` at zero), cast back to the input dtype. Fewer rows than
    DECODE_ROWS are reduced as DECODE_ROWS. A DTensor is normalised on
    each rank's batch shard."""
    if specs.is_dtensor(x):
        return specs.local_rows(lambda w, xl: rms_norm(xl, w, eps), weight,
                                x)
    dtype = x.dtype
    x = x.to(torch.float32)
    rows = x.numel() // x.shape[-1]
    if rows < DECODE_ROWS:
        sq = pad_lanes(torch.square(x).reshape(rows, x.shape[-1]))
        var = torch.mean(sq, dim=-1, keepdim=True)[:rows].reshape(
            x.shape[:-1] + (1,))
    else:
        var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x / torch.sqrt(var + eps)
    return (x * (1.0 + weight.to(torch.float32))).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 with the population variance, cast back to the
    input dtype (the reference's ``jnp.var``)."""
    dtype = x.dtype
    x = x.to(torch.float32)
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    x = (x - mean) / torch.sqrt(var + eps)
    return (x * weight.to(torch.float32)
            + bias.to(torch.float32)).to(dtype)


def modulate(x: torch.Tensor, shift: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """AdaLN modulation: x * (1 + scale) + shift, broadcast over tokens."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]
