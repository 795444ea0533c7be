"""Input embeddings: tokens, multi-codebook audio tokens, and the DiT's
patches (image or video latents), timesteps and class labels."""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.sharding import specs


def token_embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the embedding table [V, D] at integer ``tokens`` [...]."""
    if specs.is_dtensor(table):
        return specs.embedding(table, tokens)
    return table[tokens.long()]


def codebook_embed(tables: torch.Tensor, tokens: torch.Tensor
                   ) -> torch.Tensor:
    """MusicGen-style: the sum of per-codebook embeddings. tables
    [K, V, D]; tokens [B, K, T] -> [B, T, D]."""
    if specs.is_dtensor(tables):
        return sum(specs.embedding(specs.index0(tables, k), tokens[:, k])
                   for k in range(tables.shape[0]))
    book = torch.arange(tables.shape[0], device=tables.device)[None, :, None]
    return tables[book, tokens.long()].sum(dim=1)


def patchify(latents: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, (F,) H, W, C] -> [B, T, p*p*C] tokens, row-major over patches
    within a frame, frames flattened first (frame-major)."""
    if latents.dim() == 5:
        b, f, h, w, c = latents.shape
    else:
        (b, h, w, c), f = latents.shape, 1
    hp, wp = h // patch, w // patch
    x = latents.reshape(b * f, hp, patch, wp, patch, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, f * hp * wp,
                                               patch * patch * c)


def unpatchify(tokens: torch.Tensor, patch: int, h: int, w: int,
               c: int, frames: int = 1) -> torch.Tensor:
    """[B, T, p*p*C] -> [B, (F,) H, W, C] (5-D when ``frames`` > 1)."""
    b = tokens.shape[0]
    hp, wp = h // patch, w // patch
    x = tokens.reshape(b * frames, hp, wp, patch, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    if frames > 1:
        return x.reshape(b, frames, h, w, c)
    return x.reshape(b, h, w, c)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10_000.0) -> torch.Tensor:
    """Sinusoidal embedding of (possibly fractional) timesteps. t [B]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


# cuBLAS multiplies one f32 row through another kernel (a GEMV, with
# another summation order) than two rows or more, so a request served
# alone got a conditioning embedding one ulp away from the same request
# in a batch, and its samples drifted from there. The time MLP's rows are
# padded with zeros to a multiple of TIME_ROWS, so every lane width up to
# it multiplies through one kernel.
TIME_ROWS = 8


def time_mlp(params: Dict[str, torch.Tensor], t: torch.Tensor,
             dim: int) -> torch.Tensor:
    """DiT timestep conditioning in f32: sinusoid -> MLP -> [B, D]."""
    B = t.shape[0]
    h = F.pad(timestep_embedding(t, dim), (0, 0, 0, -B % TIME_ROWS))
    h = F.silu(h @ params["w1"].to(torch.float32) + params["b1"])
    return (h @ params["w2"].to(torch.float32) + params["b2"])[:B]


def label_embed(table: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Class-conditional embedding; the last row is the CFG null class."""
    return table[labels]
