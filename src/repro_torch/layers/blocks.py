"""DiT transformer blocks with their two residual-branch increments.

Each block exposes ``(inc0, inc1)`` separately — the stream update is
``h = h + inc0`` then ``h = h + inc1`` — which is the seam SpeCa plugs
into: a speculative step substitutes forecast increments instead of
computing the branch. For the DiT, inc0 = gate_msa·attn(AdaLN(h)) and
inc1 = gate_mlp·mlp(AdaLN(h)).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.layers.attention import attention_core
from repro_torch.layers.mlp import gelu_mlp
from repro_torch.layers.norms import layer_norm

Params = Dict[str, torch.Tensor]


def _qkv(cfg: ModelConfig, bp: Params, x: torch.Tensor):
    B, S, _ = x.shape
    heads = (B, S, cfg.num_heads, cfg.resolved_head_dim)
    return ((x @ bp["wq"]).reshape(heads), (x @ bp["wk"]).reshape(heads),
            (x @ bp["wv"]).reshape(heads))


def attn_branch_full(cfg: ModelConfig, bp: Params,
                     x: torch.Tensor) -> torch.Tensor:
    """Full-sequence bidirectional attention branch of a DiT block."""
    q, k, v = _qkv(cfg, bp, x)
    out = attention_core(q, k, v)
    B, S = x.shape[:2]
    return out.reshape(B, S, cfg.num_heads * cfg.resolved_head_dim) \
        @ bp["wo"]


def dit_modulation(bp: Params, t_emb: torch.Tensor):
    """AdaLN-Zero: six modulation vectors from the conditioning embedding."""
    mod = F.silu(t_emb) @ bp["mod_w"] + bp["mod_b"]
    return torch.chunk(mod, 6, dim=-1)


def _ln(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Parameter-free LayerNorm (DiT blocks)."""
    ones = torch.ones((x.shape[-1],), dtype=torch.float32, device=x.device)
    zeros = torch.zeros((x.shape[-1],), dtype=torch.float32,
                        device=x.device)
    return layer_norm(x, ones, zeros, eps)


Branch = Callable[[torch.Tensor], torch.Tensor]


def block_branches_full(cfg: ModelConfig, bp: Params,
                        t_emb: torch.Tensor) -> Tuple[Branch, Branch]:
    """Returns (fn0, fn1): fn_i(h) -> inc_i for one DiT block."""
    eps = cfg.norm_eps
    sh_a, sc_a, g_a, sh_m, sc_m, g_m = dit_modulation(bp, t_emb)

    def fn0(h):
        x = _ln(h, eps) * (1 + sc_a[:, None]) + sh_a[:, None]
        return g_a[:, None] * attn_branch_full(cfg, bp, x.to(h.dtype))

    def fn1(h):
        x = _ln(h, eps) * (1 + sc_m[:, None]) + sh_m[:, None]
        mlp = bp["mlp"]
        return g_m[:, None] * gelu_mlp(x.to(h.dtype), mlp["w_up"],
                                       mlp["w_down"])
    return fn0, fn1
