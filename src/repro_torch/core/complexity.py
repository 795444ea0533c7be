"""Analytic cost model (paper §3.5) for the DiT — the part of
``repro.core.complexity`` the serving accounting needs."""
from __future__ import annotations

from repro_torch.configs import ModelConfig


def _attn_flops(cfg: ModelConfig, tokens: int) -> float:
    """QKVO projections + score/value matmuls for one layer."""
    hd, d = cfg.resolved_head_dim, cfg.d_model
    proj = 2.0 * tokens * d * hd * 4 * cfg.num_heads
    scores = 2.0 * tokens * tokens * cfg.num_heads * hd * 2
    return proj + scores


def _ffn_flops(cfg: ModelConfig, tokens: int) -> float:
    """The GELU MLP's two products."""
    return 2.0 * tokens * cfg.d_model * cfg.d_ff * 2


def block_flops(cfg: ModelConfig, tokens: int) -> float:
    """One transformer block, full-sequence forward."""
    return _attn_flops(cfg, tokens) + _ffn_flops(cfg, tokens)


def glue_flops(cfg: ModelConfig, tokens: int) -> float:
    """Embeddings, AdaLN modulation, output head — never skipped."""
    d = cfg.d_model
    p2c = cfg.patch_size ** 2 * cfg.in_channels
    return 2.0 * tokens * d + 2.0 * tokens * p2c * d * 2 \
        + 2.0 * cfg.num_layers * d * 6 * d


def forward_flops(cfg: ModelConfig, tokens: int) -> float:
    return cfg.num_layers * block_flops(cfg, tokens) + glue_flops(cfg, tokens)


def verify_flops(cfg: ModelConfig, tokens: int) -> float:
    """One speculative step: verify layer + glue + Taylor evaluation."""
    taylor = 4.0 * cfg.num_layers * 2 * tokens * cfg.d_model
    return block_flops(cfg, tokens) + glue_flops(cfg, tokens) + taylor
