"""Analytic cost model (paper §3.5): the part of
``repro.core.complexity`` the serving accounting needs, for the DiT
(full-sequence forwards) and for dense LM decode (one position against a
KV cache)."""
from __future__ import annotations

from repro_torch.configs import ModelConfig


def _attn_flops(cfg: ModelConfig, tokens: int, kv_tokens: int = 0) -> float:
    """QKVO projections + score/value matmuls for one layer; the keys are
    ``kv_tokens`` (default: the queries themselves)."""
    hd, d = cfg.resolved_head_dim, cfg.d_model
    kv_tokens = kv_tokens or tokens
    proj = 2.0 * tokens * d * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    scores = 2.0 * tokens * kv_tokens * cfg.num_heads * hd * 2
    return proj + scores


def _ffn_flops(cfg: ModelConfig, tokens: int) -> float:
    """The MLP's products: three for SwiGLU, two for the GELU MLP (the DiT
    is a GELU MLP whatever its ``act``)."""
    mult = 3 if cfg.act == "silu" and not cfg.is_diffusion else 2
    return 2.0 * tokens * cfg.d_model * cfg.d_ff * mult


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


def decode_block_flops(cfg: ModelConfig, kv_tokens: int) -> float:
    """One block, ONE decode position attending over a ``kv_tokens``
    cache (the allocated length, so a step's cost is a constant)."""
    return _attn_flops(cfg, 1, kv_tokens=kv_tokens) + _ffn_flops(cfg, 1)


def decode_glue_flops(cfg: ModelConfig) -> float:
    """Embedding lookup, final norm and the LM head for one position."""
    d = cfg.d_model
    return 2.0 * d + 2.0 * d * cfg.vocab_size


def decode_forward_flops(cfg: ModelConfig, kv_tokens: int) -> float:
    """Full decode step: every layer + glue, one position."""
    return cfg.num_layers * decode_block_flops(cfg, kv_tokens) \
        + decode_glue_flops(cfg)


def decode_spec_cache_flops(cfg: ModelConfig) -> float:
    """Per-layer cost of the speculative cache write: the K/V projections
    of the forecast stream, the part of a layer a speculative decode step
    cannot skip."""
    return 2.0 * cfg.d_model * cfg.resolved_head_dim * 2 * cfg.num_kv_heads


def decode_verify_flops(cfg: ModelConfig, kv_tokens: int) -> float:
    """One speculative decode step: the verify layer computed, every other
    layer pays only its cache write, + glue + Taylor evaluation."""
    taylor = 4.0 * cfg.num_layers * 2 * cfg.d_model
    return decode_block_flops(cfg, kv_tokens) \
        + (cfg.num_layers - 1) * decode_spec_cache_flops(cfg) \
        + decode_glue_flops(cfg) + taylor
