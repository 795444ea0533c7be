"""Analytic cost model (paper §3.5, Theorem G.3), the reference's
``repro.core.complexity``: the DiT's full-sequence forwards and LM decode
of every family (one position against a KV cache and/or an SSD state;
MoE FFNs count their active experts), the verification cost ratio γ with
the speedup model ``S = 1 / (1 − α·(1 − γ − overhead))`` (eq. 8), a
cached sampling run's FLOPs and a training step's."""
from __future__ import annotations

from repro_torch.configs import ModelConfig


def attention_score_flops(cfg: ModelConfig, tokens: int,
                          kv_tokens: int = 0) -> float:
    """The score and value matmuls of one layer (its attention without the
    projections); the keys are ``kv_tokens`` (default: the queries)."""
    kv_tokens = kv_tokens or tokens
    return 2.0 * tokens * kv_tokens * cfg.num_heads * cfg.resolved_head_dim \
        * 2


def _attn_flops(cfg: ModelConfig, tokens: int, kv_tokens: int = 0) -> float:
    """QKVO projections + score/value matmuls for one layer."""
    hd, d = cfg.resolved_head_dim, cfg.d_model
    proj = 2.0 * tokens * d * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    return proj + attention_score_flops(cfg, tokens, kv_tokens)


def _ffn_flops(cfg: ModelConfig, tokens: int) -> float:
    """The MLP's products: three for SwiGLU, two for the GELU MLP (the DiT
    is a GELU MLP whatever its ``act``); an MoE FFN counts three for each
    of its top-k experts."""
    if cfg.is_moe:
        return 2.0 * tokens * cfg.num_experts_per_tok * cfg.d_model \
            * cfg.d_ff * 3
    mult = 3 if cfg.act == "silu" and not cfg.is_diffusion else 2
    return 2.0 * tokens * cfg.d_model * cfg.d_ff * mult


def _ssm_flops(cfg: ModelConfig, tokens: int) -> float:
    """The SSD mixer: in-projection (z and x, the B/C streams of every
    head, dt), out-projection, the intra-chunk blocks and the state
    propagation."""
    if not (cfg.is_ssm or cfg.is_hybrid):
        return 0.0
    di, ns, nh = cfg.ssm_d_inner, cfg.ssm_state, cfg.resolved_ssm_heads
    d = cfg.d_model
    proj = 2.0 * tokens * d * (2 * di + 2 * ns * nh + nh) \
        + 2.0 * tokens * di * d
    intra = 2.0 * tokens * cfg.ssm_chunk * (ns + di) * 2
    states = 2.0 * tokens * ns * di * 2
    return proj + intra + states


def _layer_flops(cfg: ModelConfig, tokens: int, kv_tokens: int) -> float:
    """Attention, FFN and SSD, summed in the reference's order."""
    f = 0.0
    if cfg.has_attention and cfg.num_heads:
        f += _attn_flops(cfg, tokens, kv_tokens)
    f += _ffn_flops(cfg, tokens)
    return f + _ssm_flops(cfg, tokens)


def block_flops(cfg: ModelConfig, tokens: int) -> float:
    """One transformer block, full-sequence forward."""
    return _layer_flops(cfg, tokens, 0)


def modulation_flops(cfg: ModelConfig) -> float:
    """One block's AdaLN modulation (six d-vectors from the conditioning
    embedding) for one sample."""
    return 2.0 * cfg.d_model * 6 * cfg.d_model


def glue_flops(cfg: ModelConfig, tokens: int) -> float:
    """Embeddings, AdaLN modulation, output head — never skipped (an LM:
    the embedding adds and the vocabulary head)."""
    d = cfg.d_model
    f = 2.0 * tokens * d
    if cfg.is_diffusion:
        p2c = cfg.patch_size ** 2 * cfg.in_channels
        f += 2.0 * tokens * p2c * d * 2
        f += cfg.num_layers * modulation_flops(cfg)
    elif cfg.vocab_size:
        f += 2.0 * tokens * d * cfg.vocab_size
    return f


def forward_flops(cfg: ModelConfig, tokens: int) -> float:
    return cfg.num_layers * block_flops(cfg, tokens) + glue_flops(cfg, tokens)


def verify_flops(cfg: ModelConfig, tokens: int) -> float:
    """One speculative step: verify layer + glue + Taylor evaluation."""
    taylor = 4.0 * cfg.num_layers * 2 * tokens * cfg.d_model
    return block_flops(cfg, tokens) + glue_flops(cfg, tokens) + taylor


def gamma(cfg: ModelConfig, tokens: int) -> float:
    """Verification cost ratio γ = C_verify / C (paper: 1.67 %–3.5 %)."""
    return verify_flops(cfg, tokens) / forward_flops(cfg, tokens)


def speedup_model(alpha: float, gamma_: float,
                  overhead_ratio: float = 0.0) -> float:
    """Eq. (8) / Theorem G.3 lower bound at speculative-step fraction
    ``alpha``."""
    return 1.0 / (1.0 - alpha * (1.0 - gamma_ - overhead_ratio))


def decode_block_flops(cfg: ModelConfig, kv_tokens: int) -> float:
    """One block, ONE decode position attending over a ``kv_tokens``
    cache (the allocated length, so a step's cost is a constant)."""
    return _layer_flops(cfg, 1, kv_tokens)


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
    of the forecast stream and/or the SSD mixer's state advance, the part
    of a layer a speculative decode step cannot skip."""
    f = _ssm_flops(cfg, 1)
    if cfg.has_attention and cfg.num_heads:
        f += 2.0 * cfg.d_model * cfg.resolved_head_dim * 2 \
            * cfg.num_kv_heads
    return f


def decode_verify_flops(cfg: ModelConfig, kv_tokens: int) -> float:
    """One speculative decode step: the verify layer computed, every other
    layer pays only its cache write, + glue + Taylor evaluation."""
    taylor = 4.0 * cfg.num_layers * 2 * cfg.d_model
    return decode_block_flops(cfg, kv_tokens) \
        + (cfg.num_layers - 1) * decode_spec_cache_flops(cfg) \
        + decode_glue_flops(cfg) + taylor


def run_flops(cfg: ModelConfig, tokens: int, num_steps: int,
              num_full: int) -> float:
    """Total FLOPs of a cached sampling run with ``num_full`` anchor
    steps (every other step a speculative one)."""
    n_spec = num_steps - num_full
    return num_full * forward_flops(cfg, tokens) \
        + n_spec * verify_flops(cfg, tokens)


def train_step_flops(cfg: ModelConfig, tokens: int) -> float:
    """fwd + bwd ≈ 3× forward matmul FLOPs."""
    return 3.0 * forward_flops(cfg, tokens)


def model_flops_6nd(cfg: ModelConfig, tokens: int) -> float:
    """MODEL_FLOPS = 6·N_active·D (roofline 'useful compute' reference)."""
    return 6.0 * cfg.active_param_count() * tokens
