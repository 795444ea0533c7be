"""Model FLOPs of the DiT, at batch-1 equivalence.

A frozen copy, for the benchmark's own use, of the DiT arithmetic of
``src/repro_torch/core/complexity.py`` at commit
703f501e5fb4824a3dc6decb92e03d82cd6a51c8 (``_attn_flops``, the GELU MLP
of ``_ffn_flops``, ``glue_flops``, ``forward_flops``, ``verify_flops``):
a multiply-add counts 2. ``bench/test_bench_counts.py`` holds it equal
to the origin and to hand counts.
"""
from __future__ import annotations

from typing import Dict


def tokens(cfg: Dict) -> int:
    return (cfg["latent_size"] // cfg["patch_size"]) ** 2


def block_flops(cfg: Dict, n: int) -> float:
    """One DiT block over n tokens: the Q, K, V and O projections, the
    score and value products, the two MLP products."""
    d, H = cfg["d_model"], cfg["num_heads"]
    hd = d // H
    proj = 2.0 * n * d * hd * (2 * H + 2 * H)
    scores = 2.0 * n * n * H * hd * 2
    mlp = 2.0 * n * d * cfg["d_ff"] * 2
    return proj + scores + mlp


def glue_flops(cfg: Dict, n: int) -> float:
    """What no step skips: the positional add, the patch projection and
    head, and every block's AdaLN modulation."""
    d = cfg["d_model"]
    p2c = cfg["patch_size"] ** 2 * cfg["in_channels"]
    return 2.0 * n * d + 2.0 * n * p2c * d * 2 \
        + cfg["num_layers"] * 2.0 * d * 6 * d


def forward_flops(cfg: Dict) -> float:
    """A full forward of one sample."""
    n = tokens(cfg)
    return cfg["num_layers"] * block_flops(cfg, n) + glue_flops(cfg, n)


def verify_flops(cfg: Dict) -> float:
    """A drafted step of one sample: the verify layer, the glue and the
    Taylor evaluation of every layer's two increments."""
    n = tokens(cfg)
    taylor = 4.0 * cfg["num_layers"] * 2 * n * cfg["d_model"]
    return block_flops(cfg, n) + glue_flops(cfg, n) + taylor
