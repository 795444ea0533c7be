"""Published peaks of one NVIDIA H100 SXM and the bytes the forecast
kernels need.

The peaks and ``bound_s`` are a frozen copy of the roofline arithmetic of
``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``BF16_TC_FLOPS``, ``bound_ms``)
at commit 703f501e5fb4824a3dc6decb92e03d82cd6a51c8, in seconds:
the least time is the larger of bytes over the memory bandwidth and
operations over the peak. ``bench/test_bench_counts.py`` holds it equal
to the origin.

Bytes are what a call needs, counted once, whatever the kernel reads
again or computes for lanes that do not need it: a forecast reads the
m+1 difference planes and writes one prediction of each drafting lane,
a refresh reads the increments and the m oldest planes and writes m+1
planes of each refreshed lane, a verify reads the predicted and the
computed verify-layer increments of each drafting lane. A lane's plane
holds L·2·T·d elements (every layer's two increments); the verify's
T·d.
"""
from __future__ import annotations

from typing import Dict

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, data sheet
BF16_TC_FLOPS = 989.4e12          # H100 SXM, dense bf16 tensor cores
F32_FLOPS = 67e12                 # H100 SXM, f32 outside the tensor cores

# the profiler's names of the forecast kernels (their __global__
# functions, matched as substrings)
KERNELS = {"predict": "predict_lanes_kernel",
           "refresh": "update_lanes_kernel",
           "verify": "verify_kernel"}


def bound_s(nbytes: float, flops: float,
            flops_per_s: float = F32_FLOPS) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_per_s)


def _plane(cfg: Dict, n_tokens: int) -> int:
    return cfg["num_layers"] * 2 * n_tokens * cfg["d_model"]


def predict_bytes(cfg: Dict, n_tokens: int, lanes: int, elem: int) -> int:
    return (cfg["taylor_order"] + 2) * lanes * _plane(cfg, n_tokens) * elem


def refresh_bytes(cfg: Dict, n_tokens: int, lanes: int, elem: int) -> int:
    m = cfg["taylor_order"]
    return (2 * m + 2) * lanes * _plane(cfg, n_tokens) * elem


def verify_bytes(cfg: Dict, n_tokens: int, lanes: int, elem: int) -> int:
    return 2 * lanes * n_tokens * cfg["d_model"] * elem


def call_bytes(kind: str, cfg: Dict, n_tokens: int, lanes: int,
               elem: int) -> int:
    return {"predict": predict_bytes, "refresh": refresh_bytes,
            "verify": verify_bytes}[kind](cfg, n_tokens, lanes, elem)
