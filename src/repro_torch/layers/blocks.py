"""Transformer blocks with their two residual-branch increments.

Each block exposes ``(inc0, inc1)`` separately — the stream update is
``h = h + inc0`` then ``h = h + inc1`` — which is the seam SpeCa plugs
into: a speculative step substitutes forecast increments instead of
computing the branch. Branch layout per family:

  dit    : inc0 = gate_msa·attn(AdaLN(h)), inc1 = gate_mlp·mlp(AdaLN(h))
  dense  : inc0 = attn(RMSNorm(h)) (causal, RoPE, GQA), inc1 =
           mlp(RMSNorm(h)) (SwiGLU or GELU); ``vlm`` text decode and
           ``audio`` are dense
  moe    : inc0 = attention, inc1 = the top-k expert FFN
  ssm    : inc0 = the Mamba2 SSD mixer, inc1 = 0
  hybrid : inc0 = 0.5·(attention + SSD) on one RMSNorm(h), inc1 = MLP

The decode blocks take one token against a KV cache (a ring buffer of
the window when every layer is windowed) and the SSM's recurrent state;
the lane-batched one (``block_decode_branches``) puts every lane at its
own position and adds ``spec_cache``, the piece of a layer a speculative
decode step cannot skip: the forecast stream's K/V projections written
at the lane's position, which keep the drafted chain's attention
self-consistent, and the SSM and conv state advance. For a pure SSM
block the state advance is the mixer itself.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.layers import attention as attn_lib
from repro_torch.layers import moe as moe_lib
from repro_torch.layers import ssm as ssm_lib
from repro_torch.layers.mlp import gelu_mlp, mlp_forward
from repro_torch.layers.norms import layer_norm, rms_norm
from repro_torch.layers.rope import apply_rope
from repro_torch.sharding import specs

Params = Dict[str, torch.Tensor]
KV = Tuple[torch.Tensor, torch.Tensor]


def _qkv(cfg: ModelConfig, bp: Params, x: torch.Tensor):
    """q [B, S, H, hd] and k, v [B, S, KV, hd] (with the biases under
    ``qkv_bias``)."""
    hd = cfg.resolved_head_dim
    B, S, _ = x.shape
    q, k, v = x @ bp["wq"], x @ bp["wk"], x @ bp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + bp["bq"], k + bp["bk"], v + bp["bv"]
    if specs.is_dtensor(q):
        return (specs.split_heads(q, cfg.num_heads, hd),
                specs.split_heads(k, cfg.num_kv_heads, hd),
                specs.split_heads(v, cfg.num_kv_heads, hd))
    return (q.reshape(B, S, cfg.num_heads, hd),
            k.reshape(B, S, cfg.num_kv_heads, hd),
            v.reshape(B, S, cfg.num_kv_heads, hd))


def _out_proj(cfg: ModelConfig, bp: Params, out: torch.Tensor,
              B: int, S: int) -> torch.Tensor:
    if specs.is_dtensor(out):
        return specs.merge_heads(out) @ bp["wo"]
    return out.reshape(B, S, cfg.num_heads * cfg.resolved_head_dim) \
        @ bp["wo"]


def attn_branch_full(cfg: ModelConfig, bp: Params, x: torch.Tensor, *,
                     angles=None, window: int = 0, use_flash: bool = False
                     ) -> Tuple[torch.Tensor, KV]:
    """Full-sequence attention branch -> (out, (k, v)): bidirectional for
    the DiT, causal (windowed when ``window > 0``) with RoPE for an LM;
    (k, v) after RoPE is what a prefill hands to the cache."""
    q, k, v = _qkv(cfg, bp, x)
    if angles is not None:
        q, k = apply_rope(q, angles), apply_rope(k, angles)
    if cfg.is_diffusion:
        out = attn_lib.attention_core(q, k, v)
    else:
        out = attn_lib.full_attention(q, k, v, window, use_flash=use_flash)
    return _out_proj(cfg, bp, out, *x.shape[:2]), (k, v)


def uses_ring_cache(cfg: ModelConfig) -> bool:
    """The reference's ring-buffer decode cache: every layer windowed."""
    return cfg.attn_window > 0 and cfg.global_every == 0


def ffn_branch(cfg: ModelConfig, bp: Params, x: torch.Tensor
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The MLP, or the top-k expert FFN of an MoE block -> (out, the
    MoE's load-balance loss, None for an MLP)."""
    if cfg.is_moe:
        return moe_lib.moe_forward(
            bp["moe"], x, num_experts=cfg.num_experts,
            top_k=cfg.num_experts_per_tok, act=cfg.act,
            capacity_factor=cfg.moe_capacity_factor)
    return mlp_forward(bp["mlp"], x, cfg.act), None


def ssm_branch_full(cfg: ModelConfig, bp: Params, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """The full-sequence SSD mixer -> (out, (final state, conv tail))."""
    out, final_state, conv_tail = ssm_lib.mamba2_forward(
        bp["ssm"], x, d_inner=cfg.ssm_d_inner, n_state=cfg.ssm_state,
        n_heads=cfg.resolved_ssm_heads, head_dim=cfg.ssm_head_dim,
        chunk=cfg.ssm_chunk, norm_eps=cfg.norm_eps)
    return out, (final_state, conv_tail)


def _ssm_decode(cfg: ModelConfig, bp: Params, x: torch.Tensor,
                cache_slice: Dict[str, torch.Tensor]):
    """One recurrent SSD step -> (out, ssm_state', conv_state')."""
    return ssm_lib.mamba2_decode(
        bp["ssm"], x, cache_slice["ssm_state"], cache_slice["conv_state"],
        d_inner=cfg.ssm_d_inner, n_state=cfg.ssm_state,
        n_heads=cfg.resolved_ssm_heads, head_dim=cfg.ssm_head_dim,
        norm_eps=cfg.norm_eps)


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


Branch = Callable[[torch.Tensor], Tuple[torch.Tensor, tuple]]


def block_branches_full(cfg: ModelConfig, bp: Params,
                        t_emb: torch.Tensor = None, *, angles=None,
                        window: int = 0, use_flash: bool = False
                        ) -> Tuple[Branch, Branch]:
    """Returns (fn0, fn1) for one block: ``fn0(h) -> (inc0, cache)``,
    the cache being the attention's (k, v), the SSD's (final state, conv
    tail) or, in a hybrid block, (k, v, final state, conv tail);
    ``fn1(h) -> (inc1, aux)``, ``aux`` the MoE's load-balance loss (None
    without experts)."""
    eps = cfg.norm_eps
    if cfg.is_diffusion:
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = dit_modulation(bp, t_emb)

        def fn0(h):
            x = _ln(h, eps) * (1 + sc_a[:, None]) + sh_a[:, None]
            out, kv = attn_branch_full(cfg, bp, x.to(h.dtype))
            return g_a[:, None] * out, kv

        def fn1(h):
            x = _ln(h, eps) * (1 + sc_m[:, None]) + sh_m[:, None]
            mlp = bp["mlp"]
            return g_m[:, None] * gelu_mlp(x.to(h.dtype), mlp["w_up"],
                                           mlp["w_down"]), None
        return fn0, fn1

    if cfg.is_ssm:
        def fn0(h):
            return ssm_branch_full(cfg, bp, rms_norm(h, bp["ln1"], eps))

        def fn1(h):
            return torch.zeros_like(h), None
        return fn0, fn1

    def fn1(h):
        return ffn_branch(cfg, bp, rms_norm(h, bp["ln2"], eps))

    if cfg.is_hybrid:
        def fn0(h):
            x = rms_norm(h, bp["ln1"], eps)
            a_out, kv = attn_branch_full(cfg, bp, x, angles=angles,
                                         window=window, use_flash=use_flash)
            s_out, state = ssm_branch_full(cfg, bp, x)
            if specs.is_dtensor(x):
                a_out, s_out = specs.residual(a_out), specs.residual(s_out)
            return 0.5 * (a_out + s_out), kv + state
        return fn0, fn1

    def fn0(h):
        return attn_branch_full(cfg, bp, rms_norm(h, bp["ln1"], eps),
                                angles=angles, window=window,
                                use_flash=use_flash)
    return fn0, fn1


# ---------------------------------------------------------------------------
# Decode: one token against the cache
# ---------------------------------------------------------------------------

def attn_branch_decode(cfg: ModelConfig, bp: Params, x: torch.Tensor, *,
                       angles, window: int, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, pos: int
                       ) -> Tuple[torch.Tensor, KV]:
    """One-token attention at the shared position ``pos`` -> (out, (new k
    cache, new v cache)); a ring-buffer cache when every layer is
    windowed."""
    q, k, v = _qkv(cfg, bp, x)
    if angles is not None:
        q, k = apply_rope(q, angles), apply_rope(k, angles)
    if uses_ring_cache(cfg):
        k_cache, v_cache = attn_lib.update_kv_cache_ring(k_cache, v_cache,
                                                         k, v, pos)
        out = attn_lib.decode_attention_ring(q, k_cache, v_cache, pos)
    else:
        k_cache, v_cache = attn_lib.update_kv_cache(k_cache, v_cache, k, v,
                                                    pos)
        out = attn_lib.decode_attention(q, k_cache, v_cache, pos, window)
    return _out_proj(cfg, bp, out, x.shape[0], 1), (k_cache, v_cache)


def block_decode(cfg: ModelConfig, bp: Params, h: torch.Tensor,
                 cache_slice: Dict[str, torch.Tensor], *, angles,
                 window: int, pos: int
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One block for one token at ``pos`` -> (h, new cache slice)."""
    eps = cfg.norm_eps
    x = rms_norm(h, bp["ln1"], eps)
    if cfg.is_ssm:
        out, s, c = _ssm_decode(cfg, bp, x, cache_slice)
        return h + specs.residual(out), {"ssm_state": s, "conv_state": c}
    a_out, (kc, vc) = attn_branch_decode(
        cfg, bp, x, angles=angles, window=window,
        k_cache=cache_slice["k"], v_cache=cache_slice["v"], pos=pos)
    new = {"k": kc, "v": vc}
    if cfg.is_hybrid:
        s_out, new["ssm_state"], new["conv_state"] = _ssm_decode(
            cfg, bp, x, cache_slice)
        h = h + specs.residual(0.5 * (a_out + s_out))
    else:
        h = h + specs.residual(a_out)
    out, _ = ffn_branch(cfg, bp, rms_norm(h, bp["ln2"], eps))
    return h + specs.residual(out), new


def attn_branch_decode_lanes(cfg: ModelConfig, bp: Params, x: torch.Tensor,
                             *, angles, window: int, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, positions: torch.Tensor
                             ) -> Tuple[torch.Tensor, KV]:
    """One-token attention at per-lane positions [B] -> (out, (new k
    cache, new v cache))."""
    q, k, v = _qkv(cfg, bp, x)
    if angles is not None:
        q, k = apply_rope(q, angles), apply_rope(k, angles)
    k_cache, v_cache = attn_lib.update_kv_cache_lanes(k_cache, v_cache, k, v,
                                                      positions)
    out = attn_lib.decode_attention_lanes(q, k_cache, v_cache, positions,
                                          window)
    return _out_proj(cfg, bp, out, x.shape[0], 1), (k_cache, v_cache)


def _kv_write_lanes(cfg: ModelConfig, bp: Params, x: torch.Tensor, *,
                    angles, k_cache: torch.Tensor, v_cache: torch.Tensor,
                    positions: torch.Tensor) -> KV:
    """The speculative cache write: K/V projections of the forecast stream
    (RoPE on K) written at each lane's position; no q, no attention."""
    hd, B = cfg.resolved_head_dim, x.shape[0]
    k, v = x @ bp["wk"], x @ bp["wv"]
    if cfg.qkv_bias:
        k, v = k + bp["bk"], v + bp["bv"]
    k = k.reshape(B, 1, cfg.num_kv_heads, hd)
    v = v.reshape(B, 1, cfg.num_kv_heads, hd)
    if angles is not None:
        k = apply_rope(k, angles)
    return attn_lib.update_kv_cache_lanes(k_cache, v_cache, k, v, positions)


def block_decode_branches(cfg: ModelConfig, bp: Params,
                          cache_slice: Dict[str, torch.Tensor], *, angles,
                          window: int, positions: torch.Tensor):
    """Returns (fn0, fn1, spec_cache) for the lane-batched decode step:
    ``fn0(h) -> (inc0, new cache slice)`` and ``fn1(h) -> inc1`` are the
    real branches (the math and add order of ``block_decode``);
    ``spec_cache(h) -> new cache slice`` advances only the cache, from the
    forecast stream: the K/V projections and the SSD state advance."""
    eps = cfg.norm_eps

    if cfg.is_ssm:
        def fn0(h):
            out, s, c = _ssm_decode(cfg, bp, rms_norm(h, bp["ln1"], eps),
                                    cache_slice)
            return out, {"ssm_state": s, "conv_state": c}

        def fn1(h):
            return torch.zeros_like(h)

        def spec_cache(h):
            # the state advance is the mixer itself
            return fn0(h)[1]
        return fn0, fn1, spec_cache

    def attn(x):
        out, (kc, vc) = attn_branch_decode_lanes(
            cfg, bp, x, angles=angles, window=window,
            k_cache=cache_slice["k"], v_cache=cache_slice["v"],
            positions=positions)
        return out, {"k": kc, "v": vc}

    def kv_write(x):
        kc, vc = _kv_write_lanes(cfg, bp, x, angles=angles,
                                 k_cache=cache_slice["k"],
                                 v_cache=cache_slice["v"],
                                 positions=positions)
        return {"k": kc, "v": vc}

    def fn1(h):
        return ffn_branch(cfg, bp, rms_norm(h, bp["ln2"], eps))[0]

    if cfg.is_hybrid:
        def fn0(h):
            x = rms_norm(h, bp["ln1"], eps)
            a_out, new = attn(x)
            s_out, new["ssm_state"], new["conv_state"] = _ssm_decode(
                cfg, bp, x, cache_slice)
            return 0.5 * (a_out + s_out), new

        def spec_cache(h):
            x = rms_norm(h, bp["ln1"], eps)
            new = kv_write(x)
            _, new["ssm_state"], new["conv_state"] = _ssm_decode(
                cfg, bp, x, cache_slice)
            return new
        return fn0, fn1, spec_cache

    def fn0(h):
        return attn(rms_norm(h, bp["ln1"], eps))

    def spec_cache(h):
        return kv_write(rms_norm(h, bp["ln1"], eps))
    return fn0, fn1, spec_cache
