"""The backbone: init, embedding, the masked layer loop, the heads, and
LM decode.

Block parameters are stacked ``[L, …]`` exactly as the reference's
``jax.vmap``-initialised tree, so ``repro_torch.convert.params_from_jax``
is a leaf-by-leaf copy. SpeCa hooks in through ``branch_preds`` /
``compute_mask``: a speculative step passes forecast increments for every
layer and a mask that is True only at the verification layer. The
reference skips the other layers with a per-layer ``lax.cond``; here the
mask is a static Python sequence fixed when the step is built, so a
skipped DiT layer is a plain ``if`` that launches nothing. A skipped
decode layer still writes its cache (``blocks.block_decode_branches``).

The LM half (every family of the reference: dense, VLM text, MoE, SSM,
hybrid, audio): ``lm_forward`` (the prefill, optionally collecting the
cache), ``lm_decode_step`` (one token at one shared position) and
``decode_branches_step`` (one token per lane at per-lane positions, with
the SpeCa seam). A cache is ``{"k", "v"}`` of [L, B, S, KV, hd] where
the model has attention (S = the window for a ring buffer, when every
layer is windowed) and ``{"ssm_state"}`` f32 [L, B, h, p, n] with
``{"conv_state"}`` [L, B, W, C] where it has an SSD mixer; every decode
returns new caches and leaves its inputs as they were. An audio model
takes [B, K, T] codebook tokens and gives [B, T, K, V] logits.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ModelConfig, check_lm
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.layers import blocks as blk
from repro_torch.layers import embeddings as emb
from repro_torch.layers.norms import layer_norm, rms_norm
from repro_torch.layers.rope import mrope_angles, rope_angles
from repro_torch.sharding import specs

Params = Dict[str, Any]


def _dense(gen: torch.Generator, shape, dtype, scale: Optional[float] = None,
           layers: Optional[int] = None) -> torch.Tensor:
    """N(0, scale²) weights; ``scale`` defaults to 1/√fan_in. With
    ``layers`` the result is a stacked ``[layers, *shape]`` leaf."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    full = tuple(shape) if layers is None else (layers,) + tuple(shape)
    w = torch.randn(full, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * scale).to(dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device: DeviceLike = "cuda") -> Params:
    """Random parameters with the reference's initialisation scheme
    (``repro.layers.model.init_params``), drawn on the generator's device,
    then moved to ``device``. A DiT's AdaLN-Zero modulation leaves and
    final layer start at zero; an LM's norm weights start at zero (RMSNorm
    applies ``1 + w``) and its embedding is N(0, 0.02²); an SSD mixer's
    ``A_log`` is log U(1, 16) and its ``dt_bias`` the inverse softplus of
    U(0.001, 0.1), both f32."""
    dev = resolve_device(device)
    if cfg.is_diffusion:
        params = _init_dit(cfg, generator)
    else:
        check_lm(cfg, "init_params")
        params = _init_lm(cfg, generator)
    return tree_to(params, dev)


def _init_dit(cfg: ModelConfig, g: torch.Generator) -> Params:
    dtype = cfg.torch_dtype
    d, hd, L = cfg.d_model, cfg.resolved_head_dim, cfg.num_layers
    in_dim = cfg.patch_size * cfg.patch_size * cfg.in_channels

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=g.device)

    embed: Params = {
        "patch_w": _dense(g, (in_dim, d), dtype),
        "patch_b": zeros(d),
        "time": {"w1": _dense(g, (d, d), torch.float32),
                 "b1": zeros(d, dt=torch.float32),
                 "w2": _dense(g, (d, d), torch.float32),
                 "b2": zeros(d, dt=torch.float32)},
    }
    if cfg.num_classes:
        embed["label"] = _dense(g, (cfg.num_classes + 1, d), dtype,
                                scale=0.02)
    if cfg.cond_dim:
        embed["cond_w"] = _dense(g, (cfg.cond_dim, d), dtype)
        embed["cond_b"] = zeros(d)
    blocks: Params = {
        "wq": _dense(g, (d, cfg.num_heads * hd), dtype, layers=L),
        "wk": _dense(g, (d, cfg.num_heads * hd), dtype, layers=L),
        "wv": _dense(g, (d, cfg.num_heads * hd), dtype, layers=L),
        "wo": _dense(g, (cfg.num_heads * hd, d), dtype,
                     scale=1.0 / math.sqrt(cfg.num_heads * hd), layers=L),
        "mlp": {"w_up": _dense(g, (d, cfg.d_ff), dtype, layers=L),
                "w_down": _dense(g, (cfg.d_ff, d), dtype, layers=L)},
        "mod_w": zeros(L, d, 6 * d),            # AdaLN-Zero
        "mod_b": zeros(L, 6 * d),
    }
    head = {"w": zeros(d, in_dim), "b": zeros(in_dim),   # zero-init
            "mod_w": zeros(d, 2 * d), "mod_b": zeros(2 * d)}
    return {"embed": embed, "blocks": blocks, "head": head}


def _init_lm(cfg: ModelConfig, g: torch.Generator) -> Params:
    dtype = cfg.torch_dtype
    d, hd, L, f = cfg.d_model, cfg.resolved_head_dim, cfg.num_layers, \
        cfg.d_ff
    qd, kvd, V = cfg.num_heads * hd, cfg.num_kv_heads * hd, cfg.padded_vocab

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=g.device)

    def uniform(lo, hi, *shape):
        return torch.rand(shape, generator=g, dtype=torch.float32,
                          device=g.device) * (hi - lo) + lo

    blocks: Params = {"ln1": zeros(L, d)}
    if not cfg.is_ssm:
        blocks["ln2"] = zeros(L, d)
    if cfg.has_attention and cfg.num_heads > 0:
        blocks.update(
            wq=_dense(g, (d, qd), dtype, layers=L),
            wk=_dense(g, (d, kvd), dtype, layers=L),
            wv=_dense(g, (d, kvd), dtype, layers=L),
            wo=_dense(g, (qd, d), dtype, scale=1.0 / math.sqrt(qd),
                      layers=L))
    if cfg.is_moe:
        E = cfg.num_experts
        blocks["moe"] = {
            "router": _dense(g, (d, E), dtype, layers=L),
            "w_gate": _dense(g, (E, d, f), dtype, scale=1.0 / math.sqrt(d),
                             layers=L),
            "w_up": _dense(g, (E, d, f), dtype, scale=1.0 / math.sqrt(d),
                           layers=L),
            "w_down": _dense(g, (E, f, d), dtype, scale=1.0 / math.sqrt(f),
                             layers=L)}
    elif f > 0:
        blocks["mlp"] = {"w_up": _dense(g, (d, f), dtype, layers=L),
                         "w_down": _dense(g, (f, d), dtype, layers=L)}
    if cfg.qkv_bias:
        blocks.update(bq=zeros(L, qd), bk=zeros(L, kvd), bv=zeros(L, kvd))
    if "mlp" in blocks and cfg.act == "silu":
        blocks["mlp"]["w_gate"] = _dense(g, (d, f), dtype, layers=L)
    if cfg.is_ssm or cfg.is_hybrid:
        di, ns, nh = cfg.ssm_d_inner, cfg.ssm_state, cfg.resolved_ssm_heads
        cc = di + 2 * ns
        blocks["ssm"] = {
            "w_in": _dense(g, (d, 2 * di + 2 * ns + nh), dtype, layers=L),
            "conv_w": _dense(g, (cfg.ssm_conv, cc), dtype,
                             scale=1.0 / math.sqrt(cfg.ssm_conv), layers=L),
            "conv_b": zeros(L, cc),
            "A_log": torch.log(uniform(1.0, 16.0, L, nh)),
            "Dp": torch.ones((L, nh), dtype=torch.float32, device=g.device),
            "dt_bias": torch.log(torch.expm1(uniform(1e-3, 1e-1, L, nh))),
            "ssm_norm": zeros(L, di),
            "w_out": _dense(g, (di, d), dtype, layers=L)}
    params: Params = {"blocks": blocks, "final_norm": zeros(d)}
    if cfg.arch_type == "audio":
        K = cfg.num_codebooks
        params["embed"] = {"codebooks": _dense(g, (K, V, d), dtype,
                                               scale=0.02)}
        # the reference's fan-in rule reads the first axis here: N(0, 1/K)
        params["head"] = {"w": _dense(g, (K, d, V), dtype)}
        return params
    params["embed"] = {"tok": _dense(g, (V, d), dtype, scale=0.02)}
    if not cfg.tie_embeddings:
        params["head"] = {"w": _dense(g, (d, V), dtype)}
    return params


def tree_to(tree: Any, device: torch.device) -> Any:
    """Move every tensor leaf of a nested dict to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def layer_params(blocks: Params, layer: int) -> Params:
    """The ``layer``-th slice of the stacked block parameters (views)."""
    return {k: layer_params(v, layer) if isinstance(v, dict)
            else specs.index0(v, layer) if specs.is_dtensor(v)
            else v[layer] for k, v in blocks.items()}


def _sincos_pos(seq: int, d: int, device: torch.device) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device)
    return emb.timestep_embedding(pos, d)


def _angles_for(cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """RoPE angles of integer positions [B, T] (M-RoPE: [B, T, 3])."""
    hd = cfg.resolved_head_dim
    if cfg.mrope_sections:
        return mrope_angles(positions, hd, cfg.rope_theta,
                            cfg.mrope_sections)
    return rope_angles(positions, hd, cfg.rope_theta)


def _token_positions(cfg: ModelConfig, positions: torch.Tensor
                     ) -> torch.Tensor:
    """Text positions [B, T] as the config's rotary input: M-RoPE carries
    the same index on its three axes."""
    if cfg.mrope_sections:
        return positions[..., None].expand(tuple(positions.shape) + (3,))
    return positions


def embed_inputs(cfg: ModelConfig, params: Params,
                 inputs: Dict[str, Any]) -> Dict[str, Any]:
    """``{"h", "t_emb", "angles"}`` for the full-sequence forward: the
    DiT's patch tokens (image or video latents) and conditioning embedding
    (timestep, class label, the mean of the projected continuous
    ``cond``), or an LM's token embeddings — a VLM's ``patch_embeds``
    ahead of them, an audio model's summed codebook embeddings of [B, K,
    T] tokens — and the RoPE angles of ``inputs["positions"]``
    (default 0..T−1 over the joined length)."""
    if cfg.is_diffusion:
        dtype = cfg.torch_dtype
        pe = params["embed"]
        tokens = emb.patchify(inputs["latents"], cfg.patch_size)
        h = tokens.to(dtype) @ pe["patch_w"] + pe["patch_b"]
        h = h + _sincos_pos(h.shape[1], cfg.d_model,
                            h.device)[None].to(h.dtype)
        t_emb = emb.time_mlp(pe["time"], inputs["t"], cfg.d_model)
        if cfg.num_classes and "labels" in inputs:
            t_emb = t_emb + emb.label_embed(
                pe["label"], inputs["labels"]).to(torch.float32)
        if cfg.cond_dim and "cond" in inputs:
            c = inputs["cond"].to(dtype) @ pe["cond_w"] + pe["cond_b"]
            t_emb = t_emb + torch.mean(c, dim=1).to(torch.float32)
        return {"h": h, "t_emb": t_emb.to(dtype), "angles": None}
    if cfg.arch_type == "audio":
        h = emb.codebook_embed(params["embed"]["codebooks"],
                               inputs["tokens"])
    else:
        h = emb.token_embed(params["embed"]["tok"], inputs["tokens"])
    if cfg.arch_type == "vlm" and "patch_embeds" in inputs:
        h = torch.cat([inputs["patch_embeds"].to(h.dtype), h], dim=1)
    h = specs.residual(h)
    positions = inputs.get("positions")
    if positions is None:
        B, T = h.shape[:2]
        positions = _token_positions(cfg, torch.arange(
            T, dtype=torch.int32, device=h.device)[None].expand(B, T))
    angles = _angles_for(cfg, positions) if cfg.has_attention else None
    return {"h": h, "t_emb": None, "angles": angles}


def forward_full(cfg: ModelConfig, params: Params, h: torch.Tensor, *,
                 t_emb: Optional[torch.Tensor] = None,
                 angles: Optional[torch.Tensor] = None,
                 branch_preds: Optional[torch.Tensor] = None,
                 compute_mask: Optional[Sequence[bool]] = None,
                 collect_branches: bool = False,
                 collect_cache: bool = False, use_flash: bool = False,
                 remat: bool = False
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The layer loop.

    branch_preds: [L, 2, B, S, D] forecast residual increments (SpeCa).
    compute_mask: [L] static bools — True runs the block for real, False
    substitutes ``branch_preds``. None = every layer real.
    remat: recompute each real layer in the backward pass
    (``torch.utils.checkpoint``, non-reentrant), the reference's
    ``jax.checkpoint`` of its scan body: the values are the same.
    Returns (h_final, {"aux_loss": the MoE load-balance losses summed
    over the real layers, an f32 scalar, 0 without experts;
    "branches": [L, 2, B, S, D] when collected; "cache": the family's
    cache leaves ({"k", "v"} [L, B, S, KV, hd], {"ssm_state",
    "conv_state"}) when collected — zeros at a substituted layer, as the
    reference's}).
    """
    L = cfg.num_layers
    mask = [True] * L if compute_mask is None \
        else [bool(m) for m in compute_mask]
    if len(mask) != L:
        raise ValueError(f"compute_mask has {len(mask)} entries for "
                         f"{L} layers")
    if branch_preds is not None:
        # the difference table may be stored in another precision
        branch_preds = branch_preds.to(h.dtype)
    elif not all(mask):
        raise ValueError("a masked forward needs branch_preds")
    branches = specs.stacked_empty((L, 2), h) if collect_branches \
        else None
    caches = []
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for layer in range(L):
        if mask[layer]:
            run = functools.partial(_real_layer, cfg, params, layer, t_emb,
                                    angles, use_flash)
            if remat and torch.is_grad_enabled():
                inc0, inc1, cache, aux_l = checkpoint(run, h,
                                                      use_reentrant=False)
            else:
                inc0, inc1, cache, aux_l = run(h)
            if aux_l is not None:
                aux = aux + aux_l
        else:
            # a forecast increment joins the residual stream's layout
            inc0 = specs.residual(branch_preds[layer][0])
            inc1 = specs.residual(branch_preds[layer][1])
            cache = None
        h = h + inc0 + inc1
        if branches is not None:
            branches[layer, 0] = inc0
            branches[layer, 1] = inc1
        if collect_cache:
            caches.append(cache)
    out: Dict[str, Any] = {"aux_loss": aux}
    if branches is not None:
        out["branches"] = branches
    if collect_cache:
        out["cache"] = _pack_cache(cfg, h, caches)
    return h, out


def _real_layer(cfg: ModelConfig, params: Params, layer: int, t_emb,
                angles, use_flash: bool, h: torch.Tensor):
    """One computed block -> (inc0, inc1, cache, MoE aux loss or None)."""
    fn0, fn1 = blk.block_branches_full(
        cfg, layer_params(params["blocks"], layer), t_emb, angles=angles,
        window=cfg.layer_window(layer), use_flash=use_flash)
    inc0, cache = fn0(h)
    inc0 = specs.residual(inc0)
    inc1, aux = fn1(h + inc0)
    return inc0, specs.residual(inc1), cache, aux


def cache_keys(cfg: ModelConfig) -> Tuple[str, ...]:
    """The cache leaves of ``cfg``, in the order a block's full-sequence
    branch returns them."""
    keys: Tuple[str, ...] = ("k", "v") if cfg.has_attention else ()
    if cfg.is_ssm or cfg.is_hybrid:
        keys += ("ssm_state", "conv_state")
    return keys


def _cache_slice_shape(cfg: ModelConfig, key: str, B: int, S: int):
    """(shape, dtype) of one layer's cache leaf ``key`` for B rows of S
    positions; ``dtype`` None is the model dtype."""
    if key in ("k", "v"):
        return (B, S, cfg.num_kv_heads, cfg.resolved_head_dim), None
    if key == "ssm_state":
        return (B, cfg.resolved_ssm_heads, cfg.ssm_head_dim,
                cfg.ssm_state), torch.float32
    return (B, cfg.ssm_conv, cfg.ssm_d_inner + 2 * cfg.ssm_state), None


def _pack_cache(cfg: ModelConfig, h: torch.Tensor, caches
                ) -> Dict[str, Any]:
    """Stack the layers' cache tuples into [L, ...] leaves (zeros at a
    substituted layer)."""
    B, S = h.shape[:2]
    out = {}
    for i, key in enumerate(cache_keys(cfg)):
        shape, dt = _cache_slice_shape(cfg, key, B, S)
        zero = torch.zeros(shape, dtype=dt or h.dtype, device=h.device)
        out[key] = torch.stack([zero if c is None else c[i]
                                for c in caches])
    return out


def dit_output(cfg: ModelConfig, params: Params, h: torch.Tensor,
               t_emb: torch.Tensor, spatial: Tuple[int, ...]) -> torch.Tensor:
    """Final AdaLN + linear + unpatchify to the latent's (H, W) or
    (F, H, W)."""
    hp = params["head"]
    mod = F.silu(t_emb) @ hp["mod_w"] + hp["mod_b"]
    shift, scale = torch.chunk(mod, 2, dim=-1)
    ones = torch.ones((h.shape[-1],), dtype=torch.float32, device=h.device)
    zeros = torch.zeros((h.shape[-1],), dtype=torch.float32,
                        device=h.device)
    x = layer_norm(h, ones, zeros, cfg.norm_eps)
    x = x * (1 + scale[:, None]) + shift[:, None]
    x = x.to(h.dtype) @ hp["w"] + hp["b"]
    *frames, hh, ww = spatial
    return emb.unpatchify(x, cfg.patch_size, hh, ww, cfg.in_channels,
                          frames=frames[0] if frames else 1)


def dit_forward(cfg: ModelConfig, params: Params, inputs: Dict[str, Any], *,
                branch_preds: Optional[torch.Tensor] = None,
                compute_mask: Optional[Sequence[bool]] = None,
                collect_branches: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Denoiser forward: latents [B, (F,) H, W, C], t [B] (and ``labels``
    [B] and/or ``cond`` [B, T_text, cond_dim]) -> eps (or velocity)
    prediction in the model dtype, in the latents' shape, and
    ``forward_full``'s extras."""
    spatial = tuple(inputs["latents"].shape[1:-1])
    e = embed_inputs(cfg, params, inputs)
    h, extras = forward_full(cfg, params, e["h"], t_emb=e["t_emb"],
                             branch_preds=branch_preds,
                             compute_mask=compute_mask,
                             collect_branches=collect_branches)
    return dit_output(cfg, params, h, e["t_emb"], spatial), extras


# ---------------------------------------------------------------------------
# The LM head and decode
# ---------------------------------------------------------------------------

def lm_logits(cfg: ModelConfig, params: Params,
              h: torch.Tensor) -> torch.Tensor:
    """Final RMSNorm and the head (the embedding table when tied; one head
    per codebook for audio, [B, T, K, V]) -> [..., padded_vocab]; the
    padding columns are −1e30 so that they never win a softmax or an
    argmax."""
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if cfg.arch_type == "audio" and specs.is_dtensor(h):
        w = params["head"]["w"]
        logits = torch.stack([h @ specs.index0(w, k)
                              for k in range(w.shape[0])], dim=2)
    elif cfg.arch_type == "audio":
        logits = torch.einsum("btd,kdv->btkv", h, params["head"]["w"])
    elif cfg.tie_embeddings:
        logits = h @ params["embed"]["tok"].T
    else:
        logits = h @ params["head"]["w"]
    if cfg.padded_vocab != cfg.vocab_size:
        col = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = torch.where(col < cfg.vocab_size, logits, -1e30)
    return logits


def lm_forward(cfg: ModelConfig, params: Params, inputs: Dict[str, Any], *,
               collect_cache: bool = False, use_flash: bool = False,
               remat: bool = False
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """LM forward over ``inputs["tokens"]`` [B, T] (audio: [B, K, T]) ->
    (logits [B, T, V] (audio: [B, T, K, V]), extras with ``aux_loss``);
    ``collect_cache=True`` adds the prefill's cache; ``remat=True``
    recomputes each layer in the backward pass."""
    e = embed_inputs(cfg, params, inputs)
    h, extras = forward_full(cfg, params, e["h"], angles=e["angles"],
                             collect_cache=collect_cache,
                             use_flash=use_flash, remat=remat)
    return lm_logits(cfg, params, h), extras


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """Zero decode caches on ``device``: K/V [L, batch, S, KV, hd] in the
    model dtype where the model has attention, S = ``max_len`` or, when
    every layer is windowed, a ring buffer of min(``max_len``, window)
    slots; an SSD mixer's ``ssm_state`` f32 [L, batch, h, p, n] and
    ``conv_state`` [L, batch, W, C] in the model dtype."""
    dev = resolve_device(device)
    S = min(max_len, cfg.attn_window) if blk.uses_ring_cache(cfg) \
        else max_len
    out = {}
    for key in cache_keys(cfg):
        shape, dt = _cache_slice_shape(cfg, key, batch, S)
        out[key] = torch.zeros((cfg.num_layers,) + shape,
                               dtype=dt or cfg.torch_dtype, device=dev)
    return out


def _decode_angles(cfg: ModelConfig,
                   positions: torch.Tensor) -> Optional[torch.Tensor]:
    """RoPE angles [B, 1, hd/2] of one token per row at ``positions`` [B]."""
    if not cfg.has_attention:
        return None
    return _angles_for(cfg, _token_positions(
        cfg, positions.to(torch.int32)[:, None]))


def decode_step_h(cfg: ModelConfig, params: Params, h: torch.Tensor,
                  cache: Dict[str, torch.Tensor], pos: int
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step on the embedded token h [B, 1, D] at the shared
    position ``pos`` -> (h, new cache)."""
    angles = _decode_angles(cfg, torch.full(
        (h.shape[0],), int(pos), dtype=torch.int32, device=h.device))
    new = {k: [] for k in cache}
    for layer in range(cfg.num_layers):
        h, sl = blk.block_decode(
            cfg, layer_params(params["blocks"], layer), h,
            {k: cache[k][layer] for k in new}, angles=angles,
            window=cfg.layer_window(layer), pos=pos)
        for k in new:
            new[k].append(sl[k])
    return h, {k: torch.stack(v) for k, v in new.items()}


def lm_decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   cache: Dict[str, torch.Tensor], pos: int
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens [B, 1] (audio: [B, K, 1]) at position ``pos`` -> (logits
    [B, 1, V] (audio: [B, 1, K, V]), new cache)."""
    if cfg.arch_type == "audio":
        h = emb.codebook_embed(params["embed"]["codebooks"], tokens)
    else:
        h = emb.token_embed(params["embed"]["tok"], tokens)
    h, new_cache = decode_step_h(cfg, params, h, cache, pos)
    return lm_logits(cfg, params, h), new_cache


def decode_branches_step(cfg: ModelConfig, params: Params, tok: torch.Tensor,
                         cache: Dict[str, torch.Tensor],
                         positions: torch.Tensor, *,
                         branch_preds: Optional[torch.Tensor] = None,
                         compute_mask: Optional[Sequence[bool]] = None,
                         collect_branches: bool = False
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                    Optional[torch.Tensor]]:
    """Lane-batched decode forward with the SpeCa branch seam: tok [B, 1]
    int32 input tokens, cache {k, v} [L, B, S, KV, hd] and/or {ssm_state,
    conv_state}, positions [B] int32 per-lane query positions.
    ``branch_preds`` [L, 2, B, 1, D] substitutes forecast increments where
    the static ``compute_mask`` [L] is False (None = every layer real).
    Every layer writes its cache either way: a substituted layer writes the
    forecast stream's K/V projections and advances its SSD state from it.
    Returns (logits [B, 1, V], new cache, branches
    [L, 2, B, 1, D] when collected, else None)."""
    h = emb.token_embed(params["embed"]["tok"], tok)
    L = cfg.num_layers
    mask = [True] * L if compute_mask is None \
        else [bool(m) for m in compute_mask]
    if len(mask) != L:
        raise ValueError(f"compute_mask has {len(mask)} entries for "
                         f"{L} layers")
    if branch_preds is not None:
        branch_preds = branch_preds.to(h.dtype)
    elif not all(mask):
        raise ValueError("a masked forward needs branch_preds")
    angles = _decode_angles(cfg, positions)
    branches = torch.empty((L, 2) + tuple(h.shape), dtype=h.dtype,
                           device=h.device) if collect_branches else None
    new = {k: [] for k in cache}
    for layer in range(L):
        fn0, fn1, spec_cache = blk.block_decode_branches(
            cfg, layer_params(params["blocks"], layer),
            {k: cache[k][layer] for k in new}, angles=angles,
            window=cfg.layer_window(layer), positions=positions)
        if mask[layer]:
            inc0, sl = fn0(h)
            inc1 = fn1(h + inc0)
        else:
            inc0, inc1 = branch_preds[layer, 0], branch_preds[layer, 1]
            sl = spec_cache(h)
        h = h + inc0 + inc1
        if branches is not None:
            branches[layer, 0] = inc0
            branches[layer, 1] = inc1
        for k in new:
            new[k].append(sl[k])
    logits = lm_logits(cfg, params, h)
    return logits, {k: torch.stack(v) for k, v in new.items()}, branches
