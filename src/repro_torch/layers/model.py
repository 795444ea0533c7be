"""The DiT backbone: init, embedding, the masked layer loop, the head.

Block parameters are stacked ``[L, …]`` exactly as the reference's
``jax.vmap``-initialised tree, so ``repro_torch.convert.params_from_jax``
is a leaf-by-leaf copy. SpeCa hooks in through ``branch_preds`` /
``compute_mask``: a speculative step passes forecast increments for every
layer and a mask that is True only at the verification layer. The
reference skips the other layers with a per-layer ``lax.cond``; here the
mask is a static Python sequence fixed when the step is built, so a
skipped layer is a plain ``if`` that launches nothing.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.layers import blocks as blk
from repro_torch.layers import embeddings as emb
from repro_torch.layers.norms import layer_norm

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
    """Random DiT parameters with the reference's initialisation scheme
    (``repro.layers.model.init_params``, DiT leaves only): AdaLN-Zero
    modulation leaves and the final layer start at zero. Drawn on the
    generator's device, then moved to ``device``."""
    dev = resolve_device(device)
    dtype = cfg.torch_dtype
    d, hd, L = cfg.d_model, cfg.resolved_head_dim, cfg.num_layers
    g = generator
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
    params = {"embed": embed, "blocks": blocks, "head": head}
    return tree_to(params, dev)


def tree_to(tree: Any, device: torch.device) -> Any:
    """Move every tensor leaf of a nested dict to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def layer_params(blocks: Params, layer: int) -> Params:
    """The ``layer``-th slice of the stacked block parameters (views)."""
    return {k: layer_params(v, layer) if isinstance(v, dict) else v[layer]
            for k, v in blocks.items()}


def _sincos_pos(seq: int, d: int, device: torch.device) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device)
    return emb.timestep_embedding(pos, d)


def embed_inputs(cfg: ModelConfig, params: Params,
                 inputs: Dict[str, Any]) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """(h [B, T, D], t_emb [B, D]) for the DiT forward."""
    dtype = cfg.torch_dtype
    pe = params["embed"]
    tokens = emb.patchify(inputs["latents"], cfg.patch_size)
    h = tokens.to(dtype) @ pe["patch_w"] + pe["patch_b"]
    h = h + _sincos_pos(h.shape[1], cfg.d_model, h.device)[None].to(h.dtype)
    t_emb = emb.time_mlp(pe["time"], inputs["t"], cfg.d_model)
    if cfg.num_classes and "labels" in inputs:
        t_emb = t_emb + emb.label_embed(
            pe["label"], inputs["labels"]).to(torch.float32)
    return h, t_emb.to(dtype)


def forward_full(cfg: ModelConfig, params: Params, h: torch.Tensor, *,
                 t_emb: torch.Tensor,
                 branch_preds: Optional[torch.Tensor] = None,
                 compute_mask: Optional[Sequence[bool]] = None,
                 collect_branches: bool = False
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The layer loop.

    branch_preds: [L, 2, B, S, D] forecast residual increments (SpeCa).
    compute_mask: [L] static bools — True runs the block for real, False
    substitutes ``branch_preds``. None = every layer real.
    Returns (h_final, {"branches": [L, 2, B, S, D]} when collected).
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
    branches = torch.empty((L, 2) + tuple(h.shape), dtype=h.dtype,
                           device=h.device) if collect_branches else None
    for layer in range(L):
        if mask[layer]:
            fn0, fn1 = blk.block_branches_full(
                cfg, layer_params(params["blocks"], layer), t_emb)
            inc0 = fn0(h)
            inc1 = fn1(h + inc0)
        else:
            inc0, inc1 = branch_preds[layer, 0], branch_preds[layer, 1]
        h = h + inc0 + inc1
        if branches is not None:
            branches[layer, 0] = inc0
            branches[layer, 1] = inc1
    out: Dict[str, Any] = {}
    if branches is not None:
        out["branches"] = branches
    return h, out


def dit_output(cfg: ModelConfig, params: Params, h: torch.Tensor,
               t_emb: torch.Tensor, spatial: Tuple[int, int]) -> torch.Tensor:
    """Final AdaLN + linear + unpatchify to the latent's (H, W)."""
    hp = params["head"]
    mod = F.silu(t_emb) @ hp["mod_w"] + hp["mod_b"]
    shift, scale = torch.chunk(mod, 2, dim=-1)
    ones = torch.ones((h.shape[-1],), dtype=torch.float32, device=h.device)
    zeros = torch.zeros((h.shape[-1],), dtype=torch.float32,
                        device=h.device)
    x = layer_norm(h, ones, zeros, cfg.norm_eps)
    x = x * (1 + scale[:, None]) + shift[:, None]
    x = x.to(h.dtype) @ hp["w"] + hp["b"]
    hh, ww = spatial
    return emb.unpatchify(x, cfg.patch_size, hh, ww, cfg.in_channels)


def dit_forward(cfg: ModelConfig, params: Params, inputs: Dict[str, Any], *,
                branch_preds: Optional[torch.Tensor] = None,
                compute_mask: Optional[Sequence[bool]] = None,
                collect_branches: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Denoiser forward: latents [B, H, W, C], t [B] -> eps prediction in
    the model dtype."""
    spatial = tuple(inputs["latents"].shape[1:-1])
    h, t_emb = embed_inputs(cfg, params, inputs)
    h, extras = forward_full(cfg, params, h, t_emb=t_emb,
                             branch_preds=branch_preds,
                             compute_mask=compute_mask,
                             collect_branches=collect_branches)
    return dit_output(cfg, params, h, t_emb, spatial), extras
