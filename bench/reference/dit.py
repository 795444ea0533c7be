"""A plain float32 DiT: the denoiser of both configurations, written from
the equations of DiT (arXiv:2212.09748, AdaLN-Zero blocks) and its
text-conditioned variant, with no kernel, cache or lane batching.

Parameters come in the layout the benchmark's weight maker draws
(``bench/harness/weights.py``): ``embed`` (patch projection, timestep
MLP, class table and/or text projection), ``blocks`` stacked ``[L, ...]``
and ``head``. Each weight is cast to float32 where it is used, one layer
at a time, so a bfloat16 model never sits whole in float32.

SpeCa's two forwards: ``forward(..., collect=True)`` returns every
layer's two residual increments, and ``forward(..., preds=, computed=)``
substitutes forecast increments for every layer but those in
``computed`` (the verify layer), returning the computed layer's
increments as well. ``matmul`` is the one product every linear layer
goes through, so a control can run the same model at a lower precision.

Imports nothing of the program under test.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

MatMul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def f32_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.to(torch.float32)


def linear(mm: MatMul, x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = mm(x, w)
    return y if b is None else y + b.to(torch.float32)


def sinusoid(t: torch.Tensor, dim: int) -> torch.Tensor:
    """cos | sin embedding of (fractional) positions or timesteps [N]."""
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    return F.pad(emb, (0, dim % 2))


def patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/p)(W/p), p·p·C], patches row-major."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def unpatchify(x: torch.Tensor, p: int, h: int, w: int,
               c: int) -> torch.Tensor:
    b = x.shape[0]
    x = x.reshape(b, h // p, w // p, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def layer_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Parameter-free LayerNorm, population variance."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps)


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """Bidirectional softmax attention, [B, T, H, hd] each."""
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    s = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return (torch.softmax(s, dim=-1) @ v).transpose(1, 2)


def _layer(P: Dict, i: int, key: str) -> torch.Tensor:
    node = P["blocks"]
    for part in key.split("."):
        node = node[part]
    return node[i]


def block(cfg: Dict, P: Dict, i: int, h: torch.Tensor, c: torch.Tensor,
          mm: MatMul):
    """Layer i's two increments: the gated attention branch on the
    modulated LayerNorm of h, then the gated GELU MLP on that of
    h + inc0."""
    B, T, d = h.shape
    H = cfg["num_heads"]
    hd = d // H
    eps = cfg["norm_eps"]
    mod = linear(mm, F.silu(c), _layer(P, i, "mod_w"), _layer(P, i, "mod_b"))
    sh_a, sc_a, g_a, sh_m, sc_m, g_m = (m[:, None] for m in
                                        mod.chunk(6, dim=-1))
    x = layer_norm(h, eps) * (1 + sc_a) + sh_a
    q = mm(x, _layer(P, i, "wq")).reshape(B, T, H, hd)
    k = mm(x, _layer(P, i, "wk")).reshape(B, T, H, hd)
    v = mm(x, _layer(P, i, "wv")).reshape(B, T, H, hd)
    inc0 = g_a * mm(attention(q, k, v).reshape(B, T, d),
                    _layer(P, i, "wo"))
    x = layer_norm(h + inc0, eps) * (1 + sc_m) + sh_m
    up = F.gelu(mm(x, _layer(P, i, "mlp.w_up")), approximate="tanh")
    inc1 = g_m * mm(up, _layer(P, i, "mlp.w_down"))
    return inc0, inc1


def condition(cfg: Dict, P: Dict, t: torch.Tensor,
              labels: Optional[torch.Tensor], text: Optional[torch.Tensor],
              mm: MatMul) -> torch.Tensor:
    """The conditioning vector [B, d]: the timestep MLP, plus the class
    embedding and/or the mean of the projected text embedding."""
    e = P["embed"]
    te = e["time"]
    c = F.silu(linear(mm, sinusoid(t, cfg["d_model"]), te["w1"], te["b1"]))
    c = linear(mm, c, te["w2"], te["b2"])
    if labels is not None and cfg.get("num_classes", 0):
        c = c + e["label"][labels.long()].to(torch.float32)
    if text is not None and cfg.get("cond_dim", 0):
        c = c + linear(mm, text.to(torch.float32), e["cond_w"],
                       e["cond_b"]).mean(dim=1)
    return c


def forward(cfg: Dict, P: Dict, latents: torch.Tensor, t: torch.Tensor, *,
            labels: Optional[torch.Tensor] = None,
            text: Optional[torch.Tensor] = None,
            preds: Optional[torch.Tensor] = None,
            computed: Optional[Sequence[int]] = None,
            collect: bool = False, mm: MatMul = f32_matmul):
    """The denoiser on latents [B, H, W, C] at model times t [B].

    Returns ``(out [B, H, W, C], increments)``: with ``collect`` every
    layer's increments [L, 2, B, T, d]; with ``preds`` (forecast
    increments [L, 2, B, T, d]) only the layers in ``computed`` run and
    the increments returned are theirs, [len(computed), 2, B, T, d];
    otherwise None."""
    p, L = cfg["patch_size"], cfg["num_layers"]
    B, Hh, Ww, C = latents.shape
    e = P["embed"]
    h = linear(mm, patchify(latents.to(torch.float32), p), e["patch_w"],
               e["patch_b"])
    T, d = h.shape[1:]
    h = h + sinusoid(torch.arange(T, device=h.device), d)[None]
    c = condition(cfg, P, t, labels, text, mm)
    run = range(L) if preds is None else sorted(computed or ())
    incs = torch.empty((L if collect else len(run), 2, B, T, d),
                       dtype=torch.float32, device=h.device) \
        if collect or preds is not None else None
    for i in range(L):
        if preds is None or i in run:
            inc0, inc1 = block(cfg, P, i, h, c, mm)
            if incs is not None:
                j = i if collect else list(run).index(i)
                incs[j, 0], incs[j, 1] = inc0, inc1
        else:
            inc0, inc1 = preds[i, 0], preds[i, 1]
        h = h + inc0 + inc1
    hp = P["head"]
    mod = linear(mm, F.silu(c), hp["mod_w"], hp["mod_b"])
    shift, scale = (m[:, None] for m in mod.chunk(2, dim=-1))
    x = layer_norm(h, cfg["norm_eps"]) * (1 + scale) + shift
    x = linear(mm, x, hp["w"], hp["b"])
    return unpatchify(x, p, Hh, Ww, C), incs
