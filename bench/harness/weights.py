"""Seeded DiT weights, drawn on the device in the port's parameter layout,
tamed so that drafts can be accepted.

A frozen copy, for the benchmark's own use, of two pieces of this
repository at commit 703f501e5fb4824a3dc6decb92e03d82cd6a51c8:

* the DiT half of ``src/repro_torch/layers/model.py`` (``_dense`` and
  ``_init_dit``): the stacked ``[L, ...]`` leaves in the same order of
  draws, N(0, 1/fan_in) unless a scale is given, AdaLN-Zero leaves and
  the head at zero;
* ``chip_smoke.py::Smoke._tamed_params``: the AdaLN leaves and the head
  refilled from small seeded noise, and the timestep MLP's first layer
  kept only on sinusoids that turn at most 0.2 rad a sampler step
  (random weights on the fast ones make every modulation jump from one
  step to the next, which no trained DiT does and which rejects every
  draft).

``bench/test_bench_counts.py`` holds this copy equal to both origins.
Each leaf is one call of the generator (a handful of large calls, the
stacked block weights whole), in float32 and then cast to the dtype the
model is served in.

:func:`permute` then lays the same model out in another order: each
layer's attention heads, each layer's MLP hidden units and the timestep
MLP's hidden units are permuted, the products that read them permuted to
match. The function is the same (up to the order of the sums), so every
run seed serves one model, whose tamed random weights are the
configuration's (``weights_seed``, ``taming_seed``), in a layout of its
own: which drafts of a lane batch reject together depends on the model,
and a model drawn anew from every run seed changed the work of a run by
a third (PERF.md).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch


def _dense(g: torch.Generator, shape, dtype, scale: Optional[float] = None,
           layers: Optional[int] = None) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    full = tuple(shape) if layers is None else (layers,) + tuple(shape)
    w = torch.randn(full, generator=g, dtype=torch.float32,
                    device=g.device)
    return (w * scale).to(dtype)


def _draw(cfg: Dict, g: torch.Generator, dtype: torch.dtype) -> Dict:
    d, L = cfg["d_model"], cfg["num_layers"]
    H = cfg["num_heads"]
    hd = d // H
    in_dim = cfg["patch_size"] ** 2 * cfg["in_channels"]

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=g.device)

    embed = {
        "patch_w": _dense(g, (in_dim, d), dtype),
        "patch_b": zeros(d),
        "time": {"w1": _dense(g, (d, d), torch.float32),
                 "b1": zeros(d, dt=torch.float32),
                 "w2": _dense(g, (d, d), torch.float32),
                 "b2": zeros(d, dt=torch.float32)},
    }
    if cfg.get("num_classes", 0):
        embed["label"] = _dense(g, (cfg["num_classes"] + 1, d), dtype,
                                scale=0.02)
    if cfg.get("cond_dim", 0):
        embed["cond_w"] = _dense(g, (cfg["cond_dim"], d), dtype)
        embed["cond_b"] = zeros(d)
    blocks = {
        "wq": _dense(g, (d, H * hd), dtype, layers=L),
        "wk": _dense(g, (d, H * hd), dtype, layers=L),
        "wv": _dense(g, (d, H * hd), dtype, layers=L),
        "wo": _dense(g, (H * hd, d), dtype, scale=1.0 / math.sqrt(H * hd),
                     layers=L),
        "mlp": {"w_up": _dense(g, (d, cfg["d_ff"]), dtype, layers=L),
                "w_down": _dense(g, (cfg["d_ff"], d), dtype, layers=L)},
        "mod_w": zeros(L, d, 6 * d),
        "mod_b": zeros(L, 6 * d),
    }
    head = {"w": zeros(d, in_dim), "b": zeros(in_dim),
            "mod_w": zeros(d, 2 * d), "mod_b": zeros(2 * d)}
    return {"embed": embed, "blocks": blocks, "head": head}


def make(cfg: Dict, seed: int, taming_seed: int,
         device: torch.device) -> Dict:
    """The tamed weights of ``cfg`` (the benchmark's configuration dict)
    from two seeds, on ``device``, in ``cfg["dtype"]``."""
    dtype = getattr(torch, cfg["dtype"])
    params = _draw(cfg, torch.Generator(device=device).manual_seed(seed),
                   dtype)
    d = cfg["d_model"]
    noise = torch.Generator(device=device).manual_seed(taming_seed)

    def fill(t, scale):
        t.copy_(torch.randn(t.shape, generator=noise, device=device)
                * scale)
    fill(params["blocks"]["mod_w"], 0.4 / math.sqrt(d))
    fill(params["blocks"]["mod_b"], 0.02)
    fill(params["head"]["mod_w"], 0.4 / math.sqrt(d))
    fill(params["head"]["mod_b"], 0.02)
    fill(params["head"]["w"], 1.0 / math.sqrt(d))
    fill(params["head"]["b"], 0.02)
    half = d // 2
    freq = torch.exp(-math.log(10_000.0)
                     * torch.arange(half, device=device) / half)
    dt = cfg["num_train_timesteps"] / cfg["num_inference_steps"]
    keep = (dt * freq <= 0.2).to(torch.float32)
    params["embed"]["time"]["w1"] *= torch.cat([keep, keep])[:, None]
    return params


def _perm(g: torch.Generator, rows: int, n: int,
          device: torch.device) -> torch.Tensor:
    """[rows, n] independent random permutations of range(n)."""
    return torch.argsort(torch.rand((rows, n), generator=g, device=device),
                         dim=1)


def permute(params: Dict, cfg: Dict, seed: int,
            device: torch.device) -> Dict:
    """The same model with each layer's heads, each layer's MLP hidden
    units and the timestep MLP's hidden units in a seeded order."""
    g = torch.Generator(device=device).manual_seed(seed)
    b, L = params["blocks"], cfg["num_layers"]
    d, H = cfg["d_model"], cfg["num_heads"]
    hd = d // H
    heads = _perm(g, L, H, device)
    cols = (heads[:, :, None] * hd + torch.arange(hd, device=device)
            ).reshape(L, H * hd)
    for k in ("wq", "wk", "wv"):
        b[k] = torch.gather(b[k], 2, cols[:, None, :].expand(-1, d, -1))
    b["wo"] = torch.gather(b["wo"], 1, cols[:, :, None].expand(-1, -1, d))
    hidden = _perm(g, L, cfg["d_ff"], device)
    mlp = b["mlp"]
    mlp["w_up"] = torch.gather(mlp["w_up"], 2,
                               hidden[:, None, :].expand(-1, d, -1))
    mlp["w_down"] = torch.gather(mlp["w_down"], 1,
                                 hidden[:, :, None].expand(-1, -1, d))
    t = params["embed"]["time"]
    order = _perm(g, 1, d, device)[0]
    t["w1"], t["b1"] = t["w1"][:, order], t["b1"][order]
    t["w2"] = t["w2"][order]
    return params
