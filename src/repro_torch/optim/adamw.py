"""AdamW with decoupled weight decay, global-norm clipping and the cosine
warmup schedule, over the port's nested-dict parameter trees (the
reference's ``repro.optim.adamw``).

The reference's arithmetic order is kept: the gradients are clipped
first (a bf16 gradient times the f32 scale is an f32 product), then the
moments update in f32, ``step = (mu/bc1)/(sqrt(nu/bc2)+eps)`` and
``p − lr·(step + wd·p)`` in f32, cast back to the leaf's dtype. Decay
applies to every leaf and there is no f32 master copy.
``torch.optim.AdamW`` rounds in another order, keeps its moments in the
parameter dtype and does not clip, so it is not used.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def init_opt_state(params) -> Dict[str, Any]:
    """Zero f32 moments shaped as ``params`` and an int32 step count, on
    the parameters' device."""
    mu = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device), params)
    dev = tree_leaves(params)[0].device
    return {"mu": mu, "nu": tree_map(torch.zeros_like, mu),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the f32 sum of squares of every leaf (leaves in sorted key
    order, as ``jax.tree.leaves``)."""
    total = None
    for g in tree_leaves(tree):
        s = torch.sum(torch.square(g.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm/(norm + 1e-9)) in f32, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state, lr_scale=1.0):
    """One AdamW step -> (new_params, new_state, {"grad_norm"}). Every
    tensor stays on the device; ``lr_scale`` is a number (the schedule's
    value on the host)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    count = state["count"] + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=c.device), c)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=c.device), c)
    # the reference's f32 product cfg.lr * lr_scale
    lr = float(np.float32(cfg.lr) * np.float32(lr_scale))

    def upd(p, g, mu, nu):
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * torch.square(g)
        step = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        p32 = p.to(torch.float32)
        new_p = p32 - lr * (step + cfg.weight_decay * p32)
        return new_p.to(p.dtype), mu, nu

    out = [upd(p, g, m, n) for p, g, m, n in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state["mu"]),
        tree_leaves(state["nu"]))]
    new_state = {"mu": tree_unflatten_like(params, [o[1] for o in out]),
                 "nu": tree_unflatten_like(params, [o[2] for o in out]),
                 "count": count}
    return (tree_unflatten_like(params, [o[0] for o in out]), new_state,
            {"grad_norm": gnorm})


def cosine_warmup_schedule(warmup: int, total: int
                           ) -> Callable[[int], np.float32]:
    """Linear warmup over ``warmup`` steps, then a cosine decay to 0 at
    ``total``: the LR multiplier of a step, an f32 host value computed as
    the reference's f32 ops."""
    f32 = np.float32

    def fn(step) -> np.float32:
        step = f32(step)
        warm = min(step / f32(max(warmup, 1)), f32(1.0))
        prog = np.clip((step - f32(warmup)) / f32(max(total - warmup, 1)),
                       f32(0.0), f32(1.0))
        return f32(warm * f32(0.5) * (f32(1.0) + np.cos(f32(math.pi)
                                                         * prog)))
    return fn

