"""Top-k mixture-of-experts with static-capacity dispatch (the reference's
``repro.layers.moe``).

Tokens are routed into a per-expert capacity buffer (GShard/Switch
style): a (token, choice) slot's rank is the running count of earlier
slots, in token-major order, that chose the same expert, and a slot whose
rank reaches the capacity is dropped and contributes nothing. The
reference splits the slots into one dispatch group per data-parallel
shard. On one device that is one group, so the plain path has no group
axis; handed DTensors (the production-mesh dry run), each rank dispatches
its own batch shard as one group with the group's capacity, as the
reference's groups do.

Three places where the reference's rounding and order are kept:

- the router product runs in the model dtype and is cast to f32 after,
  so bf16 logits round as the reference's and pick the same experts;
- ``lax.top_k`` puts the lower expert index first among equal
  probabilities (bf16 logits tie often); ``torch.topk`` promises no
  order, so the top K are the first K of a stable descending sort;
- the kept rows are written at their unique slots with a copy, not an
  add, so no atomic order decides the buffer; the dropped slots all
  write to one spare row past the buffer, which is cut off.

The per-expert products are batched matmuls over the [E, capacity, D]
buffer; the reference computes them outside any Pallas kernel. Beside
the output comes the reference's Switch load-balance loss
``E·Σ_e f_e·p̄_e`` (f_e: the share of tokens whose first choice is e,
p̄_e: the mean router probability of e), a training term.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.sharding import specs


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def capacity(n_tokens: int, top_k: int, num_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert: ``round_up(max(ceil(cf·N·K/E), 8), 8)``."""
    return round_up(max(int(math.ceil(capacity_factor * n_tokens * top_k
                                      / num_experts)), 8), 8)


def _route(params: Dict[str, torch.Tensor], x_flat: torch.Tensor, K: int):
    """(router probabilities [N, E] f32, the top-K gate values renormalised,
    their expert ids)."""
    logits = (x_flat @ params["router"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                      # [N, E]
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = order.values[:, :K], order.indices[:, :K]
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    return probs, gate_vals, gate_idx


def _dispatch(x_flat: torch.Tensor, gate_vals: torch.Tensor,
              gate_idx: torch.Tensor, E: int, K: int, cap: int):
    """Static-capacity dispatch of one group -> (the expert buffer
    [E, cap, D], each slot's buffer row, gate and keep flag)."""
    n_slots, D = gate_idx.numel(), x_flat.shape[1]
    flat_e = gate_idx.reshape(n_slots)                         # expert ids
    flat_g = gate_vals.reshape(n_slots)
    tok_of = torch.arange(n_slots, device=x_flat.device) // K
    onehot = F.one_hot(flat_e, E).to(torch.int32)              # [Ns, E]
    pos = torch.gather(torch.cumsum(onehot, dim=0) - 1, 1,
                       flat_e[:, None])[:, 0]                  # slot rank
    keep = pos < cap                                           # drop overflow
    slot = flat_e * cap + torch.clamp(pos, max=cap - 1)
    buf = torch.zeros((E * cap + 1, D), dtype=x_flat.dtype,
                      device=x_flat.device)
    buf.index_copy_(0, torch.where(keep, slot, E * cap), x_flat[tok_of])
    return buf[:E * cap].reshape(E, cap, D), slot, flat_g, keep


def _experts(params: Dict[str, torch.Tensor], xe: torch.Tensor,
             act: str) -> torch.Tensor:
    """The per-expert FFN on the buffer [E, cap, D]."""
    if act == "silu":
        h = F.silu(torch.bmm(xe, params["w_gate"])) \
            * torch.bmm(xe, params["w_up"])
    else:
        h = F.gelu(torch.bmm(xe, params["w_up"]), approximate="tanh")
    return torch.bmm(h, params["w_down"])


def _combine(ye: torch.Tensor, slot: torch.Tensor, flat_g: torch.Tensor,
             keep: torch.Tensor, K: int, dtype: torch.dtype) -> torch.Tensor:
    """Gather each slot's row of ye [E·cap, D], weight it, sum a token's K
    -> [N, D]."""
    out_k = ye[slot] * (flat_g * keep.to(torch.float32)).to(dtype)[:, None]
    return out_k.reshape(-1, K, ye.shape[-1]).sum(dim=1)


def moe_forward(params: Dict[str, torch.Tensor], x: torch.Tensor, *,
                num_experts: int, top_k: int, act: str = "silu",
                capacity_factor: float = 1.25
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-k expert FFN of x [B, T, D] -> ([B, T, D] in x's dtype,
    the f32 load-balance loss)."""
    if specs.is_dtensor(x):
        return _moe_forward_sharded(params, x, num_experts=num_experts,
                                    top_k=top_k, act=act,
                                    capacity_factor=capacity_factor)
    B, T, D = x.shape
    E, K = num_experts, top_k
    n_tok = B * T
    x_flat = x.reshape(n_tok, D)
    probs, gate_vals, gate_idx = _route(params, x_flat, K)

    # Switch-style load-balance auxiliary loss: E * Σ_e f_e · p̄_e
    f = torch.mean(F.one_hot(gate_idx[:, 0], E).to(torch.float32), dim=0)
    aux_loss = E * torch.sum(f * torch.mean(probs, dim=0))

    cap = capacity(n_tok, K, E, capacity_factor)
    xe, slot, flat_g, keep = _dispatch(x_flat, gate_vals, gate_idx, E, K,
                                       cap)
    ye = _experts(params, xe, act).reshape(E * cap, D)
    return _combine(ye, slot, flat_g, keep, K, x.dtype).reshape(B, T, D), \
        aux_loss


def _moe_forward_sharded(params, x, *, num_experts: int, top_k: int,
                         act: str, capacity_factor: float):
    """``moe_forward`` on DTensors, with the reference's dispatch groups:
    one group per shard of the batch over the data axes (G = their size;
    1 when the batch is whole). Each rank routes and dispatches its own
    tokens into a per-group buffer of the group's capacity; the buffer
    [E, G·cap, D] is split over the groups and, when the experts divide
    the "model" axis, over the experts (expert parallel; else the FFN's
    weights split their hidden dim). The load-balance loss's means are
    all-reduced over the groups."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    E, K = num_experts, top_k
    x = specs.residual(x)
    mesh, B, T, D = x.device_mesh, *x.shape
    groups = [i for i, p in enumerate(x.placements) if p == Shard(0)]
    G = math.prod(mesh.size(i) for i in groups)
    gp = [Shard(0) if i in groups else Replicate() for i in range(mesh.ndim)]
    n_loc = B * T // G
    xl = x.to_local().reshape(n_loc, D)
    router = params["router"]
    if specs.is_dtensor(router):
        router = router.full_tensor()
    probs, gate_vals, gate_idx = _route({"router": router}, xl, K)

    def global_mean(v):
        part = [Partial() if i in groups else Replicate()
                for i in range(mesh.ndim)]
        return DTensor.from_local(v, mesh, part, run_check=False) \
            .redistribute(mesh, [Replicate()] * mesh.ndim) / (B * T)

    f = global_mean(torch.sum(F.one_hot(gate_idx[:, 0], E)
                              .to(torch.float32), dim=0))
    aux_loss = E * torch.sum(f * global_mean(torch.sum(probs, dim=0)))

    cap = capacity(n_loc, K, E, capacity_factor)
    xe, slot, flat_g, keep = _dispatch(xl, gate_vals, gate_idx, E, K, cap)
    bp = [Shard(1) if i in groups else Replicate() for i in range(mesh.ndim)]
    xe = DTensor.from_local(xe, mesh, bp, run_check=False)
    model = mesh.mesh_dim_names.index("model")
    if E % mesh.size(model) == 0:
        xe = xe.redistribute(mesh, [Shard(0) if i == model else p
                                    for i, p in enumerate(bp)])
    ye = _experts(params, xe, act)
    ye = ye.redistribute(mesh, bp).to_local().reshape(E * cap, D)
    out = _combine(ye, slot, flat_g, keep, K, x.dtype).reshape(
        B // G, T, D)
    return DTensor.from_local(out, mesh, gp, run_check=False), aux_loss
