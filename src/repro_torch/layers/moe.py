"""Top-k mixture-of-experts with static-capacity dispatch (the reference's
``repro.layers.moe``, one dispatch group).

Tokens are routed into a per-expert capacity buffer (GShard/Switch
style): a (token, choice) slot's rank is the running count of earlier
slots, in token-major order, that chose the same expert, and a slot whose
rank reaches the capacity is dropped and contributes nothing. The
reference splits the slots into one dispatch group per data-parallel
shard; on one device that is one group, so the group axis, its sharding
constraints and the expert/group regroup are left out here. They come
with multi-GPU lane sharding.

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


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def capacity(n_tokens: int, top_k: int, num_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert: ``round_up(max(ceil(cf·N·K/E), 8), 8)``."""
    return round_up(max(int(math.ceil(capacity_factor * n_tokens * top_k
                                      / num_experts)), 8), 8)


def moe_forward(params: Dict[str, torch.Tensor], x: torch.Tensor, *,
                num_experts: int, top_k: int, act: str = "silu",
                capacity_factor: float = 1.25
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-k expert FFN of x [B, T, D] -> ([B, T, D] in x's dtype,
    the f32 load-balance loss)."""
    B, T, D = x.shape
    E, K = num_experts, top_k
    n_tok = B * T
    x_flat = x.reshape(n_tok, D)

    logits = (x_flat @ params["router"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                      # [N, E]
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = order.values[:, :K], order.indices[:, :K]
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    # Switch-style load-balance auxiliary loss: E * Σ_e f_e · p̄_e
    f = torch.mean(F.one_hot(gate_idx[:, 0], E).to(torch.float32), dim=0)
    aux_loss = E * torch.sum(f * torch.mean(probs, dim=0))

    # --- static-capacity dispatch
    n_slots = n_tok * K
    cap = capacity(n_tok, K, E, capacity_factor)
    flat_e = gate_idx.reshape(n_slots)                         # expert ids
    flat_g = gate_vals.reshape(n_slots)
    tok_of = torch.arange(n_slots, device=x.device) // K
    onehot = F.one_hot(flat_e, E).to(torch.int32)              # [Ns, E]
    pos = torch.gather(torch.cumsum(onehot, dim=0) - 1, 1,
                       flat_e[:, None])[:, 0]                  # slot rank
    keep = pos < cap                                           # drop overflow
    slot = flat_e * cap + torch.clamp(pos, max=cap - 1)
    buf = torch.zeros((E * cap + 1, D), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, torch.where(keep, slot, E * cap), x_flat[tok_of])
    xe = buf[:E * cap].reshape(E, cap, D)

    # --- per-expert FFN
    if act == "silu":
        h = F.silu(torch.bmm(xe, params["w_gate"])) \
            * torch.bmm(xe, params["w_up"])
    else:
        h = F.gelu(torch.bmm(xe, params["w_up"]), approximate="tanh")
    ye = torch.bmm(h, params["w_down"]).reshape(E * cap, D)

    # --- combine: gather each slot's row, weight it, sum a token's K
    out_k = ye[slot] * (flat_g * keep.to(torch.float32)).to(x.dtype)[:, None]
    return out_k.reshape(n_tok, K, D).sum(dim=1).reshape(B, T, D), aux_loss
