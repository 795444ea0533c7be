"""``jax.value_and_grad(..., has_aux=True)`` over a nested-dict tree."""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_unflatten_like


def value_and_grad(fn: Callable[[Any], Tuple[torch.Tensor, Any]],
                   params: Any) -> Tuple[Tuple[torch.Tensor, Any], Any]:
    """((loss, aux), grads): ``fn(params) -> (scalar loss, aux)`` runs on
    detached aliases of the leaves that require grad, and
    ``torch.autograd.grad`` returns one gradient a leaf, shaped as
    ``params`` (a leaf the loss does not reach gets zeros)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, aux = fn(tree_unflatten_like(params, leaves))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    aux = _detach(aux)
    return (loss.detach(), aux), tree_unflatten_like(params, list(grads))


def _detach(x):
    if isinstance(x, dict):
        return {k: _detach(v) for k, v in x.items()}
    return x.detach() if isinstance(x, torch.Tensor) else x
