"""Parameter conversion from the JAX package's DiT tree.

``repro.layers.model.init_params`` (and a trained state's ``params``)
is a nested dict with stacked ``[L, …]`` block leaves and weights laid
out ``x @ W``; the port keeps exactly that layout, so conversion is a
leaf-by-leaf copy. Leaves arrive as numpy arrays (``np.asarray`` of the
JAX arrays); bf16 leaves carry ml_dtypes' ``bfloat16``, which numpy
cannot hand to torch directly, so they travel as their raw bits.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

# the DiT leaves the port reads; anything else in the tree is ignored
DIT_KEYS = {
    "embed": ("patch_w", "patch_b", "time", "label"),
    "blocks": ("wq", "wk", "wv", "wo", "mlp", "mod_w", "mod_b"),
    "head": ("w", "b", "mod_w", "mod_b"),
}


def _leaf(x: Any, device: torch.device) -> torch.Tensor:
    a = np.array(x)          # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(a.view(np.uint16).astype(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree(x: Any, device: torch.device) -> Any:
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    return _leaf(x, device)


def params_from_jax(tree: Dict[str, Any], *,
                    device: DeviceLike = "cuda") -> Dict[str, Any]:
    """The port's DiT parameters from a JAX parameter tree of numpy (or
    array-like) leaves, on ``device``."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {}
    for group, keys in DIT_KEYS.items():
        if group not in tree:
            raise KeyError(f"parameter tree has no {group!r} group")
        out[group] = {k: _tree(tree[group][k], dev)
                      for k in keys if k in tree[group]}
    return out
