"""Parameter conversion from the JAX package's DiT and LM trees.

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

# the leaves the port reads of each family; anything else in the tree is
# ignored. A group (or a key of it) that a configuration leaves out —
# "head" under tied embeddings, the QKV biases, the label table, the
# continuous conditioning's projection ``cond_w``/``cond_b`` — is optional;
# the tree's groups say which family it is.
DIT_KEYS = {
    "embed": ("patch_w", "patch_b", "time", "label", "cond_w", "cond_b"),
    "blocks": ("wq", "wk", "wv", "wo", "mlp", "mod_w", "mod_b"),
    "head": ("w", "b", "mod_w", "mod_b"),
}
LM_KEYS = {
    "embed": ("tok", "codebooks"),
    "blocks": ("ln1", "ln2", "wq", "wk", "wv", "wo", "bq", "bk", "bv",
               "mlp", "moe", "ssm"),
    "final_norm": None,
    "head": ("w",),
}
LM_REQUIRED = ("embed", "blocks", "final_norm")


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
    """The port's parameters from a JAX parameter tree of numpy (or
    array-like) leaves, on ``device``: a DiT tree, or an LM's (one with a
    ``final_norm`` leaf; ``mlp`` keeps ``w_gate``/``w_up``/``w_down``, an
    MoE block's ``moe`` its ``router`` and the [E, …] expert weights, an
    SSD block's ``ssm`` its projections, conv, ``A_log``/``Dp``/
    ``dt_bias`` and norm; an audio model embeds through ``codebooks``
    [K, V, d] and has a [K, d, V] head; ``head`` is absent under tied
    embeddings)."""
    dev = resolve_device(device)
    lm = "final_norm" in tree
    groups = LM_KEYS if lm else DIT_KEYS
    required = LM_REQUIRED if lm else tuple(DIT_KEYS)
    out: Dict[str, Any] = {}
    for group, keys in groups.items():
        if group not in tree:
            if group in required:
                raise KeyError(f"parameter tree has no {group!r} group")
            continue
        if keys is None:
            out[group] = _leaf(tree[group], dev)
        else:
            out[group] = {k: _tree(tree[group][k], dev)
                          for k in keys if k in tree[group]}
    return out
