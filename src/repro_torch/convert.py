"""Parameter conversion from the JAX package's DiT and LM trees, and
from checkpoints in the repo's npz + manifest format.

``repro.layers.model.init_params`` (and a trained state's ``params``)
is a nested dict with stacked ``[L, …]`` block leaves and weights laid
out ``x @ W``; the port keeps exactly that layout, so conversion is a
leaf-by-leaf copy. Leaves arrive as numpy arrays (``np.asarray`` of the
JAX arrays); bf16 leaves carry ml_dtypes' ``bfloat16``, which numpy
cannot hand to torch directly, so they travel as their raw bits.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.checkpoint.io import load_leaf, read_checkpoint
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_set

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


def _tree(x: Any, leaf: Callable[[Any], torch.Tensor]) -> Any:
    if isinstance(x, dict):
        return {k: _tree(v, leaf) for k, v in x.items()}
    return leaf(x)


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
    return _select(tree, lambda x: _leaf(x, dev))


def _select(tree: Dict[str, Any],
            leaf: Callable[[Any], torch.Tensor]) -> Dict[str, Any]:
    """The family's groups and keys of ``tree`` (``DIT_KEYS`` or
    ``LM_KEYS``), each leaf through ``leaf``."""
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
            out[group] = leaf(tree[group])
        else:
            out[group] = {k: _tree(tree[group][k], leaf)
                          for k in keys if k in tree[group]}
    return out


def params_from_checkpoint(path: str, *,
                           device: DeviceLike = "cuda") -> Dict[str, Any]:
    """The port's parameters from a checkpoint in the repo's format
    (``arrays.npz`` + ``manifest.json``, written by either package's
    ``save_checkpoint``), built from the manifest with no ``like`` tree:
    each leaf in its manifest dtype on ``device``, through the same key
    filter as :func:`params_from_jax`. A checkpoint of a whole train
    state is read from its ``params`` group."""
    dev = resolve_device(device)
    manifest, data = read_checkpoint(path)
    tree: Dict[str, Any] = {}
    for key, meta in manifest["leaves"].items():
        tree_set(tree, key, (key, meta["dtype"]))
    if "params" in tree and "blocks" not in tree:
        tree = tree["params"]
    return _select(tree, lambda kd: load_leaf(data[kd[0]], kd[1], dev))
