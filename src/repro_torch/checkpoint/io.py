"""Tree checkpointing in the reference's on-disk format
(``repro.checkpoint.io``): ``arrays.npz`` holds one array a leaf under
its "/"-joined dict path, in sorted key order as ``jax.tree_util``
spells it; ``manifest.json`` records the step, an ``extra`` dict and
each leaf's shape and dtype. bf16 leaves are stored upcast to f32
(lossless) and restored to the manifest's dtype, so either package reads
the other's checkpoints.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_flatten_with_paths, tree_unflatten_like

def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)           # lossless
    return t.numpy()


def save_checkpoint(path: str, tree: Any, step: int = 0,
                    extra: Optional[Dict] = None) -> None:
    """Write ``tree`` (a nested dict of tensors) to the directory
    ``path``."""
    os.makedirs(path, exist_ok=True)
    arrays, dtypes = {}, {}
    for key, leaf in tree_flatten_with_paths(tree):
        dtypes[key] = str(leaf.dtype).replace("torch.", "")
        arrays[key] = _to_numpy(leaf)
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "extra": extra or {},
        "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                   for k, v in arrays.items()},
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def load_leaf(arr: np.ndarray, dtype: str,
              device: torch.device) -> torch.Tensor:
    """A stored array as a tensor of the manifest's ``dtype`` (a numpy
    dtype name, or "bfloat16" for an f32-stored bf16 leaf)."""
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr, np.dtype(dtype))).to(
        device)


def read_checkpoint(path: str):
    """(manifest, the npz archive) of the checkpoint at ``path``."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    return manifest, np.load(os.path.join(path, "arrays.npz"))


def restore_checkpoint(path: str, like: Any, *,
                       device: DeviceLike = "cuda") -> Any:
    """Restore into the structure of ``like`` (its values replaced), on
    ``device``. A leaf of ``like`` the checkpoint lacks raises
    ``KeyError``; a shape that differs raises ``ValueError``."""
    dev = resolve_device(device)
    manifest, data = read_checkpoint(path)
    leaves = []
    for key, ref in tree_flatten_with_paths(like):
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = data[key]
        if list(arr.shape) != list(np.shape(ref)):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} "
                             f"vs model {tuple(np.shape(ref))}")
        leaves.append(load_leaf(arr, manifest["leaves"][key]["dtype"], dev))
    return tree_unflatten_like(like, leaves)


def checkpoint_step(path: str) -> int:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)["step"]
