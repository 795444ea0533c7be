"""Step construction for the dry run (the reference's
``repro.launch.steps``): stand-ins for every model input, and the train,
prefill and decode steps with their arguments laid out on a mesh.

Nothing here allocates. :func:`params_shapes`, :func:`train_state_shapes`
and :func:`input_specs` return :class:`TensorSpec` trees (the reference's
``jax.ShapeDtypeStruct``), read off the port's own ``init_params``,
``init_opt_state`` and ``init_cache`` run on fake tensors.
:func:`build_step` runs inside a ``FakeTensorMode`` and a process group of
the mesh's size (``launch.mesh.fake_world``): each argument is a DTensor
whose placements come from ``sharding.specs`` and whose local shard is a
fake tensor of one rank's shape, built directly with
``DTensor.from_local``, so no global tensor is ever materialised. The
step functions are the port's own ``training.lm.train_step``,
``prefill_step`` and ``serve_step``.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs import ModelConfig, ShapeConfig
from repro_torch.layers import model as M
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.sharding import specs as S
from repro_torch.training import lm as T


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor that is never allocated."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def _specs(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    return TensorSpec(tuple(tree.shape), tree.dtype)


def _on_fake(fn: Callable[[], Any]) -> Any:
    """``fn()``'s tensor tree as :class:`TensorSpec`s, run on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return _specs(fn())


def params_shapes(cfg: ModelConfig) -> Any:
    return _on_fake(lambda: M.init_params(cfg, torch.Generator(),
                                          device="cpu"))


def train_state_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    def state():
        params = M.init_params(cfg, torch.Generator(), device="cpu")
        return {"params": params, "opt": init_opt_state(params),
                "step": torch.zeros((), dtype=torch.int32)}
    return _on_fake(state)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Model-input stand-ins for one workload shape."""
    B, L = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        if cfg.arch_type == "audio":
            batch = {"tokens": TensorSpec((B, cfg.num_codebooks, L), i32)}
            if shape.kind == "train":
                batch["labels"] = TensorSpec((B, cfg.num_codebooks, L), i32)
        elif cfg.arch_type == "vlm" and cfg.frontend_tokens:
            n_img = min(cfg.frontend_tokens, L // 2)
            batch = {
                "patch_embeds": TensorSpec((B, n_img, cfg.d_model),
                                           cfg.torch_dtype),
                "tokens": TensorSpec((B, L - n_img), i32),
            }
            if shape.kind == "train":
                batch["labels"] = TensorSpec((B, L - n_img), i32)
        else:
            batch = {"tokens": TensorSpec((B, L), i32)}
            if shape.kind == "train":
                batch["labels"] = TensorSpec((B, L), i32)
        return batch
    # decode: ONE new token against a seq_len cache
    cache = _on_fake(lambda: M.init_cache(cfg, B, L, device="cpu"))
    if cfg.arch_type == "audio":
        tokens = TensorSpec((B, cfg.num_codebooks, 1), i32)
    else:
        tokens = TensorSpec((B, 1), i32)
    return {"tokens": tokens, "cache": cache, "pos": TensorSpec((), i32)}


def decode_position(shape: ShapeConfig) -> int:
    """The decode step's position: the last slot of the cache. The port's
    ``serve_step`` takes a Python int where the reference traces an int32
    scalar; the step's work does not depend on its value."""
    return shape.seq_len - 1


# ---------------------------------------------------------------------------
# Arguments on the mesh
# ---------------------------------------------------------------------------

def shard_like(spec: TensorSpec, sharding: S.NamedSharding):
    """A DTensor of ``spec``'s global shape laid out by ``sharding``, its
    local shard an uninitialised tensor of one rank's shape (a fake tensor
    under ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor

    local = torch.empty(sharding.shard_shape(spec.shape), dtype=spec.dtype)
    stride = torch.empty(spec.shape, dtype=spec.dtype, device="meta").stride()
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=torch.Size(spec.shape),
                              stride=stride)


def shard_tree(specs: Any, shardings: Any) -> Any:
    if isinstance(specs, dict):
        return {k: shard_tree(v, shardings[k]) for k, v in specs.items()}
    return shard_like(specs, shardings)


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh
               ) -> Tuple[Callable, tuple, tuple, Any]:
    """(fn, args, in_shardings, out_shardings) for one workload shape:
    ``fn(*args)`` runs the step; ``args`` are DTensors laid out by
    ``in_shardings``; ``out_shardings`` (None: left as the step leaves
    it) is where the dry run puts the outputs, as the reference's
    ``jit(out_shardings=)``."""
    B = shape.global_batch
    repl = S.replicated(mesh)

    if shape.kind == "train":
        opt = AdamWConfig()
        state_sh = S.train_state_shardings(cfg, mesh, params_shapes(cfg))
        batch = input_specs(cfg, shape)
        batch_sh = {k: S.batch_sharding(mesh, B, len(v.shape))
                    for k, v in batch.items()}
        fn = functools.partial(T.train_step, cfg, opt)
        args = (shard_tree(train_state_shapes(cfg), state_sh),
                shard_tree(batch, batch_sh))
        return fn, args, (state_sh, batch_sh), (state_sh, None)

    params = params_shapes(cfg)
    params_sh = S.params_shardings(cfg, mesh, params)
    if shape.kind == "prefill":
        batch = input_specs(cfg, shape)
        batch_sh = {k: S.batch_sharding(mesh, B, len(v.shape))
                    for k, v in batch.items()}
        cache_shapes = _on_fake(lambda: M.init_cache(cfg, B, shape.seq_len,
                                                     device="cpu"))
        # the prefill's cache is laid out as the decode-side cache
        cache_sh = S.cache_shardings(cfg, mesh, B, cache_shapes)
        fn = functools.partial(T.prefill_step, cfg)
        args = (shard_tree(params, params_sh), shard_tree(batch, batch_sh))
        return fn, args, (params_sh, batch_sh), \
            (S.batch_sharding(mesh, B, 3), cache_sh)

    spec = input_specs(cfg, shape)
    cache_sh = S.cache_shardings(cfg, mesh, B, spec["cache"])
    tok_sh = S.batch_sharding(mesh, B, len(spec["tokens"].shape))
    fn = functools.partial(T.serve_step, cfg)
    args = (shard_tree(params, params_sh), shard_like(spec["tokens"], tok_sh),
            shard_tree(spec["cache"], cache_sh), decode_position(shape))
    logits_ndim = 4 if cfg.arch_type == "audio" else 3
    return fn, args, (params_sh, tok_sh, cache_sh, repl), \
        (S.batch_sharding(mesh, B, logits_ndim), cache_sh)
