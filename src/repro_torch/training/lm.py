"""LM training (the reference's ``repro.training.lm``): the
cross-entropy loss with its family cases, the AdamW train step, and the
prefill and decode steps a server runs."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.layers import model as M
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.sharding import specs
from repro_torch.training.autodiff import value_and_grad


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean cross-entropy in f32: logits [..., V], int labels [...]."""
    logits = logits.to(torch.float32)
    if specs.is_dtensor(logits):
        return torch.mean(specs.logsumexp_last(logits)
                          - specs.take_last(logits, labels))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    return torch.mean(logz - gold)


def lm_loss(cfg: ModelConfig, params, batch: Dict[str, Any],
            remat: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(ce + ``moe_aux_loss_weight``·aux, {"ce", "aux"}): an audio model's
    labels [B, K, T] are swapped to its logits' [B, T, K]; a VLM's patch
    prefix carries no labels and is dropped from the logits."""
    logits, extras = M.lm_forward(cfg, params, batch, remat=remat)
    labels = batch["labels"]
    if cfg.arch_type == "audio":
        labels = torch.swapaxes(labels, 1, 2)
    if "patch_embeds" in batch:
        logits = logits[:, batch["patch_embeds"].shape[1]:]
    loss = cross_entropy(logits, labels)
    total = loss + cfg.moe_aux_loss_weight * extras["aux_loss"]
    return total, {"ce": loss, "aux": extras["aux_loss"]}


def make_train_state(cfg: ModelConfig, generator: torch.Generator,
                     opt: AdamWConfig, *, device: DeviceLike = "cuda"
                     ) -> Dict[str, Any]:
    """{"params" (``init_params`` on ``generator``, moved to ``device``),
    "opt", "step"}."""
    dev = resolve_device(device)
    params = M.init_params(cfg, generator, device=dev)
    return {"params": params, "opt": init_opt_state(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def train_step(cfg: ModelConfig, opt: AdamWConfig, state, batch,
               lr_scale=1.0, remat: bool = True):
    """One optimizer step -> (new state, metrics {"ce", "aux", "loss",
    "grad_norm"})."""
    (loss, metrics), grads = value_and_grad(
        lambda p: lm_loss(cfg, p, batch, remat=remat), state["params"])
    params, opt_state, opt_metrics = adamw_update(
        opt, state["params"], grads, state["opt"], lr_scale)
    new_state = {"params": params, "opt": opt_state,
                 "step": state["step"] + 1}
    return new_state, dict(metrics, loss=loss, **opt_metrics)


@torch.no_grad()
def prefill_step(cfg: ModelConfig, params, batch: Dict[str, Any]):
    """Prefill: the forward with its KV/SSM cache -> (last-position
    logits, cache)."""
    logits, extras = M.lm_forward(cfg, params, batch, collect_cache=True)
    return logits[:, -1:], extras["cache"]


@torch.no_grad()
def serve_step(cfg: ModelConfig, params, tokens, cache, pos: int):
    """Decode: ONE new token against the cache at ``pos``."""
    return M.lm_decode_step(cfg, params, tokens, cache, pos)
