"""Deterministic synthetic datasets (the reference's
``repro.data.synthetic``).

Every sample is a pure function of its global example index, so a
pipeline shards across hosts without coordination: host h of H reads
indices ``i*H + h``. A sample's random draws come from a numpy generator
seeded by (stream, index) — stream 0 the LM tokens, 1 the latents, 2 the
conditioning stub. The reference draws from ``jax.random`` (threefry
keys folded with the index), whose bits cannot be reproduced here, so
each function is split into its draw and its deterministic part
(:func:`markov_mix`, :func:`gm_latents_from_draws`); the tests feed the
reference's draws into the deterministic parts.

Datasets:
  * LM token streams — uniform tokens with Markov structure (half the
    positions follow ``(prev·7 + 13) mod V``) so the LM loss is learnable.
  * Gaussian-mixture image latents — class-conditional 2-D cosine
    patterns plus noise, [H, W, C]; they train the DiTs so that SpeCa runs
    against a model with real structure.

Batches are CPU tensors (the host side of a data pipeline); the trainers
move them to their device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterator

import numpy as np
import torch


def _rng(stream: int, idx) -> np.random.Generator:
    return np.random.default_rng([stream, int(idx)])


@dataclasses.dataclass(frozen=True)
class LMStreamConfig:
    vocab_size: int
    seq_len: int
    num_codebooks: int = 0   # audio archs: tokens [K, T]


def markov_mix(base: torch.Tensor, mix: torch.Tensor,
               vocab_size: int) -> torch.Tensor:
    """The stream's deterministic part: ``where(mix, base, (roll(base, 1)
    ·7 + 13) % V)`` along the last axis."""
    rolled = torch.roll(base, 1, dims=-1)
    return torch.where(mix, base, (rolled * 7 + 13) % vocab_size)


def lm_draws(cfg: LMStreamConfig, idx) -> Dict[str, np.ndarray]:
    """One sample's draws: ``base`` uniform tokens and the Bernoulli(0.5)
    ``mix`` mask, of [T+1] (audio: [K, T+1])."""
    rng = _rng(0, idx)
    shape = ((cfg.num_codebooks, cfg.seq_len + 1) if cfg.num_codebooks
             else (cfg.seq_len + 1,))
    base = rng.integers(0, cfg.vocab_size, size=shape, dtype=np.int64)
    return {"base": base, "mix": rng.random(shape) < 0.5}


def lm_batch(cfg: LMStreamConfig, indices) -> Dict[str, torch.Tensor]:
    """Deterministic pseudo-Markov token batch for example indices [B]:
    int32 ``tokens`` and next-token ``labels``."""
    draws = [lm_draws(cfg, i) for i in np.asarray(indices).tolist()]
    base = torch.from_numpy(np.stack([d["base"] for d in draws]))
    mix = torch.from_numpy(np.stack([d["mix"] for d in draws]))
    toks = markov_mix(base, mix, cfg.vocab_size).to(torch.int32)
    return {"tokens": toks[..., :-1].contiguous(),
            "labels": toks[..., 1:].contiguous()}


@dataclasses.dataclass(frozen=True)
class GMLatentConfig:
    num_classes: int
    latent_size: int = 16
    channels: int = 4
    noise_scale: float = 0.15


def _class_pattern(cfg: GMLatentConfig, label) -> torch.Tensor:
    """Smooth class-dependent pattern [H, W, C] in f32: a mixture of 2-D
    cosine modes (the reference's f32 ops in its order)."""
    s = cfg.latent_size
    # numpy's f32 linspace rounds as jnp.linspace; torch.linspace does not
    lin = torch.from_numpy(np.linspace(np.float32(0), np.float32(1), s,
                                       dtype=np.float32))
    yy, xx = torch.meshgrid(lin, lin, indexing="ij")
    lab = torch.as_tensor(label).to(torch.float32)
    out = []
    for c in range(cfg.channels):
        fx = 1.0 + (lab % 4) + 0.5 * c
        fy = 1.0 + (torch.floor_divide(lab, 4) % 4) + 0.25 * c
        phase = 0.7 * lab + 1.3 * c
        out.append(torch.cos(2 * math.pi * (fx * xx + fy * yy) + phase))
    return torch.stack(out, dim=-1)


def gm_draws(cfg: GMLatentConfig, idx) -> Dict[str, np.ndarray]:
    """One sample's draws: its ``label`` and unit-normal ``noise`` [H, W,
    C] (f32)."""
    rng = _rng(1, idx)
    label = int(rng.integers(0, cfg.num_classes))
    noise = rng.standard_normal(
        (cfg.latent_size, cfg.latent_size, cfg.channels), dtype=np.float32)
    return {"label": label, "noise": noise}


def gm_latents_from_draws(cfg: GMLatentConfig, labels, noise
                          ) -> Dict[str, torch.Tensor]:
    """The latents' deterministic part: the class pattern of each label
    plus ``noise_scale`` times its unit-normal noise [B, H, W, C]."""
    labels = torch.as_tensor(labels).to(torch.int32)
    noise = torch.as_tensor(noise, dtype=torch.float32)
    base = torch.stack([_class_pattern(cfg, lab) for lab in labels])
    return {"latents": base + cfg.noise_scale * noise, "labels": labels}


def gm_latent_batch(cfg: GMLatentConfig, indices
                    ) -> Dict[str, torch.Tensor]:
    """Class-conditional f32 latents [B, H, W, C] and int32 labels [B] for
    example indices [B]."""
    draws = [gm_draws(cfg, i) for i in np.asarray(indices).tolist()]
    return gm_latents_from_draws(
        cfg, [d["label"] for d in draws],
        np.stack([d["noise"] for d in draws]))


def cond_stub_batch(batch: int, tokens: int, dim: int, indices
                    ) -> torch.Tensor:
    """Continuous conditioning stub (text-embedding surrogate)
    [B, tokens, dim], N(0, 0.1²) f32 per index."""
    idx = np.asarray(indices).tolist()
    assert len(idx) == batch, (len(idx), batch)
    return torch.from_numpy(np.stack([
        _rng(2, i).standard_normal((tokens, dim), dtype=np.float32)
        for i in idx])) * 0.1


class ShardedIterator:
    """Host-sharded, deterministic batch iterator: step s of host h reads
    the indices ``s·global_batch + h·local ..`` of one contiguous block."""

    def __init__(self, batch_fn: Callable, global_batch: int, *,
                 host_id: int = 0, num_hosts: int = 1, start_step: int = 0):
        if global_batch % num_hosts:
            raise ValueError(f"global_batch {global_batch} is not a "
                             f"multiple of num_hosts {num_hosts}")
        self._fn = batch_fn
        self._local = global_batch // num_hosts
        self._host = host_id
        self._step = start_step
        self._global = global_batch

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        base = self._step * self._global + self._host * self._local
        self._step += 1
        return self._fn(np.arange(base, base + self._local, dtype=np.int64))
