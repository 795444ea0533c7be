"""Workload adapters for the lane step.

The forecast-then-verify loop in ``repro_torch.core.lane_step`` works on
an opaque dynamic payload plus a verify-layer feature pair; what a model
output is, how the payload advances on it and how a lane is filled and
harvested lives behind the ``Workload`` adapter. Two adapters ship:

``DiffusionWorkload``
    payload = the latent ``x`` [W, (F,) H, W, C] (lane axis 0; five axes
    for video), advance = the DDIM (or rectified-flow) update at each
    lane's own step.

``DecodeWorkload``
    self-speculative LLM decode: the difference table extrapolates each
    lane's residual increments across decode steps (feature layout
    (L, 2, W, 1, D), one token a step), a drafted step runs the masked
    verify-layer forward, and an accepted step emits its token from the
    forecast stream's logits. The payload is the current input token
    ``tok``, the emitted tokens ``tokens`` (lane axis 0) and the cache
    leaves (lane axis 1): K/V ``k``/``v`` [L, W, S, KV, hd] where the
    model has attention, ``ssm_state`` f32 [L, W, h, p, n] and
    ``conv_state`` [L, W, conv, C] where it has an SSD mixer; a
    speculative step still writes every layer's cache from the forecast
    stream. τ_t ≡ τ0 (``t_frac`` ≡ 1); no guided pairs.

Rollback (both): the exact-copy restore of a draft-K chain's snapshots
through the rollback kernel, which copies bytes and so takes every leaf,
int32 tokens included.

Lane sharding (``repro_torch.launch.mesh``): a shard runs the step hooks
of the workload replica on its own device (:meth:`Workload.on`, one per
distinct device, parameters copied once), and the host hooks
(``init_payload``, ``fill_payload``, ``emit``) of the owning shard's
replica on that shard's block of the state, so a fill writes only the
owning shard's slices.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import (DiffusionConfig, ModelConfig, SpeCaConfig,
                                 check_lm)
from repro_torch.core import taylor
from repro_torch.core.complexity import (decode_forward_flops,
                                         decode_verify_flops, forward_flops,
                                         verify_flops)
from repro_torch.core.lane_step import num_tokens, table_dtype, verify_layer
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.diffusion.pipeline import (latent_shape, make_stepper,
                                            model_inputs)
from repro_torch.launch.mesh import canonical_device
from repro_torch.layers import blocks as blk
from repro_torch.layers import model as M
from repro_torch.tree import tree_map

NoiseFn = Callable[[int], torch.Tensor]


def _axis_where(mask: torch.Tensor, axis: int, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Per-lane select with the lane mask broadcast at ``axis``."""
    shape = [1] * a.dim()
    shape[axis] = mask.shape[0]
    return torch.where(mask.reshape(shape), a, b)


class HostCopies:
    """The copies between the host and a lane state that a lane fill
    makes: ``put`` writes ``dst[lane] = value`` for each pair, ``to``
    moves a tensor to a device, ``item`` reads a one-element tensor back
    as a Python number. These just make them; the serving engine passes
    one that also counts each copy that blocks the host."""

    def put(self, lane: int, writes: List[Tuple[torch.Tensor, Any]]
            ) -> None:
        for dst, value in writes:
            dst[lane] = value

    def to(self, x: torch.Tensor, device: DeviceLike) -> torch.Tensor:
        return x.to(device)

    def item(self, x: torch.Tensor) -> Any:
        return x.item()


HOST_COPIES = HostCopies()


class Workload:
    """Adapter interface consumed by ``lane_step.build_workload_step``.

    Static attributes: ``tag``, ``cfg``/``scfg``, ``num_steps``,
    ``num_tokens``, ``verify_layer``, ``table_dtype``, ``device``,
    ``dyn_keys`` / ``dyn_axes`` (payload keys and their lane axes),
    ``full_flops`` / ``verify_flops``, ``supports_pairing`` (guided
    cond/uncond lane pairs), ``cond_in_state`` (per-lane conditioning
    rides in the lane state), ``fill_syncs`` (host syncs a lane fill
    costs). Step hooks: ``t_frac``,
    ``step_context``, ``spec_forward``, ``full_forward``, ``zero_out``,
    ``select_out``, ``advance``, ``rollback``. Host hooks:
    ``validate_request``, ``init_payload``, ``fill_payload``, ``emit``.
    ``fill_payload`` makes every copy between the host and the state
    through its ``copies`` (:class:`HostCopies`).
    """

    tag: str = "?"
    dyn_axes: Dict[str, int] = {}
    supports_pairing: bool = False
    cond_in_state: bool = True
    fill_syncs: int = 0

    def on(self, device: DeviceLike) -> "Workload":
        """This workload on ``device``: itself where it lives there, else
        its replica there, made once (the parameters copied) and kept."""
        dev = canonical_device(device)
        if dev == canonical_device(self.device):
            return self
        replicas = self.__dict__.setdefault("_replicas", {})
        if dev not in replicas:
            replicas[dev] = self._replica(dev)
        return replicas[dev]

    def _replica(self, device: torch.device) -> "Workload":
        raise NotImplementedError(f"workload {self.tag!r} has no replica "
                                  "on another device")

    def rollback(self, chain: Dict[str, Any], n_acc: torch.Tensor, *,
                 mesh: Optional[Any] = None) -> Dict[str, torch.Tensor]:
        """Restore every payload leaf to snapshot ``n_acc[lane]`` through
        the rollback kernel, which copies bytes and so takes any dtype.
        A leaf's snapshots come as one [K+1, ...] tensor or as a sequence
        of K+1 tensors, which the kernel reads where they lie. With
        ``mesh``, ``chain`` and ``n_acc`` are per shard (each shard's
        leaves through ``ops.lane_rollback_sharded``) and so is the
        result."""
        if mesh is not None:
            leaves = {k: taylor.lane_rollback([c[k] for c in chain], n_acc,
                                              lane_axis=self.dyn_axes[k],
                                              mesh=mesh)
                      for k in chain[0]}
            return [{k: v[i] for k, v in leaves.items()}
                    for i in range(len(chain))]
        return {k: taylor.lane_rollback(v, n_acc, lane_axis=self.dyn_axes[k])
                for k, v in chain.items()}

    def select_dyn(self, mask, new, cur):
        return {k: _axis_where(mask, self.dyn_axes[k], new[k], v)
                for k, v in cur.items()}

    def validate_request(self, request, steps: int) -> None:
        """Reject (``ValueError``) a request whose payload this workload
        cannot serve. The engine calls it before any side effect of
        admission (session start, ticket, queue push). Default: accept
        everything."""


class DiffusionWorkload(Workload):
    """SpeCa diffusion lanes. ``noise_fn(seed) -> [1, (F,) H, W, C]`` (the
    latent shape of ``latent_shape(cfg, dcfg, 1)``) overrides
    the per-request initial noise (tests hand in the reference's); by
    default it is drawn from a CPU ``torch.Generator`` seeded with the
    request's seed, so a request's noise does not depend on the device."""

    tag = "diffusion"
    supports_pairing = True

    def __init__(self, cfg: ModelConfig, params, dcfg: DiffusionConfig,
                 scfg: SpeCaConfig, *, device: DeviceLike = "cuda",
                 noise_fn: Optional[NoiseFn] = None) -> None:
        self.device = resolve_device(device)
        self.cfg, self.params = cfg, params
        self.dcfg, self.scfg = dcfg, scfg
        self.stepper = make_stepper(dcfg, self.device)
        self.num_steps = self.stepper.num_steps
        self.num_tokens = num_tokens(cfg, dcfg)
        self.verify_layer = verify_layer(cfg, scfg)
        self.table_dtype = table_dtype(cfg, scfg)
        self.noise_fn = noise_fn
        self.dyn_keys: Tuple[str, ...] = ("x",)
        self.dyn_axes = {"x": 0}
        self.full_flops = forward_flops(cfg, self.num_tokens)
        self.verify_flops = verify_flops(cfg, self.num_tokens)
        # static per-layer mask of the speculative forward
        self._cmask = [layer == self.verify_layer
                       for layer in range(cfg.num_layers)]

    def _replica(self, device):
        params = tree_map(lambda t: t.to(device), self.params) \
            if self.params is not None else None
        return DiffusionWorkload(self.cfg, params, self.dcfg, self.scfg,
                                 device=device, noise_fn=self.noise_fn)

    # --- step hooks --------------------------------------------------------
    def t_frac(self, s_eff):
        return self.stepper.t_frac[s_eff]

    def step_context(self, state, s_eff):
        return self.stepper.t_model[s_eff]

    def spec_forward(self, dyn, cond, ctx, preds):
        inputs = model_inputs(self.cfg, dyn["x"], ctx, cond)
        out, extras = M.dit_forward(self.cfg, self.params, inputs,
                                    branch_preds=preds,
                                    compute_mask=self._cmask,
                                    collect_branches=True)
        vl = self.verify_layer
        real_vl = extras["branches"][vl][0] + extras["branches"][vl][1]
        return out.to(torch.float32), real_vl

    def full_forward(self, dyn, cond, ctx):
        inputs = model_inputs(self.cfg, dyn["x"], ctx, cond)
        out, extras = M.dit_forward(self.cfg, self.params, inputs,
                                    collect_branches=True)
        return out.to(torch.float32), extras["branches"]

    def zero_out(self, lanes: int) -> torch.Tensor:
        return torch.zeros(latent_shape(self.cfg, self.dcfg, lanes),
                           dtype=torch.float32, device=self.device)

    def select_out(self, mask, a, b):
        return _axis_where(mask, 0, a, b)

    def advance(self, dyn, out, ctx, s_eff):
        return {"x": self.stepper.advance(dyn["x"], out, s_eff)}

    # --- host hooks --------------------------------------------------------
    def noise(self, seed: int) -> torch.Tensor:
        """The request's initial latent [1, (F,) H, W, C] f32 on the
        device."""
        return self._draw(seed).to(device=self.device)

    def _draw(self, seed: int) -> torch.Tensor:
        """The request's initial latent, f32, where it was drawn: on the
        host by default, wherever ``noise_fn`` put it otherwise."""
        shape = latent_shape(self.cfg, self.dcfg, 1)
        if self.noise_fn is not None:
            x = self.noise_fn(seed)
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.array(x, dtype=np.float32))
        else:
            gen = torch.Generator(device="cpu").manual_seed(int(seed))
            x = torch.randn(shape, generator=gen, dtype=torch.float32)
        if tuple(x.shape) != shape:
            raise ValueError(f"noise for seed {seed} has shape "
                             f"{tuple(x.shape)}, expected {shape}")
        return x.to(dtype=torch.float32)

    def init_payload(self, lanes: int, *,
                     x: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        if x is None:
            x = self.zero_out(lanes)
        return {"x": x.to(device=self.device, dtype=torch.float32)}

    def fill_payload(self, state, lane: int, request, steps: int,
                     copies: Optional[HostCopies] = None):
        (copies or HOST_COPIES).put(
            lane, [(state["x"], self._draw(request.seed)[0])])
        return state

    def emit(self, state, lane: int, done: int) -> torch.Tensor:
        # a copy: the lane's slice is overwritten in place when it refills
        return state["x"][lane:lane + 1].to("cpu", copy=True)


class DecodeWorkload(Workload):
    """Self-speculative LLM decode lanes (no drafter model) of a dense,
    VLM (text), MoE, SSM or hybrid LM. Multi-codebook audio and
    ring-buffer caches are rejected, as the reference rejects them.

    ``max_new_tokens`` is the lane schedule length (a request's
    ``RequestPolicy.max_steps`` serves a prefix); ``max_seq_len`` sizes
    each lane's K/V cache, and a prompt of P tokens needs P + steps ≤
    ``max_seq_len``. A request carries its prompt as ``cond["tokens"]``
    ([P] or [1, P] integers). Filling a lane runs one prefill forward and
    reads its argmax back: one host sync per admission."""

    tag = "decode"
    supports_pairing = False
    cond_in_state = False
    fill_syncs = 1

    def __init__(self, cfg: ModelConfig, params, scfg: SpeCaConfig, *,
                 max_new_tokens: int, max_seq_len: int,
                 device: DeviceLike = "cuda") -> None:
        if cfg.is_diffusion:
            raise ValueError("DecodeWorkload serves autoregressive LMs; "
                             f"arch_type={cfg.arch_type!r} is a diffusion "
                             "backbone (use DiffusionWorkload)")
        check_lm(cfg, "DecodeWorkload")
        if cfg.arch_type == "audio":
            raise ValueError("DecodeWorkload does not serve multi-codebook "
                             "audio decode yet (tokens are [B, K, 1])")
        if blk.uses_ring_cache(cfg):
            raise ValueError(
                "DecodeWorkload uses absolute-position lane caches; "
                "ring-buffer decode caches (attn_window>0, global_every=0) "
                "are not supported — serve this config through "
                "lm_decode_step")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        self.device = resolve_device(device)
        self.cfg, self.params, self.scfg = cfg, params, scfg
        self.num_steps = int(max_new_tokens)
        self.num_tokens = 1
        self.max_seq_len = int(max_seq_len)
        self.verify_layer = verify_layer(cfg, scfg)
        self.table_dtype = table_dtype(cfg, scfg)
        self._cache_keys: Tuple[str, ...] = M.cache_keys(cfg)
        self.dyn_keys = ("tok", "tokens") + self._cache_keys
        self.dyn_axes = {"tok": 0, "tokens": 0,
                         **{k: 1 for k in self._cache_keys}}
        self.full_flops = decode_forward_flops(cfg, self.max_seq_len)
        self.verify_flops = decode_verify_flops(cfg, self.max_seq_len)
        self._cmask = [layer == self.verify_layer
                       for layer in range(cfg.num_layers)]

    def _replica(self, device):
        return DecodeWorkload(self.cfg,
                              tree_map(lambda t: t.to(device), self.params),
                              self.scfg, max_new_tokens=self.num_steps,
                              max_seq_len=self.max_seq_len, device=device)

    # --- step hooks --------------------------------------------------------
    def t_frac(self, s_eff):
        # no noise-level schedule: τ_t ≡ τ0 (t_frac = 1 ⇒ β exponent 0)
        return torch.ones(s_eff.shape, dtype=torch.float32,
                          device=s_eff.device)

    def step_context(self, state, s_eff):
        # each lane's absolute query position this step
        return state["pos0"] + s_eff

    def _forward(self, dyn, ctx, preds):
        cache = {k: dyn[k] for k in self._cache_keys}
        return M.decode_branches_step(
            self.cfg, self.params, dyn["tok"], cache, ctx,
            branch_preds=preds,
            compute_mask=None if preds is None else self._cmask,
            collect_branches=True)

    def spec_forward(self, dyn, cond, ctx, preds):
        logits, new_cache, branches = self._forward(dyn, ctx, preds)
        vl = self.verify_layer
        real_vl = branches[vl][0] + branches[vl][1]
        return {"logits": logits, **new_cache}, real_vl

    def full_forward(self, dyn, cond, ctx):
        logits, new_cache, branches = self._forward(dyn, ctx, None)
        return {"logits": logits, **new_cache}, branches

    def zero_out(self, lanes: int) -> Dict[str, torch.Tensor]:
        out = {"logits": torch.zeros((lanes, 1, self.cfg.padded_vocab),
                                     dtype=self.cfg.torch_dtype,
                                     device=self.device)}
        out.update(M.init_cache(self.cfg, lanes, self.max_seq_len,
                                self.device))
        return out

    def select_out(self, mask, a, b):
        return {k: _axis_where(mask, 0 if k == "logits" else 1, a[k], b[k])
                for k in a}

    def advance(self, dyn, out, ctx, s_eff):
        W = s_eff.shape[0]
        tok = torch.argmax(out["logits"][:, 0, :], dim=-1).to(torch.int32)
        tokens = dyn["tokens"].clone()
        tokens[torch.arange(W, device=tokens.device), s_eff.long()] = tok
        new = {"tok": tok[:, None], "tokens": tokens}
        for k in self._cache_keys:
            new[k] = out[k]
        return new

    # --- host hooks --------------------------------------------------------
    def init_payload(self, lanes: int, *, x=None) -> Dict[str, Any]:
        if x is not None:
            raise ValueError("DecodeWorkload lanes start from a prompt "
                             "prefill, not a latent")
        i32, dev = torch.int32, self.device
        payload = {"tok": torch.zeros((lanes, 1), dtype=i32, device=dev),
                   "tokens": torch.zeros((lanes, self.num_steps), dtype=i32,
                                         device=dev),
                   "pos0": torch.zeros((lanes,), dtype=i32, device=dev)}
        payload.update(M.init_cache(self.cfg, lanes, self.max_seq_len, dev))
        return payload

    def _prompt_of(self, request, steps: int,
                   copies: Optional[HostCopies] = None) -> np.ndarray:
        """The request's [1, P] int32 prompt, or ``ValueError`` when it is
        malformed or too long for the lane cache (shared by
        ``validate_request`` and ``fill_payload``)."""
        try:
            raw = request.cond["tokens"]
            if isinstance(raw, torch.Tensor):
                raw = (copies or HOST_COPIES).to(raw.detach(),
                                                 "cpu").numpy()
            prompt = np.array(raw, np.int32)
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError("decode request needs an integer "
                             f"cond['tokens'] prompt: {e}") from None
        if prompt.ndim == 1:
            prompt = prompt[None]
        if prompt.ndim != 2 or prompt.shape[0] != 1 or prompt.shape[1] < 1:
            raise ValueError("decode request cond['tokens'] must be a "
                             f"[1, P] prompt, got shape {prompt.shape}")
        P = prompt.shape[1]
        if P + steps > self.max_seq_len:
            raise ValueError(
                f"prompt length {P} + {steps} new tokens exceeds the "
                f"workload's max_seq_len={self.max_seq_len}")
        return prompt

    def validate_request(self, request, steps: int) -> None:
        self._prompt_of(request, steps)

    def _prefill(self, prompt: torch.Tensor):
        """(last-position logits [1, V], the prefill's cache leaves with
        batch 1) of one prompt [1, P] on the device."""
        logits, extras = M.lm_forward(self.cfg, self.params,
                                      {"tokens": prompt}, collect_cache=True)
        return logits[:, -1], extras["cache"]

    def fill_payload(self, state, lane: int, request, steps: int,
                     copies: Optional[HostCopies] = None):
        """Prefill the request's prompt into the lane: clear its K/V
        slices and scatter the prefix, take the SSD state leaves whole,
        set its first input token (the prefill's argmax: one host sync),
        emitted tokens and ``pos0``. Writes the lane's slice of the newest
        state in place, as the diffusion fill does."""
        copies = copies or HOST_COPIES
        prompt = copies.to(torch.from_numpy(
            self._prompt_of(request, steps, copies)), self.device)
        P = prompt.shape[1]
        logits, cache = self._prefill(prompt)
        tok0 = copies.item(torch.argmax(logits[0]))
        for key in self._cache_keys:
            if key in ("k", "v"):
                state[key][:, lane] = 0
                state[key][:, lane, :P] = cache[key][:, 0]
            else:
                state[key][:, lane] = cache[key][:, 0]
        copies.put(lane, [(state["tok"][:, 0], tok0), (state["tokens"], 0),
                          (state["pos0"], P)])
        return state

    def emit(self, state, lane: int, done: int) -> torch.Tensor:
        """The lane's emitted tokens so far, an int32 CPU copy."""
        n = max(min(done, self.num_steps), 0)
        return state["tokens"][lane, :n].to("cpu", copy=True)


def make_diffusion_workload(cfg: ModelConfig, params, dcfg: DiffusionConfig,
                            scfg: SpeCaConfig, *, use_flash: bool = False,
                            device: DeviceLike = "cuda"
                            ) -> DiffusionWorkload:
    """The reference's factory name for a :class:`DiffusionWorkload`;
    ``use_flash`` is accepted for its signature (DiT attention never
    reaches the flash kernel)."""
    del use_flash
    return DiffusionWorkload(cfg, params, dcfg, scfg, device=device)
