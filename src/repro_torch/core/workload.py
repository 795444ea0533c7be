"""Workload adapters for the lane step.

The forecast-then-verify loop in ``repro_torch.core.lane_step`` works on
an opaque dynamic payload plus a verify-layer feature pair; what a model
output is, how the payload advances on it and how a lane is filled and
harvested lives behind the ``Workload`` adapter. The port ships the
diffusion adapter: payload = the latent ``x`` (lane axis 0), advance =
the DDIM (or rectified-flow) update at each lane's own step; rollback =
the exact-copy restore of a draft-K chain's snapshots.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import DiffusionConfig, ModelConfig, SpeCaConfig
from repro_torch.core import taylor
from repro_torch.core.complexity import forward_flops, verify_flops
from repro_torch.core.lane_step import num_tokens, table_dtype, verify_layer
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.diffusion.pipeline import (latent_shape, make_stepper,
                                            model_inputs)
from repro_torch.layers import model as M

NoiseFn = Callable[[int], torch.Tensor]


def _axis_where(mask: torch.Tensor, axis: int, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Per-lane select with the lane mask broadcast at ``axis``."""
    shape = [1] * a.dim()
    shape[axis] = mask.shape[0]
    return torch.where(mask.reshape(shape), a, b)


class Workload:
    """Adapter interface consumed by ``lane_step.build_workload_step``.

    Static attributes: ``tag``, ``cfg``/``scfg``, ``num_steps``,
    ``num_tokens``, ``verify_layer``, ``table_dtype``, ``device``,
    ``dyn_keys`` / ``dyn_axes`` (payload keys and their lane axes),
    ``full_flops`` / ``verify_flops``, ``supports_pairing`` (guided
    cond/uncond lane pairs). Step hooks: ``t_frac``,
    ``step_context``, ``spec_forward``, ``full_forward``, ``zero_out``,
    ``select_out``, ``advance``, ``rollback``. Host hooks:
    ``validate_request``, ``init_payload``, ``fill_payload``, ``emit``.
    """

    tag: str = "?"
    dyn_axes: Dict[str, int] = {}
    supports_pairing: bool = False

    def rollback(self, chain: Dict[str, Any], n_acc: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
        """Restore every payload leaf to snapshot ``n_acc[lane]`` through
        the rollback kernel, which copies bytes and so takes any dtype.
        A leaf's snapshots come as one [K+1, ...] tensor or as a sequence
        of K+1 tensors, which the kernel reads where they lie."""
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
    """SpeCa diffusion lanes. ``noise_fn(seed) -> [1, H, W, C]`` overrides
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
        """The request's initial latent [1, H, W, C] f32 on the device."""
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
        return x.to(device=self.device, dtype=torch.float32)

    def init_payload(self, lanes: int, *,
                     x: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        if x is None:
            x = self.zero_out(lanes)
        return {"x": x.to(device=self.device, dtype=torch.float32)}

    def fill_payload(self, state, lane: int, request, steps: int):
        state["x"][lane] = self.noise(request.seed)[0]
        return state

    def emit(self, state, lane: int, done: int) -> torch.Tensor:
        # a copy: the lane's slice is overwritten in place when it refills
        return state["x"][lane:lane + 1].to("cpu", copy=True)
