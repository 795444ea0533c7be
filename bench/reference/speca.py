"""A plain SpeCa sampler (forecast, verify, accept or refresh, step) over
a batch of requests, in float32, for judging what the served path
produced.

Per request and step s (the paper, §3.2–3.4; Taylor order m):

* the request may draft when its difference table holds more than m
  anchors and fewer than ``max_draft`` drafts in a row were accepted;
* a draft forecasts every layer's two increments from the table,
  ``F(d) = Σ_i Δⁱ · dⁱ / (i! · gapⁱ)`` with d the steps since the last
  anchor, gap the spacing of the last two anchors and only orders below
  the anchor count, runs the denoiser with only the verify layer
  computed, and measures ``e = ‖pred − real‖ / (‖real‖ + eps)`` of that
  layer's summed increments against ``τ_s = τ0 · β^(1 − s/T)``;
* an accepted draft advances on the drafted output; anything else runs
  the full denoiser, refreshes the table (``Δ⁰ = F``,
  ``Δⁱ = Δⁱ⁻¹_new − Δⁱ⁻¹_old``) and advances on the full output;
* the sampler advances by DDIM (cosine schedule, η = 0) or by the Euler
  step of rectified flow.

:func:`replay` follows given accept decisions (those the served path
made) and measures, at each drafted step, how far the decision lies on
the wrong side of τ by this sampler's own error. :func:`sample` decides
for itself (the control). Imports nothing of the program under test.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from bench.reference import dit
from bench.reference.dit import MatMul, f32_matmul

Decide = Optional[Callable[[float, float], bool]]


@dataclasses.dataclass
class Schedule:
    t_model: torch.Tensor      # [S] the model's time input
    t_frac: torch.Tensor       # [S] position in the schedule, 1 -> 0
    coef: torch.Tensor         # [S, 2] per-step update coefficients
    kind: str

    def step(self, x: torch.Tensor, out: torch.Tensor, s: int
             ) -> torch.Tensor:
        a, b = self.coef[s, 0], self.coef[s, 1]
        if self.kind == "rectified_flow":
            return x + (b - a) * out            # a = σ_s, b = σ_{s+1}
        x0 = (x - torch.sqrt(1 - a) * out) / torch.sqrt(a)
        return torch.sqrt(b) * x0 + torch.sqrt(1 - b) * out


def schedule(cfg: Dict, device) -> Schedule:
    S = cfg["num_inference_steps"]
    if cfg["schedule"] == "rectified_flow":
        sig = 1.0 - np.arange(S, dtype=np.float64) / S
        nxt = np.append(sig[1:], 0.0)
        t_model, t_frac = sig * 1000.0, sig
        coef = np.stack([sig, nxt], axis=1)
    elif cfg["schedule"] == "cosine":
        n = cfg["num_train_timesteps"]
        u = np.arange(n + 1, dtype=np.float64) / n
        f = np.cos((u + 0.008) / 1.008 * math.pi / 2) ** 2
        ab = f / f[0]
        betas = np.clip(1 - ab[1:] / ab[:-1], 0, 0.999)
        abar = np.cumprod(1.0 - betas)
        ts = (np.arange(S) * (n // S))[::-1]
        prev = np.append(abar[ts[1:]], 1.0)
        t_model, t_frac = ts.astype(np.float64), ts / n
        coef = np.stack([abar[ts], prev], axis=1)
    else:
        raise ValueError(f"unknown schedule {cfg['schedule']!r}")

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)
    return Schedule(f32(t_model), f32(t_frac), f32(coef), cfg["schedule"])


@dataclasses.dataclass
class Request:
    """One request as both sides see it: its initial latent [H, W, C],
    its class label and/or text embedding [T_text, cond_dim]."""
    noise: torch.Tensor
    label: Optional[int] = None
    text: Optional[torch.Tensor] = None


@dataclasses.dataclass
class Outcome:
    sample: torch.Tensor            # [H, W, C] f32
    accepts: List[bool]             # one per step: True = accepted draft
    # per drafted step: (step, error, τ)
    drafts: List[tuple] = dataclasses.field(default_factory=list)
    # the worst margin by which a decision lies on the wrong side of τ,
    # as a share of τ (0 when every decision agrees with this sampler);
    # accept_gap: the same over accepted drafts alone
    decision_gap: float = 0.0
    accept_gap: float = 0.0
    # decisions no sound sampler can make: an accepted step that could
    # not draft, or a trajectory of the wrong length
    bad_steps: int = 0


def _weights(order: int, d: torch.Tensor, gap: torch.Tensor,
             n_anchors: torch.Tensor) -> torch.Tensor:
    """[m+1, N] Taylor weights, zero for orders the anchors do not yet
    support."""
    ws = [d ** i / (math.factorial(i) * gap ** i) for i in range(order + 1)]
    w = torch.stack(ws)
    valid = torch.arange(order + 1, device=d.device)[:, None] < n_anchors
    return torch.where(valid, w, torch.zeros_like(w))


def _run(cfg: Dict, P: Dict, reqs: List[Request], follow: Optional[List],
         mm: MatMul, decide: Decide = None) -> List[Outcome]:
    dev = reqs[0].noise.device
    sch = schedule(cfg, dev)
    S, L, m = cfg["num_inference_steps"], cfg["num_layers"], \
        cfg["taylor_order"]
    vl = cfg["verify_layer"] % L
    tau0, beta, eps = cfg["tau0"], cfg["beta"], cfg["eps"]
    N = len(reqs)
    x = torch.stack([r.noise.to(torch.float32) for r in reqs])
    labels = torch.tensor([r.label for r in reqs], device=dev) \
        if reqs[0].label is not None else None
    text = torch.stack([r.text for r in reqs]) \
        if reqs[0].text is not None else None
    T = (x.shape[1] // cfg["patch_size"]) * (x.shape[2] // cfg["patch_size"])
    # request-major, so a request's slice is one contiguous block
    table = torch.zeros((N, m + 1, L, 2, T, cfg["d_model"]),
                        dtype=torch.float32, device=dev)
    n_anchors = torch.zeros(N, dtype=torch.long, device=dev)
    anchor = torch.full((N,), -1, dtype=torch.long, device=dev)
    gap = torch.ones(N, dtype=torch.float32, device=dev)
    since = torch.zeros(N, dtype=torch.long, device=dev)
    outs = [Outcome(sample=None, accepts=[]) for _ in reqs]
    if follow is not None:
        for o, acc in zip(outs, follow):
            o.bad_steps += int(len(acc) != S)

    def cond(rows):
        return dict(labels=None if labels is None else labels[rows],
                    text=None if text is None else text[rows])

    for s in range(S):
        want = (n_anchors > m) & (since < cfg["max_draft"])
        tau = tau0 * beta ** (1.0 - float(sch.t_frac[s]))
        t = sch.t_model[s].expand(N)
        out = torch.empty_like(x)
        accept = torch.zeros(N, dtype=torch.bool, device=dev)
        rows = want.nonzero().flatten()
        if len(rows):
            d = (s - anchor[rows]).to(torch.float32)
            w = _weights(m, d, gap[rows], n_anchors[rows])
            # Σ_i w_i[n] · Δⁱ[n], one request at a time
            preds = torch.stack([torch.tensordot(w[:, j], table[n], dims=1)
                                 for j, n in enumerate(rows.tolist())],
                                dim=2)
            o, real = dit.forward(cfg, P, x[rows], t[rows], preds=preds,
                                  computed=[vl], mm=mm, **cond(rows))
            pv = (preds[vl, 0] + preds[vl, 1]).flatten(1)
            rv = (real[0, 0] + real[0, 1]).flatten(1)
            err = torch.linalg.vector_norm(pv - rv, dim=1) \
                / (torch.linalg.vector_norm(rv, dim=1) + eps)
            out[rows] = o
            for j, n in enumerate(rows.tolist()):
                e = float(err[j])
                ok = e <= tau if decide is None else decide(e, tau)
                if follow is not None:
                    ok = bool(follow[n][s]) if s < len(follow[n]) else False
                    wrong = (e / tau - 1.0) if ok else (1.0 - e / tau)
                    outs[n].decision_gap = max(outs[n].decision_gap, wrong)
                    if ok:
                        outs[n].accept_gap = max(outs[n].accept_gap, wrong)
                outs[n].drafts.append((s, e, tau))
                accept[n] = ok
        if follow is not None:
            for n in (~want).nonzero().flatten().tolist():
                if s < len(follow[n]) and follow[n][s]:
                    outs[n].bad_steps += 1
        full = (~accept).nonzero().flatten()
        if len(full):
            o, inc = dit.forward(cfg, P, x[full], t[full], collect=True,
                                 mm=mm, **cond(full))
            out[full] = o
            for j, n in enumerate(full.tolist()):
                old = table[n].clone()
                table[n, 0] = inc[:, :, j]
                for i in range(1, m + 1):
                    table[n, i] = table[n, i - 1] - old[i - 1]
            a = anchor[full]
            gap[full] = torch.where(a >= 0, (s - a).to(torch.float32),
                                    torch.ones_like(gap[full])).clamp(min=1)
            anchor[full] = s
            n_anchors[full] += 1
        for n in range(N):
            outs[n].accepts.append(bool(accept[n]))
        since = torch.where(accept, since + 1, torch.zeros_like(since))
        x = sch.step(x, out, s)
    for n, o in enumerate(outs):
        o.sample = x[n]
    return outs


def replay(cfg: Dict, P: Dict, reqs: List[Request], accepts: List[List],
           *, mm: MatMul = f32_matmul) -> List[Outcome]:
    """This sampler along the served path's accept decisions (one list of
    bools per request, True = accepted draft)."""
    return _run(cfg, P, reqs, accepts, mm)


def sample(cfg: Dict, P: Dict, reqs: List[Request], *,
           mm: MatMul = f32_matmul, decide: Decide = None
           ) -> List[Outcome]:
    """This sampler deciding for itself: a draft is accepted when its
    error is at most τ, or where ``decide(error, τ)`` says so."""
    return _run(cfg, P, reqs, None, mm, decide)
