"""Whether what the timed path served is correct.

Once the window has closed and the program's state is freed, a sample of
the requests completed in the window, drawn from the run's seed, is
served again by the plain float32 SpeCa sampler of ``bench/reference``
along the accept decisions the program made for each (its output, as
much as the sample is). The weights are drawn again from the seed, and
each request's inputs again from its own seed: the reference takes
nothing the program made. Three numbers are compared, each against its
configuration's limit (``limits`` in ``bench/configs/<name>.json``; the
readings they were set from are in PERF.md):

* ``sample_err``: the largest ‖served − reference‖ / ‖reference‖ of a
  final latent over the sampled requests (the full forward, the masked
  forward, the forecast and refresh and the sampler step all feed it);
* ``decision_gap``: the largest share of τ_t by which a served accept or
  reject lies on the wrong side of the threshold by the reference's own
  verify error (the verify and its threshold schedule);
* ``accept_gap``: the same over the served accepts alone, the side on
  which a verify that accepts too much (and so serves faster) errs;
* ``bad_steps``: decisions no sound sampler makes (an accepted draft
  where the request could not draft, a trajectory of the wrong length);
  an exact count, limit 0.

A configuration compares the numbers its ``limits`` name; the others
are measured and reported beside them (PERF.md says why a number is not
compared for a configuration).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from bench.harness import serve as SV
from bench.harness import traffic as TR
from bench.reference import speca

NUMBERS = ("sample_err", "decision_gap", "accept_gap", "bad_steps")


@dataclasses.dataclass
class Verdict:
    correct: bool
    compared: int
    failed: int
    numbers: Dict[str, float]
    limits: Dict[str, float]

    def checks(self) -> Dict[str, Dict[str, float]]:
        """The numbers compared, each beside its limit."""
        return {k: {"value": self.numbers[k], "limit": self.limits[k]}
                for k in NUMBERS if k in self.limits}

    def uncompared(self) -> Dict[str, float]:
        return {k: v for k, v in self.numbers.items()
                if k not in self.limits}


def pick(n_served: int, want: int, seed: int) -> List[int]:
    """Indices of the requests to compare, drawn from the run's seed."""
    rng = np.random.default_rng(TR.derive(seed, 5))
    k = min(want, n_served)
    return sorted(rng.choice(n_served, size=k, replace=False).tolist())


def reference_requests(cfg: Dict, rseeds: List[int],
                       device) -> List[speca.Request]:
    out = []
    for r in rseeds:
        inp = SV.request_inputs(cfg, r, device)
        out.append(speca.Request(
            noise=inp["noise"][0], label=inp["label"],
            text=None if inp["text"] is None else inp["text"][0]))
    return out


def compare(cfg: Dict, samples: List[torch.Tensor], accepts: List[List],
            outs: List[speca.Outcome]) -> Verdict:
    """The numbers of served samples and decisions against the
    reference's outcomes along them."""
    limits = {k: float(cfg["limits"][k]) for k in NUMBERS
              if k in cfg["limits"]}
    per = []
    for x, acc, o in zip(samples, accepts, outs):
        ref = o.sample.to(torch.float32).cpu()
        x = x.reshape(ref.shape).to(torch.float32).cpu()
        err = float(torch.linalg.vector_norm(x - ref)
                    / torch.linalg.vector_norm(ref))
        if not np.isfinite(err):
            err = float("inf")
        per.append({"sample_err": err, "decision_gap": o.decision_gap,
                    "accept_gap": o.accept_gap,
                    "bad_steps": float(o.bad_steps)})
    numbers = {k: max((p[k] for p in per), default=float("inf"))
               if k != "bad_steps" else sum(p[k] for p in per)
               for k in NUMBERS}
    failed = sum(any(p[k] > limits[k] for k in limits) for p in per)
    correct = bool(per) and failed == 0 and all(
        numbers[k] <= limits[k] for k in limits)
    return Verdict(correct=correct, compared=len(per), failed=failed,
                   numbers=numbers, limits=limits)


def judge(cfg: Dict, served: List[SV.Served], seed: int,
          device) -> Verdict:
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False     # f32 is f32
    torch.backends.cudnn.allow_tf32 = False
    try:
        idx = pick(len(served), int(cfg["check_requests"]), seed)
        chosen = [served[i] for i in idx]
        with torch.no_grad():
            params = SV.make_weights(cfg, seed, device)
            reqs = reference_requests(cfg, [s.rseed for s in chosen],
                                      device)
            outs = speca.replay(cfg, params, reqs,
                                [s.accepts for s in chosen])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    return compare(cfg, [s.sample for s in chosen],
                   [s.accepts for s in chosen], outs)
