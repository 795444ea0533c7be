"""SpeCa serving engine: per-lane speculative caching over a lane batch.

Concurrent requests are packed into a fixed-width lane batch and one
lane step (``repro_torch.core.lane_step``) advances all lanes per
scheduler tick:

  * every lane carries its own TaylorSeer table slice and anchor
    metadata, ``since`` counter, denoising step index, accept decision
    and verification threshold (per-request τ policy);
  * drafting runs through the fused per-lane predict kernel and the fused
    verify kernel; rejected lanes are served by a full forward whose
    refresh kernel updates ONLY their table slices — when every lane
    accepts, the full forward is skipped;
  * when a lane finishes, the FIFO queue refills it immediately
    (continuous batching).

The port serves unguided diffusion requests through ``serve_batched`` /
``serve`` / ``run_request``, at depth 1 or in draft-K chains
(``max_draft_depth`` with ``RequestPolicy.draft_depth``), with the Taylor
or the spectral forecaster. The reference's lifecycle API, guided pairs,
other schedulers, the controller, observability and meshes are not
ported yet.

Host/device discipline: while every in-flight request is depth-1, lane
completion is host-predictable (an active lane advances one step per
tick), so per-tick flags stay on the device until a request completes.
With a deep request in flight a lane moves 0..K steps per tick, so the
tick's ``advanced`` counters are fetched. The lane step itself syncs to
decide its branches. ``SpeCaEngine.host_syncs`` counts both.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import DiffusionConfig, ModelConfig, SpeCaConfig
from repro_torch.core import lane_step as LS
from repro_torch.core.forecaster import get_forecaster
from repro_torch.core.workload import DiffusionWorkload, NoiseFn
from repro_torch.device import DeviceLike
from repro_torch.obs import MonotonicClock, Timings
from repro_torch.serving.policy import RequestPolicy


@dataclasses.dataclass
class Request:
    """One serving request: conditioning + noise seed + policy."""
    request_id: int
    cond: Dict[str, Any]
    seed: int = 0
    policy: Optional[RequestPolicy] = None


@dataclasses.dataclass
class Result:
    """Per-request serving outcome and accounting."""
    request_id: int
    sample: Any
    num_full: int
    num_spec: int
    # algorithmic per-request cost of the request's own SpeCa schedule
    # (batch=1 equivalent) — lane packing never changes it
    flops: float
    wall_s: float
    accepts: Optional[List[bool]] = None   # per-step accept trajectory
    num_drafted: int = 0
    # False when the engine drained the lane before the request reached
    # its final step (tick budget) or never started it
    completed: bool = True
    finish_tick: Optional[int] = None
    timings: Optional[Timings] = None

    @property
    def alpha(self) -> float:
        """Acceptance rate: fraction of steps served speculatively."""
        return self.num_spec / max(self.num_full + self.num_spec, 1)

    @property
    def draft_accept_rate(self) -> float:
        """Accepted drafted steps per drafted step, ``num_spec /
        num_drafted``: a depth-K chain counts every position it drafted,
        so depth-1 and depth-K runs compare directly. 0.0 when the
        request never drafted."""
        return self.num_spec / max(self.num_drafted, 1)


@dataclasses.dataclass
class QueueItem:
    """One queued request with its resolved policy and schedule length;
    ``seq`` is its arrival index and the key its Result is returned
    under."""
    seq: int
    request: Request
    policy: RequestPolicy
    steps: int
    submit_s: float


@dataclasses.dataclass(eq=False)
class _Entry:
    """One in-flight request and the lane it occupies."""
    item: QueueItem
    lane: int
    start_tick: int
    t0: float
    done: int = 0       # host-tracked denoising step counter
    draft_k: int = 1    # the request's draft horizon (policy.draft_depth)
    first_tick_s: Optional[float] = None


class _Session:
    """One serving session: a fixed-width lane batch, its lane step and
    the host-side slot bookkeeping. Each tick adds its device syncs to
    the engine's ``host_syncs`` as they happen: the lane step's branches
    and the ``advanced`` fetch while a deep request is in flight."""

    def __init__(self, engine: "SpeCaEngine", width: int) -> None:
        self.e = engine
        self.wl = engine.workload
        self.W = width
        self.step_fn = engine._lane_step(width)
        self.state: Optional[Dict[str, Any]] = None
        self.lane_entry: List[Optional[_Entry]] = [None] * width
        self.tick = 0
        self._flag_log: List[Optional[Dict[str, torch.Tensor]]] = []
        self._flag_np: Dict[int, Dict[str, np.ndarray]] = {}

    def busy(self) -> bool:
        return any(e is not None for e in self.lane_entry)

    def has_free_lane(self) -> bool:
        return None in self.lane_entry

    def entries(self) -> List[_Entry]:
        return [e for e in self.lane_entry if e is not None]

    def place(self, item: QueueItem) -> None:
        """Admit a request into the first free lane."""
        lane = self.lane_entry.index(None)
        entry = _Entry(item=item, lane=lane, start_tick=self.tick,
                       t0=self.e.clock.now(),
                       draft_k=int(item.policy.draft_depth or 1))
        self.lane_entry[lane] = entry
        self._fill(entry)

    def _fill(self, entry: _Entry) -> None:
        """Reset the entry's lane slice for its request (every update is
        lane-local and in place)."""
        wl = self.wl
        req, pol = entry.item.request, entry.item.policy
        if self.state is None:
            self.state = LS.init_workload_state(
                wl, self.W, req.cond, forecaster=self.e.forecaster)
        lane, st = entry.lane, self.state
        st["draft_k"][lane] = entry.draft_k
        st["max_step"][lane] = entry.item.steps
        st["diffs"][:, :, :, lane] = 0
        st["n_anchors"][lane] = 0
        st["anchor_step"][lane] = -1
        st["gap"][lane] = 1.0
        st["since"][lane] = 0
        st["step"][lane] = 0
        st["active"][lane] = True
        st["tau0"][lane] = float(wl.scfg.tau0 if pol.tau0 is None
                                 else pol.tau0)
        for k, v in st["cond"].items():
            v[lane] = torch.as_tensor(req.cond[k])[0]
        self.state = wl.fill_payload(st, lane, req, entry.item.steps)

    def advance(self) -> List[Tuple[_Entry, Result]]:
        """One scheduler tick: run the lane step, then complete every
        entry whose schedule finished. With a deep entry in flight a lane
        moves 0..K steps per tick, so the tick's ``advanced`` counters are
        fetched (one host sync). Returns the completions."""
        now = self.e.clock.now()
        before = self.step_fn.host_syncs
        self.state, flags = self.step_fn(self.state)
        self.e._host_syncs += self.step_fn.host_syncs - before
        self._flag_log.append(flags)
        self.tick += 1
        adv = None
        if any(e.draft_k > 1 for e in self.entries()):
            adv = flags["advanced"].cpu().numpy()
            self.e._host_syncs += 1
        completed: List[Tuple[_Entry, Result]] = []
        for entry in self.entries():
            if entry.first_tick_s is None:
                entry.first_tick_s = now
            # depth-1 entries advance exactly one step per tick
            entry.done += 1 if adv is None else int(adv[entry.lane])
            if entry.done < entry.item.steps:
                continue
            completed.append((entry, self.harvest(entry, completed=True)))
            self._release(entry)
        self._gc_flags()
        return completed

    def _release(self, entry: _Entry) -> None:
        self.lane_entry[entry.lane] = None
        self.state["active"][entry.lane] = False

    def _fetch(self, t: int) -> Dict[str, np.ndarray]:
        if t not in self._flag_np:
            self._flag_np[t] = {k: v.cpu().numpy()
                                for k, v in self._flag_log[t].items()
                                if k in LS.COUNTER_FLAGS}
        return self._flag_np[t]

    def _gc_flags(self) -> None:
        # ticks older than every in-flight entry's start are consumed
        live = [e.start_tick for e in self.entries()]
        horizon = min(live) if live else self.tick
        for t in range(horizon):
            self._flag_np.pop(t, None)
            self._flag_log[t] = None

    def harvest(self, entry: _Entry, completed: bool) -> Result:
        """Materialise one entry's Result from its accumulated flags (the
        sample readback and flag fetch are the only device reads)."""
        item, lane = entry.item, entry.lane
        accepts: List[bool] = []
        n_drafted, n_full = 0, 0
        for t in range(entry.start_tick, self.tick):
            f = self._fetch(t)
            ns, nf = int(f["n_spec"][lane]), int(f["full"][lane])
            accepts.extend([True] * ns + [False] * nf)
            n_full += nf
            n_drafted += int(f["n_drafted"][lane])
        finish_s = self.e.clock.now()
        timings = Timings(
            submit_s=item.submit_s, admit_s=entry.t0, finish_s=finish_s,
            first_tick_s=entry.first_tick_s, admit_tick=entry.start_tick,
            finish_tick=self.tick)
        return Result(
            request_id=item.request.request_id,
            sample=self.wl.emit(self.state, lane, entry.done),
            num_full=n_full, num_spec=entry.done - n_full,
            num_drafted=n_drafted,
            flops=n_full * self.wl.full_flops
            + n_drafted * self.wl.verify_flops,
            wall_s=finish_s - entry.t0, accepts=accepts,
            completed=completed, finish_tick=self.tick, timings=timings)

    def drain(self) -> List[Tuple[_Entry, Result]]:
        """Tick-budget shutdown: harvest every in-flight entry as
        UNFINISHED — partial counters, ``completed=False``."""
        out = []
        for entry in self.entries():
            out.append((entry, self.harvest(entry, completed=False)))
            self._release(entry)
        return out


def _dropped_result(item: QueueItem) -> Result:
    """A queued request that never started (tick-budget shutdown)."""
    return Result(request_id=item.request.request_id, sample=None,
                  num_full=0, num_spec=0, flops=0.0, wall_s=0.0,
                  accepts=[], completed=False)


class SpeCaEngine:
    """Batched diffusion serving with per-lane speculative caching.

    accept_mode: ``"per_sample"`` (default; each lane on its own error)
    or ``"batch"`` (every drafting lane must pass). verify_backend:
    ``"fused"`` (default; the verify kernel) or ``"jnp"`` (the unfused
    metric-general path, forced for non-rel-L2 metrics). draft_mode: the
    forecast weights (``taylor.prediction_weights``). ``device``: where
    the lane state lives — ``params`` must already be there.
    ``noise_fn(seed)`` overrides the per-request initial noise.
    max_draft_depth: the chain length K of the lane step — requests may
    ask for ``RequestPolicy.draft_depth`` 1..K; the default 1 builds the
    depth-1 step. forecaster: ``None``/``"taylor"``, ``"spectral"`` or a
    ``Forecaster`` instance, fixed per engine.
    """

    def __init__(self, cfg: ModelConfig, params, dcfg: DiffusionConfig,
                 scfg: SpeCaConfig, *, draft_mode: str = "taylor",
                 accept_mode: str = "per_sample",
                 verify_backend: str = "fused",
                 noise_fn: Optional[NoiseFn] = None,
                 max_draft_depth: int = 1, forecaster: Any = None,
                 device: DeviceLike = "cuda"):
        if accept_mode not in LS.ACCEPT_MODES:
            raise ValueError(f"unknown accept_mode {accept_mode!r}")
        if max_draft_depth < 1:
            raise ValueError(f"max_draft_depth must be >= 1, "
                             f"got {max_draft_depth}")
        if verify_backend not in LS.VERIFY_BACKENDS:
            raise ValueError(f"unknown verify_backend {verify_backend!r}")
        self.workload = DiffusionWorkload(cfg, params, dcfg, scfg,
                                          device=device, noise_fn=noise_fn)
        self.draft_mode = draft_mode
        self.accept_mode = accept_mode
        self.verify_backend = verify_backend
        self.max_draft_depth = int(max_draft_depth)
        # resolved now, so a bad name fails at construction
        self.forecaster = get_forecaster(forecaster)
        self.clock = MonotonicClock()
        self._lane_fns: Dict[int, LS.LaneStep] = {}
        self._host_syncs = 0

    @property
    def host_syncs(self) -> int:
        """Device syncs this engine's sessions have made so far: the lane
        step's branches (two per depth-1 tick, up to K+1 per chain tick)
        and one ``advanced`` fetch per tick with a deep request in
        flight."""
        return self._host_syncs

    def resolve_policy(self, req: Request) -> RequestPolicy:
        """The request's policy (or the default), validated against this
        engine."""
        pol = req.policy or RequestPolicy()
        dk = pol.draft_depth
        if dk is not None and not 1 <= int(dk) <= self.max_draft_depth:
            raise ValueError(
                f"draft_depth={dk} outside this engine's compiled chain "
                f"(1..max_draft_depth={self.max_draft_depth}); construct "
                "SpeCaEngine(max_draft_depth=K) to serve deeper drafts")
        return pol

    def _lane_step(self, W: int) -> LS.LaneStep:
        """The W-lane step (built once per width)."""
        if W not in self._lane_fns:
            self._lane_fns[W] = LS.build_workload_step(
                self.workload, lanes=W, draft_mode=self.draft_mode,
                accept_mode=self.accept_mode,
                verify_backend=self.verify_backend,
                max_draft_depth=self.max_draft_depth,
                forecaster=self.forecaster)
        return self._lane_fns[W]

    def serve_batched(self, requests: List[Request], *, lanes: int = 4,
                      max_ticks: Optional[int] = None) -> List[Result]:
        """Serve a request list to completion through one private session.

        Packs up to ``lanes`` concurrent requests per lane step; finished
        lanes are refilled from the FIFO queue immediately. Per-request
        accept trajectories are identical at every lane width — only the
        packing differs. ``max_ticks`` bounds the scheduler ticks:
        requests still in flight come back ``completed=False`` with
        partial counters, queued ones with ``sample=None``.
        """
        if not requests:
            return []
        S = self.workload.num_steps
        pols = [self.resolve_policy(r) for r in requests]
        queue = collections.deque(
            QueueItem(seq=i, request=r, policy=p, steps=p.steps(S),
                      submit_s=self.clock.now())
            for i, (r, p) in enumerate(zip(requests, pols)))
        sess = _Session(self, min(max(lanes, 1), len(requests)))
        results: Dict[int, Result] = {}
        while queue or sess.busy():
            if max_ticks is not None and sess.tick >= max_ticks:
                break
            while queue and sess.has_free_lane():
                sess.place(queue.popleft())
            for entry, res in sess.advance():
                results[entry.item.seq] = res
        for entry, res in sess.drain():
            results[entry.item.seq] = res
        for item in queue:
            results[item.seq] = _dropped_result(item)
        return [results[i] for i in range(len(requests))]

    def serve(self, requests: List[Request], *, lanes: int = 1,
              max_ticks: Optional[int] = None) -> List[Result]:
        """``serve_batched`` at the reference's ``serve`` default width."""
        return self.serve_batched(requests, lanes=lanes,
                                  max_ticks=max_ticks)

    def run_request(self, req: Request) -> Result:
        """Serve one request on one lane (the per-sample reference)."""
        return self.serve_batched([req], lanes=1)[0]


def allocation_report(results: List[Result],
                      full_flops_per_step: float) -> Dict[str, float]:
    """Sample-adaptive allocation summary (paper §1): splits requests at
    the median acceptance rate into easy/hard buckets and reports each
    bucket's FLOPs speedup against always-full. Unfinished requests and
    non-finite accounting are excluded and counted in ``n_dropped``."""
    finite = [r for r in results
              if r.completed and math.isfinite(r.flops)
              and math.isfinite(r.alpha)]
    dropped = len(results) - len(finite)
    if not finite:
        return {"n_requests": 0, "n_dropped": dropped} if dropped else {}
    alphas = sorted(r.alpha for r in finite)
    median = alphas[len(alphas) // 2]
    easy = [r for r in finite if r.alpha >= median]
    hard = [r for r in finite if r.alpha < median]

    def bucket_speedup(rs: List[Result]) -> float:
        if not rs:
            return 1.0
        ref = sum((r.num_full + r.num_spec) * full_flops_per_step
                  for r in rs)
        return ref / max(sum(r.flops for r in rs), 1e-9)

    return {
        "n_requests": len(finite),
        "n_dropped": dropped,
        "frac_easy": len(easy) / len(finite),
        "frac_hard": len(hard) / len(finite),
        "speedup_easy": bucket_speedup(easy),
        "speedup_hard": bucket_speedup(hard),
        "speedup_all": bucket_speedup(finite),
        "alpha_easy": sum(r.alpha for r in easy) / max(len(easy), 1),
        "alpha_hard": sum(r.alpha for r in hard) / max(len(hard), 1),
        "alpha_mean": sum(r.alpha for r in finite) / len(finite),
    }
