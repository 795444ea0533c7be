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
    (continuous batching), with backfill: the first queued request that
    fits the free slot shape is admitted, so a guided request waiting for
    a whole pair never blocks an unguided one.

Slot-width scheduling: the lane batch is organised in pair slots of two
adjacent lanes (2k, 2k+1). An unguided request takes one lane; a guided
request (``RequestPolicy.guidance_scale``) takes a whole pair — cond
stream at 2k, uncond or negative stream at 2k+1 — and sets the slot's
``paired`` mask, which switches verification to ONE guided-residual
decision per pair. A session is paired (the lane step's ``"mixed"``
program, ``ops.verify_accept_mixed``) iff some request of its batch is
guided; unguided-only traffic keeps the plain program and
``ops.verify_accept``.

The port serves diffusion requests through ``serve_batched`` / ``serve``
/ ``run_request``, guided and unguided in one batch, at depth 1 or in
draft-K chains (``max_draft_depth`` with ``RequestPolicy.draft_depth``),
with the Taylor or the spectral forecaster. The reference's lifecycle
API, its other schedulers (SJF, EDF, WFQ), the controller,
observability and meshes are not ported yet.

Host/device discipline: while every in-flight request is depth-1, lane
completion is host-predictable (an active lane advances one step per
tick), so per-tick flags stay on the device until a request completes.
With a deep request in flight a lane moves 0..K steps per tick, so the
tick's ``advanced`` counters are fetched. The lane step itself syncs to
decide its branches. ``SpeCaEngine.host_syncs`` counts both.
"""
from __future__ import annotations

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
from repro_torch.diffusion.pipeline import null_cond_like
from repro_torch.obs import MonotonicClock, Timings
from repro_torch.serving.policy import RequestPolicy


@dataclasses.dataclass
class Request:
    """One serving request: conditioning + noise seed + policy. The legacy
    ``guidance_scale`` field is folded into the policy and wins when both
    are set."""
    request_id: int
    cond: Dict[str, Any]
    seed: int = 0
    guidance_scale: Optional[float] = None
    policy: Optional[RequestPolicy] = None


@dataclasses.dataclass
class Result:
    """Per-request serving outcome and accounting. For a guided request
    every counter is per pair decision (``num_full + num_spec`` is the
    schedule length); ``flops`` counts both streams."""
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

    @property
    def streams(self) -> int:
        return self.policy.streams


def _pop_fitting(queue: List[QueueItem], fits) -> Optional[QueueItem]:
    """FIFO with backfill: remove and return the first queued item (in
    arrival order) that ``fits``, or None."""
    for i, item in enumerate(queue):
        if fits(item):
            return queue.pop(i)
    return None


@dataclasses.dataclass(eq=False)       # identity: one entry may span two
class _Entry:                          # lanes
    """One in-flight request and the lanes it occupies: one, or a whole
    pair slot for a guided request."""
    item: QueueItem
    lanes: Tuple[int, ...]
    start_tick: int
    t0: float
    done: int = 0       # host-tracked denoising step counter
    draft_k: int = 1    # the request's draft horizon (policy.draft_depth)
    first_tick_s: Optional[float] = None

    @property
    def streams(self) -> int:
        return len(self.lanes)


class _Session:
    """One serving session: a fixed-width lane batch, its lane step and
    the host-side slot bookkeeping. ``paired`` sessions run the
    slot-width (``"mixed"``) program and admit guided requests into pair
    slots; plain sessions run the per-lane program. Each tick adds its
    device syncs to the engine's ``host_syncs`` as they happen: the lane
    step's branches and the ``advanced`` fetch while a deep request is in
    flight."""

    def __init__(self, engine: "SpeCaEngine", width: int, *,
                 paired: bool) -> None:
        self.e = engine
        self.wl = engine.workload
        self.W = width
        self.paired = bool(paired) and width >= 2 \
            and self.wl.supports_pairing
        self.step_fn = engine._lane_step(width,
                                         "mixed" if self.paired else False)
        self.state: Optional[Dict[str, Any]] = None
        self.lane_entry: List[Optional[_Entry]] = [None] * width
        self.tick = 0
        self._flag_log: List[Optional[Dict[str, torch.Tensor]]] = []
        self._flag_np: Dict[int, Dict[str, np.ndarray]] = {}

    def busy(self) -> bool:
        return any(e is not None for e in self.lane_entry)

    def entries(self) -> List[_Entry]:
        out: List[_Entry] = []
        for e in self.lane_entry:
            if e is not None and e not in out:    # identity (eq=False)
                out.append(e)
        return out

    def _free_lanes(self) -> List[int]:
        return [lane for lane in range(self.W)
                if self.lane_entry[lane] is None]

    def _free_pairs(self) -> List[int]:
        return [k for k in range(self.W // 2)
                if self.lane_entry[2 * k] is None
                and self.lane_entry[2 * k + 1] is None]

    def fits(self, item: QueueItem) -> bool:
        if item.streams == 2:
            return self.paired and bool(self._free_pairs())
        return bool(self._free_lanes())

    def place(self, item: QueueItem) -> _Entry:
        """Admit a request: a guided one into the first free pair slot, an
        unguided one into a free lane — in a paired session preferably
        one whose partner is occupied, keeping whole pairs free for guided
        admission."""
        if item.streams == 2:
            lane0 = 2 * self._free_pairs()[0]
            lanes: Tuple[int, ...] = (lane0, lane0 + 1)
        else:
            free = self._free_lanes()
            if self.paired:
                half = [lane for lane in free
                        if lane ^ 1 < self.W
                        and self.lane_entry[lane ^ 1] is not None]
                free = half or free
            lanes = (free[0],)
        entry = _Entry(item=item, lanes=lanes, start_tick=self.tick,
                       t0=self.e.clock.now(),
                       draft_k=int(item.policy.draft_depth or 1))
        for lane in lanes:
            self.lane_entry[lane] = entry
        self._fill(entry)
        return entry

    def _fill(self, entry: _Entry) -> None:
        """Reset the entry's lane slice(s) for its request (every update is
        lane-local and in place). A guided pair's second stream takes the
        policy's ``negative_cond``, else the engine's ``null_cond``, else
        ``null_cond_like`` of the request's conditioning; both lanes get
        the pair's ``gscale`` and ``paired`` set."""
        e, wl = self.e, self.wl
        req, pol = entry.item.request, entry.item.policy
        cond = {k: torch.as_tensor(v) for k, v in req.cond.items()}
        if self.state is None:
            self.state = LS.init_workload_state(
                wl, self.W, cond, guidance="mixed" if self.paired else False,
                forecaster=e.forecaster)
        tau0 = float(wl.scfg.tau0 if pol.tau0 is None else pol.tau0)
        lane0 = entry.lanes[0]
        # draft_k is pair-equal: a guided pair drafts pair-coherently
        self._fill_lane(lane0, cond, tau0, entry)
        if entry.streams == 2:
            nc = pol.negative_cond
            if nc is None:
                nc = e.null_cond if e.null_cond is not None \
                    else null_cond_like(wl.cfg, cond)
            self._fill_lane(lane0 + 1, nc, tau0, entry)
            self.state["gscale"][lane0:lane0 + 2] = float(pol.guidance_scale)
            self.state["paired"][lane0:lane0 + 2] = True
        elif self.paired:
            self.state["paired"][lane0] = False

    def _fill_lane(self, lane: int, cond: Dict[str, Any], tau0: float,
                   entry: _Entry) -> None:
        wl, st = self.wl, self.state
        st["draft_k"][lane] = entry.draft_k
        st["max_step"][lane] = entry.item.steps
        st["diffs"][:, :, :, lane] = 0
        st["n_anchors"][lane] = 0
        st["anchor_step"][lane] = -1
        st["gap"][lane] = 1.0
        st["since"][lane] = 0
        st["step"][lane] = 0
        st["active"][lane] = True
        st["tau0"][lane] = tau0
        for k, v in st["cond"].items():
            v[lane] = torch.as_tensor(cond[k])[0]
        self.state = wl.fill_payload(st, lane, entry.item.request,
                                     entry.item.steps)

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
            entry.done += 1 if adv is None else int(adv[entry.lanes[0]])
            if entry.done < entry.item.steps:
                continue
            completed.append((entry, self.harvest(entry, completed=True)))
            self._release(entry)
        self._gc_flags()
        return completed

    def _release(self, entry: _Entry) -> None:
        lane0, k = entry.lanes[0], entry.streams
        for lane in entry.lanes:
            self.lane_entry[lane] = None
        self.state["active"][lane0:lane0 + k] = False
        if self.paired and k == 2:
            self.state["paired"][lane0:lane0 + 2] = False

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
        sample readback and flag fetch are the only device reads). Flags
        are read at the entry's first lane: a guided pair's are
        pair-equal, its one decision."""
        item, lane, k = entry.item, entry.lanes[0], entry.streams
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
            flops=n_full * k * self.wl.full_flops
            + n_drafted * k * self.wl.verify_flops,
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
    ``Forecaster`` instance, fixed per engine. guidance: the legacy
    all-guided mode — a request without a scale is served guided at
    ``dcfg.guidance_scale``. null_cond: the default second stream of a
    guided pair (``None`` = ``null_cond_like`` of the request's
    conditioning).
    """

    def __init__(self, cfg: ModelConfig, params, dcfg: DiffusionConfig,
                 scfg: SpeCaConfig, *, draft_mode: str = "taylor",
                 accept_mode: str = "per_sample",
                 verify_backend: str = "fused",
                 noise_fn: Optional[NoiseFn] = None,
                 guidance: bool = False,
                 null_cond: Optional[Dict[str, Any]] = None,
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
        self.guidance = bool(guidance)
        self.null_cond = null_cond
        self.max_draft_depth = int(max_draft_depth)
        # resolved now, so a bad name fails at construction
        self.forecaster = get_forecaster(forecaster)
        self.clock = MonotonicClock()
        self._lane_fns: Dict[Tuple[int, Any], LS.LaneStep] = {}
        self._host_syncs = 0

    @property
    def host_syncs(self) -> int:
        """Device syncs this engine's sessions have made so far: the lane
        step's branches (two per depth-1 tick, up to K+1 per chain tick)
        and one ``advanced`` fetch per tick with a deep request in
        flight."""
        return self._host_syncs

    def resolve_policy(self, req: Request) -> RequestPolicy:
        """The request's policy (or the default) with the legacy
        ``Request.guidance_scale`` and the ``guidance=True`` engine mode
        folded in, validated against this engine."""
        pol = req.policy or RequestPolicy()
        if req.guidance_scale is not None:
            pol = dataclasses.replace(
                pol, guidance_scale=float(req.guidance_scale))
        if self.guidance and pol.guidance_scale is None:
            pol = dataclasses.replace(
                pol,
                guidance_scale=float(self.workload.dcfg.guidance_scale))
        dk = pol.draft_depth
        if dk is not None and not 1 <= int(dk) <= self.max_draft_depth:
            raise ValueError(
                f"draft_depth={dk} outside this engine's compiled chain "
                f"(1..max_draft_depth={self.max_draft_depth}); construct "
                "SpeCaEngine(max_draft_depth=K) to serve deeper drafts")
        return pol

    def _lane_step(self, W: int, mode: Any = False) -> LS.LaneStep:
        """The W-lane step (built once per width and program): ``mode``
        ``False`` is the plain per-lane program, ``"mixed"`` the
        slot-width pair-mask program."""
        key = (W, mode)
        if key not in self._lane_fns:
            self._lane_fns[key] = LS.build_workload_step(
                self.workload, lanes=W, draft_mode=self.draft_mode,
                accept_mode=self.accept_mode,
                verify_backend=self.verify_backend, guidance=mode,
                max_draft_depth=self.max_draft_depth,
                forecaster=self.forecaster)
        return self._lane_fns[key]

    def lane_width(self, lanes: int, n_requests: int) -> int:
        """The width ``lanes`` serves ``n_requests`` requests of the
        engine-wide mode at (``_width_for`` of that many default
        requests: whole pairs under ``guidance=True``)."""
        pol = self.resolve_policy(Request(request_id=0, cond={}))
        return self._width_for(lanes, [pol] * max(n_requests, 1))

    def _width_for(self, lanes: int, policies: List[RequestPolicy]) -> int:
        """Slot-width sizing for a request list: clamped to the total
        stream demand, room for the widest request, and rounded up to
        even as soon as any request is guided."""
        total = sum(p.streams for p in policies)
        widest = max(p.streams for p in policies)
        W = max(min(lanes, total), widest)
        return -(-W // widest) * widest

    def serve_batched(self, requests: List[Request], *, lanes: int = 4,
                      max_ticks: Optional[int] = None) -> List[Result]:
        """Serve a request list to completion through one private session.

        Packs up to ``lanes`` concurrent lanes per lane step (a guided
        request takes a pair of them); finished slots are refilled from
        the FIFO queue immediately, with backfill. Per-request accept
        trajectories are identical at every lane width — only the packing
        differs. ``max_ticks`` bounds the scheduler ticks: requests still
        in flight come back ``completed=False`` with partial counters,
        queued ones with ``sample=None``.
        """
        if not requests:
            return []
        S = self.workload.num_steps
        pols = [self.resolve_policy(r) for r in requests]
        queue = [QueueItem(seq=i, request=r, policy=p, steps=p.steps(S),
                           submit_s=self.clock.now())
                 for i, (r, p) in enumerate(zip(requests, pols))]
        sess = _Session(self, self._width_for(max(lanes, 1), pols),
                        paired=any(p.guided for p in pols))
        results: Dict[int, Result] = {}
        while queue or sess.busy():
            if max_ticks is not None and sess.tick >= max_ticks:
                break
            while True:
                item = _pop_fitting(queue, sess.fits)
                if item is None:
                    break
                sess.place(item)
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
        """Serve one request alone: on one lane, or one pair if guided (the
        per-sample reference)."""
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
