"""SpeCa serving engine: per-lane speculative caching over lane batches of
one or more workloads (diffusion denoising, LLM decode).

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
  * when a lane finishes, the admission queue refills it immediately
    (continuous batching) in the order its ``Scheduler`` decides (FIFO,
    SJF, EDF or WFQ, ``repro_torch.serving.scheduler``), with backfill: a
    guided request waiting for a whole pair never blocks an unguided one
    that fits the free lane.

Slot-width scheduling: the lane batch is organised in pair slots of two
adjacent lanes (2k, 2k+1). An unguided request takes one lane; a guided
request (``RequestPolicy.guidance_scale``) takes a whole pair — cond
stream at 2k, uncond or negative stream at 2k+1 — and sets the slot's
``paired`` mask, which switches verification to ONE guided-residual
decision per pair. A ``serve_batched`` session is paired (the lane step's
``"mixed"`` program, ``ops.verify_accept_mixed``) iff some request of its
batch is guided; unguided-only batches keep the plain program and
``ops.verify_accept``. The lifecycle session is always paired.

Request lifecycle: ``submit() -> Ticket``, ``poll``/``result``/``results``,
``stream()`` (``previews=True`` adds per-tick snapshots of the running
requests), ``tick()``, ``release()``, ``status()`` and ``shutdown()``;
requests are admitted continuously into free slots, and a bounded queue
(``max_queue``) raises ``QueueFull``. Every ticket walks queued → running →
done | dropped (→ released). ``serve_batched``/``serve``/``run_request``
serve a fixed list through private sessions and never touch the lifecycle
queue.

Closed loop (``SpeCaEngine(controller=True)``): a request whose policy
carries a ``ControllerPolicy`` has its lane's τ0, draft depth and forecast
order adapted after every tick on the device
(``repro_torch.core.controller``); controller-free requests in the same
batch keep their trajectories bitwise.

Workload routing: the lane step is workload-agnostic
(``repro_torch.core.workload``). ``RequestPolicy.workload`` names the
workload a request rides in; each workload tag owns its own lane session
(its width, lane step and FLOPs model) and shares the scheduler, the
admission queue and the lifecycle API with the others: a request whose
session is full never blocks one another session could admit.
``SpeCaEngine(workloads={"decode": DecodeWorkload(...)})`` serves decode
lanes beside the diffusion quartet's lanes, or alone without it.
``Result.workload`` says which served a request.

Host/device discipline: while every in-flight request is depth-1 and
controller-free, lane completion is host-predictable (an active lane
advances one step per tick), so per-tick flags stay on the device until a
request completes. With a deep or controlled request in flight a lane
moves 0..K steps per tick, so the tick's ``advanced`` counters are
fetched. The lane step itself syncs to decide its branches, and a
decode lane's prefill reads its first token back at admission.
``SpeCaEngine.host_syncs`` counts all three. It leaves out the other
waits on a card: the harvest's flag and sample reads, a lane fill's
one-element writes and copies from the host, and the lane step's copy
of β for its thresholds; with observability on,
``speca_device_waits_total{reason}`` counts every wait (see below).

Lane sharding (``SpeCaEngine(mesh=)``, a ``repro_torch.launch.mesh``
``LaneMesh`` of D shards): each session's lane batch is D contiguous
blocks of W/D lanes, shard i's on ``mesh.devices[i]`` with the workload's
replica there (parameters copied once per distinct device; D shards on
one card share one copy). The width rounds to a multiple of D, and of 2·D
where guided pairs can be admitted, so a pair never straddles a shard. A
lane fills, releases and emits on its owning shard's block; the step
(``lane_step.ShardedStep``) runs every shard's body in lockstep, decides
each branch once over all lanes and launches each kernel once per shard.
The flags stay per shard on their devices; the engine reads them, joined
in shard order, only where it reads them unsharded. Every request gets
the accepts, counters and FLOPs of the unsharded engine. One process
drives every shard; between distinct GPUs only the decisions and the
flags it reads are copied, device to device.

Observability (``SpeCaEngine(obs=True)`` or an ``Observability``): the
flight recorder's submit/admit/finish/drop/compile events, per-request
span traces (``trace(ticket)``), request counters and accept-rate
and latency histograms, the per-tick ``speca_queue_depth``/
``speca_in_flight`` series, and each session's on-device
``LaneAccumulator`` of the step's flags, flushed by
``metrics_snapshot()``. Its ``PhaseRecorder`` (``obs.phases``) keeps the
host's phase spans on the engine clock: ``tick``; under it ``admit`` per
admitted request, ``step`` (the lane step, with its kernel requests,
forwards and branch reads under it), ``obs.accumulate``, ``harvest`` per
completed or drained request; and ``wait.<reason>`` around every read
that blocks the host on the device (``draft``, ``chain``, ``full``:
branch reads; ``tau``: the threshold's copy of β; ``advanced``;
``fill``: a lane fill's blocking writes and copies, each counted where
it happens through the fill's ``HostCopies``; ``flags``: a harvest's
fetch of one tick's counters, six reads; ``sample``: an emitted
sample). Beside them the registry counts waits and their seconds by
reason, the forwards' calls, the lanes occupied at each lane step and
the step's host seconds outside its waits (``docs/observability_torch.md``).
It adds no host sync and never changes what the lane step computes: an
observed engine serves bitwise what an unobserved one serves.
``obs=False`` runs no observability code.
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Any, Dict, Iterator, List, Optional, Set, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch.configs import DiffusionConfig, ModelConfig, SpeCaConfig
from repro_torch.core import controller as CT
from repro_torch.core import lane_step as LS
from repro_torch.core.forecaster import get_forecaster
from repro_torch.core.workload import (HOST_COPIES, DiffusionWorkload,
                                       HostCopies, NoiseFn, Workload)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.diffusion.pipeline import null_cond_like
from repro_torch.launch.mesh import canonical_device
from repro_torch.obs import (Clock, Observability, Timings, Trace,
                             build_trace, resolve_clock)
from repro_torch.serving.policy import QueueFull, RequestPolicy, Ticket
from repro_torch.serving.scheduler import (QueueItem, Scheduler,
                                           fresh_scheduler, make_scheduler)
from repro_torch.sharding import specs as SH

# histogram bucket grids of the per-request observability metrics: rates
# live in [0, 1]; latency seconds get a coarse log grid
_RATE_EDGES = tuple(i / 20.0 for i in range(1, 21))
_SECONDS_EDGES = tuple(float(x) for x in
                       (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3,
                        1.0, 3.0, 10.0, 30.0, 100.0, 300.0))


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
    # its final step (tick budget, shutdown) or never started it
    completed: bool = True
    # the session tick after which the request completed (None if it never
    # started) and the policy's deadline tick
    finish_tick: Optional[int] = None
    deadline: Optional[float] = None
    ticket_id: Optional[int] = None
    # the workload that served the request: ``sample`` is a latent for
    # "diffusion", the emitted int32 tokens for "decode", and ``flops``
    # is that workload's cost model
    workload: str = "diffusion"
    tenant: str = "default"
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

    @property
    def deadline_met(self) -> Optional[bool]:
        """Whether the request finished by its policy deadline; None when
        it had no deadline or never finished."""
        if self.deadline is None or self.finish_tick is None \
                or not self.completed:
            return None
        return self.finish_tick <= self.deadline


@dataclasses.dataclass(frozen=True)
class Preview:
    """One per-tick snapshot of a RUNNING request
    (``SpeCaEngine.stream(previews=True)``): ``sample`` is its current
    partially denoised latent (decode: its tokens so far), a pure read of
    the lane state (the final ``Result.sample`` is bitwise a preview-free
    run's); ``step`` the schedule steps done (always below the request's
    schedule length); ``tick`` the session's scheduler tick; ``workload``
    the workload that serves it."""

    ticket_id: int
    request_id: int
    tick: int
    step: int
    sample: Any
    workload: str = "diffusion"


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
    """One serving session: a fixed-width lane batch of ONE workload, its
    lane step and the host-side slot bookkeeping. ``paired`` sessions run
    the slot-width (``"mixed"``) program and admit guided requests into
    pair slots; plain sessions run the per-lane program (a workload
    without pairing, decode, is always plain). Each tick adds its device
    syncs to the engine's ``host_syncs`` as they happen: the lane step's
    branches and the ``advanced`` fetch while a deep or controlled request
    is in flight; so does each lane fill that syncs (a decode prefill).
    On the engine's mesh the state is one dict per shard, and lane l
    belongs to shard l // (W/D)."""

    def __init__(self, engine: "SpeCaEngine", width: int, *,
                 paired: bool, workload: Workload) -> None:
        self.e = engine
        self.wl = workload
        self.W = width
        self.mesh = engine.mesh
        # the lanes each shard owns, and each shard's workload replica
        self.block = SH.lane_block(width, engine._lane_shards)
        self.shard_wls = [workload] if self.mesh is None \
            else [workload.on(d) for d in self.mesh.devices]
        self.paired = bool(paired) and width >= 2 \
            and self.wl.supports_pairing
        self.step_fn = engine._lane_step(
            width, "mixed" if self.paired else False, tag=self.wl.tag)
        self.state: Optional[Dict[str, Any]] = None
        self.lane_entry: List[Optional[_Entry]] = [None] * width
        self.tick = 0
        self._flag_log: List[Optional[Dict[str, torch.Tensor]]] = []
        self._flag_np: Dict[int, Dict[str, np.ndarray]] = {}
        # host clock stamp at the start of each tick, index-aligned with
        # _flag_log and gc'd with it: trace spans read these
        self._tick_s: List[Optional[float]] = []
        # the on-device flag accumulator and the phase recorder (None when
        # obs is off)
        self._acc = engine._obs.lane_accumulator() \
            if engine._obs is not None else None
        self._phases = engine._phases
        # a lane fill's copies between the host and the state, counted as
        # ``wait.fill`` when phases are recorded
        self._copies = HOST_COPIES if self._phases is None \
            else _FillCopies(self._phases)

    def busy(self) -> bool:
        return any(e is not None for e in self.lane_entry)

    def _shard(self, lane: int) -> Tuple[int, Workload, Dict[str, Any], int]:
        """(shard, its workload, its state dict, the lane within it) of
        session lane ``lane``; unsharded, shard 0 is the whole batch."""
        i, j = divmod(lane, self.block)
        return (i, self.shard_wls[i],
                self.state if self.mesh is None else self.state[i], j)

    def emit(self, lane: int, done: int) -> Any:
        """The lane's sample so far, read on its owning shard."""
        _, wl, st, j = self._shard(lane)
        ph = self._phases
        return wl.emit(st, j, done) if ph is None \
            else ph.wait("sample", wl.emit, st, j, done, workload=wl.tag)

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
        if item.policy.workload != self.wl.tag:
            return False
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
        if self._phases is None:
            self._fill(entry)
        else:
            self._phases.call("admit", self._fill, entry,
                              workload=self.wl.tag, ticket=item.ticket_id)
        obs = self.e._obs
        if obs is not None:
            obs.recorder.record(
                "admit", entry.t0, ticket=item.ticket_id,
                request=item.request.request_id, workload=self.wl.tag,
                tenant=item.policy.tenant, tick=entry.start_tick,
                lanes=list(entry.lanes))
        return entry

    def _fill(self, entry: _Entry) -> None:
        """Reset the entry's lane slice(s) for its request (every update is
        lane-local and in place). A guided pair's second stream takes the
        policy's ``negative_cond``, else the engine's ``null_cond``, else
        ``null_cond_like`` of the request's conditioning; both lanes get
        the pair's ``gscale`` and ``paired`` set."""
        e, wl = self.e, self.wl
        req, pol = entry.item.request, entry.item.policy
        cond = {k: torch.as_tensor(v) for k, v in req.cond.items()} \
            if wl.cond_in_state else {}
        if self.state is None:
            self.state = LS.init_workload_state(
                wl, self.W, cond, guidance="mixed" if self.paired else False,
                forecaster=e.forecaster, controller=e.controller,
                mesh=self.mesh)
        tau0 = float(wl.scfg.tau0 if pol.tau0 is None else pol.tau0)
        lane0 = entry.lanes[0]
        # draft_k is pair-equal: a guided pair drafts pair-coherently
        self._fill_lane(lane0, cond, tau0, entry)
        # a pair slot lies in one shard (the width is a multiple of 2·D)
        _, _, st, j = self._shard(lane0)
        if entry.streams == 2:
            nc = pol.negative_cond
            if nc is None:
                nc = e.null_cond if e.null_cond is not None \
                    else null_cond_like(wl.cfg, cond)
            self._fill_lane(lane0 + 1, nc, tau0, entry)
            st["gscale"][j:j + 2] = float(pol.guidance_scale)
            st["paired"][j:j + 2] = True
        elif self.paired:
            self._copies.put(j, [(st["paired"], False)])

    def _fill_lane(self, session_lane: int, cond: Dict[str, Any],
                   tau0: float, entry: _Entry) -> None:
        i, wl, st, lane = self._shard(session_lane)
        st["diffs"][:, :, :, lane] = 0
        vals = {"draft_k": entry.draft_k, "max_step": entry.item.steps,
                "n_anchors": 0, "anchor_step": -1, "gap": 1.0, "since": 0,
                "step": 0, "active": True, "tau0": tau0}
        if self.e.controller:
            # a controlled lane starts at the request's resolved knobs; a
            # controller-free lane gets the all-off row (bitwise inert)
            vals.update(CT.lane_values(
                entry.item.policy.controller, tau0=tau0,
                order=wl.scfg.taylor_order,
                max_draft_depth=self.e.max_draft_depth))
        self._copies.put(lane, [(st[k], v) for k, v in vals.items()]
                         + [(v, torch.as_tensor(cond[k])[0])
                            for k, v in st["cond"].items()])
        st = wl.fill_payload(st, lane, entry.item.request, entry.item.steps,
                             self._copies)
        if self.mesh is None:
            self.state = st
        else:
            self.state[i] = st
        self.e._host_syncs += wl.fill_syncs

    def advance(self) -> List[Tuple[_Entry, Result]]:
        """One scheduler tick: run the lane step, then complete every
        entry whose schedule finished. With a deep entry in flight a lane
        moves 0..K steps per tick, and a controlled entry adapts its
        ``draft_k`` on the device, so the tick's ``advanced`` counters are
        fetched (one host sync). Returns the completions."""
        now = self.e.clock.now()
        self._tick_s.append(now)
        before = self.step_fn.host_syncs
        ph = self._phases
        if ph is None:
            self.state, flags = self.step_fn(self.state)
        else:
            self.state, flags = self._traced_step(ph)
        self.e._host_syncs += self.step_fn.host_syncs - before
        self._flag_log.append(flags)
        self.tick += 1
        if self._acc is not None:
            # device ops only, no sync (a sharded step's flags are joined
            # on one device first)
            ph.call("obs.accumulate", self._acc.update,
                    LS.gather_flags(flags), workload=self.wl.tag)
        adv = None
        if any(e.draft_k > 1 or e.item.policy.controller is not None
               for e in self.entries()):
            adv = _advanced(flags) if ph is None \
                else ph.wait("advanced", _advanced, flags,
                             workload=self.wl.tag)
            self.e._host_syncs += 1
        completed: List[Tuple[_Entry, Result]] = []
        for entry in self.entries():
            if entry.first_tick_s is None:
                entry.first_tick_s = now
            # depth-1 entries advance exactly one step per tick
            entry.done += 1 if adv is None else int(adv[entry.lanes[0]])
            if entry.done < entry.item.steps:
                continue
            completed.append((entry, self._harvest(entry, True)))
            self._release(entry)
        self._gc_flags()
        return completed

    def _traced_step(self, ph) -> Tuple[Any, Any]:
        """The lane step inside its ``step`` span, counting the lanes it
        serves and its host seconds outside its waits."""
        tag = self.wl.tag
        ph.count("speca_lanes_occupied_total",
                 self.W - self.lane_entry.count(None), workload=tag)
        out = ph.call("step", self.step_fn, self.state, workload=tag)
        ph.count("speca_step_host_seconds_total", ph.self_s, workload=tag)
        return out

    def _harvest(self, entry: _Entry, completed: bool) -> Result:
        """``harvest``, inside its span when phases are recorded."""
        ph = self._phases
        if ph is None:
            return self.harvest(entry, completed)
        return ph.call("harvest", self.harvest, entry, completed,
                       workload=self.wl.tag, ticket=entry.item.ticket_id)

    def _release(self, entry: _Entry) -> None:
        k = entry.streams
        for lane in entry.lanes:
            self.lane_entry[lane] = None
        _, _, st, j = self._shard(entry.lanes[0])
        st["active"][j:j + k] = False
        if self.paired and k == 2:
            st["paired"][j:j + 2] = False

    def _fetch(self, t: int) -> Dict[str, np.ndarray]:
        if t not in self._flag_np:
            ph = self._phases
            self._flag_np[t] = _counters(self._flag_log[t]) if ph is None \
                else ph.wait("flags", _counters, self._flag_log[t],
                             n=len(LS.COUNTER_FLAGS))
        return self._flag_np[t]

    def _gc_flags(self) -> None:
        # ticks older than every in-flight entry's start are consumed
        live = [e.start_tick for e in self.entries()]
        horizon = min(live) if live else self.tick
        for t in range(horizon):
            self._flag_np.pop(t, None)
            self._flag_log[t] = None
            self._tick_s[t] = None

    def harvest(self, entry: _Entry, completed: bool) -> Result:
        """Materialise one entry's Result from its accumulated flags (the
        sample readback and flag fetch are the only device reads). Flags
        are read at the entry's first lane: a guided pair's are
        pair-equal, its one decision."""
        item, lane, k = entry.item, entry.lanes[0], entry.streams
        obs = self.e._obs
        accepts: List[bool] = []
        per_tick: List[Dict[str, int]] = []
        n_drafted, n_full = 0, 0
        for t in range(entry.start_tick, self.tick):
            f = self._fetch(t)
            ns, nf = int(f["n_spec"][lane]), int(f["full"][lane])
            nd = int(f["n_drafted"][lane])
            accepts.extend([True] * ns + [False] * nf)
            n_full += nf
            n_drafted += nd
            if obs is not None:
                # the trace's rows are the rows fetched above: no read
                per_tick.append({"n_spec": ns, "full": nf, "n_drafted": nd,
                                 "advanced": int(f["advanced"][lane])})
        finish_s = self.e.clock.now()
        timings = Timings(
            submit_s=item.submit_s, admit_s=entry.t0, finish_s=finish_s,
            first_tick_s=entry.first_tick_s, submit_tick=item.submit_tick,
            admit_tick=entry.start_tick, finish_tick=self.tick)
        res = Result(
            request_id=item.request.request_id,
            sample=self.emit(lane, entry.done),
            num_full=n_full, num_spec=entry.done - n_full,
            num_drafted=n_drafted,
            flops=n_full * k * self.wl.full_flops
            + n_drafted * k * self.wl.verify_flops,
            wall_s=finish_s - entry.t0, accepts=accepts,
            completed=completed, finish_tick=self.tick,
            deadline=item.policy.deadline, ticket_id=item.ticket_id,
            workload=self.wl.tag, tenant=item.policy.tenant,
            timings=timings)
        if obs is not None:
            self._observe_done(entry, res, timings, per_tick)
        return res

    def _observe_done(self, entry: _Entry, res: Result, timings: Timings,
                      per_tick: List[Dict[str, int]]) -> None:
        """Record one harvested request: its span Trace, the finish (or
        drop) event and the per-request metrics — host values only."""
        obs = self.e._obs
        item = entry.item
        wl, tenant = self.wl.tag, item.policy.tenant
        deep = entry.draft_k > 1 or item.policy.controller is not None
        obs.recorder.put_trace(build_trace(
            ticket_id=item.ticket_id, request_id=item.request.request_id,
            workload=wl, tenant=tenant, completed=res.completed,
            timings=timings, per_tick=per_tick, tick_times=self._tick_s,
            deep=deep))
        obs.recorder.record(
            "finish" if res.completed else "drop", timings.finish_s,
            ticket=item.ticket_id, request=item.request.request_id,
            workload=wl, tenant=tenant, tick=timings.finish_tick,
            num_full=res.num_full, num_spec=res.num_spec,
            num_drafted=res.num_drafted)
        m = obs.metrics
        kind = "completed" if res.completed else "dropped"
        m.counter(f"speca_requests_{kind}_total",
                  workload=wl, tenant=tenant).inc()
        # service in schedule-step decisions: the WFQ ledger's unit
        m.counter("speca_service_steps_total",
                  workload=wl, tenant=tenant).inc(res.num_full + res.num_spec)
        m.histogram("speca_accept_rate", edges=_RATE_EDGES,
                    workload=wl).observe(res.alpha)
        if res.num_drafted:
            m.histogram("speca_request_draft_accept_rate",
                        edges=_RATE_EDGES, workload=wl).observe(
                            res.draft_accept_rate)
        m.histogram("speca_queue_wait_s", edges=_SECONDS_EDGES,
                    workload=wl).observe(timings.queue_wait_s)
        m.histogram("speca_service_s", edges=_SECONDS_EDGES,
                    workload=wl).observe(timings.service_s)

    def drain(self) -> List[Tuple[_Entry, Result]]:
        """Tick-budget shutdown: harvest every in-flight entry as
        UNFINISHED — partial counters, ``completed=False``."""
        out = []
        for entry in self.entries():
            out.append((entry, self._harvest(entry, False)))
            self._release(entry)
        return out


class _FillCopies(HostCopies):
    """A lane fill's copies, each that blocks the host inside a
    ``wait.fill`` span that counts it: a read back (``item``: a host
    sync, counted on any device as ``host_syncs`` counts it), a move
    between the host and a card (``to``), and a write from the host onto
    a card that PyTorch makes as a copy (``put``; a number or a
    one-element host tensor written over more than one element is a
    fill, no copy)."""

    def __init__(self, phases) -> None:
        self.ph = phases

    def put(self, lane: int, writes: List[Tuple[torch.Tensor, Any]]
            ) -> None:
        n = sum(_copies_from_host(d, lane, v) for d, v in writes)
        if not n:
            super().put(lane, writes)
        else:
            self.ph.wait("fill", super().put, lane, writes, n=n)

    def to(self, x: torch.Tensor, device) -> torch.Tensor:
        dst = resolve_device(device)
        if x.device == dst or "cpu" not in (x.device.type, dst.type):
            return super().to(x, dst)
        return self.ph.wait("fill", super().to, x, dst)

    def item(self, x: torch.Tensor) -> Any:
        return self.ph.wait("fill", super().item, x)


def _copies_from_host(dst: torch.Tensor, lane: int, value: Any) -> bool:
    """Whether ``dst[lane] = value`` copies from the host onto a card."""
    if dst.device.type == "cpu":
        return False
    if isinstance(value, torch.Tensor):
        if value.device == dst.device:
            return False
        ndim = value.dim()
    else:
        ndim = np.ndim(value)
    # a one-element host value over a larger slice is a fill
    return not (ndim == 0 and dst.dim() > 1)


def _advanced(flags) -> np.ndarray:
    """A tick's ``advanced`` counters on the host (one device read)."""
    return LS.gather_flags(flags, ("advanced",))["advanced"].cpu().numpy()


def _counters(flags) -> Dict[str, np.ndarray]:
    """A tick's ``COUNTER_FLAGS`` on the host (one device read each)."""
    return {k: v.cpu().numpy()
            for k, v in LS.gather_flags(flags, LS.COUNTER_FLAGS).items()}


def _dropped_result(item: QueueItem) -> Result:
    """A queued request that never started (shutdown, tick budget)."""
    return Result(request_id=item.request.request_id, sample=None,
                  num_full=0, num_spec=0, flops=0.0, wall_s=0.0,
                  accepts=[], completed=False,
                  deadline=item.policy.deadline, ticket_id=item.ticket_id,
                  workload=item.policy.workload, tenant=item.policy.tenant)


def _admit_into(sessions: Dict[str, _Session],
                sched: Scheduler) -> List[_Entry]:
    """Pop fitting requests into the sessions' free slots until nothing
    fits: the scheduler decides the order, each workload's session the
    placement, and a request whose session is full never blocks one
    another session could admit (cross-workload backfill)."""
    def fits(item: QueueItem) -> bool:
        sess = sessions.get(item.policy.workload)
        return sess is not None and sess.fits(item)

    placed: List[_Entry] = []
    while len(sched):
        item = sched.pop(fits)
        if item is None:
            break
        placed.append(sessions[item.policy.workload].place(item))
    return placed


class SpeCaEngine:
    """Batched serving with per-lane speculative caching: diffusion lanes
    from the ``(cfg, params, dcfg, scfg)`` quartet, and any ``Workload``
    adapters in ``workloads`` (keyed by their tags), each in its own lane
    sessions.

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
    conditioning). controller: ``True`` builds the closed-loop step, so
    requests may carry a ``RequestPolicy.controller``; the default
    ``False`` builds the controller-free step and rejects such requests.
    scheduler: the admission order — ``"fifo"`` (default), ``"sjf"``,
    ``"edf"``, ``"wfq"`` or a ``Scheduler`` class, factory or instance.
    max_queue: bound on the lifecycle queue (``submit`` raises
    ``QueueFull`` beyond it; ``None`` = unbounded). default_policy: the
    policy of a request that carries none. lanes: the width of the
    lifecycle session the first ``submit`` starts. clock: the serving
    clock (``None`` = ``time.monotonic``; tests pass a ``FakeClock``).
    obs: ``False`` (default) runs no observability code; ``True`` builds
    an ``Observability`` on the engine clock; an ``Observability`` is
    adopted as-is and supplies the clock when ``clock`` is None.
    workloads: extra adapters keyed by tag, e.g. ``{"decode":
    DecodeWorkload(lm_cfg, lm_params, scfg, ...)}``; requests route by
    ``RequestPolicy.workload``. The diffusion quartet may be left out for
    an engine without diffusion lanes. ``device`` must be every
    workload's device. mesh: a ``LaneMesh``
    (``repro_torch.launch.mesh.make_lane_mesh``, or D shards on one card
    as ``LaneMesh([torch.device("cuda:0")] * D)``) with a ``"data"`` axis
    and ``device`` among its devices lane-shards every session over its D
    shards (see the module docstring); ``None`` serves on ``device``
    alone.
    """

    def __init__(self, cfg: Optional[ModelConfig] = None, params=None,
                 dcfg: Optional[DiffusionConfig] = None,
                 scfg: Optional[SpeCaConfig] = None, *,
                 draft_mode: str = "taylor",
                 accept_mode: str = "per_sample",
                 verify_backend: str = "fused",
                 noise_fn: Optional[NoiseFn] = None,
                 guidance: bool = False,
                 null_cond: Optional[Dict[str, Any]] = None,
                 scheduler: Any = "fifo",
                 max_queue: Optional[int] = None,
                 default_policy: Optional[RequestPolicy] = None,
                 max_draft_depth: int = 1, lanes: int = 4,
                 forecaster: Any = None, controller: bool = False,
                 obs: Union[bool, Observability] = False,
                 clock: Optional[Clock] = None,
                 workloads: Optional[Dict[str, Workload]] = None,
                 mesh: Optional[Any] = None,
                 device: DeviceLike = "cuda"):
        if accept_mode not in LS.ACCEPT_MODES:
            raise ValueError(f"unknown accept_mode {accept_mode!r}")
        if max_draft_depth < 1:
            raise ValueError(f"max_draft_depth must be >= 1, "
                             f"got {max_draft_depth}")
        if verify_backend not in LS.VERIFY_BACKENDS:
            raise ValueError(f"unknown verify_backend {verify_backend!r}")
        self._sched: Scheduler = make_scheduler(scheduler)   # fails fast
        self.device = resolve_device(device)
        if mesh is not None:
            if SH.LANE_AXIS not in mesh.axis_names:
                raise ValueError("serving mesh needs a 'data' axis "
                                 f"(got {mesh.axis_names})")
            if canonical_device(self.device) not in mesh.devices:
                raise ValueError(f"the engine's device {self.device} is "
                                 f"not a device of {mesh}")
        self.mesh = mesh
        # lanes divide into this many shards (1 without a mesh)
        self._lane_shards = SH.lane_shard_count(mesh)
        self.workloads: Dict[str, Workload] = {}
        if cfg is not None:
            if dcfg is None or scfg is None:
                raise ValueError("diffusion serving needs the full "
                                 "(cfg, params, dcfg, scfg) quartet")
            self.workloads["diffusion"] = DiffusionWorkload(
                cfg, params, dcfg, scfg, device=self.device,
                noise_fn=noise_fn)
        for tag, wl in (workloads or {}).items():
            if tag != wl.tag:
                raise ValueError(f"workloads key {tag!r} does not match "
                                 f"adapter tag {wl.tag!r}")
            if wl.device != self.device:
                raise ValueError(f"workload {tag!r} lives on {wl.device}, "
                                 f"the engine on {self.device}")
            self.workloads[tag] = wl
        if not self.workloads:
            raise ValueError("engine needs at least one workload: pass "
                             "the diffusion (cfg, params, dcfg, scfg) "
                             "quartet and/or workloads={...}")
        # the diffusion workload (None on an engine without diffusion lanes)
        self.workload: Optional[DiffusionWorkload] = \
            self.workloads.get("diffusion")
        if guidance and self.workload is None:
            raise ValueError("guidance=True is the legacy all-guided "
                             "diffusion mode; this engine serves no "
                             "diffusion workload")
        self.draft_mode = draft_mode
        self.accept_mode = accept_mode
        self.verify_backend = verify_backend
        self.guidance = bool(guidance)
        self.null_cond = null_cond
        self.scheduler_spec = scheduler
        self.max_queue = max_queue
        self.default_policy = default_policy
        self.max_draft_depth = int(max_draft_depth)
        self.default_lanes = lanes
        # resolved now, so a bad name fails at construction
        self.forecaster = get_forecaster(forecaster)
        self.controller = bool(controller)
        if isinstance(obs, Observability):
            self._obs: Optional[Observability] = obs
            self.clock: Clock = resolve_clock(
                clock if clock is not None else obs.clock)
        else:
            self.clock = resolve_clock(clock)
            self._obs = Observability(clock=self.clock) if obs else None
        self._phases = None if self._obs is None else self._obs.phases
        self._tick_count = 0    # engine-level tick index (series x-axis)
        self._lane_fns: Dict[Tuple[str, int, Any], LS.LaneStep] = {}
        self._host_syncs = 0
        # lifecycle state: one long-lived session per workload tag
        # (serve_batched keeps private ones), the Results by ticket and the
        # ticket states
        self._sessions: Dict[str, _Session] = {}
        self._seq = 0
        self._results: Dict[int, Result] = {}
        self._completion_order: List[int] = []
        self._ticket_status: Dict[int, str] = {}
        # tickets whose Result was release()d: not unknown, consumed
        self._released: Set[int] = set()

    @property
    def host_syncs(self) -> int:
        """Device syncs this engine's sessions have made so far: the lane
        step's branches (two per depth-1 tick, up to K+1 per chain tick;
        on a mesh one read of every shard's answer a branch), one
        ``advanced`` fetch per tick with a deep or controlled request in
        flight, and one per decode admission (the prefill's first token).
        Result and preview reads are not counted, nor, on a card, a lane
        fill's writes and copies from the host or the step's copy of β:
        with observability on, ``speca_device_waits_total{reason}``
        counts them too (``flags``, ``sample``, ``fill``, ``tau``), each
        wait under a ``wait.<reason>`` span of ``obs.phases``."""
        return self._host_syncs

    def resolve_policy(self, req: Request,
                       base: Optional[RequestPolicy] = None
                       ) -> RequestPolicy:
        """The request's effective policy — ``base`` (``submit(policy=)``),
        else its own, else the engine default — with the legacy
        ``Request.guidance_scale`` and the ``guidance=True`` engine mode
        folded in, validated against this engine."""
        pol = base if base is not None \
            else req.policy if req.policy is not None \
            else (self.default_policy or RequestPolicy())
        wl = self._workload(pol.workload)
        if req.guidance_scale is not None:
            pol = dataclasses.replace(
                pol, guidance_scale=float(req.guidance_scale))
        if self.guidance and wl.supports_pairing \
                and pol.guidance_scale is None:
            pol = dataclasses.replace(
                pol,
                guidance_scale=float(self.workload.dcfg.guidance_scale))
        if pol.guided and not wl.supports_pairing:
            raise ValueError(
                f"workload {wl.tag!r} does not support guided lane pairs: "
                "classifier-free guidance is a diffusion concept; submit "
                "decode requests unguided")
        dk = pol.draft_depth
        if dk is not None and not 1 <= int(dk) <= self.max_draft_depth:
            raise ValueError(
                f"draft_depth={dk} outside this engine's compiled chain "
                f"(1..max_draft_depth={self.max_draft_depth}); construct "
                "SpeCaEngine(max_draft_depth=K) to serve deeper drafts")
        if pol.controller is not None:
            if not isinstance(pol.controller, CT.ControllerPolicy):
                raise TypeError(
                    "RequestPolicy.controller must be a "
                    "repro_torch.core.controller.ControllerPolicy, got "
                    f"{type(pol.controller).__name__}")
            if not self.controller:
                raise ValueError(
                    "this engine built the controller-free step; construct "
                    "SpeCaEngine(controller=True) to serve closed-loop "
                    "requests")
        if not pol.weight > 0:
            raise ValueError(
                f"RequestPolicy.weight must be > 0, got {pol.weight}")
        return pol

    def _workload(self, tag: str) -> Workload:
        try:
            return self.workloads[tag]
        except KeyError:
            raise ValueError(
                f"unknown workload {tag!r} (this engine serves "
                f"{sorted(self.workloads)})") from None

    def _lane_step(self, W: int, mode: Any = False,
                   tag: str = "diffusion") -> LS.LaneStep:
        """The W-lane step of workload ``tag`` (built once per workload,
        width and program): ``mode`` ``False`` is the plain per-lane
        program, ``"mixed"`` the slot-width pair-mask program."""
        key = (tag, W, mode)
        if key not in self._lane_fns:
            self._lane_fns[key] = LS.build_workload_step(
                self._workload(tag), lanes=W, draft_mode=self.draft_mode,
                accept_mode=self.accept_mode,
                verify_backend=self.verify_backend, guidance=mode,
                max_draft_depth=self.max_draft_depth,
                forecaster=self.forecaster, controller=self.controller,
                mesh=self.mesh, phases=self._phases)
            if self._obs is not None:
                self._obs.metrics.counter("speca_programs_built_total",
                                          workload=tag).inc()
                self._obs.recorder.record("compile", self.clock.now(),
                                          workload=tag, width=W,
                                          mode=str(mode))
        return self._lane_fns[key]

    def lane_width(self, lanes: int, n_requests: int) -> int:
        """The width ``lanes`` serves ``n_requests`` requests of the
        engine-wide mode at (``_width_for`` of that many default
        requests: whole pairs under ``guidance=True``)."""
        pol = self.resolve_policy(Request(request_id=0, cond={}))
        return self._width_for(lanes, [pol] * max(n_requests, 1))

    def _width_for(self, lanes: int, policies: List[RequestPolicy]) -> int:
        """Slot-width sizing for a request list: clamped to the total
        stream demand, room for the widest request, and rounded up to a
        multiple of the widest request's streams times the lane-shard
        count (2·D as soon as any request is guided: pairs stay inside a
        shard)."""
        total = sum(p.streams for p in policies)
        widest = max(p.streams for p in policies)
        W = max(min(lanes, total), widest)
        mult = widest * self._lane_shards
        return -(-W // mult) * mult

    # --- lifecycle -----------------------------------------------------------
    @property
    def current_tick(self) -> int:
        return max((s.tick for s in self._sessions.values()), default=0)

    def pending(self) -> int:
        """Queued (not yet admitted) requests."""
        return len(self._sched)

    def in_flight(self) -> int:
        """Admitted, not yet completed requests."""
        return sum(len(s.entries()) for s in self._sessions.values())

    def start(self, *, lanes: Optional[int] = None,
              workload: str = "diffusion") -> None:
        """Start one workload's lifecycle session (else the first
        ``submit`` routed to it starts it at the engine's ``lanes``). A
        diffusion session is always pair-capable: the width rounds up to
        whole pairs (per shard: a multiple of 2·D), so guided and unguided
        submissions mix; a decode session is plain (a multiple of D)."""
        wl = self._workload(workload)
        if workload in self._sessions:
            raise RuntimeError(f"serving session for workload {workload!r} "
                               "already started; shutdown() first to resize")
        W = lanes if lanes is not None else self.default_lanes
        streams = 2 if wl.supports_pairing else 1
        mult = streams * self._lane_shards
        W = -(-max(W, streams) // mult) * mult
        self._sessions[workload] = _Session(self, W, paired=streams == 2,
                                            workload=wl)

    def submit(self, req: Request,
               policy: Optional[RequestPolicy] = None) -> Ticket:
        """Queue one request; returns a ``Ticket`` to poll or stream on.
        ``policy`` overrides ``req.policy`` (the legacy guidance fields
        still fold in); its ``workload`` routes the request to that
        workload's session. Raises ``QueueFull`` at ``max_queue``. A
        rejected request leaves no trace: the policy and the payload are
        validated before the session starts or a ticket is issued."""
        if self.max_queue is not None and len(self._sched) >= self.max_queue:
            raise QueueFull(f"admission queue at max_queue={self.max_queue}")
        pol = self.resolve_policy(req, base=policy)
        wl = self.workloads[pol.workload]
        steps = pol.steps(wl.num_steps)
        wl.validate_request(req, steps)
        if pol.workload not in self._sessions:
            self.start(workload=pol.workload)
        sess = self._sessions[pol.workload]
        item = QueueItem(seq=self._seq, request=req, policy=pol, steps=steps,
                         submit_tick=sess.tick, ticket_id=self._seq,
                         submit_s=self.clock.now())
        self._seq += 1
        self._sched.push(item)
        self._ticket_status[item.ticket_id] = "queued"
        if self._obs is not None:
            self._obs.recorder.record(
                "submit", item.submit_s, ticket=item.ticket_id,
                request=req.request_id, workload=pol.workload,
                tenant=pol.tenant, steps=steps)
        return Ticket(ticket_id=item.ticket_id, request_id=req.request_id,
                      submit_tick=item.submit_tick)

    def tick(self, n: int = 1) -> List[Result]:
        """Advance the lifecycle sessions up to ``n`` scheduler ticks
        (admission, then one lane step of every busy session); returns
        the Results completed on the way. Stops early when the engine is
        idle."""
        done: List[Result] = []
        ph = self._phases
        for _ in range(n):
            if not self._sessions:
                break
            if ph is None:
                busy = self._tick_once(done)
            else:
                ph.tick = self._tick_count
                busy = ph.call("tick", self._tick_once, done)
            if not busy:
                break
        return done

    def _tick_once(self, done: List[Result]) -> bool:
        """Admission, then one lane step of every busy session, adding
        the completions to ``done``; False when no session was busy."""
        if self._obs is not None:
            # before admission, so a burst shows at its full height
            self._obs_tick_sample()
        for entry in _admit_into(self._sessions, self._sched):
            self._ticket_status[entry.item.ticket_id] = "running"
        busy = [s for s in self._sessions.values() if s.busy()]
        if not busy:
            return False
        self._tick_count += 1
        for sess in busy:
            for _entry, res in sess.advance():
                self._record(res)
                done.append(res)
        return True

    def _obs_tick_sample(self) -> None:
        """One sample of the queue state per engine tick (host integers)."""
        m, t = self._obs.metrics, self._tick_count
        m.series("speca_queue_depth").append(t, len(self._sched))
        m.series("speca_in_flight").append(t, self.in_flight())

    def _record(self, res: Result) -> None:
        self._results[res.ticket_id] = res
        self._completion_order.append(res.ticket_id)
        # "dropped" for a request the engine did not finish; its Result
        # stays pollable and releasable
        self._ticket_status[res.ticket_id] = \
            "done" if res.completed else "dropped"

    @staticmethod
    def _tid(ticket: Union[Ticket, int]) -> int:
        return ticket.ticket_id if isinstance(ticket, Ticket) else ticket

    def poll(self, ticket: Union[Ticket, int]) -> Optional[Result]:
        """The ticket's Result if it has completed, else None; never
        advances the engine and never evicts the Result."""
        return self._results.get(self._tid(ticket))

    def release(self, *tickets: Union[Ticket, int]) -> None:
        """Drop completed tickets' Results (samples included) and status;
        a long-lived engine releases each ticket once consumed, or host
        memory grows by one sample per request."""
        tids = {self._tid(t) for t in tickets}
        undone = [t for t in tids if t not in self._results]
        if undone:
            raise KeyError(f"tickets {sorted(undone)} have no completed "
                           "Result to release")
        for tid in tids:
            self._results.pop(tid)
            self._ticket_status.pop(tid, None)
            self._released.add(tid)
        # _completion_order keeps its entries so an open stream() cursor
        # stays valid; streams skip released tickets

    def status(self, ticket: Union[Ticket, int]) -> str:
        """``"queued"``, ``"running"``, ``"done"``, ``"dropped"`` (drained
        unfinished or never started at ``shutdown()``; Result pollable
        with ``completed=False``), ``"released"`` or ``"unknown"``."""
        tid = self._tid(ticket)
        if tid in self._released:
            return "released"
        return self._ticket_status.get(tid, "unknown")

    def result(self, ticket: Union[Ticket, int],
               max_ticks: Optional[int] = None) -> Result:
        """Run scheduler ticks until the ticket completes and return its
        Result; raises ``KeyError`` if the engine goes idle first (an
        unknown ticket) and ``TimeoutError`` when ``max_ticks`` runs
        out."""
        tid = self._tid(ticket)
        budget = max_ticks
        while tid not in self._results:
            if budget is not None and budget <= 0:
                raise TimeoutError(f"ticket {tid} incomplete after the "
                                   "tick budget")
            if self._idle():
                raise KeyError(f"ticket {tid} is not pending on this "
                               "engine")
            self.tick()
            if budget is not None:
                budget -= 1
        return self._results[tid]

    def _idle(self) -> bool:
        return not (len(self._sched)
                    or any(s.busy() for s in self._sessions.values()))

    def results(self, tickets: List[Union[Ticket, int]]) -> List[Result]:
        """``result`` over a ticket list, in its order."""
        return [self.result(t) for t in tickets]

    def _previews(self, want: Optional[Set[int]]) -> List[Preview]:
        """Snapshots of the wanted running entries: pure reads of their
        lanes' state. A deep entry that has not advanced yet has
        nothing to show."""
        return [Preview(ticket_id=e.item.ticket_id,
                        request_id=e.item.request.request_id, tick=sess.tick,
                        step=min(e.done, e.item.steps),
                        sample=sess.emit(e.lanes[0], e.done),
                        workload=sess.wl.tag)
                for sess in self._sessions.values() for e in sess.entries()
                if (want is None or e.item.ticket_id in want) and e.done > 0]

    def stream(self, tickets: Optional[List[Union[Ticket, int]]] = None,
               *, previews: bool = False
               ) -> Iterator[Union[Result, Preview]]:
        """Yield Results in completion order as the engine runs.
        ``tickets=None`` streams the completions from this call on until
        the engine is idle; a ticket list streams exactly those tickets,
        already completed ones included, and raises ``KeyError`` up front
        for a ticket this engine never issued. A released ticket counts
        as consumed. Submissions made while streaming are admitted.
        ``previews=True`` also yields a :class:`Preview` of each wanted
        running request after every tick; final Results are bitwise the
        same either way."""
        want = None if tickets is None else {self._tid(t) for t in tickets}
        if want is not None:
            unknown = [t for t in want if t not in self._ticket_status
                       and t not in self._released]
            if unknown:
                raise KeyError(f"tickets {sorted(unknown)} are not known "
                               "to this engine")
        emitted = len(self._completion_order) if want is None else 0
        while True:
            while emitted < len(self._completion_order):
                tid = self._completion_order[emitted]
                emitted += 1
                if (want is None or tid in want) and tid in self._results:
                    yield self._results[tid]
            if want is not None and all(
                    t in self._results or t in self._released
                    for t in want):
                return
            if self._idle():
                return
            self.tick()
            if previews:
                # entries still in flight after the tick; its completions
                # are yielded as Results by the loop above
                yield from self._previews(want)

    def shutdown(self) -> List[Result]:
        """Stop the lifecycle session now: in-flight requests come back
        ``completed=False`` with partial counters, queued ones never
        started; the session is discarded (the next ``submit`` starts a
        new one). Returns the drained Results."""
        out: List[Result] = []
        for sess in self._sessions.values():
            for _entry, res in sess.drain():
                self._record(res)
                out.append(res)
        for item in self._sched.drain():
            res = _dropped_result(item)
            self._record(res)
            out.append(res)
            if self._obs is not None:
                self._obs.recorder.record(
                    "drop", self.clock.now(), ticket=item.ticket_id,
                    request=item.request.request_id,
                    workload=item.policy.workload, tenant=item.policy.tenant,
                    started=False)
        if self._obs is not None:
            # the sessions own their accumulators: flush before discarding
            self._flush_lane_metrics(self._sessions.values())
        self._sessions = {}
        return out

    # --- observability -------------------------------------------------------
    @property
    def obs(self) -> Optional[Observability]:
        """The engine's observability bundle (None when obs is off)."""
        return self._obs

    def _flush_lane_metrics(self, sessions) -> None:
        for sess in sessions:
            sess._acc.flush_into(self._obs.metrics, workload=sess.wl.tag)

    def metrics_snapshot(self) -> List[Dict[str, Any]]:
        """Flush the lifecycle sessions' lane accumulators (the one device
        read observability adds, paid only here) and return the metrics
        snapshot. Raises ``RuntimeError`` when obs is off."""
        if self._obs is None:
            raise RuntimeError("engine constructed with obs=False — "
                               "pass SpeCaEngine(obs=True) for metrics")
        self._flush_lane_metrics(self._sessions.values())
        return self._obs.metrics.snapshot()

    def trace(self, ticket: Union[Ticket, int]) -> Optional[Trace]:
        """The completed ticket's span Trace from the flight recorder
        (None when unknown, evicted or still in flight). Raises
        ``RuntimeError`` when obs is off."""
        if self._obs is None:
            raise RuntimeError("engine constructed with obs=False — "
                               "pass SpeCaEngine(obs=True) for traces")
        return self._obs.recorder.trace(self._tid(ticket))

    # --- one-shot serving ----------------------------------------------------
    def serve_batched(self, requests: List[Request], *, lanes: int = 4,
                      max_ticks: Optional[int] = None,
                      scheduler: Any = None) -> List[Result]:
        """Serve a request list to completion through private sessions (one
        per workload in the list, each sized to its own requests) and a
        fresh queue of the engine's scheduler (or ``scheduler``).

        Packs up to ``lanes`` concurrent lanes per lane step (a guided
        request takes a pair of them); finished slots are refilled from
        the queue immediately, with backfill. Per-request accept
        trajectories are identical at every lane width — only the packing
        differs. ``max_ticks`` bounds the scheduler ticks: requests still
        in flight come back ``completed=False`` with partial counters,
        queued ones with ``sample=None``.
        """
        if not requests:
            return []
        pols = [self.resolve_policy(r) for r in requests]
        steps = [p.steps(self.workloads[p.workload].num_steps) for p in pols]
        for req, pol, n in zip(requests, pols, steps):
            self.workloads[pol.workload].validate_request(req, n)
        sessions: Dict[str, _Session] = {}
        for tag in sorted({p.workload for p in pols}):
            mine = [p for p in pols if p.workload == tag]
            sessions[tag] = _Session(
                self, self._width_for(max(lanes, 1), mine),
                paired=any(p.guided for p in mine),
                workload=self.workloads[tag])
        sched = fresh_scheduler(self.scheduler_spec if scheduler is None
                                else scheduler)
        # keyed on queue position, so duplicate ids get their own Result
        for i, (r, p, n) in enumerate(zip(requests, pols, steps)):
            sched.push(QueueItem(seq=i, request=r, policy=p, steps=n,
                                 ticket_id=i, submit_s=self.clock.now()))
        results: Dict[int, Result] = {}
        while len(sched) or any(s.busy() for s in sessions.values()):
            if max_ticks is not None and max(
                    s.tick for s in sessions.values()) >= max_ticks:
                break
            if self._phases is not None:
                self._phases.tick = max(s.tick for s in sessions.values())
            _admit_into(sessions, sched)
            for sess in sessions.values():
                if sess.busy():
                    for entry, res in sess.advance():
                        results[entry.item.seq] = res
        for sess in sessions.values():
            for entry, res in sess.drain():
                results[entry.item.seq] = res
        for item in sched.drain():
            results[item.seq] = _dropped_result(item)
        if self._obs is not None:
            # the private sessions report before they are discarded
            self._flush_lane_metrics(sessions.values())
        return [results[i] for i in range(len(requests))]

    def serve(self, requests: List[Request], *, lanes: int = 1,
              max_ticks: Optional[int] = None) -> List[Result]:
        """``serve_batched`` at the reference's ``serve`` default width."""
        return self.serve_batched(requests, lanes=max(lanes, 1),
                                  max_ticks=max_ticks)

    def run_request(self, req: Request) -> Result:
        """Serve one request alone: on one lane, or one pair if guided (the
        per-sample reference)."""
        return self.serve_batched([req], lanes=1)[0]

    def kernel_sources(self) -> Tuple[str, ...]:
        """The kernel sources (``kernels/build.py``) this engine's lane
        step launches."""
        refresh = "spectral_update_lanes" \
            if self.forecaster.name == "spectral" else "taylor_update_lanes"
        if self.max_draft_depth > 1:
            return ("taylor_predict_chain", "lane_rollback", "verify_accept",
                    refresh)
        return ("taylor_predict_lanes", "verify_accept", refresh)

    def warmup(self, cond: Dict[str, Any], *, lanes: int = 1,
               mixed: bool = False, workload: str = "diffusion") -> None:
        """Prepare workload ``workload``'s serving step for ``lanes``
        outside any timed window: on the card, build and load every kernel
        the step launches (one nvcc per missing source, in parallel); then
        serve dummy requests end to end at that width (the allocator,
        cuBLAS and both branches warm up). ``cond`` is a conditioning
        template with leading axis 1 (decode: ``{"tokens": [1, P]}``).
        The default warms the engine-mode program (plain, or all-guided
        pairs under ``guidance=True``); ``mixed=True`` warms only the
        slot-width program, with a guided + unguided dummy mix — the one
        the lifecycle session and mixed ``serve_batched`` batches run.
        ``mixed`` is a pair-slot notion, ignored for a workload without
        pairs."""
        wl = self._workload(workload)
        if self.device.type == "cuda":
            from repro_torch.kernels import build
            names = list(self.kernel_sources())
            build.build_all(names)
            for name in names:
                build.library(name)
        lanes = max(lanes, 1)
        if not wl.supports_pairing:
            pol = RequestPolicy(workload=workload)
            self.serve_batched([Request(request_id=-1 - i, cond=cond,
                                        seed=90_000 + i, policy=pol)
                                for i in range(lanes)], lanes=lanes)
            return
        streams = 2 if self.guidance else 1
        if not mixed or self.guidance:
            n = max(-(-lanes // streams), 1)
            self.serve([Request(request_id=-1 - i, cond=cond,
                                seed=90_000 + i) for i in range(n)],
                       lanes=lanes)
        if mixed and not self.guidance:
            gs = float(self.workload.dcfg.guidance_scale) or 1.0
            greqs = [Request(request_id=-100, cond=cond, seed=90_100,
                             policy=RequestPolicy(guidance_scale=gs))] \
                + [Request(request_id=-101 - i, cond=cond, seed=90_101 + i)
                   for i in range(max(lanes - 2, 0))]
            self.serve_batched(greqs, lanes=lanes)


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
