"""Per-request lifecycle timings, trace spans and the flight recorder.

One serving request walks submit → admit → N scheduler ticks of
draft/verify (± rollback, ± refresh) → finish:

  * ``Timings`` — the request's lifecycle timestamps (engine-clock
    seconds) and tick indices, on every ``Result`` whether or not
    observability is on (a handful of host clock reads).
  * ``Span`` / ``Trace`` — the span timeline of one request: ``queued``
    (submit→admit), ``running`` (admit→finish) and one span per
    scheduler tick it was in flight, named by the phases that tick ran
    for its lane (``draft+verify``, ``draft+verify+refresh``,
    ``draft+verify+rollback+refresh``, bare ``refresh`` for a cold or
    rejected tick, ``stall`` when the lane did not move), with the
    tick's counters as attrs.
  * ``FlightRecorder`` — a bounded ring of lifecycle events
    (submit/admit/finish/drop/compile) and a bounded LRU of completed
    ``Trace`` objects by ticket (``SpeCaEngine.trace(ticket)``), so a
    long-lived server holds O(capacity) state, not O(requests served).

Everything here is host bookkeeping over rows the engine fetches anyway
(the per-tick flags at a request's completion) and one host clock stamp
per tick: no device read is added.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Any, Deque, Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Timings:
    """Lifecycle timestamps (engine-clock seconds) and tick indices of one
    request. ``first_tick_s`` is None when the request was drained before
    any scheduler tick dispatched it. The ticks are the owning session's:
    ``submit_tick`` when it was queued, ``admit_tick`` when it entered its
    lanes, ``finish_tick`` after which it completed."""

    submit_s: float
    admit_s: float
    finish_s: float
    first_tick_s: Optional[float] = None
    submit_tick: int = 0
    admit_tick: int = 0
    finish_tick: int = 0

    @property
    def queue_wait_s(self) -> float:
        """Seconds spent in the admission queue (submit → lane fill)."""
        return self.admit_s - self.submit_s

    @property
    def service_s(self) -> float:
        """Seconds occupying lanes (fill → harvest)."""
        return self.finish_s - self.admit_s

    @property
    def total_s(self) -> float:
        return self.finish_s - self.submit_s

    @property
    def service_ticks(self) -> int:
        """Scheduler ticks the request occupied lanes for."""
        return self.finish_tick - self.admit_tick


@dataclasses.dataclass(frozen=True)
class Span:
    """One interval of a request's timeline, in engine-clock seconds."""

    name: str
    t0: float
    t1: float
    tick0: int
    tick1: int
    attrs: Tuple[Tuple[str, Any], ...] = ()

    @property
    def dur_s(self) -> float:
        return self.t1 - self.t0

    @property
    def attr_dict(self) -> Dict[str, Any]:
        return dict(self.attrs)


@dataclasses.dataclass(frozen=True)
class Trace:
    """The full span timeline of one completed (or drained) request."""

    ticket_id: int
    request_id: int
    workload: str
    tenant: str
    completed: bool
    timings: Timings
    spans: Tuple[Span, ...]

    def tick_spans(self) -> List[Span]:
        return [s for s in self.spans
                if s.name not in ("queued", "running")]


def _tick_span_name(n_spec: int, n_drafted: int, full: int,
                    deep: bool) -> str:
    """The phase composition one scheduler tick executed for a lane.

    ``rollback`` only appears for deep-drafting lanes (``draft_k`` > 1):
    a depth-1 rejection never advanced the payload, so there is nothing
    to roll back — the closing full forward IS the service.
    """
    phases = []
    if n_drafted > 0:
        phases += ["draft", "verify"]
        if deep and n_spec < n_drafted:
            phases.append("rollback")
    if full > 0:
        phases.append("refresh")
    return "+".join(phases) if phases else "stall"


def build_trace(*, ticket_id: int, request_id: int, workload: str,
                tenant: str, completed: bool, timings: Timings,
                per_tick: List[Dict[str, int]],
                tick_times: List[Optional[float]],
                deep: bool) -> Trace:
    """Assemble a request's Trace from its per-tick counters.

    ``per_tick`` holds one ``{"n_spec", "n_drafted", "full",
    "advanced"}`` dict per scheduler tick in ``[admit_tick,
    finish_tick)`` — exactly the rows the engine's harvest already
    fetched for accounting, so building the trace adds no device reads.
    ``tick_times[t]`` is the host clock stamp at the START of session
    tick ``t`` (the engine records one per tick); a tick span ends at
    the next tick's stamp, the last one at ``timings.finish_s``.
    """
    spans: List[Span] = [
        Span("queued", timings.submit_s, timings.admit_s,
             timings.submit_tick, timings.admit_tick),
        Span("running", timings.admit_s, timings.finish_s,
             timings.admit_tick, timings.finish_tick),
    ]
    t0_tick, t1_tick = timings.admit_tick, timings.finish_tick
    for j, row in enumerate(per_tick):
        t = t0_tick + j
        start = tick_times[t] if t < len(tick_times) \
            and tick_times[t] is not None else timings.admit_s
        nxt = t + 1
        if nxt < t1_tick and nxt < len(tick_times) \
                and tick_times[nxt] is not None:
            end = tick_times[nxt]
        else:
            end = timings.finish_s
        spans.append(Span(
            _tick_span_name(row.get("n_spec", 0), row.get("n_drafted", 0),
                            row.get("full", 0), deep),
            start, end, t, t + 1,
            attrs=tuple(sorted(row.items()))))
    return Trace(ticket_id=ticket_id, request_id=request_id,
                 workload=workload, tenant=tenant, completed=completed,
                 timings=timings, spans=tuple(spans))


class FlightRecorder:
    """Bounded host-side recorder: an event ring + a trace LRU.

    ``record`` appends one event dict to a drop-oldest ring
    (``capacity`` events; ``dropped`` counts evictions). ``put_trace``
    retains completed traces up to ``trace_capacity``, evicting the
    oldest — ``trace(ticket_id)`` looks one up. Both bounds exist so a
    serving process that never restarts holds O(capacity) observability
    state, not O(requests served).
    """

    def __init__(self, capacity: int = 4096,
                 trace_capacity: int = 256) -> None:
        if capacity < 1 or trace_capacity < 1:
            raise ValueError("FlightRecorder capacities must be >= 1")
        self.capacity = int(capacity)
        self.trace_capacity = int(trace_capacity)
        self._events: Deque[Dict[str, Any]] = deque(maxlen=capacity)
        self._traces: "OrderedDict[int, Trace]" = OrderedDict()
        self.dropped = 0
        self._seq = 0

    def record(self, kind: str, t: float, **fields: Any) -> None:
        if len(self._events) == self.capacity:
            self.dropped += 1
        ev = {"seq": self._seq, "kind": kind, "s": float(t)}
        ev.update(fields)
        self._seq += 1
        self._events.append(ev)

    def events(self) -> List[Dict[str, Any]]:
        return list(self._events)

    def put_trace(self, trace: Trace) -> None:
        self._traces[trace.ticket_id] = trace
        self._traces.move_to_end(trace.ticket_id)
        while len(self._traces) > self.trace_capacity:
            self._traces.popitem(last=False)

    def trace(self, ticket_id: int) -> Optional[Trace]:
        return self._traces.get(ticket_id)

    def traces(self) -> List[Trace]:
        return list(self._traces.values())
