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
  * ``PhaseRecorder`` — a bounded ring of the engine's phase spans (what
    the host did inside each tick: admission, the lane step and its
    kernel requests and forwards, harvest, and every wait on the device
    as ``wait.<reason>``) and the counters kept at the same boundaries.

Everything here is host bookkeeping over rows the engine fetches anyway
(the per-tick flags at a request's completion) and host clock reads: no
device read is added.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple


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
    """One interval of a request's timeline, or one engine phase, in
    engine-clock seconds. A phase span (``PhaseRecorder``) also carries
    its own id, its parent's id (None at the top), the session's workload
    tag and, where one request caused it, the ticket id; its ticks are
    the engine tick it ran in, ``tick1 = tick0 + 1``."""

    name: str
    t0: float
    t1: float
    tick0: int
    tick1: int
    attrs: Tuple[Tuple[str, Any], ...] = ()
    span_id: Optional[int] = None
    parent: Optional[int] = None
    workload: Optional[str] = None
    ticket: Optional[int] = None

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


# the counters the engine keeps beside its phase spans (``PhaseRecorder``)
PHASE_METRICS = ("speca_device_waits_total", "speca_wait_seconds_total",
                 "speca_full_forward_calls_total",
                 "speca_spec_forward_calls_total",
                 "speca_lanes_occupied_total",
                 "speca_step_host_seconds_total")


class PhaseRecorder:
    """The engine's phase spans, in a bounded drop-oldest ring
    (``capacity`` spans; ``dropped`` counts evictions), and the counters
    kept at the same boundaries, in ``metrics``.

    ``call(name, fn, *args)`` runs ``fn`` inside a span; spans nest, so a
    span's parent is the innermost one open when it starts, and it takes
    its parent's workload and ticket unless given its own. ``wait(reason,
    fn, *args, n=)`` is a ``wait.<reason>`` span around a call that blocks
    the host on the device: it adds ``n`` to
    ``speca_device_waits_total{reason}`` and its seconds to
    ``speca_wait_seconds_total{reason}``, and keeps ``n`` in the span's
    ``attrs``. After a span closes,
    ``self_s`` holds its seconds outside the wait spans under it. Every
    span reads ``clock`` twice and nothing else: no device read, no sync,
    no event. ``tick`` is the engine tick the next spans belong to."""

    def __init__(self, clock, metrics, capacity: int = 16384) -> None:
        if capacity < 1:
            raise ValueError("PhaseRecorder capacity must be >= 1")
        self.clock = clock
        self.metrics = metrics
        self.capacity = int(capacity)
        self._ring: Deque[tuple] = deque(maxlen=self.capacity)
        self.dropped = 0
        self.tick = 0
        self.self_s = 0.0
        # open spans, innermost last: [id, name, t0, workload, ticket,
        # seconds of the waits under it, waits counted]
        self._open: List[list] = []
        self._next_id = 0
        self._counters: Dict[tuple, Any] = {}

    def call(self, name: str, fn: Callable, *args: Any,
             workload: Optional[str] = None,
             ticket: Optional[int] = None) -> Any:
        self._push(name, workload, ticket, 0)
        try:
            return fn(*args)
        finally:
            self._pop()

    def wait(self, reason: str, fn: Callable, *args: Any, n: int = 1,
             workload: Optional[str] = None) -> Any:
        self._push("wait." + reason, workload, None, n)
        try:
            return fn(*args)
        finally:
            dt = self._pop()
            self.count("speca_device_waits_total", n, reason=reason)
            self.count("speca_wait_seconds_total", dt, reason=reason)

    def count(self, name: str, v: float = 1.0, **labels: Any) -> None:
        """Add ``v`` to counter ``name{labels}`` of ``metrics``."""
        key = (name,) + tuple(labels.items())
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = self.metrics.counter(name, **labels)
        c.inc(v)

    def _push(self, name: str, workload: Optional[str],
              ticket: Optional[int], n: int) -> None:
        if self._open:
            up = self._open[-1]
            workload = up[3] if workload is None else workload
            ticket = up[4] if ticket is None else ticket
        self._open.append([self._next_id, name, self.clock.now(), workload,
                           ticket, 0.0, n])
        self._next_id += 1

    def _pop(self) -> float:
        sid, name, t0, workload, ticket, waited, n = self._open.pop()
        t1 = self.clock.now()
        dt = t1 - t0
        is_wait = name.startswith("wait.")
        parent = None
        if self._open:
            up = self._open[-1]
            parent = up[0]
            up[5] += dt if is_wait else waited
        self.self_s = 0.0 if is_wait else dt - waited
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append((name, t0, t1, self.tick, sid, parent, workload,
                           ticket, n))
        return dt

    def spans(self, since: Optional[float] = None) -> List[Span]:
        """The retained spans in the order they closed (a parent after
        its children); with ``since``, only those ending at or after
        it."""
        rows: List[tuple] = []
        for row in reversed(self._ring):
            if since is not None and row[2] < since:
                break
            rows.append(row)
        return [Span(name, t0, t1, tick, tick + 1,
                     (("n", n),) if name.startswith("wait.") else (),
                     span_id=sid, parent=parent, workload=wl, ticket=ticket)
                for name, t0, t1, tick, sid, parent, wl, ticket, n
                in reversed(rows)]
