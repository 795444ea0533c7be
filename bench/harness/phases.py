"""The traced run seen from inside the program: the engine's phase spans
and counters (``SpeCaEngine(obs=True)``: ``engine.obs.phases`` and
``engine.obs.metrics``) laid onto the profiled slice.

:class:`PhaseTracer` is the benchmark's :class:`~bench.harness.trace.
Tracer`, every number of which it keeps, plus:

* the program's counters, read at the window's open (construction, after
  set-up's device sync) and at its close (:meth:`close`, after the
  window's): each read flushes the engine's lane accumulators, the one
  device read observability adds, outside the window;
* two clock anchors bracketing the slice: the spans' clock read
  (:func:`span_clock`), ``torch.cuda.synchronize()``, the clock read
  again, once as the slice starts and once as it ends (each the
  narrowest of three such brackets, unevenly spaced, after a sync that
  drains the device). The profile's ``cudaDeviceSynchronize`` runtime
  event of each anchor gives the offset between the spans' clock and the
  profiler's time base, within the bracket's width; the two offsets give
  the drift and a linear map (:class:`ClockMap`). Nothing assumes the
  profiler reads the spans' clock;
* the slice's raw intervals (the device's busy union, its idle gaps, the
  host's runtime calls) and the engine spans mapped onto them
  (:class:`PhaseSlice`): each idle gap is named by the path of engine
  spans under its middle in front of the runtime call's name
  (``step|host``, ``harvest>wait.sample|cudaMemcpyAsync``, ``outside|…``
  where no engine span covers it), and the readers of
  ``bench/metrics/`` ask which share of the idle time lies under which
  spans.

Without observability on the engine the counters and spans are None, and
the readers that need them find nothing to read.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from bench.harness.trace import Slice, Tracer, _union

Interval = Tuple[float, float]
SYNC = "cudaStreamSynchronize"      # the engine's waits on its stream
ANCHOR = "cudaDeviceSynchronize"    # torch.cuda.synchronize()
MARGIN_US = 20.0


@dataclasses.dataclass
class Anchor:
    """One bracketed ``torch.cuda.synchronize()``: engine-clock seconds
    before and after (``c0``, ``c1``), and its runtime event on the
    profiler's base in µs (``p0``, ``p1``), once found."""
    c0: float
    c1: float
    p0: Optional[float] = None
    p1: Optional[float] = None

    @property
    def offset_us(self) -> float:
        """Profiler µs minus engine-clock µs at the sync's middle."""
        return 0.5 * (self.p0 + self.p1) - 0.5e6 * (self.c0 + self.c1)

    @property
    def width_us(self) -> float:
        """How far the offset may be wrong: half of what the bracket
        holds beyond the runtime event."""
        return max(0.0, 0.5 * ((self.c1 - self.c0) * 1e6
                               - (self.p1 - self.p0)))


class ClockMap:
    """Engine-clock seconds to profiler µs, linear through two anchors."""

    def __init__(self, a: Anchor, b: Anchor) -> None:
        self.drift_us = b.offset_us - a.offset_us
        self._scale = 1e6 + self.drift_us / (0.5 * (b.c0 + b.c1 - a.c0
                                                     - a.c1))
        self._c, self._p = 0.5 * (a.c0 + a.c1), 0.5 * (a.p0 + a.p1)

    def __call__(self, t: float) -> float:
        return self._p + (t - self._c) * self._scale


@dataclasses.dataclass
class MappedSpan:
    name: str
    a: float                    # profiler µs
    b: float
    path: str                   # names from the top, "tick" left out
    n: int = 0                  # waits a ``wait.*`` span counted


def map_spans(spans, cmap: ClockMap) -> List[MappedSpan]:
    """Phase spans (``repro_torch.obs.Span``) onto the profiler's base,
    each with the path of names from its outermost ancestor down."""
    by_id = {s.span_id: s for s in spans}

    def path(s) -> str:
        names = []
        while s is not None:
            if s.name != "tick":
                names.append(s.name)
            s = by_id.get(s.parent)
        return ">".join(reversed(names)) or "tick"

    return [MappedSpan(s.name, cmap(s.t0), cmap(s.t1), path(s),
                       dict(s.attrs).get("n", 0))
            for s in spans]


def overlap(xs: List[Interval], ys: List[Interval]) -> float:
    """Total length of the intersection of two sorted, disjoint interval
    lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        lo = max(xs[i][0], ys[j][0])
        hi = min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def innermost(spans: List[MappedSpan], t: float) -> Optional[MappedSpan]:
    """The shortest span holding ``t`` (spans nest, so the deepest)."""
    inner = [s for s in spans if s.a <= t <= s.b]
    return min(inner, key=lambda s: s.b - s.a) if inner else None


@dataclasses.dataclass
class PhaseSlice(Slice):
    """The benchmark's slice plus the intervals the phase readers need,
    all in profiler µs."""
    gaps: List[Interval] = dataclasses.field(default_factory=list)
    spans: List[MappedSpan] = dataclasses.field(default_factory=list)
    syncs: List[Interval] = dataclasses.field(default_factory=list)
    anchors: List[Anchor] = dataclasses.field(default_factory=list)
    drift_us: Optional[float] = None
    anchor_events: int = 0          # cudaDeviceSynchronize events seen
    syncs_bounds: Interval = (0.0, 0.0)     # where syncs were taken

    def idle_share_under(self, names: Iterable[str]) -> Optional[float]:
        """% of the slice's device idle time that lies under a span of
        one of ``names``; None without spans or idle time."""
        idle = sum(b - a for a, b in self.gaps)
        if not self.spans or idle <= 0:
            return None
        names = set(names)
        cover = _union([(s.a, s.b) for s in self.spans if s.name in names])
        return 100.0 * overlap(self.gaps, cover) / idle

    def sync_counts(self) -> Dict[str, List[int]]:
        """By wait reason: [waits the program counted, the slice's
        ``cudaStreamSynchronize`` events its spans hold], over the
        ``wait.*`` spans that lie wholly in the slice. Each sync goes to
        one span: the one under its middle, else the nearest within
        ``MARGIN_US`` (waits come back to back, as a harvest's fetches
        do, so a margin alone would hand a sync to two). On a card every
        blocking copy or read is one such event, so the two agree where
        the program counts each wait where it happens."""
        lo, hi = self.syncs_bounds
        waits = sorted((s for s in self.spans if s.name.startswith("wait.")
                        and lo <= s.a and s.b <= hi), key=lambda s: s.a)
        out: Dict[str, List[int]] = {}
        for s in waits:
            out.setdefault(s.name[len("wait."):], [0, 0])[0] += s.n
        starts = [s.a for s in waits]
        for a, b in self.syncs:
            mid = 0.5 * (a + b)
            k = bisect.bisect_right(starts, mid)
            near = [s for s in waits[max(k - 1, 0):k + 1]
                    if s.a - MARGIN_US <= a and b <= s.b + MARGIN_US]
            if near:
                s = min(near, key=lambda s: max(s.a - mid, mid - s.b, 0.0))
                out[s.name[len("wait."):]][1] += 1
        return out

    def unspanned_syncs(self) -> List[Tuple[float, str]]:
        """Each ``cudaStreamSynchronize`` of the slice that no mapped
        ``wait.*`` span holds within ``MARGIN_US``: (its start, the span
        path under its middle)."""
        waits = sorted((s.a - MARGIN_US, s.b + MARGIN_US)
                       for s in self.spans if s.name.startswith("wait."))
        starts = [w[0] for w in waits]
        out = []
        for a, b in self.syncs:
            # waits never nest: only the last two starting before the
            # sync can hold it
            k = bisect.bisect_right(starts, a)
            if not any(waits[i][1] >= b for i in range(max(k - 2, 0), k)):
                out.append((a, gap_path(self.spans, 0.5 * (a + b))))
        return out


# pauses before an anchor's brackets: uneven, so that the spacing of
# their runtime events tells them from the profiler's own syncs
PAUSES_S = (0.0, 4e-4, 1.1e-3)
SPREAD_US = 50.0


def take_anchors(clock) -> List[Anchor]:
    """One anchor's brackets on ``clock``: a first
    ``torch.cuda.synchronize()`` drains the device (and takes whatever the
    profiler does at the first calls after it starts), then one more for
    each of ``PAUSES_S``, on an idle device, bracketed by clock reads."""
    torch.cuda.synchronize()
    out = []
    for pause in PAUSES_S:
        time.sleep(pause)
        c0 = clock.now()
        torch.cuda.synchronize()
        out.append(Anchor(c0, clock.now()))
    return out


def _run(brackets: List[Anchor], events: List[Interval]
         ) -> Optional[Tuple[float, List[Anchor]]]:
    """(spread of the offsets, the matched anchors) when each event fits
    in its bracket, else None."""
    out = [Anchor(b.c0, b.c1, p0, p1) for b, (p0, p1) in zip(brackets,
                                                            events)]
    if any(a.p1 - a.p0 > (a.c1 - a.c0) * 1e6 for a in out):
        return None
    offs = [a.offset_us for a in out]
    return max(offs) - min(offs), out


def match_anchors(opening: List[Anchor], closing: List[Anchor],
                  marks: List[Interval]) -> Optional[Tuple[Anchor, Anchor]]:
    """The opening and the closing anchor. Of the trace's
    ``cudaDeviceSynchronize`` events in order, each anchor's brackets
    take the run of as many consecutive events that fit in them and
    whose offsets agree best (within ``SPREAD_US``: the pauses make a
    run shifted by one disagree by hundreds of µs), the closing run after
    the opening one; then each anchor is its narrowest bracket. None when
    no runs qualify."""
    k, m = len(opening), len(closing)
    best = None
    for i in range(len(marks) - k - m + 1):
        a = _run(opening, marks[i:i + k])
        if a is None or a[0] > SPREAD_US:
            continue
        for j in range(i + k, len(marks) - m + 1):
            b = _run(closing, marks[j:j + m])
            if b is not None and b[0] <= SPREAD_US and (
                    best is None or a[0] + b[0] < best[0]):
                best = (a[0] + b[0], a[1], b[1])
    if best is None:
        return None
    return tuple(min(run, key=lambda x: x.width_us) for run in best[1:])


def span_clock(engine):
    """The clock the engine's phase spans read: its ``PhaseRecorder``'s,
    which need not be ``engine.clock`` (an engine given an
    ``Observability`` and a clock of its own keeps both); the engine's
    clock without observability."""
    return engine.clock if engine.obs is None else engine.obs.phases.clock


def gap_path(spans: List[MappedSpan], t: float) -> str:
    s = innermost(spans, t)
    return "outside" if s is None else s.path


def counters(engine) -> Optional[Dict[Tuple[str, tuple], float]]:
    """The engine's counters by (name, labels); None without
    observability. Flushes the lane accumulators (one device read)."""
    if engine is None or engine.obs is None:
        return None
    return {(r["name"], tuple(sorted(r["labels"].items()))): r["value"]
            for r in engine.metrics_snapshot() if r["kind"] == "counter"}


class PhaseTracer(Tracer):
    """The benchmark's tracer plus the program's counters, the clock
    anchors and the spans on the slice (see the module docstring)."""

    def __init__(self, engine, slice_ticks: int, attempts: int = 3):
        super().__init__(engine, slice_ticks, attempts)
        self.engine = engine
        self.opened = counters(engine)
        self.closed = None
        self._begin: List[Anchor] = []
        self._end: List[Anchor] = []

    def close(self) -> None:
        super().close()
        self.closed = counters(self.engine)
        self.engine = None      # the run frees the engine before judging

    def growth(self, name: str, **labels) -> Optional[float]:
        """Growth over the window of counter ``name``, summed over the
        label sets that hold ``labels``; None without observability."""
        if self.opened is None or self.closed is None:
            return None
        want = set((k, str(v)) for k, v in labels.items())

        def total(rows):
            return sum(v for (n, lab), v in rows.items()
                       if n == name and want <= set(lab))
        return total(self.closed) - total(self.opened)

    def _anchor(self) -> List[Anchor]:
        return take_anchors(span_clock(self.engine))

    def _on_tick(self, i: int) -> None:
        # the benchmark's own slice logic, with the closing sync and one
        # opening sync each bracketed by engine clock reads
        self.tick = i
        n = self.slice_ticks
        if self._prof is not None and i == self._start + n:
            self._end = self._anchor()
            self._prof.stop()
            self.slice = self._read(self._prof, self._start)
            self._prof = None
            self.tries += 1
        if self._prof is None and self.busy() and i >= n:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.start()
            self._start = i
            self._begin = self._anchor()

    def _read(self, prof, first: int) -> Optional[PhaseSlice]:
        sl = super()._read(prof, first)
        if sl is None:
            return None
        cuda = torch.autograd.DeviceType.CUDA
        evs = prof.events()
        dev = [(e.time_range.start, e.time_range.end) for e in evs
               if e.device_type == cuda
               and not getattr(e, "is_user_annotation", False)]
        host = [(e.name, e.time_range.start, e.time_range.end)
                for e in evs if e.device_type != cuda]
        return slice_phases(sl, dev, host, [self._begin, self._end],
                            self.engine.obs)


def slice_phases(sl: Slice, dev: List[Interval],
                 host: List[Tuple[str, float, float]],
                 anchors: Tuple[List[Anchor], List[Anchor]],
                 obs) -> PhaseSlice:
    """``sl`` with its idle gaps, host syncs and the engine's spans mapped
    by the opening and closing anchors' brackets (``match_anchors``); the
    ten longest gaps renamed with the span path under their middle.
    Spans stay empty without ``obs`` or without the anchors' events."""
    lo = min(a for a, _ in dev)
    hi = max(b for _, b in dev)
    busy = _union(dev)
    gaps: List[Interval] = []
    edge = lo
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = b
    if hi > edge:
        gaps.append((edge, hi))
    syncs = sorted((a, b) for name, a, b in host
                   if name == SYNC and lo <= a and b <= hi)
    marks = sorted((a, b) for name, a, b in host if name == ANCHOR)
    spans: List[MappedSpan] = []
    drift = None
    matched = None if obs is None else match_anchors(*anchors, marks)
    if matched is not None:
        cmap = ClockMap(*matched)
        drift = cmap.drift_us
        spans = map_spans(obs.phases.spans(since=matched[0].c0), cmap)
    labelled = []
    for a, b in sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:10]:
        mid = 0.5 * (a + b)
        inner = [x for x in host if x[1] <= mid <= x[2]]
        call = min(inner, key=lambda x: x[2] - x[1])[0] if inner else "host"
        name = f"{gap_path(spans, mid)}|{call}" if spans else call
        labelled.append((name, (b - a) / 1e6))
    fields = {f.name: getattr(sl, f.name) for f in dataclasses.fields(Slice)}
    fields["idle_gaps"] = labelled
    return PhaseSlice(**fields, gaps=gaps, spans=spans, syncs=syncs,
                      anchors=list(matched or ()), syncs_bounds=(lo, hi),
                      anchor_events=len(marks),
                      drift_us=drift)
