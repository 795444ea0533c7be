"""The traced run's instruments: the benchmark's own spans around the
port's workload calls, and one profiled slice of the window.

Spans: the engine's diffusion workload instance gets its
``full_forward`` and ``spec_forward`` wrapped, counting calls per window
tick and recording CUDA events around each call (read once the window
is over: no sync inside it). The host clock stamps each window tick.

The slice: ``torch.profiler`` records device activity (kernels, copies,
and the CUDA runtime calls on the host) over ``slice_ticks`` consecutive
ticks, from window tick ``slice_ticks`` on (so the lanes have run a
whole schedule first); the slice runs from its first device operation
to its last. Idle gaps are named by the host call under their middle,
or ``host`` where the host ran Python. The
profiler now and then loses device events, so a slice whose count of
forecast kernels (one predict and one verify a tick with a draft, one
refresh a tick with a full forward) falls short of what the spans
counted in it is rejected, never read as idle time, and the next slice
is recorded, up to ``attempts`` times; the window runs on until one is
taken or the attempts are spent.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

from bench.harness.roofline import KERNELS


@dataclasses.dataclass
class Slice:
    first: int                    # window tick of the slice's first tick
    ticks: int
    seconds: float                # the slice's length on the trace clock
    busy_s: float                 # union of device activity in the slice
    kernel_s: Dict[str, float]    # device seconds of the forecast kernels
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float,
                                                              float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Tracer:
    def __init__(self, engine, slice_ticks: int, attempts: int = 3):
        self.slice_ticks = slice_ticks
        self.attempts = attempts
        self.tries = 0
        self.calls = {"full": [], "spec": []}    # window tick per call
        self.events = {"full": [], "spec": []}
        self.tick: Optional[int] = -1     # None once the window closed
        self.slice: Optional[Slice] = None
        self._prof = None
        self._start = None
        # host clock as each window tick starts and ends (the tracer's own
        # work between them left out), and the ticks run under the profiler
        self.begin: List[float] = []
        self.end: List[float] = []
        self.profiled: set = set()
        wl = engine.workloads["diffusion"]
        for kind in ("full", "spec"):
            setattr(wl, f"{kind}_forward", self._wrap(
                kind, getattr(wl, f"{kind}_forward")))

    def _wrap(self, kind: str, fn):
        def call(*args, **kw):
            if self.tick is None:
                return fn(*args, **kw)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = fn(*args, **kw)
            t1.record()
            self.calls[kind].append(self.tick)
            self.events[kind].append((t0, t1))
            return out
        return call

    def busy(self) -> bool:
        """Whether the window must run on for a slice."""
        return self.slice is None and self.tries < self.attempts

    def on_tick(self, i: int) -> None:
        now = time.perf_counter()
        if self.begin:
            self.end.append(now)
        self._on_tick(i)
        if self._prof is not None:
            self.profiled.add(i)
        self.begin.append(time.perf_counter())

    def close(self) -> None:
        """The window has closed (after its device sync): stop counting."""
        self.end.append(time.perf_counter())
        self.tick = None

    def tick_seconds(self) -> List[float]:
        """Host seconds of each window tick."""
        return [b - a for a, b in zip(self.begin, self.end)]

    def _on_tick(self, i: int) -> None:
        self.tick = i
        n = self.slice_ticks
        if self._prof is not None and i == self._start + n:
            torch.cuda.synchronize()
            self._prof.stop()
            self.slice = self._read(self._prof, self._start)
            self._prof = None
            self.tries += 1
        if self._prof is None and self.busy() and i >= n:
            from torch.profiler import ProfilerActivity, profile
            # device activity only: recording every host operation as
            # well doubled a DiT tick's host time
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.start()
            self._start = i

    def forward_ms(self, kind: str) -> Optional[float]:
        """Mean device ms between the events around each call."""
        evs = self.events[kind]
        if not evs:
            return None
        return sum(a.elapsed_time(b) for a, b in evs) / len(evs)

    def _read(self, prof, first: int) -> Optional[Slice]:
        cuda = torch.autograd.DeviceType.CUDA
        evs = prof.events()
        # a user annotation on the device's timeline is no operation
        dev = [e for e in evs if e.device_type == cuda
               and not getattr(e, "is_user_annotation", False)]
        host = [e for e in evs if e.device_type != cuda]
        if not dev:
            return None
        # the slice: from its first device operation to its last
        lo = min(e.time_range.start for e in dev)
        hi = max(e.time_range.end for e in dev)
        n = self.slice_ticks
        spec = sum(1 for t in self.calls["spec"] if first <= t < first + n)
        full = sum(1 for t in self.calls["full"] if first <= t < first + n)
        want = {"predict": spec, "verify": spec, "refresh": full}
        kernel_s = {k: 0.0 for k in KERNELS}
        kernel_n = {k: 0 for k in KERNELS}
        by_name: Dict[str, float] = {}
        spans = [(e.time_range.start, e.time_range.end) for e in dev]
        for e, (a, b) in zip(dev, spans):
            by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e6
            for k, sub in KERNELS.items():
                if sub in e.name:
                    kernel_s[k] += (b - a) / 1e6
                    kernel_n[k] += 1
        if any(kernel_n[k] < want[k] for k in want):
            return None          # the profiler lost events: not a reading
        busy = _union(spans)
        gaps = []
        edge = lo
        for a, b in busy:
            if a > edge:
                gaps.append((edge, a))
            edge = b
        if hi > edge:
            gaps.append((edge, hi))
        gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
        labelled = []
        for a, b in gaps[:10]:
            mid = 0.5 * (a + b)
            inner = [e for e in host
                     if e.time_range.start <= mid <= e.time_range.end]
            name = min(inner, key=lambda e: e.time_range.end
                       - e.time_range.start).name if inner else "host"
            labelled.append((name, (b - a) / 1e6))
        ops = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)
        return Slice(first=first, ticks=n, seconds=(hi - lo) / 1e6,
                     busy_s=sum(b - a for a, b in busy) / 1e6,
                     kernel_s=kernel_s,
                     device_ops=[(k[:160], v) for k, v in ops[:10]],
                     idle_gaps=labelled)
