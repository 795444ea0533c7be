"""repro_torch.obs — the serving observability subsystem (the
counterpart of ``repro.obs``).

One ``Observability`` object bundles what ``SpeCaEngine(obs=...)``
threads through serving:

  * ``metrics``  — a ``MetricsRegistry`` of counters/gauges/histograms/
                   per-tick series (host-side, dependency-free).
  * ``recorder`` — a bounded ``FlightRecorder`` of lifecycle events and
                   completed request ``Trace`` objects.
  * ``clock``    — the monotonic ``Clock`` every timestamp reads
                   through (``FakeClock`` for tests).
  * ``phases``   — a bounded ``PhaseRecorder`` of the engine's phase
                   spans inside each tick, on ``clock``, and the wait,
                   forward and lane counters kept beside them.
  * ``lane_accumulator()`` — a per-session on-device accumulator of the
                   lane step's flags that adds zero host syncs.

The rule: observability never changes what the lane step computes or
adds a device sync to the serving path. ``SpeCaEngine(obs=False)`` runs
no observability code at all, and ``obs=True`` only (a) runs host-side
Python over values the engine already fetched, (b) reads the host clock
around the engine's phases and (c) launches the accumulator's in-place
tensor ops.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch.obs.clock import (Clock, FakeClock, MonotonicClock,
                                   resolve_clock)
from repro_torch.obs.exporters import chrome_trace, prometheus_text, to_jsonl
from repro_torch.obs.lane_metrics import DEFAULT_ERR_EDGES, LaneAccumulator
from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry, Series)
from repro_torch.obs.trace import (FlightRecorder, PhaseRecorder, Span,
                                   Timings, Trace, build_trace)

__all__ = [
    "Clock", "MonotonicClock", "FakeClock", "resolve_clock",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "Series",
    "Timings", "Span", "Trace", "FlightRecorder", "build_trace",
    "LaneAccumulator", "DEFAULT_ERR_EDGES",
    "to_jsonl", "prometheus_text", "chrome_trace",
    "Observability",
]


class Observability:
    """The bundle ``SpeCaEngine(obs=...)`` owns (see module docstring).

    ``event_capacity``/``trace_capacity`` bound the flight recorder;
    ``err_edges`` sets the device-binned chain-err histogram grid. A
    caller may pass a pre-built ``Observability`` to share one registry
    across several engines.
    """

    def __init__(self, *, clock: Optional[Clock] = None,
                 event_capacity: int = 4096, trace_capacity: int = 256,
                 err_edges: Tuple[float, ...] = DEFAULT_ERR_EDGES) -> None:
        self.clock: Clock = resolve_clock(clock)
        self.metrics = MetricsRegistry()
        self.recorder = FlightRecorder(capacity=event_capacity,
                                       trace_capacity=trace_capacity)
        self.phases = PhaseRecorder(self.clock, self.metrics)
        self.err_edges = tuple(float(e) for e in err_edges)

    def lane_accumulator(self) -> LaneAccumulator:
        return LaneAccumulator(err_edges=self.err_edges)

    # -- convenience export surface -------------------------------------
    def snapshot(self) -> Any:
        return self.metrics.snapshot()

    def prometheus(self) -> str:
        return prometheus_text(self.metrics.snapshot())

    def events_jsonl(self, fp: Any = None) -> str:
        return to_jsonl(self.recorder.events(), fp)

    def chrome_trace(self, fp: Any = None) -> Any:
        return chrome_trace(self.recorder.traces(), fp)
