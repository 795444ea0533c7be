"""Metrics registry: counters, gauges, histograms and tick series.

The registry is the host-side half of the observability subsystem
(the counterpart of ``repro.obs.registry``): a flat, label-keyed
namespace of metric instruments the serving engine writes into at
lifecycle events — submit, admit, completion, program compile — plus
per-tick queue/occupancy series. It is deliberately dependency-free
and pure Python: nothing here touches torch, so instantiating or
writing a metric can never perturb the lane step (the inertness
guarantee). The device-side
half — accumulation of per-tick lane-step flags without host syncs —
lives in ``repro_torch.obs.lane_metrics`` and *flushes into* this
registry when a snapshot is taken.

Model (Prometheus-flavoured):

  * ``Counter``   — monotonically increasing float (requests completed,
                    schedule steps served per tenant, programs built).
  * ``Gauge``     — a settable instantaneous value (queue depth now).
  * ``Histogram`` — fixed-boundary buckets with ``sum``/``count``;
                    quantiles are interpolated from the buckets the
                    Prometheus way (accept-rate and chain-err
                    distributions).
  * ``Series``    — an append-only (x, value) sequence with a bounded
                    capacity (drop-oldest), for per-scheduler-tick
                    signals like queue depth over time.

Instruments are identified by ``(name, sorted label items)``; asking for
the same identity returns the same instrument, asking for the same name
with a different type is an error. ``snapshot()`` renders everything to
plain Python for the exporters (``repro_torch.obs.exporters``).
"""
from __future__ import annotations

import math
from collections import deque
from typing import Any, Deque, Dict, Iterable, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    kind = "metric"

    def __init__(self, name: str, labels: LabelKey) -> None:
        self.name = name
        self.labels = labels

    @property
    def label_dict(self) -> Dict[str, str]:
        return dict(self.labels)


class Counter(_Metric):
    """Monotonically increasing value; ``inc`` rejects negatives."""

    kind = "counter"

    def __init__(self, name: str, labels: LabelKey) -> None:
        super().__init__(name, labels)
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {v})")
        self.value += float(v)


class Gauge(_Metric):
    """Instantaneous value, set at will."""

    kind = "gauge"

    def __init__(self, name: str, labels: LabelKey) -> None:
        super().__init__(name, labels)
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += float(v)


class Histogram(_Metric):
    """Fixed-boundary histogram with Prometheus bucket semantics.

    ``edges`` are the upper bounds of the finite buckets; one implicit
    +Inf bucket catches the overflow. ``observe`` is O(#buckets) (linear
    scan — fine for host-side per-request observations);
    ``add_counts`` merges a whole pre-binned count vector at once, which
    is how the device-side lane accumulator flushes without ever
    observing value-by-value.
    """

    kind = "histogram"

    def __init__(self, name: str, labels: LabelKey,
                 edges: Iterable[float]) -> None:
        super().__init__(name, labels)
        self.edges = tuple(float(e) for e in edges)
        if list(self.edges) != sorted(set(self.edges)):
            raise ValueError(f"histogram {name} edges must be strictly "
                             f"increasing, got {self.edges}")
        self.counts = [0.0] * (len(self.edges) + 1)   # +Inf overflow
        self.sum = 0.0
        self.count = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        while i < len(self.edges) and v > self.edges[i]:
            i += 1
        self.counts[i] += 1.0
        self.sum += v
        self.count += 1.0

    def add_counts(self, counts: Iterable[float], total_sum: float,
                   total_count: float) -> None:
        counts = [float(c) for c in counts]
        if len(counts) != len(self.counts):
            raise ValueError(
                f"histogram {self.name} has {len(self.counts)} buckets, "
                f"add_counts got {len(counts)}")
        for i, c in enumerate(counts):
            self.counts[i] += c
        self.sum += float(total_sum)
        self.count += float(total_count)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def quantile(self, q: float) -> float:
        """Prometheus-style bucket-interpolated quantile. NaN when
        empty; the +Inf bucket clamps to the last finite edge (there is
        no upper bound to interpolate toward)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if not self.count:
            return math.nan
        rank = q * self.count
        cum = 0.0
        for i, c in enumerate(self.counts):
            prev = cum
            cum += c
            if cum >= rank:
                if i >= len(self.edges):          # +Inf bucket
                    return self.edges[-1] if self.edges else math.nan
                lo = self.edges[i - 1] if i > 0 else 0.0
                hi = self.edges[i]
                if c <= 0:
                    return hi
                return lo + (hi - lo) * (rank - prev) / c
        return self.edges[-1] if self.edges else math.nan


class Series(_Metric):
    """Append-only (x, value) sequence with drop-oldest capacity.

    ``x`` is whatever the writer indexes by — the serving engine uses
    its scheduler tick, so one row lands per tick (the fix for
    ``serve_load``'s poll-boundary under-sampling). ``values()`` /
    ``points()`` return plain lists; ``peak()`` is the max value over
    the retained window.
    """

    kind = "series"

    def __init__(self, name: str, labels: LabelKey,
                 capacity: int = 65536) -> None:
        super().__init__(name, labels)
        if capacity < 1:
            raise ValueError(f"series {name} capacity must be >= 1")
        self.capacity = int(capacity)
        self._points: Deque[Tuple[float, float]] = deque(maxlen=capacity)
        self.dropped = 0

    def append(self, x: float, v: float) -> None:
        if len(self._points) == self.capacity:
            self.dropped += 1
        self._points.append((float(x), float(v)))

    def points(self) -> List[Tuple[float, float]]:
        return list(self._points)

    def values(self) -> List[float]:
        return [v for _, v in self._points]

    def peak(self) -> float:
        return max((v for _, v in self._points), default=math.nan)

    def last(self) -> float:
        return self._points[-1][1] if self._points else math.nan

    def __len__(self) -> int:
        return len(self._points)


class MetricsRegistry:
    """Label-keyed instrument namespace (see module docstring)."""

    def __init__(self) -> None:
        self._metrics: Dict[Tuple[str, LabelKey], _Metric] = {}

    def _get(self, cls, name: str, labels: Dict[str, Any],
             **ctor_kw) -> Any:
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, key[1], **ctor_kw)
            self._metrics[key] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}")
        return m

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, edges: Optional[Iterable[float]] = None,
                  **labels: Any) -> Histogram:
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is not None:
            if not isinstance(m, Histogram):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, requested histogram")
            if edges is not None and tuple(float(e) for e in edges) \
                    != m.edges:
                raise ValueError(f"histogram {name!r} re-requested with "
                                 "different edges")
            return m
        if edges is None:
            raise ValueError(f"histogram {name!r} needs edges on first "
                             "registration")
        return self._get(Histogram, name, labels, edges=edges)

    def series(self, name: str, capacity: int = 65536,
               **labels: Any) -> Series:
        return self._get(Series, name, labels, capacity=capacity)

    def collect(self) -> List[_Metric]:
        """All instruments in deterministic (name, labels) order."""
        return [self._metrics[k] for k in sorted(self._metrics)]

    def snapshot(self) -> List[Dict[str, Any]]:
        """Plain-Python rendering for the exporters: one dict per
        instrument with its kind-specific payload."""
        out: List[Dict[str, Any]] = []
        for m in self.collect():
            row: Dict[str, Any] = {"name": m.name, "kind": m.kind,
                                   "labels": m.label_dict}
            if isinstance(m, (Counter, Gauge)):
                row["value"] = m.value
            elif isinstance(m, Histogram):
                row.update(edges=list(m.edges), counts=list(m.counts),
                           sum=m.sum, count=m.count)
                if m.count:
                    row.update(mean=m.mean, p50=m.quantile(0.5),
                               p90=m.quantile(0.9), p99=m.quantile(0.99))
            elif isinstance(m, Series):
                row.update(points=m.points(), dropped=m.dropped)
                if len(m):
                    row.update(peak=m.peak(), last=m.last())
            out.append(row)
        return out
