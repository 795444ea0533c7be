"""Render observability state to interchange formats.

Three exporters, all pure functions over already-materialised host data
(a ``MetricsRegistry.snapshot()`` list, ``FlightRecorder`` events, or
``Trace`` objects) — exporting never touches the device:

  * ``to_jsonl``        — newline-delimited JSON event log (flight
                          recorder events and/or metric snapshots), the
                          grep-able archival format.
  * ``prometheus_text`` — Prometheus exposition text (``# TYPE`` lines,
                          label rendering, histograms as cumulative
                          ``_bucket{le=...}`` plus ``_sum``/``_count``;
                          series are flattened to ``_last``/``_peak``
                          gauges since Prometheus scrapes instants).
  * ``chrome_trace``    — Chrome ``trace_event`` JSON: each request's
                          spans become complete ("ph": "X") events on a
                          per-request thread inside a per-workload
                          process, loadable in chrome://tracing or
                          Perfetto.

The formats are the reference's (``repro.obs.exporters``), byte for
byte on equal inputs.
"""
from __future__ import annotations

import io
import json
import math
import re
from typing import Any, Dict, Iterable, List, Optional, Union

from repro_torch.obs.trace import Trace

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_RE = re.compile(r"[^a-zA-Z0-9_]")


def _san_name(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    return name if not name[:1].isdigit() else "_" + name


def _san_label(name: str) -> str:
    name = _LABEL_RE.sub("_", name)
    return name if not name[:1].isdigit() else "_" + name


def _fmt_value(v: float) -> str:
    if isinstance(v, float) and math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    return repr(float(v))


def _esc_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels_str(labels: Dict[str, str],
                extra: Optional[Dict[str, str]] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    body = ",".join(f'{_san_label(k)}="{_esc_label_value(str(v))}"'
                    for k, v in sorted(merged.items()))
    return "{" + body + "}"


def to_jsonl(rows: Iterable[Dict[str, Any]],
             fp: Union[str, io.IOBase, None] = None) -> str:
    """Serialise dict rows as newline-delimited JSON. Returns the text;
    also writes it if ``fp`` is a path or open file."""
    text = "".join(json.dumps(r, sort_keys=True, default=str) + "\n"
                   for r in rows)
    if isinstance(fp, str):
        with open(fp, "w") as f:
            f.write(text)
    elif fp is not None:
        fp.write(text)
    return text


def prometheus_text(snapshot: List[Dict[str, Any]]) -> str:
    """Render a ``MetricsRegistry.snapshot()`` to Prometheus exposition
    text. ``# TYPE`` is emitted once per metric name; histogram buckets
    are cumulative with an explicit ``le="+Inf"`` terminal bucket."""
    lines: List[str] = []
    typed: set = set()

    def declare(name: str, kind: str) -> None:
        if name not in typed:
            lines.append(f"# TYPE {name} {kind}")
            typed.add(name)

    for row in snapshot:
        name, labels = _san_name(row["name"]), row["labels"]
        kind = row["kind"]
        if kind in ("counter", "gauge"):
            declare(name, kind)
            lines.append(f"{name}{_labels_str(labels)} "
                         f"{_fmt_value(row['value'])}")
        elif kind == "histogram":
            declare(name, "histogram")
            cum = 0.0
            for edge, c in zip(list(row["edges"]) + [math.inf],
                               row["counts"]):
                cum += c
                le = "+Inf" if math.isinf(edge) else repr(float(edge))
                lines.append(
                    f'{name}_bucket{_labels_str(labels, {"le": le})} '
                    f"{_fmt_value(cum)}")
            lines.append(f"{name}_sum{_labels_str(labels)} "
                         f"{_fmt_value(row['sum'])}")
            lines.append(f"{name}_count{_labels_str(labels)} "
                         f"{_fmt_value(row['count'])}")
        elif kind == "series":
            # Prometheus scrapes instants; expose the retained window's
            # last and peak values as gauges.
            for suffix in ("last", "peak"):
                if suffix in row:
                    declare(f"{name}_{suffix}", "gauge")
                    lines.append(
                        f"{name}_{suffix}{_labels_str(labels)} "
                        f"{_fmt_value(row[suffix])}")
    return "\n".join(lines) + ("\n" if lines else "")


def chrome_trace(traces: Iterable[Trace],
                 fp: Union[str, io.IOBase, None] = None) -> Dict[str, Any]:
    """Render request traces as Chrome ``trace_event`` JSON.

    Each workload becomes a process (stable small pid), each request a
    thread within it named by ticket; spans are complete events with
    microsecond ``ts``/``dur``. Returns the document (also written to
    ``fp`` when given) — open in chrome://tracing or ui.perfetto.dev.
    """
    events: List[Dict[str, Any]] = []
    pids: Dict[str, int] = {}
    for tr in traces:
        pid = pids.get(tr.workload)
        if pid is None:
            pid = pids[tr.workload] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0,
                           "args": {"name": f"workload:{tr.workload}"}})
        tid = tr.ticket_id
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid,
                       "args": {"name": f"req {tr.request_id} "
                                        f"(ticket {tr.ticket_id})"}})
        for sp in tr.spans:
            events.append({
                "ph": "X", "name": sp.name, "cat": "speca",
                "pid": pid, "tid": tid,
                "ts": sp.t0 * 1e6,
                "dur": max(0.0, (sp.t1 - sp.t0) * 1e6),
                "args": dict(sp.attrs, tick0=sp.tick0, tick1=sp.tick1,
                             tenant=tr.tenant, completed=tr.completed),
            })
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if isinstance(fp, str):
        with open(fp, "w") as f:
            json.dump(doc, f)
    elif fp is not None:
        json.dump(doc, fp)
    return doc
