"""Find a cell's pieces by the names ``BENCHMARK.json`` gives them:

* a configuration in ``bench/configs/<name>.json``;
* a traffic mix in ``bench/traffic/<name>.json`` (read by
  ``bench/harness/traffic.py``, the one generator);
* a per-layer metric's reader in ``bench/metrics/<name>.py``, a module
  with ``read(run: Run) -> float | None`` (None when it finds nothing to
  read; the metric is then left out of the result).

A later change adds a configuration, a mix or a metric by adding its
file and its entry in ``BENCHMARK.json``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from bench.harness import traffic

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""
    cfg: Dict
    window: Any                        # serve.Window
    tracer: Any = None                 # trace.Tracer (traced runs)
    ticks: Optional[np.ndarray] = None  # serve.tick_table of the window


def benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(spec: Dict, workload: str) -> Dict:
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have "
                   f"{[w['name'] for w in spec['workloads']]})")


def metrics_of(spec: Dict, workload: str, group: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports."""
    return [m for m in spec[group]
            if workload in m.get("workloads", [workload])]


def config(name: str, bench: Path = BENCH) -> Dict:
    return json.loads((bench / "configs" / f"{name}.json").read_text())


def mix(name: str, bench: Path = BENCH) -> Dict:
    return traffic.load(bench / "traffic" / f"{name}.json")


def reader(name: str, bench: Path = BENCH) -> Callable[[Run], Any]:
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
