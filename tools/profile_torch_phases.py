"""The engine's phase spans and counters on the card, through the
benchmark's own run of a cell (``bench/run.py``'s ``run_cell``).

    python3 tools/profile_torch_phases.py traced --workload <cell> \\
        --seed <n> --seconds 51
    python3 tools/profile_torch_phases.py cost --workload <cell> \\
        --seed <n> --seconds 51 --pairs 3

``traced``: the cell's ``--trace 1`` run with the engine built with
``obs=True`` and ``bench/harness/phases.PhaseTracer`` in the place of the
benchmark's tracer. Prints the benchmark's per-layer metrics and the four
phase readers' (``device_waits_per_tick``, ``step_host_ms``,
``idle_in_step_share``, ``idle_in_lifecycle_share``), the waits a tick
by reason, the program's counters against the benchmark's outside
readings (full-forward calls against the tracer's wrapped calls, occupied
lanes against the window's lane-steps, the waits of the reasons
``host_syncs`` counts against its growth), the clock anchors' offsets
and drift, the share of the slice's ``cudaStreamSynchronize`` events
inside a mapped ``wait.*`` span (20 µs margin) with every one outside
named, by wait reason the waits counted against the syncs their spans
hold, and the slice's idle gaps by span path. One JSON line a run, also
written to ``chiprun_out/phases_<cell>_<seed>.json``.

``cost``: pairs of ``--trace 0`` runs with observability off and on, in
alternating order (off, on; on, off; ...), a seed a pair: one JSON line
a run with ``samples_per_s`` and ``latency_p95_s``.

Exits with code 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from bench import run as BR    # noqa: E402

NEW = {"device_waits_per_tick": "waits/tick", "step_host_ms": "ms",
       "idle_in_step_share": "%", "idle_in_lifecycle_share": "%"}
# the wait reasons SpeCaEngine.host_syncs counts (a diffusion fill has
# no read it counts)
SYNC_REASONS = ("draft", "full", "chain", "advanced")


@contextlib.contextmanager
def patched(obs: bool, seen: dict):
    """The benchmark's run with ``SpeCaEngine(obs=obs)``, the
    ``PhaseTracer`` as its tracer, and the tracer and window kept in
    ``seen``."""
    import repro_torch.serving as S
    from bench.harness import serve as SV
    from bench.harness import trace as TRC
    from bench.harness.phases import PhaseTracer

    class Kept(PhaseTracer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen["tracer"] = self

    window = SV.Server.window

    def kept_window(server, *a, **k):
        seen["window"] = window(server, *a, **k)
        return seen["window"]

    saved = (S.SpeCaEngine, TRC.Tracer)
    S.SpeCaEngine = functools.partial(saved[0], obs=obs)
    TRC.Tracer = Kept
    SV.Server.window = kept_window
    try:
        yield
    finally:
        S.SpeCaEngine, TRC.Tracer = saved
        SV.Server.window = window


def traced(workload: str, seed: int, seconds: float, device) -> dict:
    from bench.harness import registry as RG
    spec = copy.deepcopy(RG.benchmark())
    spec["per_layer"] += [{"name": n, "unit": u, "better": "lower",
                           "source": "program_counter", "layer": "-",
                           "moves": "samples_per_s"}
                          for n, u in NEW.items()]
    seen: dict = {}
    with patched(True, seen):
        out = BR.run_cell(workload, seed, seconds, True, device, spec=spec)
    tr, win = seen["tracer"], seen["window"]
    reasons = sorted({dict(lab)["reason"] for (n, lab) in tr.closed
                      if n == "speca_device_waits_total"})
    waits = {r: tr.growth("speca_device_waits_total", reason=r) / win.ticks
             for r in reasons}
    wait_ms = {r: 1e3 * tr.growth("speca_wait_seconds_total", reason=r)
               / win.ticks for r in reasons}
    rep = {
        "workload": workload, "seed": seed, "correct": out["correct"],
        "metrics": {k: v["value"] for k, v in out["metrics"].items()},
        "waits_per_tick": waits, "wait_ms_per_tick": wait_ms,
        "counters_vs_outside": {
            "full_forward_calls": [
                tr.growth("speca_full_forward_calls_total"),
                len(tr.calls["full"])],
            "spec_forward_calls": [
                tr.growth("speca_spec_forward_calls_total"),
                len(tr.calls["spec"])],
            "lanes_occupied": [tr.growth("speca_lanes_occupied_total"),
                               win.lane_steps],
            "host_sync_waits": [sum(tr.growth("speca_device_waits_total",
                                              reason=r)
                                    for r in SYNC_REASONS),
                                win.host_syncs]},
        "window": {"ticks": win.ticks, "seconds": win.seconds,
                   "requests": len(win.served)},
        "breakdown": out.get("breakdown")}
    sl = tr.slice
    if sl is not None and getattr(sl, "spans", None):
        outside = sl.unspanned_syncs()
        held = [(x.a, x.b) for x in sl.spans if x.name.startswith("wait.")]

        def off_by(t):
            """µs from ``t`` to the nearest wait span."""
            return min((max(a - t, t - b, 0.0) for a, b in held),
                       default=None)
        rep["alignment"] = {
            "syncs": len(sl.syncs), "outside_wait_spans": len(outside),
            "share_inside": 1.0 - len(outside) / max(len(sl.syncs), 1),
            "outside": [[p, off_by(t)] for t, p in outside][:20],
            "offsets_us": [a.offset_us for a in sl.anchors],
            "widths_us": [a.width_us for a in sl.anchors],
            "drift_us": sl.drift_us, "anchor_events": sl.anchor_events,
            "sync_counts": sl.sync_counts(),
            "spans_in_slice": len(sl.spans)}
    return rep


def cost(workload: str, seed: int, seconds: float, pairs: int,
         device) -> list:
    rows = []
    for i in range(pairs):
        for obs in ((False, True) if i % 2 == 0 else (True, False)):
            with patched(obs, {}):
                out = BR.run_cell(workload, seed + i, seconds, False, device)
            row = {"workload": workload, "seed": seed + i, "obs": obs,
                   "correct": out["correct"],
                   **{k: v["value"] for k, v in out["metrics"].items()
                      if k != "setup_s"}}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("traced", "cost"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args(argv)
    BR._environment()
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_phases: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    if args.mode == "cost":
        cost(args.workload, args.seed, args.seconds, args.pairs, device)
        return 0
    rep = traced(args.workload, args.seed, args.seconds, device)
    out = ROOT / "chiprun_out" / f"phases_{args.workload}_{args.seed}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(rep, indent=1))
    print(json.dumps(rep), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
