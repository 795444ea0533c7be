"""Run one benchmark cell once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. ``BENCHMARK.json`` names the cell's configuration and traffic mix
(``bench/configs/<name>.json``, ``bench/traffic/<name>.json``) and its
metrics: with ``--trace 0`` the end-to-end ones, measured on the host's
clock, with ``--trace 1`` the per-layer ones (``bench/metrics/<name>.py``
each) from a run with the benchmark's spans and one profiled slice.

Set-up (``setup_s``): import, the weights drawn on the card from the
seed, the engine and its warm-up at the cell's width, the ticks the mix
needs to spread its lanes. The window then serves the mix's clients
through the port's lifecycle engine. Afterwards a sample of the
requests served in the window is judged against the plain reference
(``bench/harness/judge.py``); the numbers compared and their limits are
printed last on standard error and, under ``checks``, last in the
result line, the last line of standard output.

Exits with a code other than 0, and prints no result, without the cards
the cell asks for, or when ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``repro`` was imported.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse      # noqa: E402
import gc            # noqa: E402
import json          # noqa: E402
import os            # noqa: E402
import sys           # noqa: E402
from pathlib import Path   # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))
    # one process, few threads: host-side thread pools would compete with
    # the thread that drives the card
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (``repro_torch`` is neither)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, spec=None, cfg=None, mix=None) -> dict:
    """One run of a cell on ``device``; returns the result line's
    fields. ``spec``, ``cfg`` and ``mix`` default to the files the cell
    names."""
    import numpy as np
    import torch

    from bench.harness import judge as JD
    from bench.harness import registry as RG
    from bench.harness import serve as SV

    spec = spec if spec is not None else RG.benchmark()
    cell = RG.cell(spec, workload)
    cfg = cfg if cfg is not None else RG.config(cell["config"])
    mix = mix if mix is not None else RG.mix(cell["traffic"])
    cuda = device.type == "cuda"

    marks = [("start", T_START), ("imports", time.perf_counter())]
    params = SV.make_weights(cfg, seed, device)
    if cuda:
        torch.cuda.synchronize(device)
    marks.append(("weights", time.perf_counter()))
    server = SV.Server(cfg, mix, seed, device, params)
    server.warm()
    marks.append(("warmup", time.perf_counter()))
    server.spread()
    marks.append(("spread", time.perf_counter()))
    tracer = None
    if trace:
        from bench.harness.trace import Tracer
        tracer = Tracer(server.engine, slice_ticks=server.steps)
    setup_s = time.perf_counter() - T_START
    win = server.window(
        seconds, on_tick=None if tracer is None else tracer.on_tick,
        extend=(lambda: False) if tracer is None else tracer.busy)
    ticks = None
    if trace:
        tracer.close()
        drained = server.drain()
        ticks = SV.tick_table(cfg, win.served + drained, win.first_tick,
                              win.ticks)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run = RG.Run(cfg=cfg, window=win, tracer=tracer, ticks=ticks)
    metrics = {}
    if trace:
        for m in RG.metrics_of(spec, workload, "per_layer"):
            v = RG.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        lat = [s.done_s - s.submit_s for s in win.served]
        measured = {
            "samples_per_s": win.lane_steps / server.steps / win.seconds,
            "latency_p95_s": float(np.percentile(lat, 95)) if lat
            else None,
            "setup_s": setup_s}
        for m in RG.metrics_of(spec, workload, "end_to_end"):
            if measured.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": measured[m["name"]],
                                      "unit": m["unit"]}
    server.close()
    del server, params
    gc.collect()        # the traced run's wrappers hold the workload in a cycle
    if cuda:
        torch.cuda.empty_cache()
    verdict = JD.judge(cfg, win.served, seed, device)
    out = {"correct": verdict.correct, "attempted": len(win.served),
           "failed": verdict.failed, "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(device) if cuda
                      else "cpu",
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if trace and tracer.slice is not None:
        sl = tracer.slice
        out["device"].update(busy_s=sl.busy_s, window_s=sl.seconds)
        out["breakdown"] = {"device_ops": [list(x) for x in sl.device_ops],
                            "idle_gaps": [list(x) for x in sl.idle_gaps]}
    # printed on standard error before the checks, not in the result
    steps = sum(x.num_full + x.num_spec for x in win.served)
    out["_window"] = {
        "setup": {b: round(tb - ta, 3)
                  for (_, ta), (b, tb) in zip(marks, marks[1:])},
        "seconds": win.seconds, "ticks": win.ticks,
        "requests": len(win.served),
        "accepted": sum(x.num_spec for x in win.served) / max(steps, 1),
        "not compared": verdict.uncompared()}
    out["checks"] = verdict.checks()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from bench.harness import registry as RG
    spec = RG.benchmark()
    chips = int(RG.cell(spec, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell needs {chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda:0"), spec=spec)
    bad = forbidden_modules()
    if bad:
        print(f"bench: modules of JAX or the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    print(f"bench: window {out.pop('_window')}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
