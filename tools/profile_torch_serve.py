#!/usr/bin/env python3
"""Where the time of the port's serving path goes, on one GPU.

Serves the chip check's workload — DiT-XL/2 at full width with the same
seeded random weights, 8 requests at lanes=4, 50 DDIM steps, fused
verify — under ``torch.profiler`` and reports the device time by kernel
group (the hand-written kernels, cuBLAS matrix products, attention,
everything else), the device's busy and idle share of the served
window, and the host syncs per tick. For orientation it also times the
reference sampler (a full forward every step, ``sample_full``) on 4
requests at batch 4, the same work without speculation.

``--max-draft-depth K --depths 1,2,4,4`` serves the requests in draft-K
chains (request i at depth ``depths[i % len(depths)]``), the chip check's
deep phase.

Run from the repository root on the card:
    python3 tools/profile_torch_serve.py [--max-draft-depth 4 --depths 1,2,4,4]
Writes ``chiprun_out/profile_torch_serve[_<tag>].json`` and prints it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

GROUPS = (("taylor_predict_lanes", ("predict_lanes_kernel",)),
          ("taylor_update_lanes", ("update_lanes_kernel",)),
          ("verify_accept", ("verify_kernel",)),
          ("taylor_predict_chain_lanes", ("predict_chain_kernel",)),
          ("lane_rollback", ("rollback_kernel",)),
          ("spectral_update_lanes", ("ring_update_kernel",)),
          ("attention", ("fmha", "attention", "flash", "efficient")),
          ("matmul", ("gemm", "xmma", "cutlass", "sm90_", "cublas",
                      "nvjet")))


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def busy_us(intervals):
    """Length of the union of [start, end) intervals (µs)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--max-draft-depth", type=int, default=1)
    ap.add_argument("--depths", default="1",
                    help="comma-separated draft_depth by request")
    args = ap.parse_args()
    depths = [int(d) for d in args.depths.split(",")]
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.configs import DIT_XL2, DiffusionConfig, SpeCaConfig
    from repro_torch.diffusion.pipeline import sample_full
    from repro_torch.serving import Request, RequestPolicy, SpeCaEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    dev = torch.device("cuda")
    dcfg = DiffusionConfig()
    smoke = chip_smoke.Smoke(torch, dev, DIT_XL2, dcfg)
    params = smoke._model()
    engine = SpeCaEngine(DIT_XL2, params, dcfg, SpeCaConfig(taylor_order=2),
                         max_draft_depth=args.max_draft_depth,
                         device=dev)
    reqs = [Request(request_id=i, cond={"labels": torch.tensor([37 * i])},
                    seed=100 + i,
                    policy=RequestPolicy(draft_depth=depths[i % len(depths)]))
            for i in range(8)]
    engine.serve_batched(reqs[:4], lanes=4, max_ticks=5)       # warm-up
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    res = engine.serve_batched(reqs, lanes=4)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0

    from torch.profiler import ProfilerActivity, profile
    syncs0 = engine.host_syncs
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.serve_batched(reqs, lanes=4)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    syncs = engine.host_syncs - syncs0
    ticks = max(r.finish_tick for r in res)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_group, by_name = {}, {}
    for e in kernels:
        dt = e.time_range.end - e.time_range.start
        g = group_of(e.name)
        by_group[g] = by_group.get(g, 0.0) + dt
        by_name[e.name] = by_name.get(e.name, 0.0) + dt
    busy = busy_us([(e.time_range.start, e.time_range.end)
                    for e in kernels])
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) if kernels else 0.0
    OUT = ROOT / "chiprun_out"
    OUT.mkdir(exist_ok=True)

    gen = torch.Generator(device=dev).manual_seed(3)
    cond = {"labels": torch.tensor([0, 37, 74, 111], device=dev)}
    sample_full(DIT_XL2, params, dcfg, cond, 4, generator=gen, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sample_full(DIT_XL2, params, dcfg, cond, 4, generator=gen, device=dev)
    torch.cuda.synchronize()
    wall_full4 = time.perf_counter() - t0

    report = {
        "card": chip_smoke.smi_line(),
        "max_draft_depth": args.max_draft_depth, "depths": depths,
        "serve_wall_s": wall_plain,
        "serve_req_per_s": len(reqs) / wall_plain,
        "profiled_wall_s": wall_prof,
        "ticks": ticks,
        "host_syncs": syncs,
        "alpha_mean": sum(r.alpha for r in res) / len(res),
        "device_kernels": len(kernels),
        "device_busy_ms": busy / 1e3,
        "device_span_ms": span / 1e3,
        # the profiler slows the host, not the device: the busy time
        # against the unprofiled wall is the closer idle share
        "device_idle_share_of_profiled_wall": 1.0 - busy / 1e6 / wall_prof,
        "device_idle_share_of_unprofiled_wall":
            1.0 - busy / 1e6 / wall_plain,
        "group_ms": {k: v / 1e3 for k, v in sorted(
            by_group.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms": {k: v / 1e3 for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:15]},
        "sample_full_batch4_wall_s": wall_full4,
    }
    tag = "" if args.max_draft_depth == 1 else f"_k{args.max_draft_depth}"
    (OUT / f"profile_torch_serve{tag}.json").write_text(
        json.dumps(report, indent=1))
    for k, v in report.items():
        if isinstance(v, dict):
            print(f"{k}:")
            for name, ms in v.items():
                print(f"  {ms:10.3f}  {name[:110]}")
        else:
            print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
