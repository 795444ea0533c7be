#!/usr/bin/env python3
"""Where a decode lane step's forwards spend their time, on one GPU.

Builds the chip check's decode workload — Llama-3-8B at full width and
depth, bf16 random weights drawn on the card from seed 0, 4 lanes filled
with the chip check's first 4 seeded prompts, ``max_seq_len`` 192 — and
measures the two forwards a decode tick runs (``DecodeWorkload``'s full
forward and its speculative forward: the verify layer real, every other
layer only its K/V cache write):

* host wall per forward (ending in a synchronise) and CUDA-event time
  over back-to-back forwards;
* the host syncs a forward makes (``torch.cuda.set_sync_debug_mode``
  warnings);
* from ``torch.profiler``: kernels per forward, device busy time by
  kernel group (matmul, attention, other) and the busiest kernels;
* the forward's bound: the bytes it must read (weights, the K/V cache
  it attends over) over 3.35 TB/s.

Run from the repository root on the card:
    python3 tools/profile_torch_decode.py [--lanes 4] [--iters 10]
Writes ``chiprun_out/profile_torch_decode.json`` and prints it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def count_syncs(torch, fn) -> int:
    """Synchronising CUDA calls one call of ``fn`` makes, as the sync
    debug mode reports them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message).lower() for w in seen)


def profile(torch, fn, iters: int):
    """(kernels per call, busy µs per call by group, top kernels)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof_ctx
    from tools.profile_torch_serve import busy_us, group_of
    fn()
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    groups, by_name = {}, {}
    for e in events:
        span = (e.time_range.start, e.time_range.end)
        groups.setdefault(group_of(e.name), []).append(span)
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + span[1] - span[0])
    busy = {g: busy_us(v) / iters for g, v in groups.items()}
    busy["all"] = busy_us([s for v in groups.values() for s in v]) / iters
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return (len(events) / iters, busy,
            [{"kernel": k[:100], "calls": n / iters, "us": t / iters}
             for k, (n, t) in top])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_decode: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.configs import LLAMA3_8B
    from repro_torch.core import lane_step as LS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    dev = torch.device("cuda")
    smoke = chip_smoke.Smoke(torch, "cuda", None, None, LLAMA3_8B)
    wl = smoke._decode_workload(1.0)
    W, cfg = args.lanes, LLAMA3_8B
    state = LS.init_workload_state(wl, W, {}, active=True)
    for lane, req in enumerate(smoke._decode_requests(W)):
        state = wl.fill_payload(state, lane, req, wl.num_steps)
    dyn = {k: state[k] for k in wl.dyn_keys}
    s_eff = torch.full((W,), 3, dtype=torch.int32, device=dev)
    ctx = wl.step_context(state, s_eff)
    g = torch.Generator(device=dev).manual_seed(5)
    preds = (torch.randn((cfg.num_layers, 2, W, 1, cfg.d_model),
                         generator=g, device=dev) * 0.05).to(wl.table_dtype)
    calls = {"full": lambda: wl.full_forward(dyn, {}, ctx),
             "spec": lambda: wl.spec_forward(dyn, {}, ctx, preds)}
    p = smoke._lm_params()
    blocks, es = p["blocks"], 2
    layer_bytes = sum(t[0].numel() for t in chip_smoke._leaves(blocks)) * es
    kv_layer = {k: blocks[k][0].numel() * es for k in ("wk", "wv")}
    head = p["head"]["w"].numel() * es
    cache = 2 * state["k"].numel() * es
    need = {"full": cfg.num_layers * layer_bytes + head + cache,
            "spec": layer_bytes + (cfg.num_layers - 1) * sum(
                kv_layer.values()) + head + cache // cfg.num_layers}
    out = {"card": chip_smoke.smi_line(), "lanes": W,
           "max_seq_len": wl.max_seq_len, "forwards": {}}
    for name, fn in calls.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        event_ms = chip_smoke.time_ms(torch, fn, iters=args.iters)
        syncs = count_syncs(torch, fn)
        kernels, busy, top = profile(torch, fn, 3)
        bound, by = chip_smoke.bound_ms(need[name], 0.0)
        out["forwards"][name] = dict(
            wall_ms=sorted(walls)[len(walls) // 2], event_ms=event_ms,
            host_syncs=syncs, kernels=kernels,
            busy_ms={k: v / 1e3 for k, v in busy.items()},
            bound_ms=bound, bound_by=by, bytes=need[name], top=top)
        print(f"{name}: {out['forwards'][name]}", flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "profile_torch_decode.json").write_text(
        json.dumps(out, indent=1))
    print(out["card"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
