#!/usr/bin/env python3
"""Time other builds of the lane and chain predict kernels against the
tree's, in turns, on one GPU.

Builds each ``--variant DIR``'s ``taylor_predict_lanes.cu`` and
``taylor_predict_chain.cu`` (another version with the tree's C entry
points: a parent commit's, or the tree's with a header of its own beside
them, which comes before the tree's) beside the tree's. At the tables
of the serving paths (``SHAPES``: DiT-XL/2 in bf16 and f32, Llama-3-8B
decode at 8 and 32 layers, FLUX-like, HunyuanVideo-like) and for the
lane predict and the chain at K = 1 and 4 it

- asserts every build's output ``torch.equal`` to the tree's, holds the
  tree's against the plain version a layer at a time (bf16 within one
  bf16 ulp of the plain f32 sum, f32 to FMA rounding: the chip check's
  bars) and each chain position bitwise the lane predict;
- times every build in turns (the builds in order, then reversed):
  device ms a call from ``torch.profiler`` back to back and with the 50 MB
  L2 flushed before each call, kernels a call, and CUDA events over the
  same two (the cold one less the flush alone); every build through the
  same Python call (allocate the output, call the C entry);
- reports the bound (the bytes at 3.35 TB/s: 2·(m+2) bytes a bf16
  element for the predict, 2·(m+1+K) for the chain) and the launch floor
  of the tree's grid (its empty kernel on the same grid, block and
  shared memory), timed the same ways.

Each table is released before the next: the FLUX-like chain at K = 4
holds ~21 GB with two outputs. Run from the repository root on the card,
the variant under a gitignored directory (the chip copy has no .git):

    mkdir -p build/ab/parent
    for f in taylor_predict_lanes taylor_predict_chain; do git show \
        <commit>:src/repro_torch/kernels/csrc/$f.cu > build/ab/parent/$f.cu
    done
    python3 tools/predict_ab.py --variant build/ab/parent \
        [--variant build/ab/other] [--shapes decode32,dit_bf16] \
        [--cases lanes,chain_k4] [--tag T]

A build is named by its directory.

Writes ``chiprun_out/predict_ab.json`` (``predict_ab_<T>.json``) and
prints one line a case.
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

# name -> (table [m+1, L, 2, W, T, D], dtype name)
SHAPES = {"dit_bf16": ((3, 28, 2, 4, 256, 1152), "bfloat16"),
          "dit_f32": ((3, 28, 2, 4, 256, 1152), "float32"),
          "decode8": ((3, 8, 2, 4, 1, 4096), "bfloat16"),
          "decode32": ((3, 32, 2, 4, 1, 4096), "bfloat16"),
          "flux": ((3, 38, 2, 4, 1024, 3072), "bfloat16"),
          "video": ((3, 40, 2, 2, 2048, 3072), "bfloat16")}
# kernel case -> chain depth K (None: the lane predict)
CASES = {"lanes": None, "chain_k1": 1, "chain_k4": 4}
LIBS = ("taylor_predict_lanes", "taylor_predict_chain")
TIMED_MS = 20.0                  # aim of one timing window, by the bound


def caller(torch, fn, diffs, w, K):
    """One call of a predict library's C entry as ``ops`` makes it: the
    output allocated, the folded shape, the vector flag."""
    from repro_torch.kernels import ops
    m1, feat = diffs.shape[0], tuple(diffs.shape[1:])
    G, B, C = ops._lane_fold(feat, 2)
    code = ops._DTYPE_CODES[diffs.dtype]
    shape, kk = (feat, ()) if K is None else ((K,) + feat, (K,))

    def call():
        out = torch.empty(shape, dtype=diffs.dtype, device=diffs.device)
        stream, dev = ops._stream(diffs)
        rc = fn(diffs.data_ptr(), w.data_ptr(), out.data_ptr(), code, m1,
                *kk, G * B, C, B,
                ops._vec_ok(C, diffs.element_size(), diffs, out), stream,
                dev)
        assert rc == 0, f"launch failed: {rc}"
        return out
    return call


def hold_plain(torch, out, diffs, w, K):
    """The tree's output against the plain version, a layer at a time:
    |kernel − plain f32| ≤ tol·|plain| + 2^-21·Σ|w·x| (one rounding to the
    table dtype, tol 2^-8 in bf16 and 1e-6 in f32, plus the f32 rounding
    by which an FMA chain and a multiply-then-add differ); returns the
    largest |kernel − plain in the table dtype|."""
    from repro_torch.kernels import ref
    tol = 2.0 ** -8 if diffs.dtype == torch.bfloat16 else 1e-6
    wk = w if K is not None else w[:, None]
    worst = 0.0
    for layer in range(diffs.shape[1]):
        d = diffs[:, layer]                   # [m+1, 2, W, T, D], lanes 2
        got = out[:, layer] if K is not None else out[layer][None]
        p32 = ref.taylor_predict_chain_lanes_ref(d.float(), wk, lane_axis=1)
        terms = ref.taylor_predict_chain_lanes_ref(d.float().abs(), wk.abs(),
                                                   lane_axis=1)
        excess = ((got.float() - p32).abs() - tol * p32.abs()
                  - 2.0 ** -21 * terms).max().item()
        assert excess <= 0.0, f"off the plain sum by {excess} at layer {layer}"
        plain = ref.taylor_predict_chain_lanes_ref(d, wk, lane_axis=1)
        worst = max(worst, (got.float() - plain.float()).abs().max().item())
    return worst


def timings(torch, cs, call, names, flush, iters):
    """Device ms a call (profiler, back to back and L2-cold), kernels a
    call, and event ms (back to back and cold less the flush alone) of
    ``call``, whose kernels' names contain one of ``names``."""
    def cold():
        flush.zero_()
        call()

    def ours(spans):
        return sum(us for n, us in spans.items()
                   if any(x in n for x in names)) / 1e3
    return dict(
        device_ms=ours(cs.device_spans(torch, call, iters=iters)),
        cold_device_ms=ours(cs.device_spans(torch, cold, iters=iters)),
        kernels_per_call=cs.kernels_per_call(torch, call, iters=iters),
        ms=cs.time_ms(torch, call, iters=iters),
        cold_ms=cs.time_ms(torch, cold, iters=iters)
        - cs.time_ms(torch, flush.zero_, iters=iters))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", type=Path, action="append", required=True,
                    help="directory with another build's two sources "
                    "(repeatable; the build takes the directory's name)")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--tag", default="",
                    help="writes chiprun_out/predict_ab_<tag>.json")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from flash_ab import load_variant
    from repro_torch.kernels import build, ops
    assert torch.cuda.is_available(), "needs a CUDA device"
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    # build -> lib -> entry; "tree" is the tree's own build
    entries = {"tree": {lib: getattr(build.library(lib), lib) for lib in LIBS}}
    logs = {"tree": {lib: build.build_logs.get(lib, "") for lib in LIBS}}
    variants = [d.resolve() for d in args.variant]
    for src_dir in variants:
        name = src_dir.name
        assert name not in entries, f"two builds named {name}"
        entries[name], logs[name] = {}, {}
        for lib in LIBS:
            fn = load_variant(src_dir / f"{lib}.cu", lib,
                              build.SIGNATURES[lib][lib])
            entries[name][lib], logs[name][lib] = fn, fn.log
    order = [variants[0].name, "tree"] + [d.name for d in variants[1:]]
    order += order[::-1]
    smoke = cs.Smoke(torch, "cuda", None, None)
    dev = torch.device("cuda")
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, device=dev)
    result = {"card": cs.smi_line(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "order": order,
              "variants": [str(d) for d in args.variant], "ptxas": logs,
              "cases": {}}
    print(result["card"], flush=True)
    for sname in args.shapes.split(","):
        table, dname = SHAPES[sname]
        dtype = getattr(torch, dname)
        diffs, _, _, _ = smoke._inputs(table, dtype, 2)
        m1, W = table[0], table[3]
        R, C = table[1] * table[2] * W, table[4] * table[5]
        es = diffs.element_size()
        for cname in args.cases.split(","):
            K = CASES[cname]
            w = smoke._weights(m1, W, K)
            lib = LIBS[0] if K is None else LIBS[1]
            calls = {b: caller(torch, entries[b][lib], diffs, w, K)
                     for b in entries}
            want = calls["tree"]()
            for b, call in calls.items():
                if b != "tree":
                    assert torch.equal(call(), want), f"{b} != tree at " \
                        f"{sname} {cname}"
            err = hold_plain(torch, want, diffs, w, K)
            if K is not None:
                for k in range(K):
                    assert torch.equal(want[k], ops.taylor_predict_lanes(
                        diffs, w[:, k].contiguous())), \
                        f"position {k} != lane predict at {sname} {cname}"
            del want
            torch.cuda.synchronize()
            nbytes = (m1 + (K or 1)) * R * C * es + m1 * (K or 1) * W * 4
            bound, by = cs.bound_ms(nbytes, 2.0 * m1 * (K or 1) * R * C)
            iters = int(max(3, min(100, TIMED_MS / bound)))
            row = {"bound_ms": bound, "bound_by": by, "iters": iters,
                   "max_abs_err": err,
                   "builds": {b: {} for b in entries}}
            for b in order:
                for k, v in timings(torch, cs, calls[b], ("predict_",), flush,
                                    iters).items():
                    row["builds"][b].setdefault(k, []).append(v)
            row["floor"] = timings(
                torch, cs, lambda: ops.predict_launch_floor(diffs, w),
                ("floor_kernel",), flush, iters)
            for b, t in row["builds"].items():
                row["builds"][b] = {k: sum(v) / len(v) for k, v in t.items()}
                row["builds"][b]["turns"] = t
            result["cases"].setdefault(sname, {})[cname] = row
            brief = {b: round(t["cold_device_ms"], 5)
                     for b, t in row["builds"].items()}
            print(f"{sname} {cname}: bound {bound:.5f} floor "
                  f"{row['floor']['device_ms']:.5f} cold device {brief} "
                  f"warm {({b: round(t['device_ms'], 5) for b, t in row['builds'].items()})} "
                  f"events {({b: round(t['ms'], 5) for b, t in row['builds'].items()})}",
                  flush=True)
            del calls
        del diffs
        torch.cuda.empty_cache()
    result["seconds"] = time.perf_counter() - t_start
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    name = f"predict_ab_{args.tag}.json" if args.tag else "predict_ab.json"
    (out / name).write_text(json.dumps(result, indent=1))
    print(f"predict_ab: {len(result['cases'])} tables in "
          f"{result['seconds']:.1f} s; chiprun_out/{name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
