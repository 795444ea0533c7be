#!/usr/bin/env python3
"""Time two builds of a flash attention kernel in turns, on one GPU.

Builds ``--variant`` (another version of the route's source with the same
C entry point, e.g. a parent commit's) beside the tree's own, holds both
against the plain f32 attention (the chip check's tolerance) and times
them at ``chip_smoke.py``'s attention shapes (gemma3-27b global and
local, DiT-XL/2) in the order variant, tree, tree, variant: device time
per call from ``torch.profiler`` and CUDA events over 20 calls.
``--route bf16`` (the default) builds ``csrc/flash_attention_sm90.cu``'s
entry on bf16 inputs (rtol 2^-8, atol 1e-5); ``--route f32``
``csrc/flash_attention.cu``'s on inputs drawn in f32 (rtol = atol =
2e-5).

Run from the repository root on the card:
    python3 tools/flash_ab.py --route f32 --variant path/to/flash_attention.cu
Writes ``chiprun_out/flash_ab_<route>.json`` and prints it.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


ROUTES = {"bf16": "flash_attention_sm90", "f32": "flash_attention"}


def load_variant(source: Path, entry: str, argtypes):
    """Build ``source`` as the tree's libraries are built (a header beside
    it comes before the tree's of the same name); returns its C ``entry``
    with ``argtypes``. What ptxas reported goes beside the library, as
    ``<library>.log``."""
    from repro_torch.kernels import build
    h = hashlib.sha256(source.read_bytes())
    for f in sorted(build.CSRC.glob("*.cuh")) + \
            sorted(source.parent.glob("*.cuh")):
        h.update(f.read_bytes())
    path = build.BUILD_DIR / f"ab-{h.hexdigest()[:16]}.so"
    if not path.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        done = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS,
                               "-I", str(build.CSRC), "-o", str(path),
                               str(source)], capture_output=True, text=True)
        if done.returncode:
            raise RuntimeError(f"nvcc failed on {source}:\n"
                               f"{done.stdout}{done.stderr}")
        path.with_suffix(".log").write_text(done.stdout + done.stderr)
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, entry)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    fn.log = path.with_suffix(".log").read_text() \
        if path.with_suffix(".log").exists() else ""
    return fn


def caller(torch, fn, q, k, v, causal, window):
    """One call of a library's entry point, as ops.flash_attention makes
    it."""
    from repro_torch.kernels import ops
    B, S, H, hd = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = [s for t in (q, k, v) for s in ops._tma_strides(t)]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                S, H, hd, *strides, int(causal), max(min(window, S), 0),
                1.0 / hd ** 0.5, stream, q.device.index)
        assert rc == 0, f"launch failed: {rc}"
        return out
    return call


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", type=Path, required=True)
    ap.add_argument("--route", choices=sorted(ROUTES), default="bf16")
    ap.add_argument("--no-check", action="store_true",
                    help="time a variant that computes something else "
                    "(a diagnostic with work removed)")
    args = ap.parse_args()
    name = ROUTES[args.route]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    assert torch.cuda.is_available(), "needs a CUDA device"
    fns = {"variant": load_variant(args.variant.resolve(), name,
                                   build.SIGNATURES[name][name]),
           "tree": getattr(build.library(name), name)}
    tol = dict(rtol=2.0 ** -8, atol=1e-5) if args.route == "bf16" else \
        dict(rtol=2e-5, atol=2e-5)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    S, H, hd = cs.ATTN_SEQ, cs.GEMMA3_HEADS, cs.GEMMA3_HEAD_DIM
    cases = {"gemma3_global": ((1, S, H, hd), True, 0),
             "gemma3_local": ((1, S, H, hd), True, cs.GEMMA3_WINDOW),
             "dit_xl2": ((cs.LANES, 256, 16, 72), False, 0)}
    result = {"card": cs.smi_line(), "variant": str(args.variant),
              "route": args.route, "checked": not args.no_check,
              "cases": {}}
    for case, (shape, causal, window) in cases.items():
        q, k, v = (torch.randn(shape, generator=g, device=dev)
                   for _ in range(3))
        if args.route == "bf16":
            q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
        want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                       causal=causal, window=window)
        calls = {n: caller(torch, f, q, k, v, causal, window)
                 for n, f in fns.items()}
        row = {n: {"device_ms": [], "ms": []} for n in calls}
        for n in calls:
            if n == "tree" or not args.no_check:
                torch.testing.assert_close(calls[n]().float(), want, **tol)
        for n in ("variant", "tree", "tree", "variant"):
            spans = cs.device_spans(torch, calls[n], iters=20)
            row[n]["device_ms"].append(sum(spans.values()) / 1e3)
            row[n]["ms"].append(cs.time_ms(torch, calls[n], iters=20))
        result["cases"][case] = row
        print(case, json.dumps(row), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"flash_ab_{args.route}.json").write_text(
        json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
