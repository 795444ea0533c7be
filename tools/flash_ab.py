#!/usr/bin/env python3
"""Time two builds of the bf16 flash attention kernel in turns, on one GPU.

Builds ``--variant`` (another version of ``csrc/flash_attention_sm90.cu``
with the same C entry point, e.g. a parent commit's) beside the tree's
own, holds both against the plain f32 attention (rtol 2^-8, atol 1e-5,
the chip check's tolerance) and times them at ``chip_smoke.py``'s
attention shapes (gemma3-27b global and local, DiT-XL/2) in the order
variant, tree, tree, variant: device time per call from
``torch.profiler`` and CUDA events over 20 calls.

Run from the repository root on the card:
    python3 tools/flash_ab.py --variant path/to/flash_attention_sm90.cu
Writes ``chiprun_out/flash_ab.json`` and prints it.
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


def load_variant(source: Path):
    """Build ``source`` as the tree's libraries are built; returns the
    loaded library with the tree's argument types."""
    from repro_torch.kernels import build
    h = hashlib.sha256(source.read_bytes())
    for f in sorted(build.CSRC.glob("*.cuh")):
        h.update(f.read_bytes())
    path = build.BUILD_DIR / f"ab-{h.hexdigest()[:16]}.so"
    if not path.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS,
                        "-I", str(build.CSRC), "-o", str(path),
                        str(source)], check=True)
    lib = ctypes.CDLL(str(path))
    fn = lib.flash_attention_sm90
    fn.argtypes = list(build.SIGNATURES["flash_attention_sm90"]
                       ["flash_attention_sm90"])
    fn.restype = ctypes.c_int
    return fn


def caller(torch, fn, q, k, v, causal, window):
    """One call of a library's entry point, as ops.flash_attention makes
    it for bf16 inputs."""
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
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    assert torch.cuda.is_available(), "needs a CUDA device"
    fns = {"variant": load_variant(args.variant.resolve()),
           "tree": build.library("flash_attention_sm90").flash_attention_sm90}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    S, H, hd = cs.ATTN_SEQ, cs.GEMMA3_HEADS, cs.GEMMA3_HEAD_DIM
    cases = {"gemma3_global": ((1, S, H, hd), True, 0),
             "gemma3_local": ((1, S, H, hd), True, cs.GEMMA3_WINDOW),
             "dit_xl2": ((cs.LANES, 256, 16, 72), False, 0)}
    result = {"card": cs.smi_line(), "variant": str(args.variant),
              "cases": {}}
    for name, (shape, causal, window) in cases.items():
        q, k, v = (torch.randn(shape, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                       causal=causal, window=window)
        calls = {n: caller(torch, f, q, k, v, causal, window)
                 for n, f in fns.items()}
        row = {n: {"device_ms": [], "ms": []} for n in calls}
        for n in calls:
            torch.testing.assert_close(calls[n]().float(), want,
                                       rtol=2.0 ** -8, atol=1e-5)
        for n in ("variant", "tree", "tree", "variant"):
            spans = cs.device_spans(torch, calls[n], iters=20)
            row[n]["device_ms"].append(sum(spans.values()) / 1e3)
            row[n]["ms"].append(cs.time_ms(torch, calls[n], iters=20))
        result["cases"][name] = row
        print(name, json.dumps(row), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "flash_ab.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
