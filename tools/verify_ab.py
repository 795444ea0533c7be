#!/usr/bin/env python3
"""Time another build of the fused verify with τ against the tree's, in
turns, on one GPU.

Builds ``--variant`` beside the tree's one-launch kernel: with
``--abi two_pass`` (the default) the two-pass design of
``csrc/verify_accept.cu`` (a partials kernel, then a finish kernel, no
atomics, 8,192-element chunks, partials and outputs allocated per call),
with ``--abi one_launch`` another version of the tree's own (its C
signature, chunk and scratch). On
the serving planes (W 4 lanes × 294,912 elements, bf16 and f32, seeded)
it holds both against the plain version (rtol 1e-5, equal accept bits
where |e − τ| > 1e-5) and times, in the order variant, tree, tree,
variant: device time per call and kernels per call from
``torch.profiler``, and CUDA events over 200 calls of the whole wrapper
(``ops.verify_accept`` for the tree; the two-pass wrapper's allocations
and call for the variant) and of the bare C entry with preallocated
buffers, whose difference is the wrapper's own host cost.

Run from the repository root on the card:
    python3 tools/verify_ab.py --variant path/to/verify_accept.cu \
        [--abi one_launch]
Writes ``chiprun_out/verify_ab_<abi>.json`` and prints it.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# the two-pass design's entry: pred, ref, tau, partials, err, accept,
# dtype, W, N, chunk, nchunks, eps, vec, stream, device
VARIANT_ARGS = (_P, _P, _P, _P, _P, _P, _I, _I, _LL, _LL, _I, _F, _I, _P, _I)
VARIANT_CHUNK = 8192


def variant_calls(torch, fn, pred, real, tau):
    """(wrapper, bare) calls of the two-pass entry: the wrapper allocates
    partials, err and accept each call, as ops.verify_accept of the two-pass design
    did; the bare call reuses one set."""
    from repro_torch.kernels import ops
    W, N = pred.shape
    nchunks = -(-N // VARIANT_CHUNK)
    code = ops._DTYPE_CODES[pred.dtype]
    vec = ops._vec_ok(N, pred.element_size(), pred, real)

    def launch(partials, err, accept):
        stream, dev = ops._stream(pred)
        rc = fn(pred.data_ptr(), real.data_ptr(), tau.data_ptr(),
                partials.data_ptr(), err.data_ptr(), accept.data_ptr(), code,
                W, N, VARIANT_CHUNK, nchunks, 1e-8, vec, stream, dev)
        assert rc == 0, f"launch failed: {rc}"
        return err, accept

    def alloc():
        return (torch.empty((W, nchunks, 2), dtype=torch.float32,
                            device=pred.device),
                torch.empty((W,), dtype=torch.float32, device=pred.device),
                torch.empty((W,), dtype=torch.bool, device=pred.device))
    bufs = alloc()
    return (lambda: launch(*alloc())), (lambda: launch(*bufs))


def tree_calls(torch, pred, real, tau, fn=None):
    """(wrapper, bare) calls of an entry with the tree's signature:
    ``ops.verify_accept`` (for another build ``fn``: its allocation of the
    outputs and its call), and the C entry on a zeroed scratch of its own
    and one output set."""
    from repro_torch.kernels import build, ops
    W, N = pred.shape
    stream, dev = ops._stream(pred)
    nchunks = -(-N // ops._VERIFY_CHUNK)
    tickets = torch.zeros(W, dtype=torch.int32, device=pred.device)
    partials = torch.empty(2 * W * nchunks, device=pred.device)
    tree = fn is None
    fn = fn or build.library("verify_accept").verify_accept
    code = ops._DTYPE_CODES[pred.dtype]
    vec = ops._vec_ok(N, pred.element_size(), pred, real)

    def launch(err, accept):
        rc = fn(
            pred.data_ptr(), real.data_ptr(), tau.data_ptr(),
            partials.data_ptr(), tickets.data_ptr(), err.data_ptr(),
            accept.data_ptr(), code, W, N, ops._VERIFY_CHUNK, nchunks, 1e-8,
            vec, stream, dev)
        assert rc == 0, f"launch failed: {rc}"
        return err, accept

    def alloc():
        buf = torch.empty(5 * W, dtype=torch.uint8, device=pred.device)
        return buf[:4 * W].view(torch.float32), buf[4 * W:].view(torch.bool)
    outs = alloc()
    if tree:
        return (lambda: ops.verify_accept(pred, real, tau)), \
            (lambda: launch(*outs))
    return (lambda: launch(*alloc())), (lambda: launch(*outs))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", type=Path, required=True)
    ap.add_argument("--abi", choices=("two_pass", "one_launch"),
                    default="two_pass")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from flash_ab import load_variant
    from repro_torch.kernels import build, ref
    assert torch.cuda.is_available(), "needs a CUDA device"
    one = args.abi == "one_launch"
    fn = load_variant(args.variant.resolve(), "verify_accept",
                      build.SIGNATURES["verify_accept"]["verify_accept"]
                      if one else VARIANT_ARGS)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    W, N = cs.LANES, 256 * 1152
    real = torch.randn((W, N), generator=g, device=dev)
    scale = torch.tensor([0.05, 0.2, 0.5, 1.0], device=dev)[:, None]
    pred = real + scale * torch.randn((W, N), generator=g, device=dev)
    result = {"card": cs.smi_line(), "variant": str(args.variant),
              "abi": args.abi, "shape": [W, N], "cases": {}}
    for dtype in (torch.bfloat16, torch.float32):
        p, r = pred.to(dtype).contiguous(), real.to(dtype).contiguous()
        ep, _ = ref.verify_accept_ref(p, r, torch.ones(W, device=dev))
        tau = (ep * torch.tensor([2.0, 0.5, 1.0, 0.9], device=dev))
        ep, ap_ = ref.verify_accept_ref(p, r, tau)
        calls = {"variant": tree_calls(torch, p, r, tau, fn) if one
                 else variant_calls(torch, fn, p, r, tau),
                 "tree": tree_calls(torch, p, r, tau)}
        row = {n: {"device_ms": [], "kernels_per_call": [], "ms": [],
                   "bare_ms": []} for n in calls}
        far = (ep - tau).abs() > 1e-5
        for n, (wrapped, bare) in calls.items():
            for call in (wrapped, bare):
                ek, ak = call()
                torch.testing.assert_close(ek, ep, rtol=1e-5, atol=0.0)
                assert torch.equal(ak[far], ap_[far]), f"{n}: accept bits"
        for n in ("variant", "tree", "tree", "variant"):
            wrapped, bare = calls[n]
            spans = cs.device_spans(torch, wrapped, iters=100)
            row[n]["device_ms"].append(sum(spans.values()) / 1e3)
            row[n]["kernels_per_call"].append(
                cs.kernels_per_call(torch, wrapped))
            row[n]["ms"].append(cs.time_ms(torch, wrapped, iters=200))
            row[n]["bare_ms"].append(cs.time_ms(torch, bare, iters=200))
        result["cases"][str(dtype)] = row
        print(dtype, json.dumps(row), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"verify_ab_{args.abi}.json").write_text(
        json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
