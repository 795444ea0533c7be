#!/usr/bin/env python3
"""Split the rollback wrapper's host time, and time the chain step's old
restore against its new one, in turns, on one GPU.

On the serving latent snapshots (K+1 = 5 snapshots [4, 32, 32, 4] f32,
seeded; each lane's index seeded in 0..K) it times these calls, in
``ROUNDS`` rounds of the order of ``PATHS`` and then its reverse:

- ``old``: the chain step's restore before snapshots were passed
  through: ``torch.stack`` of the snapshots, then ``ops.lane_rollback``
  on the stacked tensor (the stacked entry);
- ``new``: ``ops.lane_rollback`` over the list of snapshots (the
  snapshot entry);
- ``bare``: the snapshot entry's C call alone, its pointer table,
  integers and output prepared once;
- ``bare_stacked``: the stacked entry's C call alone on a prepared
  stacked chain (its parameters are 2 KB smaller: no pointer table);
- ``empty``: ``torch.empty`` of the output with its shape, dtype and
  device (what the wrapper first did);
- ``empty_like``: ``torch.empty_like`` of a snapshot (what it does now);
- ``checks``: the wrapper's argument checks of a snapshot list alone
  (``ops._snapshots``, the lane fold, the idx checks);
- ``table``: building the ``ctypes`` pointer table alone;
- ``stack``: ``torch.stack`` of the snapshots alone.

For each: host µs per call (the host clock over back-to-back calls, the
device drained before and not inside), and for the calls that launch:
CUDA events per call, device time per call and kernels per call from
``torch.profiler``. ``new`` − ``bare`` − ``empty_like`` − ``checks`` −
``table`` is what else the wrapper spends on the host.

Run from the repository root on the card:
    python3 tools/rollback_ab.py
Writes ``chiprun_out/rollback_ab.json`` and prints it.
"""
from __future__ import annotations

import ctypes
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

PATHS = ("old", "new", "bare", "bare_stacked", "empty", "empty_like",
         "checks", "table", "stack")
LAUNCHING = ("old", "new", "bare", "bare_stacked")
HOST_CALLS = 2000
ROUNDS = 3


def host_us(torch, fn, calls: int = HOST_CALLS) -> float:
    """Host µs per call of ``fn`` over back-to-back calls."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def calls(torch, snaps, idx):
    """name -> one call of each path in ``PATHS``."""
    from repro_torch.kernels import build, ops
    x = snaps[0]
    K1, W = len(snaps), x.shape[0]
    lib = build.library("lane_rollback")
    out = torch.empty_like(x)
    stream, dev = ops._stream(x)
    row_bytes = x[0].numel() * x.element_size()
    table = (ctypes.c_void_p * K1)(*[t.data_ptr() for t in snaps])
    args = (table, K1, idx.data_ptr(), out.data_ptr(), W, row_bytes, W,
            stream, dev)
    stacked = torch.stack(snaps)
    stacked_args = (stacked.data_ptr(), idx.data_ptr(), out.data_ptr(),
                    K1 - 1, W, row_bytes, W, stream, dev)

    def bare():
        rc = lib.lane_rollback_snapshots(*args)
        assert rc == 0, f"launch failed: {rc}"
        return out

    def bare_stacked():
        rc = lib.lane_rollback(*stacked_args)
        assert rc == 0, f"launch failed: {rc}"
        return out
    bare_stacked.chain = stacked          # the launch reads it: keep it

    def checks():
        s, d = ops._snapshots(snaps)
        ops._lane_fold(s[0].shape, 0)
        return idx.shape == (W,) and idx.dtype == torch.int32 and \
            idx.device == d and idx.is_contiguous()

    return {"old": lambda: ops.lane_rollback(torch.stack(snaps), idx,
                                             lane_axis=0),
            "new": lambda: ops.lane_rollback(snaps, idx, lane_axis=0),
            "bare": bare,
            "bare_stacked": bare_stacked,
            "empty": lambda: torch.empty(x.shape, dtype=x.dtype,
                                         device=x.device),
            "empty_like": lambda: torch.empty_like(x),
            "checks": checks,
            "table": lambda: (ctypes.c_void_p * K1)(
                *[t.data_ptr() for t in snaps]),
            "stack": lambda: torch.stack(snaps)}


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import ref
    assert torch.cuda.is_available(), "needs a CUDA device"
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    K, W, size, ch = cs.CHAIN_K, cs.LANES, 32, 4
    snaps = [torch.randn((W, size, size, ch), generator=g, device=dev)
             for _ in range(K + 1)]
    idx = torch.randint(0, K + 1, (W,), generator=g, device=dev,
                        dtype=torch.int32)
    fns = calls(torch, snaps, idx)
    want = ref.lane_rollback_ref(snaps, idx, lane_axis=0)
    for name in LAUNCHING:
        assert torch.equal(fns[name](), want), f"{name}: not bitwise"
    row = {n: {"host_us": []} for n in PATHS}
    for n in LAUNCHING:
        row[n].update(event_ms=[], device_ms=[], kernels_per_call=[])
    for n in (PATHS + PATHS[::-1]) * ROUNDS:
        fn = fns[n]
        row[n]["host_us"].append(host_us(torch, fn))
        if n in LAUNCHING:
            spans = cs.device_spans(torch, fn, iters=100)
            row[n]["device_ms"].append(sum(spans.values()) / 1e3)
            row[n]["kernels_per_call"].append(cs.kernels_per_call(torch, fn))
            row[n]["event_ms"].append(cs.time_ms(torch, fn, iters=200))
    result = {"card": cs.smi_line(), "snapshots": [K + 1, W, size, size, ch],
              "dtype": "float32", "idx": idx.tolist(), "paths": row}
    print(json.dumps(result), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "rollback_ab.json").write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
