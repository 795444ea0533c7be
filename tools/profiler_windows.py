#!/usr/bin/env python3
"""Count how often torch.profiler loses the CUDA events of a window, on
one GPU.

The kernel counts of ``chip_smoke.py`` and of the card tests are read
from torch.profiler windows (``iters`` calls of a function between the
profiler's start and stop). This records ``WINDOWS`` windows of each of
these functions and counts the CUDA events of each:

- ``mixed``: ``ops.verify_accept_mixed`` (first pair paired);
- ``accept``: ``ops.verify_accept``;
- ``torch_add``: one PyTorch elementwise kernel on 16 elements (no
  kernel of this repo);

on bf16 verify planes [5, 3000] and [4, 294912] (seeded), at 10 and 100
calls a window, with the profiler's default and with ``acc_events=True``.
A window that counts fewer events than calls lost some; the histogram
and the indices of the windows that lost all are printed.

Run from the repository root on the card:
    python3 tools/profiler_windows.py
Writes ``chiprun_out/profiler_windows.json`` and prints one line a case.
"""
from __future__ import annotations

import collections
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

WINDOWS = 60
PLANES = ((5, 3000), (4, 294912))


def _events(torch, fn, iters: int, acc: bool) -> int:
    from torch.profiler import ProfilerActivity, profile
    kw = {"acc_events": True} if acc else {}
    with profile(activities=[ProfilerActivity.CUDA], **kw) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profiler_windows: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    out = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "device": torch.cuda.get_device_name(0), "cases": {}}
    for W, N in PLANES:
        g = torch.Generator(device=dev).manual_seed(1)
        real = torch.randn((W, N), generator=g, device=dev)
        pred = real + 0.3 * torch.randn((W, N), generator=g, device=dev)
        pred, real = pred.to(torch.bfloat16), real.to(torch.bfloat16)
        tau = torch.full((W,), 0.3, device=dev)
        gs = torch.full((W,), 1.5, device=dev)
        paired = torch.arange(W, device=dev) < 2
        small = torch.ones(16, device=dev)
        fns = {"mixed": lambda: ops.verify_accept_mixed(pred, real, tau, gs,
                                                        paired),
               "accept": lambda: ops.verify_accept(pred, real, tau),
               "torch_add": lambda: small.add(1.0)}
        for name, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            for iters in (10, 100):
                for acc in (False, True):
                    t0 = time.perf_counter()
                    counts = [_events(torch, fn, iters, acc)
                              for _ in range(WINDOWS)]
                    key = (f"{name} [{W}, {N}] iters={iters} "
                           f"acc_events={acc}")
                    case = dict(
                        hist=dict(collections.Counter(counts)),
                        lost_some=sum(c < iters for c in counts),
                        lost_all_at=[i for i, c in enumerate(counts)
                                     if c == 0],
                        s=time.perf_counter() - t0)
                    out["cases"][key] = case
                    print(key, case, flush=True)
    lost = sum(c["lost_some"] for c in out["cases"].values())
    total = WINDOWS * len(out["cases"])
    out["windows"], out["windows_lost_some"] = total, lost
    print(f"{lost} of {total} windows lost events")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "profiler_windows.json").write_text(
        json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
