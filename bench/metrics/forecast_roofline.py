"""Share of their roofline the forecast kernels reach in the traced
slice, in %: Σ bound ÷ Σ device time of the predict, refresh and verify
kernels. A call's bound is the bytes it needs (the lanes that draft, or
that refresh, by the window's decisions) over the H100's memory
bandwidth (``bench/harness/roofline.py``), so a kernel that skips lanes
it does not need cannot read above 100 %."""
from bench.harness import flops, roofline as RL

ELEM = {"bfloat16": 2, "float16": 2, "float32": 4}


def read(run):
    sl = None if run.tracer is None else run.tracer.slice
    if sl is None or run.ticks is None:
        return None
    cfg = run.cfg
    n, e = flops.tokens(cfg), ELEM[cfg["dtype"]]
    bound = 0.0
    for draft, _acc, full in run.ticks[sl.first:sl.first + sl.ticks]:
        if draft:
            for kind in ("predict", "verify"):
                bound += RL.bound_s(RL.call_bytes(kind, cfg, n, int(draft),
                                                  e), 0.0)
        if full:
            bound += RL.bound_s(RL.call_bytes("refresh", cfg, n, int(full),
                                              e), 0.0)
    spent = sum(sl.kernel_s.values())
    return 100.0 * bound / spent if spent > 0 else None
