"""Useful model FLOPs over the host seconds of the window's unprofiled
ticks, at the H100's dense bf16 peak, in %. Per lane, at batch-1
equivalence (``bench/harness/flops.py``): a step served by the full
forward counts one full forward of one sample, an accepted draft one
drafted step (the verify layer, the glue, the forecast). Work computed
for lanes that do not need it counts nothing. Ticks run under the
profiler are left out, their work and their seconds alike."""
from bench.harness import flops, roofline as RL


def read(run):
    if run.ticks is None or run.tracer is None:
        return None
    cfg = run.cfg
    per = {1: flops.verify_flops(cfg), 2: flops.forward_flops(cfg)}
    useful = seconds = 0.0
    for i, dt in enumerate(run.tracer.tick_seconds()):
        if i in run.tracer.profiled or i >= len(run.ticks):
            continue
        useful += sum(float(run.ticks[i, k]) * f for k, f in per.items())
        seconds += dt
    if seconds <= 0:
        return None
    return 100.0 * useful / (seconds * RL.BF16_TC_FLOPS)
