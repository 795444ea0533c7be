"""Waits of the host on the device a window tick: the growth of the
program's ``speca_device_waits_total`` (every reason: the lane step's
branch reads, the ``advanced`` fetch, a lane fill's blocking copies, the
harvest's flag and sample reads) over the window's ticks. Needs the
engine built with observability and ``harness/phases.PhaseTracer``."""


def read(run):
    growth = getattr(run.tracer, "growth", None)
    if growth is None or not run.window.ticks:
        return None
    waits = growth("speca_device_waits_total")
    return None if waits is None else waits / run.window.ticks
