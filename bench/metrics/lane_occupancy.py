"""Occupied lane-ticks over all lane-ticks of the window, in %: the
requests in flight in each tick, by the harness's own admission
record."""


def read(run):
    w = run.window
    lanes = int(run.cfg["lanes"])
    return 100.0 * w.lane_steps / (lanes * w.ticks) if w.ticks else None
