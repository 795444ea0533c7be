"""Host syncs a tick: the growth of ``SpeCaEngine.host_syncs`` over the
window's ticks (the lane step's branch decisions and any counter
fetches)."""


def read(run):
    w = run.window
    return w.host_syncs / w.ticks if w.ticks else None
