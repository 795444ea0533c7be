"""Calls of the workload's ``full_forward`` over the window's ticks (a
tick runs at most one: the lanes that rejected or could not draft share
it)."""


def read(run):
    if run.tracer is None or not run.window.ticks:
        return None
    return len(run.tracer.calls["full"]) / run.window.ticks
