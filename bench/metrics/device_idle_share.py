"""Share of the traced slice in which no operation ran on the device, in
%: 1 − the union of its device intervals over the slice's length, both
from the same trace."""


def read(run):
    sl = None if run.tracer is None else run.tracer.slice
    if sl is None or sl.seconds <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.seconds)
