"""Device ms of a full forward: CUDA events around each call of the
workload's ``full_forward`` in the window, their total over the calls
(a mean, not a median)."""


def read(run):
    return None if run.tracer is None else run.tracer.forward_ms("full")
