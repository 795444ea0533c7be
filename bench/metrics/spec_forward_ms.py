"""Device ms of a drafted step's forward (every layer forecast, the
verify layer computed): CUDA events around each call of the workload's
``spec_forward`` in the window, their total over the calls."""


def read(run):
    return None if run.tracer is None else run.tracer.forward_ms("spec")
