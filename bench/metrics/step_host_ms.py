"""Host ms of a lane step outside its waits on the device: the growth of
the program's ``speca_step_host_seconds_total`` over the growth of its
lane steps (``speca_obs_ticks_total``, one accumulator update a step) in
the window. Needs the engine built with observability and
``harness/phases.PhaseTracer``."""


def read(run):
    growth = getattr(run.tracer, "growth", None)
    if growth is None:
        return None
    steps = growth("speca_obs_ticks_total")
    if not steps:
        return None
    return 1e3 * growth("speca_step_host_seconds_total") / steps
