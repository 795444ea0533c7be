"""Share of the traced slice's device idle time (the union
``device_idle_share`` reads) that lies under the engine's ``admit`` and
``harvest`` spans, mapped onto the profiler's time base by the slice's
clock anchors, in %. Needs the engine built with observability and
``harness/phases.PhaseTracer``."""


def read(run):
    sl = None if run.tracer is None else run.tracer.slice
    share = getattr(sl, "idle_share_under", None)
    return None if share is None else share(("admit", "harvest"))
