"""The SpeCa serving engine (counterpart of ``repro.serving``)."""
from repro_torch.core.controller import ControllerPolicy
from repro_torch.obs import (Clock, FakeClock, MonotonicClock, Observability,
                             Span, Timings, Trace)
from repro_torch.serving.engine import (Preview, Request, Result,
                                        SpeCaEngine, allocation_report)
from repro_torch.serving.policy import QueueFull, RequestPolicy, Ticket
from repro_torch.serving.scheduler import (EDFScheduler, FIFOScheduler,
                                           QueueItem, Scheduler,
                                           SJFScheduler, WFQScheduler,
                                           make_scheduler)

__all__ = ["Clock", "ControllerPolicy", "EDFScheduler", "FIFOScheduler",
           "FakeClock", "MonotonicClock", "Observability", "Preview",
           "QueueFull", "QueueItem", "Request", "RequestPolicy", "Result",
           "SJFScheduler", "Scheduler", "Span", "SpeCaEngine", "Ticket",
           "Timings", "Trace", "WFQScheduler", "allocation_report",
           "make_scheduler"]
