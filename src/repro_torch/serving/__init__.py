"""The SpeCa serving engine (counterpart of ``repro.serving``)."""
from repro_torch.core.controller import ControllerPolicy
from repro_torch.serving.engine import (Preview, Request, Result,
                                        SpeCaEngine, allocation_report)
from repro_torch.serving.policy import QueueFull, RequestPolicy, Ticket
from repro_torch.serving.scheduler import (EDFScheduler, FIFOScheduler,
                                           QueueItem, Scheduler,
                                           SJFScheduler, WFQScheduler,
                                           make_scheduler)

__all__ = ["ControllerPolicy", "EDFScheduler", "FIFOScheduler", "Preview",
           "QueueFull", "QueueItem", "Request", "RequestPolicy", "Result",
           "SJFScheduler", "Scheduler", "SpeCaEngine", "Ticket",
           "WFQScheduler", "allocation_report", "make_scheduler"]
