"""The SpeCa serving engine (counterpart of ``repro.serving``)."""
from repro_torch.serving.engine import (Request, Result, SpeCaEngine,
                                        allocation_report)
from repro_torch.serving.policy import RequestPolicy

__all__ = ["Request", "RequestPolicy", "Result", "SpeCaEngine",
           "allocation_report"]
