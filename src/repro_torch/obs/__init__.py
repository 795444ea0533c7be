"""The serving clock and per-request timings (the part of ``repro.obs``
that ``Result`` needs)."""
from repro_torch.obs.clock import MonotonicClock
from repro_torch.obs.trace import Timings

__all__ = ["MonotonicClock", "Timings"]
