"""The serving clock and per-request timings (the part of ``repro.obs``
that ``Result`` needs)."""
from repro_torch.obs.clock import (Clock, FakeClock, MonotonicClock,
                                   resolve_clock)
from repro_torch.obs.trace import Timings

__all__ = ["Clock", "FakeClock", "MonotonicClock", "Timings",
           "resolve_clock"]
