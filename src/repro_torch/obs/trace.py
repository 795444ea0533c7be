"""Per-request lifecycle timings."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Timings:
    """Lifecycle timestamps (engine-clock seconds) and tick indices of one
    request. ``first_tick_s`` is None when the request was drained before
    any scheduler tick dispatched it. The ticks are the owning session's:
    ``submit_tick`` when it was queued, ``admit_tick`` when it entered its
    lanes, ``finish_tick`` after which it completed."""

    submit_s: float
    admit_s: float
    finish_s: float
    first_tick_s: Optional[float] = None
    submit_tick: int = 0
    admit_tick: int = 0
    finish_tick: int = 0

    @property
    def queue_wait_s(self) -> float:
        """Seconds spent in the admission queue (submit → lane fill)."""
        return self.admit_s - self.submit_s

    @property
    def service_s(self) -> float:
        """Seconds occupying lanes (fill → harvest)."""
        return self.finish_s - self.admit_s

    @property
    def total_s(self) -> float:
        return self.finish_s - self.submit_s

    @property
    def service_ticks(self) -> int:
        """Scheduler ticks the request occupied lanes for."""
        return self.finish_tick - self.admit_tick
