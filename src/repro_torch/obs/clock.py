"""The serving clock: one monotonic time source for every timestamp."""
from __future__ import annotations

import time


class MonotonicClock:
    """``time.monotonic`` (never steps backward, unlike ``time.time``)."""

    def now(self) -> float:
        return time.monotonic()
