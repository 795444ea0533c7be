"""The serving clock: one injectable monotonic time source for every
serving timestamp (``Result.wall_s``, ``Result.timings``).

The default is ``time.monotonic``, so spans never go negative across a
wall-clock step; ``SpeCaEngine(clock=FakeClock())`` makes every lifecycle
timestamp a scripted value for tests. Nothing on the device reads the
clock."""
from __future__ import annotations

import time
from typing import Protocol, runtime_checkable


@runtime_checkable
class Clock(Protocol):
    """Anything with a monotonic ``now() -> float`` (seconds)."""

    def now(self) -> float: ...


class MonotonicClock:
    """``time.monotonic`` (never steps backward, unlike ``time.time``)."""

    def now(self) -> float:
        return time.monotonic()


class FakeClock:
    """A scripted clock: ``now()`` returns the current time, then advances
    it by ``auto_tick`` (0 by default: time moves only on ``advance``)."""

    def __init__(self, start: float = 0.0, auto_tick: float = 0.0) -> None:
        self._t = float(start)
        self.auto_tick = float(auto_tick)
        self.reads = 0

    def now(self) -> float:
        t = self._t
        self._t += self.auto_tick
        self.reads += 1
        return t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"FakeClock cannot run backwards (dt={dt})")
        self._t += float(dt)


def resolve_clock(clock) -> Clock:
    """``None`` -> a fresh ``MonotonicClock``; anything with ``now()``
    passes through; anything else raises ``TypeError``."""
    if clock is None:
        return MonotonicClock()
    if isinstance(clock, Clock):
        return clock
    raise TypeError(f"clock must have a now() -> float method, "
                    f"got {type(clock).__name__}")
