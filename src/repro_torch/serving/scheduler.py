"""Admission-queue schedulers of the serving engine (counterpart of
``repro.serving.scheduler``).

A ``Scheduler`` owns the admission queue; every tick the engine asks it for
the next request that fits the free slot shape (an unguided request needs
one free lane, a guided request a whole free lane pair):

  * ``FIFOScheduler`` — arrival order within priority class (at priority 0
    exactly ``serve_batched``'s order);
  * ``SJFScheduler`` — shortest schedule first (mean completion time);
  * ``EDFScheduler`` — earliest deadline first, deadline-less requests last
    (deadline hit rate);
  * ``WFQScheduler`` — weighted fair queueing over
    ``RequestPolicy.tenant``: each request is stamped a virtual finish tag
    (its tenant's ledger advanced by ``steps × streams / weight``) at push
    time and pops in tag order, so backlogged tenants are served in
    proportion to their weights and a burst from one tenant delays another
    tenant's queued request by a bounded number of pops.

All four skip queued requests that do not fit (backfill): a guided request
waiting for a whole pair never blocks an unguided one that could take the
lone free lane. Ties break by priority (higher first), then arrival, so
admission is deterministic.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Protocol, Tuple

from repro_torch.serving.policy import RequestPolicy


@dataclasses.dataclass
class QueueItem:
    """One queued request with its resolved policy and schedule length.
    ``seq`` is its arrival index (the tie-break and the key its Result is
    returned under); ``steps`` its resolved schedule length; ``submit_s``
    the engine clock at submit (0.0 where nobody tracks time)."""

    seq: int
    request: Any
    policy: RequestPolicy
    steps: int
    submit_tick: int = 0
    ticket_id: int = -1
    submit_s: float = 0.0

    @property
    def streams(self) -> int:
        return self.policy.streams


FitFn = Callable[[QueueItem], bool]


class Scheduler(Protocol):
    """``pop(can_fit)`` removes and returns the best queued item for which
    ``can_fit(item)`` holds (None when nothing fits); ``drain()`` empties
    the queue and returns its items (engine shutdown)."""

    name: str

    def push(self, item: QueueItem) -> None: ...

    def pop(self, can_fit: Optional[FitFn] = None) -> Optional[QueueItem]: ...

    def drain(self) -> List[QueueItem]: ...

    def __len__(self) -> int: ...


class _KeyedScheduler:
    """A stable list popped by a sort key over the fitting items."""

    name = "keyed"

    def __init__(self) -> None:
        self._items: List[QueueItem] = []

    def key(self, item: QueueItem) -> Tuple:  # pragma: no cover
        raise NotImplementedError

    def push(self, item: QueueItem) -> None:
        self._items.append(item)

    def pop(self, can_fit: Optional[FitFn] = None) -> Optional[QueueItem]:
        best_i, best_k = -1, None
        for i, item in enumerate(self._items):
            if can_fit is not None and not can_fit(item):
                continue
            k = self.key(item)
            if best_k is None or k < best_k:
                best_i, best_k = i, k
        if best_i < 0:
            return None
        return self._items.pop(best_i)

    def drain(self) -> List[QueueItem]:
        out, self._items = self._items, []
        return out

    def __len__(self) -> int:
        return len(self._items)


class FIFOScheduler(_KeyedScheduler):
    """Arrival order within priority class (the default)."""

    name = "fifo"

    def key(self, item: QueueItem) -> Tuple:
        return (-item.policy.priority, item.seq)


class SJFScheduler(_KeyedScheduler):
    """Shortest schedule (``QueueItem.steps``) first."""

    name = "sjf"

    def key(self, item: QueueItem) -> Tuple:
        return (item.steps, -item.policy.priority, item.seq)


class EDFScheduler(_KeyedScheduler):
    """Earliest deadline first; deadline-less requests sort last."""

    name = "edf"

    def key(self, item: QueueItem) -> Tuple:
        d = item.policy.deadline
        return (d is None, d if d is not None else 0.0,
                -item.policy.priority, item.seq)


class WFQScheduler:
    """Weighted fair queueing keyed on ``RequestPolicy.tenant``.

    Start-time fair queueing over one schedule step per lane stream: a
    request of ``steps × streams`` service from tenant ``t`` (weight ``w``)
    is stamped at push time

        start  = max(V, finish[t])          # V: the virtual time
        finish = start + steps·streams / w

    and ``pop`` returns the fitting request with the smallest ``(finish,
    -priority, seq)``; ``V`` advances to the popped tag, so an idle tenant
    re-enters at the current virtual time (no credit for its unused past
    share). A queued request's tag is fixed and every later push lands a
    larger tag within its tenant, so only the finitely many smaller tags
    already queued can be served before it."""

    name = "wfq"

    def __init__(self) -> None:
        self._items: List[Tuple[float, QueueItem]] = []   # (finish tag, item)
        self._vtime = 0.0
        self._finish: dict = {}                           # tenant -> tag

    def push(self, item: QueueItem) -> None:
        pol = item.policy
        w = float(pol.weight)
        if not w > 0.0:
            raise ValueError(f"RequestPolicy.weight must be > 0, got {w}")
        start = max(self._vtime, self._finish.get(pol.tenant, 0.0))
        finish = start + item.steps * item.streams / w
        self._finish[pol.tenant] = finish
        self._items.append((finish, item))

    def pop(self, can_fit: Optional[FitFn] = None) -> Optional[QueueItem]:
        best_i, best_k = -1, None
        for i, (tag, item) in enumerate(self._items):
            if can_fit is not None and not can_fit(item):
                continue
            k = (tag, -item.policy.priority, item.seq)
            if best_k is None or k < best_k:
                best_i, best_k = i, k
        if best_i < 0:
            return None
        tag, item = self._items.pop(best_i)
        self._vtime = max(self._vtime, tag)
        return item

    def drain(self) -> List[QueueItem]:
        out = [item for _, item in self._items]
        self._items = []
        return out

    def __len__(self) -> int:
        return len(self._items)


SCHEDULERS = {
    "fifo": FIFOScheduler,
    "sjf": SJFScheduler,
    "edf": EDFScheduler,
    "wfq": WFQScheduler,
}


def make_scheduler(spec: Any = "fifo") -> Scheduler:
    """Resolve a scheduler: a name from ``SCHEDULERS``, a ``Scheduler``
    class or zero-argument factory, or an instance (returned as it is)."""
    if isinstance(spec, str):
        try:
            return SCHEDULERS[spec]()
        except KeyError:
            raise ValueError(
                f"unknown scheduler {spec!r} (have {sorted(SCHEDULERS)})"
            ) from None
    if isinstance(spec, type) or callable(spec):
        made = spec()
        if not hasattr(made, "pop"):
            raise TypeError(f"{spec!r} did not produce a Scheduler")
        return made
    if hasattr(spec, "pop") and hasattr(spec, "push"):
        return spec
    raise TypeError(f"cannot interpret {spec!r} as a Scheduler")


def fresh_scheduler(spec: Any = "fifo") -> Scheduler:
    """Like :func:`make_scheduler`, but always a new, empty queue: an
    instance spec gives a fresh instance of its class. ``serve_batched``'s
    private sessions use it, so they never share or drain the lifecycle
    queue behind a caller's scheduler instance."""
    if not isinstance(spec, (str, type)) and not callable(spec) \
            and hasattr(spec, "pop"):
        spec = type(spec)
    return make_scheduler(spec)
