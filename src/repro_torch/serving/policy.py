"""Per-request serving policy (counterpart of ``repro.serving.policy``):
what one request decides for itself, the ticket ``SpeCaEngine.submit``
returns and the backpressure error of a full admission queue."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.core.controller import ControllerPolicy


@dataclasses.dataclass(frozen=True)
class RequestPolicy:
    """guidance_scale: ``None`` serves the request unguided on one lane; a
    float serves it under classifier-free guidance on a cond/uncond lane
    pair with ONE verify decision per pair. negative_cond: the pair's
    second stream (``None`` = the engine's ``null_cond``, else
    ``null_cond_like`` of the request's conditioning); a non-null dict is
    negative-prompt conditioning, which ``u + s·(c − u)`` steers away
    from. tau0: the request's base verification threshold (None = the
    engine's ``SpeCaConfig.tau0``); a strict and a permissive request can
    share one batch, each verified against its own τ. max_steps: cap on
    the request's denoising steps (None = the full schedule) — a smaller
    value serves the prefix of the schedule. draft_depth: the request's
    draft horizon K — its lane (or pair) drafts up to K steps per
    scheduler tick before one closing verify/refresh round (None or 1 =
    depth-1 forecast-then-verify); a value above the engine's
    ``max_draft_depth`` is rejected. workload: the tag of the engine
    workload that serves the request (``"diffusion"`` or ``"decode"``;
    guided decode requests are rejected at resolution). priority: higher
    pops first within a scheduler's ordering class (FIFO orders by
    (priority, arrival); SJF and EDF use it as a tie-break). deadline:
    the scheduler tick by which the request should complete (EDF's key;
    ``Result.deadline_met``); ``None`` sorts last under EDF. tenant: the
    request's fair-queueing class under WFQ (other schedulers ignore
    it). weight: the tenant's WFQ share, > 0. controller: a
    ``ControllerPolicy`` makes the request's τ0, draft depth and forecast
    order starting points that the controller adapts in flight toward
    its accept-rate or deadline SLO (needs
    ``SpeCaEngine(controller=True)``); ``None`` serves it statically."""

    guidance_scale: Optional[float] = None
    negative_cond: Optional[Dict[str, Any]] = None
    tau0: Optional[float] = None
    max_steps: Optional[int] = None
    draft_depth: Optional[int] = None
    workload: str = "diffusion"
    priority: int = 0
    deadline: Optional[float] = None
    tenant: str = "default"
    weight: float = 1.0
    controller: Optional[ControllerPolicy] = None

    @property
    def guided(self) -> bool:
        return self.guidance_scale is not None

    @property
    def streams(self) -> int:
        """Lanes this request occupies: 1, or 2 for a guided pair."""
        return 2 if self.guided else 1

    def steps(self, schedule_steps: int) -> int:
        """Resolved step count on a schedule of ``schedule_steps`` steps."""
        if self.max_steps is None:
            return schedule_steps
        return max(1, min(int(self.max_steps), schedule_steps))


@dataclasses.dataclass(frozen=True)
class Ticket:
    """Handle returned by ``SpeCaEngine.submit``: poll it, stream on it, or
    exchange it for the request's ``Result``."""

    ticket_id: int
    request_id: int
    submit_tick: int


class QueueFull(RuntimeError):
    """Bounded-queue backpressure: the engine's admission queue is at
    ``max_queue``; the caller retries later or sheds load."""
