"""Per-request serving policy: the part of ``repro.serving.policy`` the
port's unguided engine serves."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RequestPolicy:
    """tau0: the request's base verification threshold (None = the
    engine's ``SpeCaConfig.tau0``); a strict and a permissive request can
    share one batch, each verified against its own τ. max_steps: cap on
    the request's denoising steps (None = the full schedule) — a smaller
    value serves the prefix of the schedule. draft_depth: the request's
    draft horizon K — its lane drafts up to K steps per scheduler tick
    before one closing verify/refresh round (None or 1 = depth-1
    forecast-then-verify); a value above the engine's ``max_draft_depth``
    is rejected."""

    tau0: Optional[float] = None
    max_steps: Optional[int] = None
    draft_depth: Optional[int] = None

    def steps(self, schedule_steps: int) -> int:
        """Resolved step count on a schedule of ``schedule_steps`` steps."""
        if self.max_steps is None:
            return schedule_steps
        return max(1, min(int(self.max_steps), schedule_steps))
