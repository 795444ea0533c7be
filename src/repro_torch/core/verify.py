"""SpeCa verification: relative error metrics (eq. 4) and the τ schedule
(§3.4.2). Metrics beyond rel-L2 are the paper's Appendix E ablation."""
from __future__ import annotations

import torch


def _flatten_per_sample(x: torch.Tensor, batch_axis: int) -> torch.Tensor:
    x = torch.movedim(x, batch_axis, 0)
    return x.reshape(x.shape[0], -1).to(torch.float32)


def relative_error(pred: torch.Tensor, ref: torch.Tensor, *,
                   metric: str = "rel_l2", eps: float = 1e-8,
                   batch_axis: int = 0) -> torch.Tensor:
    """Per-sample relative error e_k; shape [B]."""
    p = _flatten_per_sample(pred, batch_axis)
    r = _flatten_per_sample(ref, batch_axis)
    if metric == "rel_l2":
        num = torch.linalg.vector_norm(p - r, dim=-1)
        den = torch.linalg.vector_norm(r, dim=-1)
    elif metric == "rel_l1":
        num = torch.sum(torch.abs(p - r), dim=-1)
        den = torch.sum(torch.abs(r), dim=-1)
    elif metric == "rel_linf":
        num = torch.amax(torch.abs(p - r), dim=-1)
        den = torch.amax(torch.abs(r), dim=-1)
    elif metric == "cosine":
        # distance form: 1 − cos(p, r); same accept-iff-small semantics
        dot = torch.sum(p * r, dim=-1)
        den = torch.linalg.vector_norm(p, dim=-1) \
            * torch.linalg.vector_norm(r, dim=-1)
        return 1.0 - dot / (den + eps)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return num / (den + eps)


def threshold_schedule(t_frac: torch.Tensor, tau0, beta: float
                       ) -> torch.Tensor:
    """τ_t = τ0 · β^((T−t)/T); ``t_frac`` = t/T runs 1 → 0 over sampling,
    so the threshold is permissive early and strict late."""
    base = torch.tensor(beta, dtype=torch.float32, device=t_frac.device)
    return tau0 * torch.pow(base, 1.0 - t_frac)
