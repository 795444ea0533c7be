"""Device-side lane telemetry accumulation — the zero-sync half.

Every scheduler tick the lane step returns a flags dict
(``n_spec``/``n_drafted``/``full``/``advanced``/``err``/...; see
``repro_torch.core.lane_step``) on the device. The engine reads those
tensors only when a request completes; the ``LaneAccumulator`` keeps
that discipline:

  * ``update(flags)`` folds one tick's flags into one preallocated f32
    buffer on the flags' device, in place, with plain tensor ops: no
    ``.item()``, no boolean-mask indexing, no ``nonzero``/``bincount``
    (both size their output from device data) and no Python branch on
    a tensor, so observed traffic adds **zero host syncs**
    (``chip_smoke.py`` runs it under ``torch.cuda.set_sync_debug_mode
    ("error")``).
  * ``flush_into(metrics, **labels)`` is the one materialisation: a
    single device-to-host copy of that buffer, merged into a
    ``MetricsRegistry``; then the buffer is zeroed (delta semantics —
    flushing twice never double-counts).

The error histogram is binned on the device with ``searchsorted`` and
``index_add_`` over log-spaced edges, so a flush moves a fixed
``len(_SUM_KEYS) + len(edges) + 4`` floats, not one per observation.
It reads ``chain_err`` [K, W] where the step emits it, else ``err`` [W]
(the port's depth-1 step emits no ``chain_*`` flags; the reference's
emits ``chain_err = err[None]``, the same values). A guided pair
reports pair-equal flags on both lanes, and both lanes are counted, as
in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs.registry import MetricsRegistry

# Log-spaced relative-error bucket edges: SpeCa accept thresholds live
# around 1e-2..1e0, so the grid brackets them with headroom both ways.
DEFAULT_ERR_EDGES: Tuple[float, ...] = tuple(
    float(x) for x in np.geomspace(1e-6, 1e2, 25))

_SUM_KEYS = ("n_spec", "n_drafted", "full", "advanced", "attempted")


class LaneAccumulator:
    """Per-session on-device counter accumulation (see module docstring).

    The buffer holds, in f32 (the reference runs with ``jax_enable_x64``
    off): the sums of ``_SUM_KEYS``, the error bucket counts (one per
    edge, then +Inf, then a scratch bucket for non-finite errors that
    is dropped at flush), the sum of the finite errors and their count.
    It is allocated on the device of the first flags it receives.
    """

    def __init__(self, err_edges: Tuple[float, ...] = DEFAULT_ERR_EDGES
                 ) -> None:
        self.err_edges = tuple(float(e) for e in err_edges)
        self._edges: Optional[torch.Tensor] = None
        self._acc: Optional[torch.Tensor] = None
        self._ticks = 0

    def _alloc(self, device: torch.device) -> None:
        edges = torch.tensor(self.err_edges, dtype=torch.float32)
        if device.type == "cuda":
            edges = edges.pin_memory()     # an asynchronous upload
        self._edges = edges.to(device, non_blocking=True)
        S, E = len(_SUM_KEYS), len(self.err_edges)
        self._acc = torch.zeros(S + E + 4, dtype=torch.float32,
                                device=device)
        self._sums = self._acc[:S]
        self._counts = self._acc[S:S + E + 2]
        self._err = self._acc[S + E + 2:]

    def update(self, flags: Dict[str, Any]) -> None:
        """Fold one tick's lane-step flags in, on their device, without a
        host sync."""
        err = flags["chain_err"] if "chain_err" in flags else flags["err"]
        if self._acc is None:
            self._alloc(err.device)
        self._sums.add_(torch.stack([flags[k] for k in _SUM_KEYS]).sum(
            dim=1, dtype=torch.float32))
        err = err.reshape(-1).to(torch.float32)
        finite = torch.isfinite(err)
        # side="left", as jnp.searchsorted's default; non-finite errors
        # are parked in the scratch bucket one past +Inf
        idx = torch.searchsorted(self._edges, err)
        idx = torch.where(finite, idx, len(self.err_edges) + 1)
        self._counts.index_add_(0, idx, torch.ones_like(err))
        self._err.add_(torch.stack([torch.where(finite, err, 0.0),
                                    finite.to(torch.float32)]).sum(dim=1))
        self._ticks += 1

    def flush_into(self, metrics: MetricsRegistry, **labels: Any) -> None:
        """Materialise (the one device-to-host copy), merge into
        ``metrics``, reset. Counter totals land as ``speca_<key>_total``;
        the binned errors as the ``speca_chain_err`` histogram."""
        S, E = len(_SUM_KEYS), len(self.err_edges)
        if self._acc is None:
            host = [0.0] * (S + E + 4)
        else:
            host = self._acc.tolist()
            self._acc.zero_()
        ticks, self._ticks = self._ticks, 0
        sums = dict(zip(_SUM_KEYS, host[:S]))
        for k in _SUM_KEYS:
            metrics.counter(f"speca_{k}_total", **labels).inc(sums[k])
        metrics.counter("speca_obs_ticks_total", **labels).inc(float(ticks))
        metrics.histogram("speca_chain_err", edges=self.err_edges,
                          **labels).add_counts(
            host[S:S + E + 1], host[S + E + 2], host[S + E + 3])
        if sums["n_drafted"] > 0:
            metrics.gauge("speca_draft_accept_rate", **labels).set(
                sums["n_spec"] / sums["n_drafted"])
