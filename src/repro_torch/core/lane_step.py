"""The forecast-then-verify step (paper §3.2–3.4) over a lane batch.

Both execution paths — the sampler (``repro_torch.core.speca``, where the
sample batch is the lane batch) and the serving engine — advance their
state through the step built here:

  1. *Draft* (runs iff ANY lane is warm and under its draft budget): the
     forecaster's fused per-lane predict kernel forecasts every lane's
     residual increments from its own anchor, and the backbone runs with
     compute masked to the verify layer.
  2. *Verify*: each lane's relative error against its own τ_t — the fused
     verify kernel (``verify_backend="fused"``, rel-L2 only) or the
     metric-general path (``"jnp"``, named after the reference's).
  3. *Accept combiner*: ``per_sample`` accepts each lane on its own bit;
     ``batch`` accepts iff every drafting lane passes.
  4. *Masked refresh* (runs iff ANY active lane rejected): the full
     forward serves the rejected lanes and the refresh kernel updates only
     their table slices; accepted lanes advance on the speculative output.

At ``max_draft_depth=K > 1`` (:class:`ChainStep`, the reference's
``chain_step``) steps 1–3 repeat for K chain positions per tick from one
chain forecast, the payload advancing blindly with a snapshot after each
position; the rollback kernel then restores every lane to the snapshot
of its accepted prefix (reading the snapshots where they lie; a tick
that drafted nothing has nothing to restore and launches nothing), and
ONE closing full forward serves the lanes that stopped on a rejection.

The reference decides the "runs iff" branches on the device with
``lax.cond``. Eager PyTorch decides them on the host, which costs one
device sync per branch; :attr:`LaneStep.host_syncs` counts them (two per
tick at depth 1, at most K+1 per chain tick). Both branches are never
computed.

Phases (``phases=``, the engine's ``repro_torch.obs.PhaseRecorder``,
None by default): each kernel request runs inside a span named for its
phase (``predict``, ``predict_chain``, ``verify``, ``refresh``,
``rollback``), each workload forward inside ``spec_forward`` or
``full_forward`` (counted in ``speca_<kind>_forward_calls_total``), each
branch read inside ``wait.draft``, ``wait.chain`` or ``wait.full``, and
on a card each threshold schedule inside ``wait.tau`` (it copies β from
the host, a copy that blocks). Without it the step runs no span code.

Lane sharding (``mesh=``, a ``repro_torch.launch.mesh.LaneMesh`` of D
shards): the state is D per-shard dicts of W/D lanes each
(``repro_torch.sharding.specs``), and each shard runs the step body of a
W/D-lane step on its own device. The body is a generator: its global
decisions (the branches' "any lane", ``accept_mode="batch"``'s "every
drafting lane") and its kernel calls are requests it yields.
:class:`LaneStep` answers them on its own lanes; :class:`ShardedStep`
advances the D bodies to the same request, so every shard's work is
queued before the host reads anything, then answers it across the
shards — one host read per decision, as unsharded, and each kernel
through its ``ops.*_sharded`` routing, once per shard — and so serves
every lane the decisions the unsharded step would.

Guidance (``guidance=True`` or ``"mixed"``): lanes (2k, 2k+1) form pair
slot k, the cond and uncond (or negative) streams of one guided request
where the per-lane ``paired`` mask is set. A paired slot drafts iff both
its streams can (a pair-coherent ``want``), verifies ONE decision on the
guided residual ``u + s·(c − u)`` at the verify layer (s = the slot's
``gscale``; ``ops.verify_accept_mixed`` on the fused backend), and both
lanes advance on the guided model output, so ``x``, the counters and the
anchors stay pair-equal; a rejected pair's full forward refreshes both
tables. Unpaired lanes — and a trailing odd lane — run the plain
program's per-lane math. ``True`` starts with every slot paired (even
W), ``"mixed"`` with none (the engine pairs slots as it fills them).

State (all on the device): ``since`` [W] i32 consecutive accepted drafts,
``step`` [W] i32 schedule step, ``active`` [W] bool occupancy, ``tau0``
[W] f32 per-lane base threshold, ``draft_k`` [W] i32 draft horizon and
``max_step`` [W] i32 schedule length (read only by chain steps),
``cond`` {k: [W, …]} (class labels [W], a text embedding [W, T_text,
cond_dim]), the workload payload (diffusion: ``x`` [W, (F,) H, W, C]
f32; decode: ``tok``, ``tokens``, ``pos0`` and the ``k``/``v`` caches,
``pos0`` read by ``step_context`` and never advanced) and the table
(``diffs`` [m+1, L, 2, W, T, D], ``n_anchors``/``anchor_step``/``gap``
[W]); in the guidance modes also ``gscale`` [W] f32 and ``paired`` [W]
bool.

Flags per tick ([W]): ``attempted``, ``ok``, ``accepted``, ``full``,
``err`` (NaN where the lane did not draft), ``tau``, and the counters
``n_spec``/``n_drafted``/``advanced``; a chain step adds
``chain_attempted``/``chain_accepted``/``chain_err``/``chain_tau``
[K, W] and reports chain position 0 in the depth-1 keys. In a paired slot
every flag is pair-equal: both lanes report the pair's one decision and
its guided-residual error.

Controller (``controller=True``): the state also carries the
``repro_torch.core.controller`` [W] tensors (``ctl_*``); each lane's
forecast weights are capped at its ``ctl_order``, and after every tick the
controller update adapts the controller-on lanes' ``tau0``, ``draft_k`` and
``ctl_order`` from their own counters, on the device (no host sync).
``controller=False`` adds no key and no operation.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.configs import (DiffusionConfig, ModelConfig, SpeCaConfig,
                                 torch_dtype)
from repro_torch.core import controller as CT
from repro_torch.core import taylor
from repro_torch.core.forecaster import get_forecaster
from repro_torch.core.verify import relative_error, threshold_schedule
from repro_torch.device import DeviceLike
from repro_torch.diffusion.pipeline import guided_output
from repro_torch.kernels import ops
from repro_torch.sharding import specs as SH

ACCEPT_MODES = ("batch", "per_sample")
VERIFY_BACKENDS = ("fused", "jnp")
GUIDANCE_MODES = (False, True, "mixed")

# the per-tick [W] counters the engine's accounting reads
COUNTER_FLAGS = ("attempted", "accepted", "full",
                 "n_spec", "n_drafted", "advanced")

# the phase span each kernel request of the body runs in
_PHASE_OF = {"predict": "predict", "predict_chain": "predict_chain",
             "verify": "verify", "verify_mixed": "verify",
             "update": "refresh", "rollback": "rollback"}

State = Dict[str, Any]


def verify_layer(cfg: ModelConfig, scfg: SpeCaConfig) -> int:
    """Resolved verify-layer index (negative config values wrap)."""
    return scfg.verify_layer % cfg.num_layers


def num_tokens(cfg: ModelConfig, dcfg: DiffusionConfig) -> int:
    """Backbone sequence length: patches per frame × frames."""
    per_frame = (dcfg.latent_size // cfg.patch_size) ** 2
    return per_frame * max(dcfg.num_frames, 1)


def table_dtype(cfg: ModelConfig, scfg: SpeCaConfig) -> torch.dtype:
    """Difference-table dtype: ``scfg.table_dtype`` or the model dtype."""
    return torch_dtype(scfg.table_dtype or cfg.dtype)


def _check_guidance(guidance: Union[bool, str], lanes: int) -> None:
    if guidance not in GUIDANCE_MODES:
        raise ValueError(f"unknown guidance mode {guidance!r} "
                         f"(have {GUIDANCE_MODES})")
    if guidance is True and lanes % 2 != 0:
        raise ValueError(f"guidance mode packs lane PAIRS: lanes={lanes} "
                         "must be even")


def _check_pairing(wl, guidance: Union[bool, str], lanes: int) -> None:
    _check_guidance(guidance, lanes)
    if guidance and not wl.supports_pairing:
        raise ValueError(f"workload {wl.tag!r} does not support guided "
                         "lane pairs")


def _check_mesh_width(lanes: int, mesh, pairing: bool) -> int:
    """The lanes a shard owns: ``lanes`` must divide into D blocks, and
    into whole pairs per block when pairs can be admitted."""
    mult = SH.lane_width_multiple(mesh, streams=2 if pairing else 1)
    if lanes % mult != 0:
        raise ValueError(
            f"lanes={lanes} not divisible by {mult} (lane-shard count "
            f"{SH.lane_shard_count(mesh)}"
            + (" × 2 streams — a pair slot must never straddle a shard "
               "boundary)" if pairing else ")"))
    return lanes // SH.lane_shard_count(mesh)


def init_workload_state(wl, lanes: int, cond_template: Dict[str, Any], *,
                        x: Optional[torch.Tensor] = None,
                        active: bool = False,
                        guidance: Union[bool, str] = False,
                        forecaster: Any = None,
                        controller: bool = False,
                        mesh: Optional[Any] = None
                        ) -> Union[State, List[State]]:
    """Fresh lane-batch state on the workload's device. ``cond_template``
    supplies per-key shapes (its leading axis is replaced by ``lanes``;
    ignored when the workload's conditioning is not lane state);
    pass ``x`` to start from a concrete latent (the sampler) instead of
    zeros (the engine). ``forecaster`` (a name or instance, ``None`` =
    Taylor) lays out the table. ``guidance=True`` adds ``gscale`` (all
    ones) and ``paired`` all True and needs an even ``lanes``;
    ``"mixed"`` starts ``paired`` all False. ``controller=True`` adds the
    controller's all-off ``ctl_*`` tensors.

    With ``mesh``: D per-shard states of ``lanes / D`` lanes, shard i on
    ``mesh.devices[i]`` (``x`` split by lane), equal to the unsharded
    state split by ``repro_torch.sharding.specs.split_lane_state``;
    ``lanes`` must divide by D, and by 2·D in a guidance mode."""
    W, dev = lanes, wl.device
    _check_pairing(wl, guidance, W)
    if mesh is not None:
        block = _check_mesh_width(W, mesh, bool(guidance))
        xs = [None] * mesh.size if x is None else SH.split_lanes(x, mesh)
        return [init_workload_state(wl.on(d), block, cond_template, x=xb,
                                    active=active, guidance=guidance,
                                    forecaster=forecaster,
                                    controller=controller)
                for d, xb in zip(mesh.devices, xs)]
    fc = get_forecaster(forecaster)
    feat_shape = taylor.feature_shape_for(wl.cfg.num_layers, W,
                                          wl.num_tokens, wl.cfg.d_model)
    tstate = fc.init_state(wl.scfg.taylor_order, feat_shape, wl.table_dtype,
                           W, dev)
    cond = {}
    # a workload whose conditioning does not ride in the lane state (decode:
    # the prompt goes into the payload at fill) keeps an empty ``cond``
    for k, v in (cond_template.items() if wl.cond_in_state else ()):
        v = torch.as_tensor(v, device=dev)
        cond[k] = torch.broadcast_to(v, (W,) + tuple(v.shape[1:])).clone()
    state = {
        "since": torch.zeros((W,), dtype=torch.int32, device=dev),
        "step": torch.zeros((W,), dtype=torch.int32, device=dev),
        "active": torch.full((W,), bool(active), device=dev),
        "tau0": torch.full((W,), float(wl.scfg.tau0), dtype=torch.float32,
                           device=dev),
        # per-lane draft horizon and schedule length (chain steps only)
        "draft_k": torch.ones((W,), dtype=torch.int32, device=dev),
        "max_step": torch.full((W,), wl.num_steps, dtype=torch.int32,
                               device=dev),
        "cond": cond,
        **wl.init_payload(W, x=x),
        **tstate,
    }
    if guidance:
        state["gscale"] = torch.ones((W,), dtype=torch.float32, device=dev)
        state["paired"] = torch.full((W,), guidance is True, device=dev)
    if controller:
        state.update(CT.init_controller_state(W, wl.scfg.taylor_order, dev))
    return state


class LaneStep:
    """The built lane step: ``step(state) -> (state, flags)``. Counts the
    host syncs its two data-dependent branches cost in ``host_syncs``;
    records its phases in ``phases`` when given one."""

    def __init__(self, wl, *, lanes: int, draft_mode: str,
                 accept_mode: str, verify_backend: str,
                 guidance: Union[bool, str] = False,
                 forecaster: Any = None, controller: bool = False,
                 phases: Optional[Any] = None) -> None:
        if accept_mode not in ACCEPT_MODES:
            raise ValueError(f"unknown accept_mode {accept_mode!r}")
        if verify_backend not in VERIFY_BACKENDS:
            raise ValueError(f"unknown verify_backend {verify_backend!r}")
        _check_pairing(wl, guidance, lanes)
        if wl.scfg.error_metric != "rel_l2":
            verify_backend = "jnp"   # the fused kernel implements eq. 4 only
        self.wl, self.W = wl, lanes
        self.NP = lanes // 2             # pair slots (guidance modes)
        self.pairing = bool(guidance) and self.NP > 0
        self.fc = get_forecaster(forecaster)
        self.draft_mode = draft_mode
        self.accept_mode = accept_mode
        self.verify_backend = verify_backend
        self.controller = bool(controller)
        self.phases = phases
        self.host_syncs = 0

    def __call__(self, state: State) -> Tuple[State, Dict[str, Any]]:
        body, answer, ph = self._body(state), None, self.phases
        while True:
            done, out = _resume(body, answer)
            if done:
                return out
            answer = self._answer(*out) if ph is None \
                else _phase(ph, out, self._answer, *out)

    def _tau(self, ph, s_eff, tau0):
        """``threshold_schedule``, which copies β from the host: on a card
        a copy that blocks the host, so inside ``wait.tau``."""
        wl = self.wl
        args = (wl.t_frac(s_eff), tau0, wl.scfg.beta)
        if wl.device.type == "cpu":
            return threshold_schedule(*args)
        return ph.wait("tau", threshold_schedule, *args)

    def _forward(self, ph, kind: str, *args):
        """The workload's ``<kind>_forward`` inside its phase span."""
        ph.count(f"speca_{kind}_forward_calls_total", workload=self.wl.tag)
        return ph.call(f"{kind}_forward",
                       getattr(self.wl, f"{kind}_forward"), *args)

    # --- the body's requests -------------------------------------------------
    # ("any", t, reason): is any lane of t set (a branch, one host sync;
    # ``reason`` names its wait: "draft", "chain" or "full"); ("all", t):
    # t [] bool over every lane, as a device tensor (batch accept); and the
    # kernel calls ("predict", "predict_chain", "update", "rollback",
    # "verify", "verify_mixed"), whose arguments are one lane batch's —
    # or, with ``mesh``, lists of every shard's, answered by :meth:`kernel`
    # once per shard
    def _answer(self, op: str, *args):
        if op == "any":
            return self._any(args[0])
        if op == "all":
            return args[0]
        return self.kernel(op, args)

    def kernel(self, op: str, args, mesh: Optional[Any] = None):
        """Run a kernel request of the body (per shard with ``mesh``)."""
        fc, eps = self.fc, self.wl.scfg.eps
        if op in ("predict", "predict_chain"):
            tstate, steps, cap = args
            fn = fc.predict_lanes if op == "predict" \
                else fc.predict_chain_lanes
            return fn(tstate, steps, mode=self.draft_mode, order_cap=cap,
                      mesh=mesh)
        if op == "update":
            return fc.update_lanes(*args, mesh=mesh)
        if op == "rollback":
            return self.wl.rollback(*args, mesh=mesh)
        if op == "verify":
            if mesh is None:
                return ops.verify_accept(*args, eps=eps)
            return list(zip(*ops.verify_accept_sharded(*args, mesh=mesh,
                                                       eps=eps)))
        if op == "verify_mixed":
            if mesh is None:
                return ops.verify_accept_mixed(*args, eps=eps)
            return list(zip(*ops.verify_accept_mixed_sharded(
                *args, mesh=mesh, eps=eps)))
        raise ValueError(f"unknown lane-step request {op!r}")

    def _nan(self) -> torch.Tensor:
        return torch.full((self.W,), float("nan"), dtype=torch.float32,
                          device=self.wl.device)

    def _combine(self, want, ok):
        if self.accept_mode == "batch":
            # parity mode: every drafting lane (of every shard) must pass
            # or all reject
            return want & (yield ("all", torch.all(ok | ~want)))
        return want & ok

    def _any(self, t: torch.Tensor) -> bool:
        self.host_syncs += 1
        return bool(t.any())

    # --- pair slots (guidance modes) -----------------------------------------
    def pair_head(self, v: torch.Tensor) -> torch.Tensor:
        """[W, …] -> [NP, 2, …]: the pair-slot fold of the first 2·NP
        lanes; a trailing odd lane is left out (it is never paired)."""
        NP = self.NP
        return v[:2 * NP].reshape((NP, 2) + tuple(v.shape[1:]))

    def with_tail(self, head2: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
        """[NP, 2, …] -> [W, …], re-attaching ``v``'s trailing odd lane."""
        out = head2.reshape((2 * self.NP,) + tuple(head2.shape[2:]))
        if self.W % 2:
            out = torch.cat([out, v[2 * self.NP:]], dim=0)
        return out

    def pair_select(self, paired: torch.Tensor, pair_val: torch.Tensor,
                    lane_val: torch.Tensor) -> torch.Tensor:
        """Per-lane select between pair-slot and per-lane values."""
        pm = paired.reshape((self.W,) + (1,) * (lane_val.dim() - 1))
        return torch.where(pm, pair_val, lane_val)

    def pair_broadcast(self, pair_val: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
        """A per-slot value [NP, …] on both lanes of its slot, as [W, …]
        with ``v``'s trailing odd lane."""
        return self.with_tail(torch.broadcast_to(
            pair_val[:, None], (self.NP, 2) + tuple(pair_val.shape[1:])), v)

    def pair_combine(self, out: torch.Tensor, gscale: torch.Tensor,
                     paired: torch.Tensor) -> torch.Tensor:
        """A paired slot's lanes both advance on the guided output
        ``u + s·(c − u)``; unpaired lanes keep their own."""
        h = self.pair_head(out)
        g = guided_output(h[:, 0], h[:, 1], self.pair_head(gscale)[:, 0])
        return self.pair_select(paired, self.pair_broadcast(g, out), out)

    def pair_want(self, want: torch.Tensor,
                  paired: torch.Tensor) -> torch.Tensor:
        """A paired slot drafts iff both its streams can."""
        h = self.pair_head(want)
        return torch.where(paired, self.pair_broadcast(h[:, 0] & h[:, 1],
                                                       want), want)

    # --- verification --------------------------------------------------------
    def _verify(self, state, pred_vl, real_vl, tau):
        """(err [W], ok [W]) — the same math on every execution path: the
        fused kernels through a request (slot-width in the guidance modes:
        ONE guided-residual decision per paired slot, both lanes report
        it), the metric-general path here."""
        W, scfg = self.W, self.wl.scfg
        if self.verify_backend == "fused":
            p, r = pred_vl.reshape(W, -1), real_vl.reshape(W, -1)
            if self.pairing:
                return (yield ("verify_mixed", p, r, tau, state["gscale"],
                               state["paired"]))
            return (yield ("verify", p, r, tau))
        err = relative_error(pred_vl, real_vl, metric=scfg.error_metric,
                             eps=scfg.eps, batch_axis=0)
        if self.pairing:
            # unpaired lanes keep the plain program's math; pairs combine
            # in f32, as the fused kernel does
            ph = self.pair_head(pred_vl).to(torch.float32)
            rh = self.pair_head(real_vl).to(torch.float32)
            gs_p = self.pair_head(state["gscale"])[:, 0]
            err_p = relative_error(guided_output(ph[:, 0], ph[:, 1], gs_p),
                                   guided_output(rh[:, 0], rh[:, 1], gs_p),
                                   metric=scfg.error_metric, eps=scfg.eps,
                                   batch_axis=0)
            err = torch.where(state["paired"],
                              self.pair_broadcast(err_p, err), err)
        return err, err <= tau

    def _want(self, state, want):
        return self.pair_want(want, state["paired"]) if self.pairing \
            else want

    def _out(self, state, out):
        return self.pair_combine(out, state["gscale"], state["paired"]) \
            if self.pairing else out

    def _body(self, state: State):
        wl, fc, W, ph = self.wl, self.fc, self.W, self.phases
        scfg, vl = wl.scfg, wl.verify_layer
        dyn = {k: state[k] for k in wl.dyn_keys}
        since, s, active = state["since"], state["step"], state["active"]
        cond = state["cond"]
        tstate = {k: state[k] for k in fc.state_keys}
        s_eff = torch.clamp(s, max=wl.num_steps - 1)
        ctx = wl.step_context(state, s_eff)
        warm = fc.warm(tstate, scfg)
        want = self._want(state, active & warm & (since < scfg.max_draft))
        # per-lane τ_t = τ0·β^((T−t)/T) at each lane's own step
        tau = threshold_schedule(wl.t_frac(s_eff), state["tau0"], scfg.beta) \
            if ph is None else self._tau(ph, s_eff, state["tau0"])
        nan = self._nan()

        if (yield ("any", want, "draft")):
            preds = yield ("predict", tstate, s_eff, self._order_cap(state))
            out_spec, real_vl = wl.spec_forward(dyn, cond, ctx, preds) \
                if ph is None else \
                self._forward(ph, "spec", dyn, cond, ctx, preds)
            pred_vl = preds[vl][0] + preds[vl][1]
            err, ok = yield from self._verify(state, pred_vl, real_vl, tau)
            # NaN marks "did not draft": it fails every `err <= tau`
            err, ok = torch.where(want, err, nan), ok & want
        else:
            out_spec = wl.zero_out(W)
            err, ok = nan, torch.zeros_like(want)
        accept = yield from self._combine(want, ok)
        full = active & ~accept

        if (yield ("any", full, "full")):
            out_full, branches = wl.full_forward(dyn, cond, ctx) \
                if ph is None else self._forward(ph, "full", dyn, cond, ctx)
            tstate = yield ("update", tstate, branches, s_eff, full)
        else:
            out_full = wl.zero_out(W)
        out = self._out(state, wl.select_out(accept, out_spec, out_full))
        dyn = wl.select_dyn(active, wl.advance(dyn, out, ctx, s_eff), dyn)
        since = torch.where(accept, since + 1,
                            torch.where(active, torch.zeros_like(since),
                                        since))
        new_state = dict(state)
        new_state.update(since=since, step=s + active.to(torch.int32),
                         **dyn, **tstate)
        flags = {"attempted": want, "ok": ok, "accepted": accept,
                 "full": full, "err": err, "tau": tau,
                 "n_spec": accept.to(torch.int32),
                 "n_drafted": want.to(torch.int32),
                 "advanced": active.to(torch.int32)}
        self._adapt(state, new_state, flags)
        return new_state, flags

    def _order_cap(self, state: State) -> Optional[torch.Tensor]:
        return state["ctl_order"] if self.controller else None

    def _adapt(self, state: State, new_state: State,
               flags: Dict[str, Any]) -> None:
        """The controller tick: adapt ``new_state``'s controlled knobs from
        the old state and this tick's counters."""
        if self.controller:
            new_state.update(CT.controller_update(
                state, step_new=new_state["step"], n_spec=flags["n_spec"],
                n_drafted=flags["n_drafted"], advanced=flags["advanced"],
                active=state["active"]))


class ChainStep(LaneStep):
    """The depth-K lane step (the reference's ``chain_step``,
    ``repro/core/lane_step.py:607``): K draft-verify positions per tick
    from ONE chain forecast, then at most one rollback and one closing
    full forward. A lane drafts at position j under its budget
    ``(draft_k > j) & (step < max_step)`` while it has accepted every
    earlier position; rows advance blindly on the drafted output and the
    rollback restores each lane to the snapshot of its accepted prefix, so
    a lane lands bitwise on the state ``advanced`` depth-1 ticks would
    give it.

    Host syncs: one per position while some lane drafts (its branch),
    one for the closing full forward. The first position at which no lane
    drafts leaves every later position without a drafting lane (none is
    alive), so the loop stops syncing there and fills those positions'
    flags with the reference's values (attempted/accepted False, err NaN,
    τ at the unchanged step); their blind advances are never selected by
    the rollback and are skipped."""

    def __init__(self, wl, *, lanes: int, depth: int, **kw) -> None:
        super().__init__(wl, lanes=lanes, **kw)
        self.K = depth

    def _body(self, state: State):
        wl, fc, W, K, ph = self.wl, self.fc, self.W, self.K, self.phases
        scfg, vl, S = wl.scfg, wl.verify_layer, wl.num_steps
        dyn = {k: state[k] for k in wl.dyn_keys}
        since, s, active = state["since"], state["step"], state["active"]
        cond = state["cond"]
        tstate = {k: state[k] for k in fc.state_keys}
        draft_k, max_step = state["draft_k"], state["max_step"]
        warm = fc.warm(tstate, scfg)
        # a lane alive at position j has accepted 0..j-1, so its step
        # there is step₀ + j (clamped to the schedule end)
        steps_chain = torch.clamp(
            s[None, :] + torch.arange(K, dtype=torch.int32,
                                      device=s.device)[:, None], max=S - 1)
        preds_chain = None
        alive = active
        stop_full = torch.zeros_like(active)
        n_acc = torch.zeros_like(s)
        n_drafted = torch.zeros_like(s)
        snaps = [dyn]
        rows = {k: [] for k in ("attempted", "accepted", "err", "tau")}
        ok0 = None
        drafting = True
        for j in range(K):
            s_eff = torch.clamp(s, max=S - 1)
            ctx = wl.step_context(state, s_eff)
            budget = (draft_k > j) & (s < max_step)
            want = self._want(state, alive & budget & warm
                              & (since < scfg.max_draft))
            tau = threshold_schedule(wl.t_frac(s_eff), state["tau0"],
                                     scfg.beta) if ph is None \
                else self._tau(ph, s_eff, state["tau0"])
            drafting = drafting and (yield ("any", want, "chain"))
            if drafting:
                if preds_chain is None:
                    preds_chain = yield ("predict_chain", tstate,
                                         steps_chain,
                                         self._order_cap(state))
                preds = preds_chain[j]
                out_spec, real_vl = \
                    wl.spec_forward(dyn, cond, ctx, preds) if ph is None \
                    else self._forward(ph, "spec", dyn, cond, ctx, preds)
                pred_vl = preds[vl][0] + preds[vl][1]
                err, ok = yield from self._verify(state, pred_vl, real_vl,
                                                  tau)
                err, ok = torch.where(want, err, self._nan()), ok & want
            else:
                err, ok = self._nan(), torch.zeros_like(want)
            acc = yield from self._combine(want, ok)
            # a lane with budget at j that did not advance is served by
            # the closing full; one whose budget ran out stops clean
            stop_full = stop_full | (alive & budget & ~acc)
            if drafting:
                # blind advance: every row steps on the drafted output
                # (a paired slot's on the guided one); the rollback keeps
                # only accepted prefixes
                dyn = wl.advance(dyn, self._out(state, out_spec), ctx, s_eff)
                snaps.append(dyn)
            since = torch.where(acc, since + 1, since)
            s = s + acc.to(torch.int32)
            n_acc = n_acc + acc.to(torch.int32)
            n_drafted = n_drafted + want.to(torch.int32)
            alive = acc
            if j == 0:
                ok0 = ok
            for k, v in (("attempted", want), ("accepted", acc),
                         ("err", err), ("tau", tau)):
                rows[k].append(v)
        # exact-copy restore to each lane's accepted-prefix snapshot
        # (n_acc never exceeds the drafted positions, so the snapshots
        # taken are all it can select); the kernel reads the snapshots
        # where they lie. A tick that drafted nothing restores nothing:
        # every index clamps to snapshot 0, which is dyn itself, so dyn
        # carries over into the new state as it is — an alias of the old
        # state's payload, not a copy. That is safe because only the
        # newest state is live: the engine fills a lane in place on the
        # state the step returned (Workload.fill_payload) and never
        # reads an older one again.
        if len(snaps) > 1:
            dyn = yield ("rollback", {k: [sn[k] for sn in snaps]
                                      for k in wl.dyn_keys}, n_acc)
        # ONE closing full forward serves every stopped lane at its
        # rolled-back step and refreshes only those lanes' table slices
        s_eff = torch.clamp(s, max=S - 1)
        if (yield ("any", stop_full, "full")):
            ctx = wl.step_context(state, s_eff)
            out_full, branches = wl.full_forward(dyn, cond, ctx) \
                if ph is None else self._forward(ph, "full", dyn, cond, ctx)
            tstate = yield ("update", tstate, branches, s_eff, stop_full)
            out_full = self._out(state, out_full)
            dyn = wl.select_dyn(stop_full,
                                wl.advance(dyn, out_full, ctx, s_eff), dyn)
        since = torch.where(stop_full, torch.zeros_like(since), since)
        s = s + stop_full.to(torch.int32)
        new_state = dict(state)
        new_state.update(since=since, step=s, **dyn, **tstate)
        advanced = n_acc + stop_full.to(torch.int32)
        flags = {"attempted": rows["attempted"][0], "ok": ok0,
                 "accepted": rows["accepted"][0], "full": stop_full,
                 "err": rows["err"][0], "tau": rows["tau"][0],
                 "n_spec": n_acc, "n_drafted": n_drafted,
                 "advanced": advanced,
                 **{f"chain_{k}": torch.stack(v) for k, v in rows.items()}}
        self._adapt(state, new_state, flags)
        return new_state, flags


def _resume(body, value) -> Tuple[bool, Any]:
    """(False, the body's next request) or (True, its result)."""
    try:
        return False, body.send(value)
    except StopIteration as done:
        return True, done.value


def _phase(ph, request: tuple, fn, *args):
    """``fn(*args)`` answering the body's ``request`` inside its phase
    span: a branch read as ``wait.<reason>``, a kernel request under
    ``_PHASE_OF``; a batch-accept request needs no span."""
    op = request[0]
    if op == "any":
        return ph.wait(request[2], fn, *args)
    if op in _PHASE_OF:
        return ph.call(_PHASE_OF[op], fn, *args)
    return fn(*args)


class ShardedStep:
    """The lane step over a :class:`~repro_torch.launch.mesh.LaneMesh`:
    ``step(shards) -> (shards, flags)`` with the state and the flags as D
    per-shard dicts, shard i on ``mesh.devices[i]``. ``steps[i]`` is the
    W/D-lane step of shard i's workload replica (shards on one device
    share it). Each tick advances the D step bodies to the same request
    and answers it for all of them: a branch's "any lane" from one host
    read of the D shards' answers (so ``host_syncs`` counts what the
    unsharded step counts), batch accept's "every lane" on the device,
    and each kernel once per shard through its ``ops.*_sharded``
    routing. With ``phases`` each answer runs in its phase span, once for
    all shards (each shard step records its own forwards)."""

    def __init__(self, steps: List[LaneStep], mesh,
                 phases: Optional[Any] = None) -> None:
        if len(steps) != mesh.size:
            raise ValueError(f"{len(steps)} shard steps for a mesh of "
                             f"{mesh.size}")
        self.steps, self.mesh = list(steps), mesh
        self.phases = phases
        self.host_syncs = 0

    def __call__(self, shards: List[State]
                 ) -> Tuple[List[State], List[Dict[str, Any]]]:
        bodies = [st._body(sh) for st, sh in zip(self.steps, shards)]
        answers: List[Any] = [None] * len(bodies)
        while True:
            out = [_resume(b, a) for b, a in zip(bodies, answers)]
            finished = {f for f, _ in out}
            requests = [r for _, r in out]
            if finished == {True}:
                return [r[0] for r in requests], [r[1] for r in requests]
            ops_ = {r[0] for r in requests} if finished == {False} else ()
            if len(ops_) != 1:
                seen = ["done" if f else r[0] for f, r in out]
                raise RuntimeError(f"lane shards diverged in the step: {seen}")
            op, args = requests[0][0], [r[1:] for r in requests]
            answers = self._answer_all(op, args) if self.phases is None \
                else _phase(self.phases, requests[0], self._answer_all, op,
                            args)

    def _answer_all(self, op: str, args: List[tuple]) -> List[Any]:
        devs = self.mesh.devices
        if op == "any":
            self.host_syncs += 1
            flag = bool(torch.stack([a[0].any().to(devs[0])
                                     for a in args]).any())
            return [flag] * len(args)
        if op == "all":
            every = torch.stack([a[0].to(devs[0]) for a in args]).all()
            return [every.to(d) for d in devs]
        return self.steps[0].kernel(op, [list(c) for c in zip(*args)],
                                    mesh=self.mesh)


def gather_flags(flags: Union[Dict[str, Any], List[Dict[str, Any]]],
                 keys: Optional[Tuple[str, ...]] = None) -> Dict[str, Any]:
    """A tick's flags (``keys`` of them, default all) over every lane: a
    sharded step's per-shard flags joined on shard 0's device along their
    lane (last) axis — device copies only, no host sync; an unsharded
    step's as they are."""
    if isinstance(flags, dict):
        return flags if keys is None else {k: flags[k] for k in keys}
    dev = flags[0]["advanced"].device
    return {k: torch.cat([f[k].to(dev) for f in flags], dim=-1)
            for k in (keys or flags[0])}


def build_workload_step(wl, *, lanes: int, draft_mode: str = "taylor",
                        accept_mode: str = "per_sample",
                        verify_backend: str = "jnp",
                        guidance: Union[bool, str] = False,
                        max_draft_depth: int = 1,
                        forecaster: Any = None,
                        controller: bool = False,
                        mesh: Optional[Any] = None,
                        phases: Optional[Any] = None
                        ) -> Union[LaneStep, ShardedStep]:
    """Build the lane step for a ``Workload``: the depth-1
    :class:`LaneStep` at ``max_draft_depth=1``, else a :class:`ChainStep`
    of K = ``max_draft_depth`` positions (each lane's horizon is its
    ``draft_k`` state entry). ``draft_mode`` picks the Taylor weights of
    ``taylor.prediction_weights``; ``guidance`` is ``False`` (per-lane),
    ``True`` (every slot a guided pair) or ``"mixed"`` (the state's
    ``paired`` mask decides, slot by slot); ``forecaster`` is a name or
    ``Forecaster`` instance (``None`` = Taylor); ``controller=True`` builds
    the closed-loop step (state from ``init_workload_state(...,
    controller=True)``). ``mesh`` builds the :class:`ShardedStep` over
    that many ``lanes / D``-lane shard steps, one per distinct device on
    its workload replica (state from ``init_workload_state(...,
    mesh=mesh)``); ``lanes`` must divide by D, and by 2·D in a guidance
    mode. ``phases`` (a ``repro_torch.obs.PhaseRecorder``) records the
    step's phase spans and counters."""
    if max_draft_depth < 1:
        raise ValueError(f"max_draft_depth must be >= 1, "
                         f"got {max_draft_depth}")
    kw = dict(draft_mode=draft_mode, accept_mode=accept_mode,
              verify_backend=verify_backend, guidance=guidance,
              forecaster=forecaster, controller=controller, phases=phases)
    if mesh is not None:
        _check_pairing(wl, guidance, lanes)
        block = _check_mesh_width(lanes, mesh, bool(guidance))
        per_device = {d: build_workload_step(wl.on(d), lanes=block,
                                             max_draft_depth=max_draft_depth,
                                             **kw)
                      for d in mesh.distinct_devices()}
        return ShardedStep([per_device[d] for d in mesh.devices], mesh,
                           phases=phases)
    if max_draft_depth == 1:
        return LaneStep(wl, lanes=lanes, **kw)
    return ChainStep(wl, lanes=lanes, depth=int(max_draft_depth), **kw)


def init_lane_state(cfg: ModelConfig, dcfg: DiffusionConfig,
                    scfg: SpeCaConfig, lanes: int,
                    cond_template: Dict[str, Any], *,
                    x: Optional[torch.Tensor] = None,
                    active: bool = False,
                    guidance: Union[bool, str] = False,
                    device: DeviceLike = "cuda",
                    mesh: Optional[Any] = None
                    ) -> Union[State, List[State]]:
    """Fresh DIFFUSION lane-batch state (the reference's original entry
    point): :func:`init_workload_state` over a parameter-free
    ``DiffusionWorkload`` on ``device`` (per shard with ``mesh``)."""
    from repro_torch.core.workload import DiffusionWorkload
    wl = DiffusionWorkload(cfg, None, dcfg, scfg, device=device)
    return init_workload_state(wl, lanes, cond_template, x=x, active=active,
                               guidance=guidance, mesh=mesh)


def build_lane_step(cfg: ModelConfig, params: Dict[str, Any],
                    dcfg: DiffusionConfig, scfg: SpeCaConfig, *,
                    lanes: int, draft_mode: str = "taylor",
                    accept_mode: str = "per_sample",
                    verify_backend: str = "jnp",
                    use_flash: bool = False,
                    guidance: Union[bool, str] = False,
                    max_draft_depth: int = 1,
                    forecaster: Any = None,
                    controller: bool = False,
                    device: DeviceLike = "cuda",
                    mesh: Optional[Any] = None
                    ) -> Union[LaneStep, ShardedStep]:
    """The DIFFUSION lane step (the reference's original entry point):
    :func:`build_workload_step` over a ``DiffusionWorkload`` on
    ``device`` (over ``mesh``'s shards with ``mesh``). ``use_flash`` is
    accepted for the reference's signature: DiT attention is
    bidirectional and never reaches the flash kernel."""
    from repro_torch.core.workload import make_diffusion_workload
    wl = make_diffusion_workload(cfg, params, dcfg, scfg,
                                 use_flash=use_flash, device=device)
    return build_workload_step(wl, lanes=lanes, draft_mode=draft_mode,
                               accept_mode=accept_mode,
                               verify_backend=verify_backend,
                               guidance=guidance,
                               max_draft_depth=max_draft_depth,
                               forecaster=forecaster, controller=controller,
                               mesh=mesh)
