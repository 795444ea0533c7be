"""The port's closed-loop controller (``repro_torch.core.controller``) and
the forecasters' ``order_cap`` against the JAX package, model-free.

Held against the reference: ``init_controller_state`` and ``lane_values``
exactly; ``controller_update`` over several ticks on seeded [W] states
(both SLOs, controller-off, inactive and non-drafting lanes, every bound
reached) with integers exact and f32 state within rtol 1e-6 of the
reference's jitted update (the engine's form, where XLA fuses the
multiply-adds); ``ControllerPolicy``'s validation; ``prediction_weights``
and ``spectral_weights`` under an ``order_cap``. Then the port's own
analogues of ``tests/test_controller_properties.py``: bounds, lane
locality, monotone back-off under rejects, and a deadline lane behind
schedule speculating deeper.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import controller as JCT
from repro.core import taylor as JT
from repro.core.forecaster import spectral_weights as jspectral_weights
from repro_torch.core import controller as CT
from repro_torch.core import taylor as PT
from repro_torch.core.forecaster import spectral_weights

W = 6
ORDER = 2
MAX_STEP = 24
OUT_KEYS = ("tau0", "draft_k", "ctl_rate", "ctl_adv", "ctl_order",
            "ctl_ticks")
F32_KEYS = ("tau0", "ctl_rate", "ctl_adv")

POLICY_KW = [
    None,                                           # controller-off lane
    dict(),
    dict(target_accept=0.9, gain=1.0, ema=0.0, k_max=3),
    dict(target_accept=0.2, gain=0.1, ema=0.95, tau_min=0.05, k_min=2,
         k_max=6, order_min=1),
    dict(slo="deadline", deadline_ticks=8.0, tau_max=3.0),
    dict(slo="deadline", deadline_ticks=30.0, gain=0.5, tau_max=0.1,
         order_min=0, order_max=1),
]


def _pols(mod):
    return [None if kw is None else mod.ControllerPolicy(**kw)
            for kw in POLICY_KW]


def _mk_state(seed, pol_idx, active, *, mod=CT):
    """A lane-batch controller state as numpy arrays: each lane gets
    ``POLICY_KW[pol_idx[lane]]`` through ``mod.lane_values`` (the fill
    path), then random mid-flight statistics."""
    rng = np.random.default_rng(seed)
    tau0 = rng.uniform(0.05, 1.0, W).astype(np.float32)
    st = {"tau0": tau0,
          "draft_k": rng.integers(1, 5, W).astype(np.int32),
          "max_step": np.full(W, MAX_STEP, np.int32)}
    st.update({k: np.array(v) for k, v in
               CT.init_controller_state(W, ORDER, device="cpu").items()})
    pols = _pols(mod)
    for lane, pi in enumerate(pol_idx):
        vals = mod.lane_values(pols[pi], tau0=float(tau0[lane]),
                               order=ORDER, max_draft_depth=4)
        for k, v in vals.items():
            st[k][lane] = v
        if pols[pi] is not None:
            st["draft_k"][lane] = np.clip(st["draft_k"][lane],
                                          vals["ctl_k_lo"], vals["ctl_k_hi"])
    st["ctl_rate"] = rng.uniform(0, 1, W).astype(np.float32)
    st["ctl_adv"] = rng.uniform(0, 4, W).astype(np.float32)
    st["ctl_ticks"] = rng.integers(0, 10, W).astype(np.int32)
    return st, np.asarray(active, bool)


def _draw_counters(rng):
    n_drafted = rng.integers(0, 5, W)
    n_spec = np.asarray([rng.integers(0, d + 1) for d in n_drafted])
    return {"step_new": rng.integers(0, MAX_STEP + 1, W).astype(np.int32),
            "n_spec": n_spec.astype(np.int32),
            "n_drafted": n_drafted.astype(np.int32),
            "advanced": (n_spec + rng.integers(0, 2, W)).astype(np.int32)}


def _port_update(st, act, counters):
    out = CT.controller_update(
        {k: torch.from_numpy(np.array(v)) for k, v in st.items()},
        active=torch.from_numpy(act),
        **{k: torch.from_numpy(v) for k, v in counters.items()})
    return {k: v.numpy() for k, v in out.items()}


_jit_update = jax.jit(lambda st, act, c: JCT.controller_update(
    st, active=act, **c))


def _ref_update(st, act, counters):
    out = _jit_update({k: jnp.asarray(v) for k, v in st.items()},
                      jnp.asarray(act),
                      {k: jnp.asarray(v) for k, v in counters.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def test_init_and_lane_values_match_reference():
    ref = JCT.init_controller_state(W, ORDER)
    got = CT.init_controller_state(W, ORDER, device="cpu")
    assert set(got) == set(ref) == set(CT.CONTROLLER_KEYS) \
        == set(JCT.CONTROLLER_KEYS)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), k)
        assert got[k].numpy().dtype == np.asarray(ref[k]).dtype, k
    assert CT.SLO_MODES == JCT.SLO_MODES
    for pj, pp in zip(_pols(JCT), _pols(CT)):
        for tau0, kmax in ((0.3, 4), (1e-5, 1), (2.5, 8)):
            kw = dict(tau0=tau0, order=ORDER, max_draft_depth=kmax)
            assert CT.lane_values(pp, **kw) == JCT.lane_values(pj, **kw)


SEEDED_CASES = [
    # (seed, policy per lane, active per lane)
    (0, [0, 1, 2, 3, 4, 5], [1, 1, 1, 1, 1, 1]),
    (1, [1, 1, 0, 0, 4, 4], [1, 0, 1, 0, 1, 0]),
    (2, [2, 3, 2, 3, 5, 0], [1, 1, 0, 1, 1, 1]),
    (3, [0, 0, 0, 0, 0, 0], [1, 1, 1, 0, 0, 0]),   # all controller-off
    (4, [5, 4, 3, 2, 1, 0], [0, 0, 0, 0, 0, 0]),   # all finished
    (5, [2, 2, 3, 3, 4, 5], [1, 1, 1, 1, 1, 1]),
]


def _assert_outputs_match(got, ref):
    for k in OUT_KEYS:
        if k in F32_KEYS:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], ref[k], k)
        assert got[k].dtype == ref[k].dtype, k


@pytest.mark.parametrize("case", SEEDED_CASES)
def test_controller_update_matches_reference(case):
    """Eight ticks from the same state through both packages, each tick
    from the reference's state: the integers exact, f32 within 1e-6."""
    seed, pol_idx, active = case
    st, act = _mk_state(seed, pol_idx, active)
    rng = np.random.default_rng(seed + 1)
    for _ in range(8):
        counters = _draw_counters(rng)
        ref = _ref_update(st, act, counters)
        _assert_outputs_match(_port_update(st, act, counters), ref)
        st.update(ref)


def test_seeded_parity_cases_reach_every_bound():
    """The parity cases are not vacuous: across them the reference's
    update moved lanes in both SLOs, clamped at every bound, froze lanes
    that drafted nothing and left off and finished lanes alone."""
    hit = set()
    for seed, pol_idx, active in SEEDED_CASES:
        st, act = _mk_state(seed, pol_idx, active)
        rng = np.random.default_rng(seed + 1)
        for _ in range(8):
            counters = _draw_counters(rng)
            ref = _ref_update(st, act, counters)
            on = st["ctl_on"] & act
            for name, lo, hi in (("draft_k", "ctl_k_lo", "ctl_k_hi"),
                                 ("ctl_order", "ctl_order_lo",
                                  "ctl_order_hi"),
                                 ("tau0", "ctl_tau_lo", "ctl_tau_hi")):
                if (on & (ref[name] == st[lo])).any():
                    hit.add(name + "_lo")
                if (on & (ref[name] == st[hi])).any():
                    hit.add(name + "_hi")
            moved = on & (ref["tau0"] != st["tau0"])
            if (moved & ~st["ctl_dl"]).any():
                hit.add("accept")
            if (moved & st["ctl_dl"]).any():
                hit.add("deadline")
            if (on & (counters["n_drafted"] == 0)).any():
                hit.add("no_draft")
            if (~on).any():
                hit.add("off")
            st.update(ref)
    assert hit >= {"draft_k_lo", "draft_k_hi", "ctl_order_lo",
                   "ctl_order_hi", "tau0_lo", "tau0_hi", "accept",
                   "deadline", "no_draft", "off"}, hit


@pytest.mark.parametrize("kw", [
    dict(slo="fast"), dict(target_accept=0.0), dict(target_accept=1.5),
    dict(gain=0.0), dict(gain=2.0), dict(ema=1.0), dict(ema=-0.1),
    dict(tau_min=-1.0), dict(tau_min=0.5, tau_max=0.1), dict(k_min=0),
    dict(k_min=4, k_max=2), dict(order_min=-1),
    dict(order_min=2, order_max=1), dict(slo="deadline"),
    dict(slo="deadline", deadline_ticks=0.0)])
def test_policy_validation_matches_reference(kw):
    with pytest.raises(ValueError) as ref:
        JCT.ControllerPolicy(**kw)
    with pytest.raises(ValueError) as got:
        CT.ControllerPolicy(**kw)
    assert str(got.value) == str(ref.value)


def _weights_inputs(seed, chain):
    rng = np.random.default_rng(seed)
    shape = (3, 5) if chain else (5,)
    d = rng.integers(1, 9, shape).astype(np.float32)
    gap = rng.integers(1, 4, 5).astype(np.float32)
    n_anchors = rng.integers(0, 5, 5).astype(np.int32)
    cap = np.array([0, 1, 2, 3, 1], np.int32)
    return d, gap, n_anchors, cap


@pytest.mark.parametrize("chain", [False, True])
@pytest.mark.parametrize("mode", ["taylor", "newton", "ab2"])
def test_prediction_weights_order_cap_match_reference(chain, mode):
    d, gap, n_anchors, cap = _weights_inputs(3, chain)
    for order_cap in (None, cap):
        ref = np.asarray(JT.prediction_weights(
            ORDER, jnp.asarray(d), jnp.asarray(gap), jnp.asarray(n_anchors),
            mode, order_cap=None if order_cap is None
            else jnp.asarray(order_cap)))
        got = PT.prediction_weights(
            ORDER, torch.from_numpy(d), torch.from_numpy(gap),
            torch.from_numpy(n_anchors), mode,
            order_cap=None if order_cap is None
            else torch.from_numpy(order_cap)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
        np.testing.assert_array_equal(got == 0, ref == 0)
    # a cap at or above the order leaves the weights bitwise as None's
    full = torch.full((5,), ORDER, dtype=torch.int32)
    args = (ORDER, torch.from_numpy(d), torch.from_numpy(gap),
            torch.from_numpy(n_anchors), mode)
    assert torch.equal(PT.prediction_weights(*args, order_cap=full),
                       PT.prediction_weights(*args))


@pytest.mark.parametrize("chain", [False, True])
def test_spectral_weights_order_cap_match_reference(chain):
    d, gap, n_anchors, cap = _weights_inputs(4, chain)
    n_anchors = np.full(5, ORDER + 1, np.int32)
    for order_cap in (None, cap):
        ref = np.asarray(jspectral_weights(
            ORDER, jnp.asarray(d), jnp.asarray(gap), jnp.asarray(n_anchors),
            order_cap=None if order_cap is None
            else jnp.asarray(order_cap)))
        got = spectral_weights(
            ORDER, torch.from_numpy(d), torch.from_numpy(gap),
            torch.from_numpy(n_anchors),
            order_cap=None if order_cap is None
            else torch.from_numpy(order_cap)).numpy()
        np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-7)
    # cap 0 keeps only the DC band: every row weighs 1/M
    zero = spectral_weights(ORDER, torch.from_numpy(d),
                            torch.from_numpy(gap),
                            torch.from_numpy(n_anchors),
                            order_cap=torch.zeros(5, dtype=torch.int32))
    torch.testing.assert_close(zero, torch.full_like(zero, 1 / (ORDER + 1)))
    big = torch.full((5,), ORDER + 1, dtype=torch.int32)
    args = (ORDER, torch.from_numpy(d), torch.from_numpy(gap),
            torch.from_numpy(n_anchors))
    assert torch.equal(spectral_weights(*args, order_cap=big),
                       spectral_weights(*args))


# ---------------------------------------------------------------------------
# The port's own analogues of tests/test_controller_properties.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", SEEDED_CASES)
def test_tick_invariants(case):
    """Every adapted knob stays in its bounds (accept lanes never above
    their base τ0, the rate in [0, 1]); off and finished lanes keep all
    six outputs bitwise."""
    seed, pol_idx, active = case
    st, act = _mk_state(seed, pol_idx, active)
    rng = np.random.default_rng(seed + 1)
    for _ in range(4):
        out = _port_update(st, act, _draw_counters(rng))
        on = st["ctl_on"] & act
        for name, lo, hi in (("tau0", "ctl_tau_lo", "ctl_tau_hi"),
                             ("draft_k", "ctl_k_lo", "ctl_k_hi"),
                             ("ctl_order", "ctl_order_lo", "ctl_order_hi")):
            assert (out[name][on] >= st[lo][on]).all(), name
            assert (out[name][on] <= st[hi][on]).all(), name
        acc = on & ~st["ctl_dl"]
        assert (out["tau0"][acc] <= st["ctl_tau_base"][acc]).all()
        assert ((out["ctl_rate"][on] >= 0) & (out["ctl_rate"][on] <= 1)).all()
        off = ~on
        for k in OUT_KEYS:
            assert out[k][off].tobytes() == st[k][off].tobytes(), k
        st.update(out)


@pytest.mark.parametrize("lane", range(W))
def test_no_cross_lane_contamination(lane):
    """Perturbing every other lane's state and counters leaves this lane's
    outputs bit for bit."""
    st, act = _mk_state(11, [1, 2, 3, 4, 0, 5], [1] * W)
    counters = _draw_counters(np.random.default_rng(18))
    base = _port_update(st, act, counters)
    other = np.arange(W) != lane
    prng = np.random.default_rng(24)
    pst = {}
    for k, v in st.items():
        if v.dtype == bool:
            pst[k] = np.where(other, ~v, v)
        elif np.issubdtype(v.dtype, np.integer):
            pst[k] = np.where(other, v + 1, v).astype(v.dtype)
        else:
            pst[k] = np.where(other, v + prng.uniform(0.1, 0.9, W),
                              v).astype(v.dtype)
    pcounters = {k: np.where(other, v + 1, v).astype(v.dtype)
                 for k, v in counters.items()}
    got = _port_update(pst, act, pcounters)
    for k in OUT_KEYS:
        assert got[k][lane].tobytes() == base[k][lane].tobytes(), k


@pytest.mark.parametrize("seed,pol_idx", [(21, [1, 1, 2, 3, 0, 0]),
                                          (22, [3, 2, 1, 1, 1, 0])])
def test_monotone_backoff_under_rejects(seed, pol_idx):
    """Accept SLO from the fill-time state (rate at target): sustained
    rejects never raise τ0, draft_k or the order cap, and shrink them
    until the floors bind."""
    st, act = _mk_state(seed, pol_idx, [1] * W)
    st["ctl_rate"] = st["ctl_target"].copy()
    on = st["ctl_on"] & ~st["ctl_dl"] & act
    assert on.any()
    moved = False
    for t in range(12):
        out = _port_update(st, act, {
            "step_new": np.full(W, min(t, MAX_STEP), np.int32),
            "n_spec": np.zeros(W, np.int32),
            "n_drafted": np.full(W, 3, np.int32),
            "advanced": np.ones(W, np.int32)})
        for k in ("tau0", "draft_k", "ctl_order"):
            assert (out[k][on] <= st[k][on]).all(), k
        moved |= bool((out["tau0"][on] < st["tau0"][on]).any()
                      or (out["draft_k"][on] < st["draft_k"][on]).any())
        st.update(out)
    assert moved
    assert (st["tau0"][on] >= st["ctl_tau_lo"][on]).all()
    assert (st["draft_k"][on] == st["ctl_k_lo"][on]).all()


def test_deadline_lane_behind_speculates_deeper():
    """A deadline lane far behind its pace walks draft_k up to its cap and
    relaxes τ0 above its base, never above ``tau_max``."""
    st, act = _mk_state(5, [4, 0, 0, 0, 0, 0], [1] * W)
    st["ctl_adv"] = np.full(W, 0.25, np.float32)
    base_tau = float(st["tau0"][0])
    for _ in range(10):
        st.update(_port_update(st, act, {
            "step_new": np.ones(W, np.int32),
            "n_spec": np.zeros(W, np.int32),
            "n_drafted": np.ones(W, np.int32),
            "advanced": np.zeros(W, np.int32)}))
    assert st["draft_k"][0] == st["ctl_k_hi"][0]
    assert base_tau < st["tau0"][0] <= st["ctl_tau_hi"][0]
