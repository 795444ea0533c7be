"""The port's slice end to end against the JAX package, on the trained
tiny DiT (``tiny_trained_dit``; kept in one file so ``--dist loadfile``
trains it once).

The reference's parameters are converted with ``params_from_jax`` and its
initial noise is handed to the port, so both packages run the same
trajectories. Held: the DiT forward and its branch increments within
1e-5 (with and without the SpeCa mask); sampler and engine accept
trajectories identical; latents within rtol=atol=1e-5; verification
errors within rtol=1e-4; the NaN "did not draft" sentinel as in
``tests/test_lane_step.py``.

Draft-K chains and the spectral forecaster: the port's own analogues of
``tests/test_draft_k.py`` (the rollback invariant bitwise against the
port's depth-1 step, per-lane depths, frozen lanes, the ``max_step`` cap,
serving), one chain tick and ``serve_batched`` against the reference
under the same bars.

Classifier-free guidance (analogues of ``tests/test_serving_cfg.py`` and
``tests/test_serving_v2.py``), under the same bars: guided
``speca_sample`` and the two-pass ``sample_full`` oracle against the
reference's; a mixed guided/unguided ``serve_batched`` batch (two scales,
a negative prompt, distinct τ) per request against the reference engine
(accepts, counters, flops, samples), lanes 4 against lanes 2 on the port;
s = 1 against cond-only; one guided chain tick and a guided deep serve
against the reference's; pair coherence; the width rule and backfill.

Lane-sharded serving (``SpeCaEngine(mesh=)``, analogues of
``tests/test_serving_sharded.py``): engines on D ∈ {1, 2, 4} CPU shards
against the unsharded engine (accepts, counters, FLOPs and host syncs
exact; samples bitwise at D = 1 and within 2e-5 at D ∈ {2, 4}, the
reference's bar), at D = 1 against the reference's engine on
``make_lane_mesh(1)``, guided pairs, depth-4 Taylor and spectral chains
and ``accept_mode="batch"`` at D = 2 with the shards' lanes deciding
apart, the lifecycle with observability, the width rules, and the
reference's ``make_lane_mesh(4)`` engine in a subprocess with 4 forced
host devices against the port at D = 4 on one checkpoint.
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SpeCaConfig as JSpeCaConfig
from repro.core import controller as JCT
from repro.core import lane_step as JLS
from repro.core.speca import speca_sample as jspeca_sample
from repro.diffusion.pipeline import latent_shape
from repro.diffusion.pipeline import sample_full as jsample_full
from repro.layers import model as JM
from repro.serving import Preview as JPreview
from repro.serving import QueueFull as JQueueFull
from repro.serving import Request as JRequest
from repro.serving import RequestPolicy as JRequestPolicy
from repro.serving import SpeCaEngine as JEngine
from repro_torch import configs as PC
from repro_torch.convert import params_from_jax
from repro_torch.core import controller as CT
from repro_torch.core import lane_step as PLS
from repro_torch.core.speca import speca_sample
from repro_torch.core.workload import DiffusionWorkload
from repro_torch.diffusion.pipeline import sample_full
from repro_torch.layers import model as PM
from repro_torch.obs.trace import PHASE_METRICS, PhaseRecorder
from repro_torch.serving import (ControllerPolicy, Observability, Preview,
                                 QueueFull, Request, RequestPolicy,
                                 SpeCaEngine, allocation_report)

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def port_record(cls, ref):
    """The port's record ``cls`` with the reference record's values."""
    return cls(**{f.name: getattr(ref, f.name)
                  for f in dataclasses.fields(cls)})


@pytest.fixture(scope="module")
def both(tiny_trained_dit):
    """(reference (cfg, dcfg, params), port (cfg, dcfg, params))."""
    cfg, dcfg, params = tiny_trained_dit
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                         device="cpu")
    pcfg = port_record(PC.ModelConfig, cfg)
    pdcfg = port_record(PC.DiffusionConfig, dcfg)
    return (cfg, dcfg, params), (pcfg, pdcfg, tp)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("masked", [False, True])
def test_dit_forward_matches_reference(both, masked):
    (cfg, dcfg, params), (pcfg, _, tp) = both
    rng = np.random.default_rng(0)
    B, T = 3, (dcfg.latent_size // cfg.patch_size) ** 2
    lat = rng.normal(size=(B, dcfg.latent_size, dcfg.latent_size,
                           cfg.in_channels)).astype(np.float32)
    inp = {"latents": lat, "t": np.array([980.0, 500.0, 20.0], np.float32),
           "labels": np.array([1, 4, 7])}
    kw_j, kw_p = {}, {}
    if masked:
        preds = (rng.normal(size=(cfg.num_layers, 2, B, T, cfg.d_model))
                 * 0.1).astype(np.float32)
        mask = [layer == cfg.num_layers - 1
                for layer in range(cfg.num_layers)]
        kw_j = dict(branch_preds=jnp.asarray(preds),
                    compute_mask=jnp.asarray(mask))
        kw_p = dict(branch_preds=torch.from_numpy(preds), compute_mask=mask)
    oj, ej = JM.dit_forward(cfg, params, {k: jnp.asarray(v)
                                          for k, v in inp.items()},
                            collect_branches=True, **kw_j)
    op, ep = PM.dit_forward(pcfg, tp, {k: torch.from_numpy(v)
                                       for k, v in inp.items()},
                            collect_branches=True, **kw_p)
    np.testing.assert_allclose(op.numpy(), np.asarray(oj), **TOL)
    np.testing.assert_allclose(ep["branches"].numpy(),
                               np.asarray(ej["branches"]), **TOL)
    # the increments are not vacuous: trained AdaLN gates are non-zero
    assert np.abs(np.asarray(ej["branches"])).max() > 1e-3


def _scfgs(tau0=0.35, max_draft=6):
    kw = dict(taylor_order=2, max_draft=max_draft, tau0=tau0, beta=0.9)
    return JSpeCaConfig(**kw), PC.SpeCaConfig(**kw)


def _run_samplers(both, accept_mode, labels, seed, draft_mode="taylor"):
    (cfg, dcfg, params), (pcfg, pdcfg, tp) = both
    jscfg, pscfg = _scfgs()
    key = jax.random.PRNGKey(seed)
    B = len(labels)
    xj, sj = jax.jit(lambda k: jspeca_sample(
        cfg, params, dcfg, jscfg, k, {"labels": jnp.asarray(labels)}, B,
        accept_mode=accept_mode, draft_mode=draft_mode))(key)
    noise = jax.random.normal(key, latent_shape(cfg, dcfg, B), jnp.float32)
    xp, sp = speca_sample(pcfg, tp, pdcfg, pscfg,
                          {"labels": torch.tensor(labels)}, B,
                          noise=torch.from_numpy(np.array(noise)),
                          accept_mode=accept_mode, draft_mode=draft_mode,
                          device="cpu")
    return (xj, sj), (xp, sp)


@pytest.mark.parametrize("accept_mode, draft_mode", [
    ("batch", "taylor"), ("per_sample", "taylor"), ("per_sample", "newton"),
    ("per_sample", "reuse"), ("per_sample", "ab2")])
def test_speca_sample_matches_reference(both, accept_mode, draft_mode):
    (xj, sj), (xp, sp) = _run_samplers(both, accept_mode, [1, 5, 6], 5,
                                       draft_mode)
    for k in ("accept_b", "spec_step", "spec_attempted",
              "per_sample_accepts"):
        np.testing.assert_array_equal(_np(sp[k]), np.asarray(sj[k]), k)
    assert int(sp["num_spec"]) == int(sj["num_spec"])
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), **TOL)
    ej, ep = np.asarray(sj["err"]), sp["err"].numpy()
    np.testing.assert_array_equal(np.isnan(ep), np.isnan(ej))
    drafted = np.isfinite(ej)
    np.testing.assert_allclose(ep[drafted], ej[drafted], rtol=1e-4)
    np.testing.assert_allclose(sp["tau"].numpy(), np.asarray(sj["tau"]),
                               rtol=1e-6)
    # the run speculated (the comparison is not vacuous) and synced the
    # host twice per step to decide its two branches
    assert int(sp["num_spec"]) > 0
    assert sp["host_syncs"] == 2 * sp["num_steps"]


def test_err_sentinel_is_nan_not_inf(both):
    """As ``tests/test_lane_step.py``: NaN where the sample did not draft,
    finite where it did (batch mode drafts every sample), never inf."""
    _, (_, sp) = _run_samplers(both, "batch", [1, 4], 3)
    err = sp["err"].numpy()
    attempted = sp["spec_attempted"].numpy()
    assert not np.isinf(err).any()
    assert np.isnan(err[~attempted]).all()
    assert np.isfinite(err[attempted]).all()
    assert attempted.any() and (~attempted).any()
    assert np.isfinite(np.nanmean(err))
    assert np.isfinite(np.nanpercentile(err, 95))


@pytest.fixture(scope="module")
def engines(both):
    (cfg, dcfg, params), (pcfg, pdcfg, tp) = both
    jscfg, pscfg = _scfgs(tau0=0.4, max_draft=8)

    def noise_fn(seed):
        return np.asarray(jax.random.normal(
            jax.random.PRNGKey(seed), latent_shape(cfg, dcfg, 1),
            jnp.float32))

    return (JEngine(cfg, params, dcfg, jscfg),
            SpeCaEngine(pcfg, tp, pdcfg, pscfg, noise_fn=noise_fn,
                        device="cpu"))


@pytest.mark.parametrize("lanes", [1, 2])
def test_serve_batched_matches_reference(both, engines, lanes):
    (cfg, dcfg, _), _ = both
    je, pe = engines
    jreqs = [JRequest(request_id=i, cond={"labels": jnp.asarray([i + 1])},
                      seed=10 + i) for i in range(3)]
    preqs = [Request(request_id=i, cond={"labels": torch.tensor([i + 1])},
                     seed=10 + i) for i in range(3)]
    jres = je.serve_batched(jreqs, lanes=lanes)
    pres = pe.serve_batched(preqs, lanes=lanes)
    S = dcfg.num_inference_steps
    for a, b in zip(jres, pres):
        assert a.request_id == b.request_id
        assert b.accepts == a.accepts, a.request_id
        assert (b.num_full, b.num_spec, b.num_drafted) == \
            (a.num_full, a.num_spec, a.num_drafted)
        assert b.num_full + b.num_spec == S and b.completed
        assert b.flops == a.flops
        np.testing.assert_allclose(b.sample.numpy(), np.asarray(a.sample),
                                   **TOL)
    assert sum(r.num_spec for r in pres) > 0
    rep_j = allocation_report(jres, 1.0)
    rep_p = allocation_report(pres, 1.0)
    assert rep_p == pytest.approx(rep_j)


def test_serve_lane_width_keeps_trajectories(engines):
    """The port's own trajectory-exactness: the same requests at lanes 1
    and 3 serve identical per-request accept sequences."""
    _, pe = engines
    reqs = [Request(request_id=i, cond={"labels": torch.tensor([i])},
                    seed=40 + i) for i in range(3)]
    r1 = pe.serve_batched(reqs, lanes=1)
    r3 = pe.serve_batched(reqs, lanes=3)
    for a, b in zip(r1, r3):
        assert a.accepts == b.accepts
        assert (a.num_full, a.num_spec) == (b.num_full, b.num_spec)


def test_tick_budget_drains_and_drops(both, engines):
    (_, dcfg, _), _ = both
    _, pe = engines
    S = dcfg.num_inference_steps
    reqs = [Request(request_id=i, cond={"labels": torch.tensor([i])},
                    seed=i) for i in range(3)]
    res = pe.serve_batched(reqs, lanes=2, max_ticks=S // 2)
    assert [r.completed for r in res] == [False, False, False]
    assert res[0].num_full + res[0].num_spec == S // 2
    assert res[2].sample is None and res[2].accepts == []
    assert allocation_report(res, 1.0) == {"n_requests": 0, "n_dropped": 3}


# ---------------------------------------------------------------------------
# Draft-K chains: the port's own analogues of tests/test_draft_k.py
# ---------------------------------------------------------------------------

W, ORDER, K = 4, 2, 3


@pytest.fixture(scope="module")
def chain_steps(both):
    """(workload, depth-1 step, depth-K chain step) of the port over the
    trained backbone."""
    _, (pcfg, pdcfg, tp) = both
    scfg = PC.SpeCaConfig(taylor_order=ORDER, max_draft=6, tau0=0.5,
                          beta=0.9)
    wl = DiffusionWorkload(pcfg, tp, pdcfg, scfg, device="cpu")
    return (wl, PLS.build_workload_step(wl, lanes=W),
            PLS.build_workload_step(wl, lanes=W, max_draft_depth=K))


def _warm(wl, legacy, seed, tau0, draft_k):
    """A mid-schedule state whose tables hold real backbone features:
    random latents, then depth-1 ticks from cold (cold lanes refresh)."""
    rng = np.random.default_rng(seed)
    st = PLS.init_workload_state(wl, W, {"labels": torch.tensor([0])},
                                 active=True)
    st["x"] = torch.from_numpy(rng.normal(size=tuple(st["x"].shape))
                               .astype(np.float32))
    st["cond"] = {"labels": torch.tensor(
        [(seed + i) % wl.cfg.num_classes for i in range(W)])}
    st["tau0"] = torch.tensor(tau0, dtype=torch.float32)
    st["draft_k"] = torch.tensor(draft_k, dtype=torch.int32)
    for _ in range(ORDER + 2):
        st, _ = legacy(st)
    assert bool((st["n_anchors"] > ORDER).all())
    return st


def _legacy_states(legacy, st):
    """The state after 0..K depth-1 ticks."""
    out = [st]
    for _ in range(K):
        st, _ = legacy(st)
        out.append(st)
    return out


def _assert_lane_equal(a, b, lane):
    for k in ("since", "step", "n_anchors", "anchor_step", "gap"):
        assert torch.equal(a[k][lane], b[k][lane]), (lane, k)
    assert torch.equal(a["x"][lane], b["x"][lane]), lane
    assert torch.equal(a["diffs"][:, :, :, lane],
                       b["diffs"][:, :, :, lane]), lane


def test_chain_rollback_restores_accepted_prefix_state(chain_steps):
    """The rollback invariant: after one depth-3 chain tick each lane's
    state is bitwise that lane's state after ``advanced[lane]`` depth-1
    ticks — accept-all, mid-chain rejection and reject-at-0 lanes."""
    wl, legacy, chain = chain_steps
    st = _warm(wl, legacy, 0, [1e12, 0.5, 1e-9, 0.3], [K] * W)
    syncs = chain.host_syncs
    new, flags = chain(st)
    assert chain.host_syncs - syncs <= K + 1
    adv = flags["advanced"]
    assert int(adv.min()) >= 1 and int(adv.max()) <= K
    assert bool(flags["full"].any()) and bool((flags["n_spec"] > 0).any())
    states = _legacy_states(legacy, st)
    for lane in range(W):
        _assert_lane_equal(new, states[int(adv[lane])], lane)
    assert tuple(flags["chain_err"].shape) == (K, W)
    # the counters are the chain flags summed
    assert torch.equal(flags["n_spec"],
                       flags["chain_accepted"].sum(0).to(torch.int32))
    assert torch.equal(flags["n_drafted"],
                       flags["chain_attempted"].sum(0).to(torch.int32))


def test_chain_mixed_per_lane_depths(chain_steps):
    """draft_k = [1, 2, 3, 1] in one batch: budgets hold, every lane sits
    bitwise on its own depth-1 trajectory, and lanes that advanced alike
    under a uniform depth agree with it."""
    wl, legacy, chain = chain_steps
    mixed = [1, 2, 3, 1]
    st = _warm(wl, legacy, 3, [0.6, 0.4, 0.5, 0.3], mixed)
    new, flags = chain(st)
    assert bool((flags["advanced"] <= torch.tensor(mixed)).all())
    assert bool((flags["n_drafted"] <= torch.tensor(mixed)).all())
    states = _legacy_states(legacy, st)
    for lane in range(W):
        _assert_lane_equal(new, states[int(flags["advanced"][lane])], lane)
    st_u = dict(st, draft_k=torch.full((W,), K, dtype=torch.int32))
    new_u, flags_u = chain(st_u)
    same = flags_u["advanced"] == flags["advanced"]
    assert bool(same.any())
    for lane in torch.nonzero(same).flatten().tolist():
        assert torch.equal(new["x"][lane], new_u["x"][lane]), lane


def test_chain_finished_lanes_frozen(chain_steps):
    wl, legacy, chain = chain_steps
    st = _warm(wl, legacy, 5, [0.5] * W, [K] * W)
    st["active"] = torch.tensor([True, False, True, False])
    new, flags = chain(st)
    idle = ~st["active"]
    assert torch.equal(new["x"][idle], st["x"][idle])
    assert torch.equal(new["diffs"][:, :, :, idle],
                       st["diffs"][:, :, :, idle])
    for k in ("since", "step", "n_anchors", "anchor_step"):
        assert torch.equal(new[k][idle], st[k][idle]), k
    assert int(flags["advanced"][idle].abs().sum()) == 0
    assert int(flags["n_drafted"][idle].abs().sum()) == 0
    assert not bool(flags["full"][idle].any())


def test_chain_max_step_caps_the_chain(chain_steps):
    wl, legacy, chain = chain_steps
    st = _warm(wl, legacy, 1, [1e12] * W, [K] * W)
    cap = st["step"] + torch.tensor([1, 2, 3, 0], dtype=torch.int32)
    st["max_step"] = cap
    new, flags = chain(st)
    assert bool((new["step"] <= cap).all())
    assert flags["advanced"].tolist() == [1, 2, 3, 0]
    # a lane drafts exactly up to its cap; the positions past it carry
    # the reference's values (not attempted, err NaN)
    att = flags["chain_attempted"]
    assert att.sum(0).tolist() == [1, 2, 3, 0]
    assert bool(torch.isnan(flags["chain_err"][~att]).all())
    assert not bool(flags["full"].any())


@pytest.mark.parametrize("kind", ["no_budget", "cold"])
def test_chain_tick_that_drafts_nothing_restores_nothing(chain_steps,
                                                         monkeypatch, kind):
    """A chain tick in which no lane drafts calls no rollback: every index
    would clamp to snapshot 0, the payload itself. With no closing full
    either (no lane has budget left) the payload comes back bitwise, as
    the same tensor, and an engine fill of one lane afterwards changes
    only that lane. With cold tables every active lane runs the closing
    full, and the tick is bitwise the depth-1 tick."""
    wl, legacy, chain = chain_steps
    calls = []
    monkeypatch.setattr(wl, "rollback", lambda *a: calls.append(a))
    if kind == "no_budget":
        st = _warm(wl, legacy, 7, [1e12] * W, [K] * W)
        st["max_step"] = st["step"].clone()
        st["active"] = torch.tensor([True, False, True, True])
    else:
        rng = np.random.default_rng(7)
        st = PLS.init_workload_state(wl, W, {"labels": torch.tensor([0])},
                                     active=True)
        st["x"] = torch.from_numpy(rng.normal(size=tuple(st["x"].shape))
                                   .astype(np.float32))
    x0 = st["x"].clone()
    new, flags = chain(st)
    assert calls == []
    assert int(flags["n_drafted"].sum()) == 0
    if kind == "cold":
        assert bool(flags["full"].all())
        ref_new, _ = legacy(st)
        for lane in range(W):
            _assert_lane_equal(new, ref_new, lane)
        return
    assert not bool(flags["full"].any())
    assert new["x"] is st["x"] and torch.equal(new["x"], x0)
    assert int(flags["advanced"].abs().sum()) == 0
    # the engine fills a freed lane in place on the state the step
    # returned: only that lane changes
    req = Request(request_id=0, cond={"labels": torch.tensor([3])}, seed=9)
    new = wl.fill_payload(new, 1, req, wl.num_steps)
    assert torch.equal(new["x"][1], wl.noise(9)[0])
    others = [0, 2, 3]
    assert torch.equal(new["x"][others], x0[others])


def _port_reqs(n, policy=None):
    return [Request(request_id=i, cond={"labels": torch.tensor([i + 1])},
                    seed=20 + i, policy=policy) for i in range(n)]


def test_depth1_policy_on_deep_engine_bitwise(both, engines):
    """A max_draft_depth=3 engine serving draft_depth=1 requests returns
    the depth-1 engine's Results bit for bit."""
    (_, _, _), (pcfg, pdcfg, tp) = both
    _, pe = engines
    ref = pe.serve_batched(_port_reqs(5), lanes=W)
    deep = SpeCaEngine(pcfg, tp, pdcfg, pe.workload.scfg,
                       noise_fn=pe.workload.noise_fn, max_draft_depth=3,
                       device="cpu")
    got = deep.serve_batched(_port_reqs(5, RequestPolicy(draft_depth=1)),
                             lanes=W)
    for a, b in zip(ref, got):
        assert (a.accepts, a.num_full, a.num_spec, a.num_drafted,
                a.flops) == (b.accepts, b.num_full, b.num_spec,
                             b.num_drafted, b.flops)
        assert torch.equal(a.sample, b.sample)
    assert sum(sum(r.accepts) for r in ref) > 0
    assert sum(r.num_full for r in ref) > 0


def test_depth3_same_trajectories_fewer_ticks(both, engines):
    (_, _, _), (pcfg, pdcfg, tp) = both
    _, pe = engines
    ref = pe.serve_batched(_port_reqs(5), lanes=W)
    deep = SpeCaEngine(pcfg, tp, pdcfg, pe.workload.scfg,
                       noise_fn=pe.workload.noise_fn, max_draft_depth=3,
                       device="cpu")
    got = deep.serve_batched(_port_reqs(5, RequestPolicy(draft_depth=3)),
                             lanes=W)
    for a, b in zip(ref, got):
        assert a.accepts == b.accepts
        assert torch.equal(a.sample, b.sample)
        assert (a.num_full, a.num_spec) == (b.num_full, b.num_spec)
        assert b.num_drafted >= b.num_spec
        assert 0.0 <= b.draft_accept_rate <= 1.0
    assert sum(r.finish_tick for r in got) < sum(r.finish_tick
                                                 for r in ref)


def test_draft_depth_beyond_engine_raises(both):
    _, (pcfg, pdcfg, tp) = both
    eng = SpeCaEngine(pcfg, tp, pdcfg, PC.SpeCaConfig(taylor_order=ORDER),
                      max_draft_depth=2, device="cpu")
    req = Request(request_id=0, cond={"labels": torch.tensor([0])},
                  policy=RequestPolicy(draft_depth=3))
    with pytest.raises(ValueError, match="max_draft_depth"):
        eng.resolve_policy(req)
    with pytest.raises(ValueError, match="max_draft_depth"):
        eng.serve_batched([req])
    with pytest.raises(ValueError, match="max_draft_depth"):
        SpeCaEngine(pcfg, tp, pdcfg, PC.SpeCaConfig(), max_draft_depth=0,
                    device="cpu")


# ---------------------------------------------------------------------------
# Draft-K and the spectral forecaster against the reference
# ---------------------------------------------------------------------------

def _to_port_state(jstate):
    out = {}
    for k, v in jstate.items():
        if k == "cond":
            out[k] = {ck: torch.from_numpy(np.array(cv))
                      for ck, cv in v.items()}
        else:
            out[k] = torch.from_numpy(np.array(v))
    return out


def test_chain_tick_matches_reference(both, chain_steps):
    """One K=3 chain tick from the same warmed state in both packages:
    identical counters and chain decisions, latents within 1e-5, chain
    errors within rtol 1e-4 where drafted."""
    (cfg, dcfg, params), _ = both
    _, _, chain = chain_steps
    jscfg = JSpeCaConfig(taylor_order=ORDER, max_draft=6, tau0=0.5,
                         beta=0.9)
    legacy = jax.jit(JLS.build_lane_step(cfg, params, dcfg, jscfg, lanes=W))
    jchain = jax.jit(JLS.build_lane_step(cfg, params, dcfg, jscfg, lanes=W,
                                         max_draft_depth=K))
    rng = np.random.default_rng(2)
    js = JLS.init_lane_state(cfg, dcfg, jscfg, W,
                             {"labels": jnp.asarray([0])}, active=True)
    js["x"] = jnp.asarray(rng.normal(size=js["x"].shape), jnp.float32)
    js["cond"] = {"labels": jnp.asarray([1, 2, 3, 4])}
    js["tau0"] = jnp.asarray([1e12, 0.5, 1e-9, 0.3], jnp.float32)
    js["draft_k"] = jnp.asarray([3, 3, 2, 3], jnp.int32)
    for _ in range(ORDER + 2):
        js, _ = legacy(js)
    jnew, jf = jax.tree_util.tree_map(np.asarray, jchain(js))
    pnew, pf = chain(_to_port_state(js))
    for k in ("n_spec", "n_drafted", "advanced", "full", "chain_accepted",
              "chain_attempted"):
        np.testing.assert_array_equal(pf[k].numpy(), jf[k], k)
    np.testing.assert_allclose(pnew["x"].numpy(), jnew["x"], **TOL)
    for k in ("step", "since", "n_anchors", "anchor_step"):
        np.testing.assert_array_equal(pnew[k].numpy(), jnew[k], k)
    np.testing.assert_allclose(pf["chain_tau"].numpy(), jf["chain_tau"],
                               rtol=1e-6)
    ej, ep = jf["chain_err"], pf["chain_err"].numpy()
    np.testing.assert_array_equal(np.isnan(ep), np.isnan(ej))
    drafted = np.isfinite(ej)
    np.testing.assert_allclose(ep[drafted], ej[drafted], rtol=1e-4)
    # non-vacuous: some lane accepted part of the chain and some stopped
    assert jf["n_spec"].sum() > 0 and jf["full"].any()


SERVE_CASES = [("taylor", 3, "mixed"), ("spectral", 1, 1),
               ("spectral", 3, 3)]


@pytest.fixture(scope="module")
def deep_engines(both, engines):
    """(reference engine, port engine) per (forecaster, max_draft_depth)."""
    (cfg, dcfg, params), (pcfg, pdcfg, tp) = both
    jscfg, pscfg = _scfgs(tau0=0.4, max_draft=8)
    _, pe = engines
    out = {}
    for fc, kmax, _ in SERVE_CASES:
        out[fc, kmax] = (
            JEngine(cfg, params, dcfg, jscfg, max_draft_depth=kmax,
                    forecaster=fc),
            SpeCaEngine(pcfg, tp, pdcfg, pscfg,
                        noise_fn=pe.workload.noise_fn, max_draft_depth=kmax,
                        forecaster=fc, device="cpu"))
    return out


@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("fc, kmax, depth", SERVE_CASES)
def test_deep_and_spectral_serve_match_reference(deep_engines, fc, kmax,
                                                 depth, lanes):
    je, pe = deep_engines[fc, kmax]
    depths = [1, 2, 3] if depth == "mixed" else [depth] * 3
    jreqs = [JRequest(request_id=i, cond={"labels": jnp.asarray([i + 1])},
                      seed=10 + i,
                      policy=JRequestPolicy(draft_depth=depths[i]))
             for i in range(3)]
    preqs = [Request(request_id=i, cond={"labels": torch.tensor([i + 1])},
                     seed=10 + i, policy=RequestPolicy(draft_depth=depths[i]))
             for i in range(3)]
    jres = je.serve_batched(jreqs, lanes=lanes)
    pres = pe.serve_batched(preqs, lanes=lanes)
    for a, b in zip(jres, pres):
        assert b.accepts == a.accepts, a.request_id
        assert (b.num_full, b.num_spec, b.num_drafted, b.finish_tick) == \
            (a.num_full, a.num_spec, a.num_drafted, a.finish_tick)
        assert b.draft_accept_rate == a.draft_accept_rate
        assert b.completed and b.flops == a.flops
        np.testing.assert_allclose(b.sample.numpy(), np.asarray(a.sample),
                                   **TOL)
    assert sum(r.num_spec for r in pres) > 0
    assert sum(r.num_full for r in pres) > 0


# ---------------------------------------------------------------------------
# Classifier-free guidance: lane pairs and mixed slots
# ---------------------------------------------------------------------------

GS = 4.0


def _assert_sampler_parity(sj, sp, xj, xp):
    for k in ("accept_b", "spec_step", "spec_attempted",
              "per_sample_accepts"):
        np.testing.assert_array_equal(_np(sp[k]), np.asarray(sj[k]), k)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), **TOL)
    ej, ep = np.asarray(sj["err"]), sp["err"].numpy()
    np.testing.assert_array_equal(np.isnan(ep), np.isnan(ej))
    drafted = np.isfinite(ej)
    np.testing.assert_allclose(ep[drafted], ej[drafted], rtol=1e-4)


@pytest.mark.parametrize("accept_mode", ["per_sample", "batch"])
def test_guided_speca_sample_matches_reference(both, accept_mode):
    """Lane pairs in the sampler: sample k's noise seeds both of its
    lanes, one decision per pair on the guided residual, stats folded to
    samples."""
    (cfg, dcfg, params), (pcfg, pdcfg, tp) = both
    jscfg, pscfg = _scfgs(tau0=0.4, max_draft=8)
    key = jax.random.PRNGKey(17)
    labels = [1, 5]
    xj, sj = jax.jit(lambda k: jspeca_sample(
        cfg, params, dcfg, jscfg, k, {"labels": jnp.asarray(labels)}, 2,
        accept_mode=accept_mode, guidance_scale=GS))(key)
    noise = jax.random.normal(key, latent_shape(cfg, dcfg, 2), jnp.float32)
    xp, sp = speca_sample(pcfg, tp, pdcfg, pscfg,
                          {"labels": torch.tensor(labels)}, 2,
                          noise=torch.from_numpy(np.array(noise)),
                          accept_mode=accept_mode, guidance_scale=GS,
                          device="cpu")
    assert tuple(xp.shape) == tuple(np.asarray(xj).shape)
    assert tuple(sp["accept_b"].shape) == (pdcfg.num_inference_steps, 2)
    _assert_sampler_parity(sj, sp, xj, xp)
    acc = sp["accept_b"].numpy()
    assert acc.any() and not acc.all()       # speculated and rejected


def test_guided_sample_full_matches_two_pass_oracle(both):
    """The two-pass CFG oracle: guided full sampling equals the
    reference's, steers away from cond-only, and s = 1 recovers it."""
    (cfg, dcfg, params), (pcfg, pdcfg, tp) = both
    key = jax.random.PRNGKey(3)
    noise = torch.from_numpy(np.array(jax.random.normal(
        key, latent_shape(cfg, dcfg, 2), jnp.float32)))
    cond = {"labels": np.array([4, 2])}
    ncond = {"labels": np.array([7, 0])}     # a negative prompt
    outs = {}
    for name, gs, nc in (("g", GS, None), ("neg", 1.5, ncond)):
        xj, _ = jsample_full(cfg, params, dcfg, key,
                             {"labels": jnp.asarray(cond["labels"])}, 2,
                             guidance_scale=gs,
                             null_cond=None if nc is None else
                             {"labels": jnp.asarray(nc["labels"])})
        xp = sample_full(pcfg, tp, pdcfg,
                         {"labels": torch.from_numpy(cond["labels"])}, 2,
                         noise=noise, guidance_scale=gs,
                         null_cond=None if nc is None else
                         {"labels": torch.from_numpy(nc["labels"])},
                         device="cpu")
        np.testing.assert_allclose(xp.numpy(), np.asarray(xj), **TOL)
        outs[name] = xp
    xc = sample_full(pcfg, tp, pdcfg, {"labels": torch.tensor([4, 2])}, 2,
                     noise=noise, device="cpu")
    x1 = sample_full(pcfg, tp, pdcfg, {"labels": torch.tensor([4, 2])}, 2,
                     noise=noise, guidance_scale=1.0, device="cpu")
    np.testing.assert_allclose(x1.numpy(), xc.numpy(), **TOL)
    assert (outs["g"] - xc).abs().max() > 1e-3


def test_guidance_scale_one_matches_unguided(both):
    """``u + 1·(c − u) = c`` up to rounding: the s = 1 guided sampler
    follows the cond-only trajectory."""
    _, (pcfg, pdcfg, tp) = both
    _, pscfg = _scfgs(tau0=0.4, max_draft=8)
    noise = torch.from_numpy(np.random.default_rng(23).normal(
        size=(2, pdcfg.latent_size, pdcfg.latent_size, pcfg.in_channels))
        .astype(np.float32))
    cond = {"labels": torch.tensor([2, 6])}
    x1, s1 = speca_sample(pcfg, tp, pdcfg, pscfg, cond, 2, noise=noise,
                          guidance_scale=1.0, accept_mode="per_sample",
                          device="cpu")
    x0, s0 = speca_sample(pcfg, tp, pdcfg, pscfg, cond, 2, noise=noise,
                          accept_mode="per_sample", device="cpu")
    assert torch.equal(s1["accept_b"], s0["accept_b"])
    np.testing.assert_allclose(x1.numpy(), x0.numpy(), **TOL)


def _mixed_batch(n_unguided=2, tau0s=(0.3, 0.6)):
    """(reference requests, port requests): guided at s = 4 and at s = 1.5
    with a negative prompt, then unguided requests with distinct τ."""
    def build(Req, Pol, lab):
        reqs = [Req(request_id=0, cond={"labels": lab([1])}, seed=50,
                    policy=Pol(guidance_scale=GS)),
                Req(request_id=1, cond={"labels": lab([2])}, seed=51,
                    policy=Pol(guidance_scale=1.5,
                               negative_cond={"labels": lab([6])}))]
        reqs += [Req(request_id=2 + i, cond={"labels": lab([3 + i])},
                     seed=52 + i, policy=Pol(tau0=tau0s[i]))
                 for i in range(n_unguided)]
        return reqs
    return (build(JRequest, JRequestPolicy, jnp.asarray),
            build(Request, RequestPolicy, torch.tensor))


def _assert_results_equal(jres, pres):
    for a, b in zip(jres, pres):
        assert a.request_id == b.request_id
        assert b.accepts == a.accepts, a.request_id
        assert (b.num_full, b.num_spec, b.num_drafted, b.finish_tick) == \
            (a.num_full, a.num_spec, a.num_drafted, a.finish_tick)
        assert b.flops == a.flops and b.completed
        np.testing.assert_allclose(b.sample.numpy(), np.asarray(a.sample),
                                   **TOL)


def test_mixed_guided_serve_matches_reference(engines):
    """One batch of guided pairs (two scales, a negative prompt) and
    unguided lanes with their own τ: per request the reference engine's
    accepts, counters, flops and samples; lanes 2 keep lanes 4's."""
    je, pe = engines
    jreqs, preqs = _mixed_batch()
    jres = je.serve_batched(jreqs, lanes=4)
    pres = pe.serve_batched(preqs, lanes=4)
    _assert_results_equal(jres, pres)
    # guided flops count both streams
    assert pres[0].flops == 2 * (pres[0].num_full * pe.workload.full_flops
                                 + pres[0].num_drafted
                                 * pe.workload.verify_flops)
    # not vacuous: each guided request accepted a draft and had one
    # rejected (a drafted step that was not accepted)
    for r in pres[:2]:
        assert 0 < r.num_spec < r.num_drafted, r.request_id
    narrow = pe.serve_batched(preqs, lanes=2)
    for a, b in zip(pres, narrow):
        assert (a.accepts, a.num_full, a.num_spec, a.num_drafted,
                a.flops) == (b.accepts, b.num_full, b.num_spec,
                             b.num_drafted, b.flops)
        np.testing.assert_allclose(a.sample.numpy(), b.sample.numpy(),
                                   **TOL)


def test_unguided_requests_keep_their_trajectory_in_a_paired_session(
        engines):
    """Unpaired lanes of the mixed program run the plain program's math:
    unguided requests served beside guided pairs keep the trajectories
    they have in a plain session."""
    _, pe = engines
    _, preqs = _mixed_batch()
    mixed = pe.serve_batched(preqs, lanes=4)
    plain = pe.serve_batched(preqs[2:], lanes=2)
    for a, b in zip(mixed[2:], plain):
        assert (a.accepts, a.num_full, a.num_spec) == \
            (b.accepts, b.num_full, b.num_spec)
        np.testing.assert_allclose(a.sample.numpy(), b.sample.numpy(),
                                   **TOL)


def test_guided_width_rule_and_backfill(both, engines):
    """The width rounds up to whole pairs as soon as any request is
    guided; a guided request waiting for a pair never blocks an unguided
    one behind it, and two requests that both fit keep their order."""
    (_, (pcfg, pdcfg, tp)) = both
    _, pe = engines
    un, gd = RequestPolicy(), RequestPolicy(guidance_scale=2.0)
    assert pe._width_for(4, [un, un, un]) == 3
    assert pe._width_for(3, [gd, un]) == 4          # odd rounds up
    assert pe._width_for(1, [gd]) == 2              # one pair minimum
    assert pe._width_for(8, [gd, gd]) == 4          # clamp to 2 × 2 lanes
    legacy = SpeCaEngine(pcfg, tp, pdcfg, pe.workload.scfg, guidance=True,
                         device="cpu")
    assert legacy.lane_width(1, 1) == 2 and legacy.lane_width(3, 100) == 4
    assert legacy.lane_width(8, 2) == 4
    assert legacy.resolve_policy(Request(request_id=0, cond={})) \
        .guidance_scale == pdcfg.guidance_scale
    # the legacy per-request field wins over the policy's scale
    assert pe.resolve_policy(Request(
        request_id=0, cond={}, guidance_scale=3.0,
        policy=RequestPolicy(guidance_scale=1.5))).guidance_scale == 3.0
    # one pair slot: an unguided request holds lane 0 while a guided one
    # waits for the whole pair; the unguided request queued behind it
    # takes the free lane (backfill), and both finish before the guided
    # one starts
    S = pdcfg.num_inference_steps
    reqs = [Request(request_id=0, cond={"labels": torch.tensor([1])},
                    seed=60, policy=RequestPolicy(max_steps=S // 2)),
            Request(request_id=1, cond={"labels": torch.tensor([2])},
                    seed=61, policy=RequestPolicy(guidance_scale=2.0)),
            Request(request_id=2, cond={"labels": torch.tensor([3])},
                    seed=62, policy=RequestPolicy(max_steps=S // 2))]
    res = pe.serve_batched(reqs, lanes=2)
    assert [r.completed for r in res] == [True] * 3
    assert res[0].finish_tick == res[2].finish_tick == S // 2
    assert res[1].finish_tick == S // 2 + S


@pytest.mark.parametrize("seed", [0, 1])
def test_guided_pair_coherence(chain_steps, seed):
    """From a random pair-coherent state every flag and every
    pair-shared state entry stays pair-equal after a guided step, at
    depth 1 and in a chain (as ``test_pair_coherence_property``)."""
    wl = chain_steps[0]
    rng = np.random.default_rng(seed)
    pair = lambda v: np.repeat(v, 2)                       # noqa: E731
    st = PLS.init_workload_state(wl, W, {"labels": torch.tensor([0])},
                                 guidance=True)
    st["x"] = torch.from_numpy(np.repeat(rng.normal(
        size=(W // 2,) + tuple(st["x"].shape[1:])), 2, axis=0)
        .astype(np.float32))
    st["cond"] = {"labels": torch.from_numpy(rng.integers(
        0, wl.cfg.num_classes + 1, size=W))}
    st["diffs"] = torch.from_numpy(0.1 * rng.normal(
        size=tuple(st["diffs"].shape)).astype(np.float32))
    st["active"] = torch.from_numpy(pair(rng.random(W // 2) < 0.8))
    st["n_anchors"] = torch.from_numpy(pair(rng.integers(2, 6, W // 2))
                                       .astype(np.int32))
    st["since"] = torch.from_numpy(pair(rng.integers(0, 4, W // 2))
                                   .astype(np.int32))
    st["step"] = torch.from_numpy(pair(rng.integers(0, 15, W // 2))
                                  .astype(np.int32))
    st["anchor_step"] = torch.clamp(st["step"] - 1 - st["since"], min=-1)
    st["gscale"] = torch.from_numpy(pair(rng.uniform(0.0, 8.0, W // 2))
                                    .astype(np.float32))
    for depth in (1, K):
        step = PLS.build_workload_step(wl, lanes=W, guidance=True,
                                       max_draft_depth=depth)
        st["draft_k"] = torch.full((W,), depth, dtype=torch.int32)
        new, flags = step(dict(st))
        for k in ("attempted", "ok", "accepted", "full", "tau", "n_spec",
                  "n_drafted", "advanced"):
            assert torch.equal(flags[k][0::2], flags[k][1::2]), (depth, k)
        assert torch.equal(flags["err"][0::2].isnan(),
                           flags["err"][1::2].isnan())
        for k in ("since", "step", "n_anchors", "anchor_step", "gap", "x"):
            assert torch.equal(new[k][0::2], new[k][1::2]), (depth, k)


def _guided_reference_state(cfg, dcfg, params, jscfg):
    """A warmed guided 4-lane state of the reference: two pairs at
    scales 4 and 1.5, the second stream of pair 1 a negative prompt."""
    legacy = jax.jit(JLS.build_lane_step(cfg, params, dcfg, jscfg, lanes=W,
                                         guidance="mixed"))
    rng = np.random.default_rng(8)
    js = JLS.init_lane_state(cfg, dcfg, jscfg, W,
                             {"labels": jnp.asarray([0])}, active=True,
                             guidance="mixed")
    x = rng.normal(size=(W // 2,) + tuple(js["x"].shape[1:]))
    js["x"] = jnp.asarray(np.repeat(x, 2, axis=0), jnp.float32)
    js["cond"] = {"labels": jnp.asarray([1, cfg.num_classes, 2, 6])}
    js["tau0"] = jnp.asarray([1e12, 1e12, 0.3, 0.3], jnp.float32)
    js["gscale"] = jnp.asarray([GS, GS, 1.5, 1.5], jnp.float32)
    js["paired"] = jnp.ones((W,), bool)
    js["draft_k"] = jnp.asarray([3, 3, 2, 2], jnp.int32)
    for _ in range(ORDER + 2):
        js, _ = legacy(js)
    return js


def test_guided_chain_tick_matches_reference(both, chain_steps):
    """One guided K=3 chain tick (mixed program, both slots paired) from
    the same warmed state: the reference's counters and chain decisions,
    latents within 1e-5, chain errors within rtol 1e-4."""
    (cfg, dcfg, params), _ = both
    wl = chain_steps[0]
    jscfg = JSpeCaConfig(taylor_order=ORDER, max_draft=6, tau0=0.5,
                         beta=0.9)
    js = _guided_reference_state(cfg, dcfg, params, jscfg)
    jchain = jax.jit(JLS.build_lane_step(cfg, params, dcfg, jscfg, lanes=W,
                                         guidance="mixed",
                                         max_draft_depth=K))
    jnew, jf = jax.tree_util.tree_map(np.asarray, jchain(js))
    chain = PLS.build_workload_step(wl, lanes=W, guidance="mixed",
                                    max_draft_depth=K)
    pnew, pf = chain(_to_port_state(js))
    for k in ("n_spec", "n_drafted", "advanced", "full", "chain_accepted",
              "chain_attempted"):
        np.testing.assert_array_equal(pf[k].numpy(), jf[k], k)
    np.testing.assert_allclose(pnew["x"].numpy(), jnew["x"], **TOL)
    for k in ("step", "since", "n_anchors", "anchor_step"):
        np.testing.assert_array_equal(pnew[k].numpy(), jnew[k], k)
    ej, ep = jf["chain_err"], pf["chain_err"].numpy()
    np.testing.assert_array_equal(np.isnan(ep), np.isnan(ej))
    drafted = np.isfinite(ej)
    np.testing.assert_allclose(ep[drafted], ej[drafted], rtol=1e-4)
    assert jf["n_spec"].sum() > 0 and jf["full"].any()


def test_guided_deep_serve_matches_reference(engines, deep_engines):
    """Guided requests at draft depths 3 and 1 beside an unguided
    depth-3 one on max_draft_depth=3 engines: the reference's Results;
    in both packages the depth-1 trajectories, in fewer ticks."""
    je, pe = deep_engines["taylor", 3]
    jreqs, preqs = _mixed_batch(n_unguided=1)
    shallow = [e.serve_batched(r, lanes=4)
               for e, r in zip(engines, (jreqs, preqs))]
    for reqs in (jreqs, preqs):
        for r, d in zip(reqs, (3, 1, 3)):
            r.policy = dataclasses.replace(r.policy, draft_depth=d)
    jres = je.serve_batched(jreqs, lanes=4)
    pres = pe.serve_batched(preqs, lanes=4)
    _assert_results_equal(jres, pres)
    assert sum(r.num_spec for r in pres) > 0
    assert sum(r.num_full for r in pres) > 0
    # the depth-3 guided request accepted chain positions and had one
    # rejected, so its rollback restored an earlier snapshot
    assert 0 < pres[0].num_spec < pres[0].num_drafted
    for deep, flat in zip((jres, pres), shallow):
        for a, b in zip(deep, flat):
            assert (a.accepts, a.num_full, a.num_spec) == \
                (b.accepts, b.num_full, b.num_spec), a.request_id
        assert sum(r.finish_tick for r in deep) < sum(r.finish_tick
                                                      for r in flat)


# ---------------------------------------------------------------------------
# The closed-loop controller (analogues of tests/test_controller_properties.py
# and the engine's controller path) against the reference
# ---------------------------------------------------------------------------

def _controller_batch(guided=False):
    """(reference requests, port requests): a controller-free request,
    then the accept SLO at its defaults, a target that backs off, a
    deadline lane allowed above its base τ and an order-1 cap; with
    ``guided`` the accept-SLO request is a guided pair."""
    def build(Req, Pol, Ctl, lab):
        ctls = [None, Ctl(), Ctl(target_accept=0.9),
                Ctl(slo="deadline", deadline_ticks=10, tau_max=0.8),
                Ctl(order_max=1)]
        return [Req(request_id=i, cond={"labels": lab([i + 1])},
                    seed=30 + i,
                    policy=Pol(controller=c,
                               guidance_scale=GS if guided and i == 1
                               else None))
                for i, c in enumerate(ctls)]
    return (build(JRequest, JRequestPolicy, JCT.ControllerPolicy,
                  jnp.asarray),
            build(Request, RequestPolicy, ControllerPolicy, torch.tensor))


CONTROLLER_CASES = [("taylor", 1, False), ("taylor", 3, True),
                    ("spectral", 3, False)]


@pytest.fixture(scope="module")
def controller_engines(both, engines):
    (cfg, dcfg, params), (pcfg, pdcfg, tp) = both
    jscfg, pscfg = _scfgs(tau0=0.4, max_draft=8)
    _, pe = engines
    return {(fc, kmax): (
        JEngine(cfg, params, dcfg, jscfg, max_draft_depth=kmax,
                forecaster=fc, controller=True),
        SpeCaEngine(pcfg, tp, pdcfg, pscfg, noise_fn=pe.workload.noise_fn,
                    max_draft_depth=kmax, forecaster=fc, controller=True,
                    device="cpu"))
        for fc, kmax, _ in CONTROLLER_CASES}


@pytest.mark.parametrize("fc, kmax, guided", CONTROLLER_CASES)
def test_controller_serve_matches_reference(controller_engines, engines, fc,
                                            kmax, guided):
    """Controlled and controller-free requests in one batch on
    ``SpeCaEngine(controller=True)``: per request the reference engine's
    accepts, counters, finish ticks, flops and samples, at depth 1 and in
    chains, Taylor and spectral, with a guided pair under a controller."""
    je, pe = controller_engines[fc, kmax]
    jreqs, preqs = _controller_batch(guided)
    jres = je.serve_batched(jreqs, lanes=4)
    pres = pe.serve_batched(preqs, lanes=4)
    _assert_results_equal(jres, pres)
    assert sum(r.num_spec for r in pres) > 0
    assert sum(r.num_full for r in pres) > 0
    if kmax > 1:
        # a controlled lane's draft_k left 1: it drafted past a rejection-
        # free tick's single position, finishing in fewer ticks
        assert any(r.timings.service_ticks < r.num_full + r.num_spec
                   for r in pres[1:])
    if fc == "taylor" and kmax == 1:
        # the controller changed something: the static engine serves the
        # controlled requests' twins differently
        _, plain = engines
        static = plain.serve_batched(
            [dataclasses.replace(r, policy=RequestPolicy()) for r in preqs],
            lanes=4)
        assert static[0].accepts == pres[0].accepts
        assert any(a.accepts != b.accepts
                   for a, b in zip(static[1:], pres[1:]))


def test_controller_off_lanes_bitwise_inert(both, controller_engines):
    """As ``test_mixed_batch_controller_off_bitwise_inert``: at the same
    width, request 0 served beside a controller-free twin and beside a
    controlled request keeps its sample, accepts and counters bit for bit,
    while the controlled neighbour really adapts."""
    _, pe = controller_engines["taylor", 3]
    cpol = RequestPolicy(controller=ControllerPolicy(
        target_accept=0.5, gain=0.5, ema=0.5))

    def run(second):
        return pe.serve_batched(
            [Request(request_id=0, cond={"labels": torch.tensor([3])},
                     seed=7),
             Request(request_id=1, cond={"labels": torch.tensor([5])},
                     seed=8, policy=second)], lanes=2)

    a, b = run(RequestPolicy()), run(cpol)
    assert torch.equal(a[0].sample, b[0].sample)
    assert (a[0].accepts, a[0].num_full, a[0].num_spec, a[0].num_drafted,
            a[0].flops) == (b[0].accepts, b[0].num_full, b[0].num_spec,
                            b[0].num_drafted, b[0].flops)
    assert (b[1].finish_tick < a[1].finish_tick
            or b[1].num_drafted != a[1].num_drafted
            or b[1].accepts != a[1].accepts)
    assert all(r.completed for r in a + b)


def test_controller_free_engine_builds_todays_step(both, engines):
    """``controller=False`` builds no ``ctl_*`` state; a controller engine
    serving only controller-free requests gives the controller-free
    engine's Results bitwise with the same host syncs; a
    ``ControllerPolicy`` on a controller-free engine is rejected."""
    _, (pcfg, pdcfg, tp) = both
    _, pe = engines
    reqs = _port_reqs(3)
    syncs = pe.host_syncs
    ref = pe.serve_batched(reqs, lanes=2)
    syncs = pe.host_syncs - syncs
    ctl = SpeCaEngine(pcfg, tp, pdcfg, pe.workload.scfg,
                      noise_fn=pe.workload.noise_fn, controller=True,
                      device="cpu")
    got = ctl.serve_batched(reqs, lanes=2)
    assert ctl.host_syncs == syncs
    for a, b in zip(ref, got):
        assert (a.accepts, a.num_full, a.num_spec, a.flops) == \
            (b.accepts, b.num_full, b.num_spec, b.flops)
        assert torch.equal(a.sample, b.sample)
    st = PLS.init_workload_state(pe.workload, 2, {"labels": torch.tensor([0])})
    assert not any(k.startswith("ctl_") for k in st)
    with pytest.raises(ValueError, match="controller=True"):
        pe.resolve_policy(Request(request_id=0, cond={}, policy=RequestPolicy(
            controller=ControllerPolicy())))
    with pytest.raises(TypeError, match="ControllerPolicy"):
        ctl.resolve_policy(Request(request_id=0, cond={}, policy=RequestPolicy(
            controller={"slo": "accept"})))


def test_guided_pair_controller_state_stays_pair_equal(controller_engines):
    """A guided pair's two lanes see equal counters, so their controller
    state stays pair-equal tick after tick."""
    _, pe = controller_engines["taylor", 3]
    t = pe.submit(Request(request_id=0, cond={"labels": torch.tensor([2])},
                          seed=5, policy=RequestPolicy(
                              guidance_scale=GS,
                              controller=ControllerPolicy(ema=0.5))))
    st0 = None
    for _ in range(8):
        pe.tick()
        st = pe._sessions["diffusion"].state
        for k in CT.CONTROLLER_KEYS + ("tau0", "draft_k"):
            assert torch.equal(st[k][0], st[k][1]), k
        st0 = st0 or {k: st[k][0].clone() for k in ("tau0", "draft_k")}
    assert any(not torch.equal(st[k][0], st0[k]) for k in st0)
    assert pe.result(t).completed
    pe.shutdown()


# ---------------------------------------------------------------------------
# The serving lifecycle (analogues of tests/test_serving_lifecycle.py and
# tests/test_serving_v2.py) against the reference, ticket by ticket
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def life_engines(both, engines):
    """(reference, port) lifecycle engines at lanes 2: one pair slot."""
    (cfg, dcfg, params), (pcfg, pdcfg, tp) = both
    jscfg, pscfg = _scfgs(tau0=0.4, max_draft=8)
    _, pe = engines
    return (JEngine(cfg, params, dcfg, jscfg, lanes=2),
            SpeCaEngine(pcfg, tp, pdcfg, pscfg, noise_fn=pe.workload.noise_fn,
                        lanes=2, device="cpu"))


def _life_reqs(n, guided=(), **pol):
    def build(Req, Pol, lab):
        return [Req(request_id=i, cond={"labels": lab([i % 8])},
                    seed=100 + i,
                    policy=Pol(guidance_scale=3.0 if i in guided else None,
                               **pol))
                for i in range(n)]
    return (build(JRequest, JRequestPolicy, jnp.asarray),
            build(Request, RequestPolicy, torch.tensor))


def _both_do(engines, fn):
    """``fn(engine, package index)`` on the reference, then the port."""
    return [fn(e, i) for i, e in enumerate(engines)]


def _assert_life_results_equal(jres, pres):
    for a, b in zip(jres, pres):
        assert (a.ticket_id, a.request_id, a.completed) == \
            (b.ticket_id, b.request_id, b.completed)
        assert b.accepts == a.accepts, a.ticket_id
        assert (b.num_full, b.num_spec, b.num_drafted, b.finish_tick,
                b.flops, b.deadline, b.tenant) == \
            (a.num_full, a.num_spec, a.num_drafted, a.finish_tick, a.flops,
             a.deadline, a.tenant)
        if a.sample is None:
            assert b.sample is None
        else:
            np.testing.assert_allclose(b.sample.numpy(),
                                       np.asarray(a.sample), **TOL)
        if a.timings is not None:
            assert (b.timings.submit_tick, b.timings.admit_tick,
                    b.timings.finish_tick) == \
                (a.timings.submit_tick, a.timings.admit_tick,
                 a.timings.finish_tick)


def test_lifecycle_status_walk_and_results_match_reference(life_engines):
    """queued → running → done → released, per ticket in both packages,
    with one guided request among them; Results equal the reference's."""
    reqs = _life_reqs(3, guided=(1,))
    tickets = _both_do(life_engines, lambda e, i: [e.submit(r)
                                                   for r in reqs[i]])
    stat = lambda: [[e.status(t) for t in ts]              # noqa: E731
                    for e, ts in zip(life_engines, tickets)]
    assert stat() == [["queued"] * 3] * 2
    for e in life_engines:
        assert e.poll(0) is None and e.pending() == 3
        e.tick()
    # the guided request waits for the whole pair; request 2 backfills
    assert stat()[0] == stat()[1] == ["running", "queued", "running"]
    res = _both_do(life_engines, lambda e, i: e.results(tickets[i]))
    _assert_life_results_equal(*res)
    assert stat() == [["done"] * 3] * 2
    for e, ts in zip(life_engines, tickets):
        e.release(ts[0])
        assert e.status(ts[0]) == "released" and e.poll(ts[0]) is None
        assert e.status(987654) == "unknown"
        with pytest.raises(KeyError):
            e.release(ts[0])
        with pytest.raises(KeyError):
            e.result(987654)
        e.shutdown()


def test_lifecycle_shutdown_reports_dropped_and_resubmits(life_engines):
    """Shutdown after two ticks: the in-flight request comes back partial
    and the queued ones never started, all "dropped", as in the
    reference; a later submit serves on a fresh session."""
    reqs = _life_reqs(4)
    tickets = _both_do(life_engines, lambda e, i: [e.submit(r)
                                                   for r in reqs[i]])
    for e in life_engines:
        e.tick(2)
    drained = _both_do(life_engines, lambda e, i: sorted(
        e.shutdown(), key=lambda r: r.ticket_id))
    _assert_life_results_equal(*drained)
    pres = drained[1]
    assert sum(r.finish_tick is not None for r in pres) == 2
    assert all(not r.completed for r in pres)
    for e, ts in zip(life_engines, tickets):
        assert [e.status(t) for t in ts] == ["dropped"] * 4
        e.release(*ts)
    again = _both_do(life_engines, lambda e, i: e.result(
        e.submit(reqs[i][0])))
    _assert_life_results_equal(*[[r] for r in again])
    assert again[1].completed
    for e in life_engines:
        e.shutdown()


def test_lifecycle_rejected_submit_leaves_no_trace(life_engines):
    """A draft depth beyond the engine, a non-positive WFQ weight, a
    controller on a controller-free engine and a controller that is no
    ``ControllerPolicy`` raise at submit — as in the reference — and leave
    no session, ticket or queue entry behind."""
    pe = life_engines[1]
    pe.shutdown()
    seq = pe._seq
    bad = [(ValueError, "draft_depth", RequestPolicy(draft_depth=3)),
           (ValueError, "weight", RequestPolicy(weight=0.0)),
           (ValueError, "controller=True",
            RequestPolicy(controller=ControllerPolicy())),
           (TypeError, "ControllerPolicy",
            RequestPolicy(controller="accept"))]
    jbad = [JRequestPolicy(draft_depth=3), JRequestPolicy(weight=0.0),
            JRequestPolicy(controller=JCT.ControllerPolicy()),
            JRequestPolicy(controller="accept")]
    for (exc, match, pol), jpol in zip(bad, jbad):
        with pytest.raises(exc, match=match.split("=")[0]):
            life_engines[0].submit(JRequest(request_id=0, cond={}),
                                   policy=jpol)
        with pytest.raises(exc, match=match):
            pe.submit(Request(request_id=0, cond={}), policy=pol)
        assert not pe._sessions and pe.pending() == 0
        assert pe._seq == seq
    assert set(pe._ticket_status) <= set(range(seq))


def test_lifecycle_stream_previews_and_bitwise_finals(both, life_engines):
    """``stream(previews=True)``: progressive snapshots of each running
    request, final Results bitwise a preview-free run's and equal to the
    reference's stream; an injected submit is admitted mid-stream."""
    reqs = _life_reqs(3, guided=(1,))
    streamed, previews = [], {}
    for i, e in enumerate(life_engines):
        for r in reqs[i][:2]:
            e.submit(r)
        out, injected = [], False
        for item in e.stream(previews=True):
            if isinstance(item, (JPreview, Preview)):
                previews.setdefault(i, []).append(
                    (item.ticket_id, item.step))
                continue
            out.append(item)
            if not injected:
                e.submit(reqs[i][2])
                injected = True
        assert len(out) == 3
        streamed.append(out)
    _assert_life_results_equal(*streamed)
    assert previews[0] == previews[1]
    pe = life_engines[1]
    tids = [r.ticket_id for r in streamed[1]]
    assert {t for t, _ in previews[1]} == set(tids)
    for tid in tids:
        steps = [s for t, s in previews[1] if t == tid]
        assert steps == sorted(set(steps))
        assert steps[-1] < pe.workload.num_steps
    for e in life_engines:
        e.shutdown()
    # bitwise against a preview-free run on a fresh port engine
    _, (pcfg, pdcfg, tp) = both
    fresh = SpeCaEngine(pcfg, tp, pdcfg, pe.workload.scfg,
                        noise_fn=pe.workload.noise_fn, lanes=2, device="cpu")
    plain = fresh.results([fresh.submit(r) for r in reqs[1][:2]])
    for a, b in zip(streamed[1][:2], plain):
        assert a.accepts == b.accepts and torch.equal(a.sample, b.sample)


def test_lifecycle_release_mid_stream_timeout_and_queue_full(life_engines):
    """A release mid-stream keeps the cursor valid (and a fresh stream
    over the list skips it), ``result(max_ticks=)`` raises
    ``TimeoutError`` and leaves the request running, and a bounded queue
    raises ``QueueFull`` until a tick admits its head — ticket for ticket
    as in the reference."""
    reqs = _life_reqs(3)
    seen = []
    for i, e in enumerate(life_engines):
        ts = [e.submit(r) for r in reqs[i]]
        gen = e.stream(ts)
        first = next(gen)
        e.release(first.ticket_id)
        rest = [r.ticket_id for r in gen]
        assert first.ticket_id not in rest and len(rest) == 2
        assert [r.ticket_id for r in e.stream(ts)] == rest
        t = e.submit(reqs[i][0])
        with pytest.raises(TimeoutError):
            e.result(t, max_ticks=3)
        assert e.status(t) == "running"
        res = e.result(t)
        assert e.result(t, max_ticks=0) is res
        e.max_queue = 2
        e.submit(reqs[i][0])
        e.submit(reqs[i][1])
        full = (JQueueFull, QueueFull)[i]
        with pytest.raises(full):
            e.submit(reqs[i][2])
        e.tick()
        e.submit(reqs[i][2])
        e.max_queue = None
        seen.append([res] + [r for r in e.stream()])
        e.shutdown()
    _assert_life_results_equal(*seen)
    assert len(seen[1]) == 4


def _length_workload(S):
    """One long request in front of two short ones with deadlines: FIFO
    serves the long one first."""
    def build(Req, Pol, lab):
        return [Req(request_id=0, cond={"labels": lab([0])}, seed=90)] + [
            Req(request_id=1 + i, cond={"labels": lab([1 + i])},
                seed=91 + i, policy=Pol(max_steps=max(S // 4, 1),
                                        deadline=float((i + 1) * S)))
            for i in range(2)]
    return (build(JRequest, JRequestPolicy, jnp.asarray),
            build(Request, RequestPolicy, torch.tensor))


def test_sjf_and_edf_against_fifo_match_reference(both, engines):
    """On one slot, SJF lowers the mean completion tick and EDF meets
    every deadline where FIFO misses, with the reference's Results per
    scheduler; scheduling never changes a request's trajectory."""
    (_, dcfg, _), _ = both
    S = dcfg.num_inference_steps
    jreqs, preqs = _length_workload(S)
    out = {}
    for name in ("fifo", "sjf", "edf"):
        jres = engines[0].serve_batched(jreqs, lanes=1, scheduler=name)
        pres = engines[1].serve_batched(preqs, lanes=1, scheduler=name)
        _assert_life_results_equal(jres, pres)
        out[name] = pres
    mean = {k: np.mean([r.finish_tick for r in v]) for k, v in out.items()}
    hit = {k: np.mean([bool(r.deadline_met) for r in v
                       if r.deadline is not None]) for k, v in out.items()}
    assert mean["sjf"] < mean["fifo"]
    assert hit["edf"] > hit["fifo"] and hit["edf"] == 1.0
    for name in ("sjf", "edf"):
        for a, b in zip(out["fifo"], out[name]):
            assert a.accepts == b.accepts


def test_serve_batched_never_drains_the_lifecycle_queue(both, engines):
    _, (pcfg, pdcfg, tp) = both
    _, pe = engines
    from repro_torch.serving import SJFScheduler
    life = SpeCaEngine(pcfg, tp, pdcfg, pe.workload.scfg,
                       noise_fn=pe.workload.noise_fn,
                       scheduler=SJFScheduler(), lanes=2, device="cpu")
    t = life.submit(Request(request_id=7, cond={"labels": torch.tensor([1])},
                            seed=77))
    got = life.serve_batched([Request(request_id=8, cond={
        "labels": torch.tensor([2])}, seed=88)], lanes=1)
    assert [r.request_id for r in got] == [8]
    assert life.status(t) == "queued" and life.pending() == 1
    life.shutdown()


def test_lifecycle_timings_on_fake_clocks_match_reference(life_engines):
    """With a scripted clock (one second a read) the port reads the clock
    where the reference does: every ``Timings`` field and ``wall_s``
    equal the reference's, and the lifecycle order holds."""
    from repro.obs import FakeClock as JFakeClock
    from repro_torch.obs import FakeClock, resolve_clock
    reqs = _life_reqs(3, guided=(1,))
    clocks = (JFakeClock(auto_tick=1.0), FakeClock(auto_tick=1.0))
    out = []
    for i, (e, clock) in enumerate(zip(life_engines, clocks)):
        saved, e.clock = e.clock, clock
        try:
            out.append(e.results([e.submit(r) for r in reqs[i]]))
        finally:
            e.clock = saved
            e.shutdown()
    _assert_life_results_equal(*out)
    for a, b in zip(*out):
        assert b.timings == port_record(type(b.timings), a.timings)
        assert b.wall_s == a.wall_s
        t = b.timings
        assert t.submit_s < t.admit_s <= t.first_tick_s < t.finish_s
    assert clocks[1].reads == clocks[0].reads
    with pytest.raises(TypeError, match="now"):
        resolve_clock(object())
    with pytest.raises(ValueError, match="backwards"):
        FakeClock().advance(-1.0)


# ---------------------------------------------------------------------------
# Observability (analogues of the engine half of tests/test_obs.py) against
# the reference, and obs on against obs off
# ---------------------------------------------------------------------------

OBS_CASES = ("depth1", "chain_controller", "mixed")


def _obs_reqs(case, n=4, first=0):
    """(reference requests, port requests) of one observability case: at
    depth 1 (tenants alternate); at depth 3 with one request under a
    ``ControllerPolicy``; or with guided request 1 beside unguided
    ones."""
    def build(Req, Pol, Ctl, lab):
        out = []
        for i in range(first, first + n):
            kw = {"tenant": "gold" if i % 2 else "default"}
            if case == "chain_controller":
                kw["draft_depth"] = 3 if i % 2 == 0 else 2
                kw["controller"] = Ctl(ema=0.5) if i == 1 else None
            if case == "mixed" and i == 1:
                kw["guidance_scale"] = 3.0
            out.append(Req(request_id=i, cond={"labels": lab([i % 8])},
                           seed=200 + i, policy=Pol(**kw)))
        return out
    return (build(JRequest, JRequestPolicy, JCT.ControllerPolicy,
                  jnp.asarray),
            build(Request, RequestPolicy, ControllerPolicy, torch.tensor))


def _obs_engine_kw(case):
    return dict(lanes=2, max_draft_depth=3 if case == "chain_controller"
                else 1, controller=case == "chain_controller")


def _port_obs_engine(both, engines, case, **kw):
    _, (pcfg, pdcfg, tp) = both
    _, pe = engines
    return SpeCaEngine(pcfg, tp, pdcfg, pe.workload.scfg,
                       noise_fn=pe.workload.noise_fn, device="cpu",
                       **_obs_engine_kw(case), **kw)


def _drive_life(engine, reqs):
    """submit, then tick and release to idle; Results in request order."""
    tickets = [engine.submit(r) for r in reqs]
    out = {}
    while engine.pending() or engine.in_flight():
        for res in engine.tick():
            out[res.ticket_id] = res
            engine.release(res.ticket_id)
    return tickets, [out[t.ticket_id] for t in tickets]


@pytest.mark.parametrize("case", OBS_CASES)
def test_obs_on_is_bitwise_inert(both, engines, case, monkeypatch):
    """An ``obs=True`` engine serves bitwise what an ``obs=False`` one
    serves — samples, accepts, every counter — with the same host syncs
    and the same number of ``_Session._fetch`` reads and ``emit`` calls,
    at depth 1, at K=3 under the controller and with a guided pair; its
    lane totals agree with the Results (a guided pair's flags count on
    both lanes). With obs off no phase span is opened."""
    from repro_torch.serving import engine as PE
    _, preqs = _obs_reqs(case)
    fetch, emit, push = PE._Session._fetch, PE._Session.emit, \
        PhaseRecorder._push
    out = {}
    for obs in (False, True):
        n = [0, 0, 0]

        def counted(sess, t, n=n):
            n[0] += 1
            return fetch(sess, t)

        def emitted(sess, lane, done, n=n):
            n[1] += 1
            return emit(sess, lane, done)

        def pushed(rec, *a, n=n):
            n[2] += 1
            return push(rec, *a)
        monkeypatch.setattr(PE._Session, "_fetch", counted)
        monkeypatch.setattr(PE._Session, "emit", emitted)
        monkeypatch.setattr(PhaseRecorder, "_push", pushed)
        eng = _port_obs_engine(both, engines, case, obs=obs)
        _, res = _drive_life(eng, preqs)
        out[obs] = (eng, res, eng.host_syncs, n)
        monkeypatch.setattr(PE._Session, "_fetch", fetch)
        monkeypatch.setattr(PE._Session, "emit", emit)
        monkeypatch.setattr(PhaseRecorder, "_push", push)
    (off, roff, soff, noff), (on, ron, son, non) = out[False], out[True]
    assert son == soff and non[:2] == noff[:2] and min(noff[:2]) > 0
    assert noff[2] == 0 and non[2] > 0
    assert off._phases is None and all(
        st.phases is None for st in off._lane_fns.values())
    for a, b in zip(roff, ron):
        assert torch.equal(a.sample, b.sample), a.request_id
        assert (a.accepts, a.num_full, a.num_spec, a.num_drafted,
                a.finish_tick, a.flops) == \
            (b.accepts, b.num_full, b.num_spec, b.num_drafted,
             b.finish_tick, b.flops)
    assert sum(r.num_spec for r in ron) > 0
    assert off.obs is None and isinstance(on.obs, Observability)
    streams = [1 + (p.guidance_scale is not None)
               for p in (r.policy for r in preqs)]
    snap = {(r["name"], tuple(sorted(r["labels"].items()))): r
            for r in on.metrics_snapshot()}
    lab = (("workload", "diffusion"),)
    for key, attr in (("n_spec", "num_spec"), ("n_drafted", "num_drafted"),
                      ("full", "num_full")):
        assert snap[f"speca_{key}_total", lab]["value"] == sum(
            getattr(r, attr) * k for r, k in zip(ron, streams)), key
    # one queue-depth point and one accumulator update per engine tick
    assert snap["speca_obs_ticks_total", lab]["value"] == on._tick_count \
        == len(on.obs.metrics.series("speca_queue_depth")) > 0
    assert snap["speca_chain_err", lab]["count"] > 0
    for eng in (off, on):
        eng.shutdown()
    with pytest.raises(RuntimeError, match="obs=True"):
        off.metrics_snapshot()
    with pytest.raises(RuntimeError, match="obs=True"):
        off.trace(0)


# the span names each phase span may sit under (None: the top)
_PHASE_PARENTS = {
    "tick": {None}, "admit": {"tick"}, "step": {"tick"},
    "obs.accumulate": {"tick"}, "wait.advanced": {"tick"},
    "harvest": {"tick"}, "wait.fill": {"admit"},
    "wait.flags": {"harvest"}, "wait.sample": {"harvest"},
    **{k: {"step"} for k in ("wait.draft", "wait.chain", "wait.full",
                             "wait.tau",
                             "predict", "predict_chain", "verify",
                             "refresh", "rollback", "spec_forward",
                             "full_forward")}}


@pytest.mark.parametrize("case", ["mixed", "chain_controller"])
def test_phase_spans_per_tick(both, engines, case, monkeypatch):
    """On a ``FakeClock`` engine, a mixed paired session at depth 1 and a
    K = 3 chain under the controller record one ``tick`` span an engine
    tick and under it, by name, parent and ticket: an ``admit`` and a
    ``harvest`` per request, one ``step`` with its kernel requests,
    forwards and branch reads, one ``obs.accumulate``. One
    ``full_forward`` span and one forward-counter step per step whose
    ``wait.full`` read came back true; the waits by reason add up to
    ``host_syncs``, ``wait.flags`` to the fetches, ``wait.sample`` to the
    emits; the occupied-lane and step-host-seconds counters to what the
    spans show."""
    from repro_torch.obs import FakeClock
    from repro_torch.serving import engine as PE
    answers, fetched, emits = [], set(), [0]
    any_, fetch, emit = PLS.LaneStep._any, PE._Session._fetch, \
        PE._Session.emit

    def spy_any(step, t):
        answers.append(any_(step, t))
        return answers[-1]

    def spy_fetch(sess, t):
        fetched.add((id(sess), t))
        return fetch(sess, t)

    def spy_emit(sess, lane, done):
        emits[0] += 1
        return emit(sess, lane, done)
    monkeypatch.setattr(PLS.LaneStep, "_any", spy_any)
    monkeypatch.setattr(PE._Session, "_fetch", spy_fetch)
    monkeypatch.setattr(PE._Session, "emit", spy_emit)
    clock = FakeClock(0.0, auto_tick=1.0)
    eng = _port_obs_engine(both, engines, case, obs=True, clock=clock)
    assert eng.obs.clock is clock is eng.clock
    tickets, res = _drive_life(eng, _obs_reqs(case)[1])
    ph = eng.obs.phases
    spans = ph.spans()
    assert ph.dropped == 0 and spans
    by_id = {s.span_id: s for s in spans}
    kids = {}
    for s in spans:
        up = by_id.get(s.parent)
        assert (None if up is None else up.name) in _PHASE_PARENTS[s.name]
        assert s.t0 <= s.t1 and s.tick1 == s.tick0 + 1
        if up is not None:
            assert up.t0 <= s.t0 <= s.t1 <= up.t1 and up.tick0 == s.tick0
            kids.setdefault(up.span_id, []).append(s)
        if s.name != "tick":
            assert s.workload == "diffusion"
        in_request = s.name in ("admit", "harvest") or (
            up is not None and up.name in ("admit", "harvest"))
        assert (s.ticket is not None) == in_request, s.name
    ticks = [s for s in spans if s.name == "tick"]
    assert [s.tick0 for s in ticks] == list(range(eng._tick_count))
    ids = sorted(t.ticket_id for t in tickets)
    for name in ("admit", "harvest"):
        assert sorted(s.ticket for s in spans if s.name == name) == ids
    steps = [s for s in spans if s.name == "step"]
    for name in ("step", "obs.accumulate"):
        assert [s.tick0 for s in spans if s.name == name] == \
            [s.tick0 for s in ticks]
    # the branch reads, in order, against their answers
    reads = [s for s in spans if s.name in ("wait.draft", "wait.chain",
                                            "wait.full")]
    assert len(reads) == len(answers)
    full_true = 0
    for st in steps:
        names = [k.name for k in kids[st.span_id]]
        if case == "mixed":
            assert names.count("wait.draft") == 1
            assert "wait.chain" not in names
        else:
            assert 1 <= names.count("wait.chain") <= 3
        assert names.count("wait.full") == 1
        full = [a for r, a in zip(reads, answers)
                if r.parent == st.span_id and r.name == "wait.full"][0]
        assert names.count("full_forward") == names.count("refresh") \
            == int(full)
        full_true += full
    count = {(r["name"], r.get("labels", {}).get("reason")): r["value"]
             for r in eng.metrics_snapshot() if r["kind"] == "counter"}
    assert count["speca_full_forward_calls_total", None] == full_true > 0
    assert count["speca_spec_forward_calls_total", None] == sum(
        s.name == "spec_forward" for s in spans) > 0

    def waits(reason):
        return count.get(("speca_device_waits_total", reason), 0.0)
    for reason in ("draft", "chain", "full", "advanced", "sample",
                   "flags"):
        assert sum(s.name == f"wait.{reason}" for s in spans) == \
            waits(reason) / (6 if reason == "flags" else 1), reason
    assert waits("draft") + waits("chain") + waits("full") \
        + waits("advanced") == eng.host_syncs
    assert (waits("advanced") > 0) == (case == "chain_controller")
    assert waits("flags") == 6 * len(fetched) > 0
    assert waits("sample") == emits[0] == len(res)
    assert waits("fill") == 0        # the conditioning is on the CPU too
    streams = [1 + (r.policy.guidance_scale is not None)
               for r in _obs_reqs(case)[1]]
    assert count["speca_lanes_occupied_total", None] == sum(
        k * r.timings.service_ticks for k, r in zip(streams, res))
    host = sum(st.t1 - st.t0 - sum(k.t1 - k.t0 for k in kids[st.span_id]
                                   if k.name.startswith("wait."))
               for st in steps)
    assert count["speca_step_host_seconds_total", None] == host > 0
    for s in spans:
        if s.name.startswith("wait."):
            reason = s.name[len("wait."):]
            assert count["speca_wait_seconds_total", reason] == sum(
                x.t1 - x.t0 for x in spans if x.name == s.name)
    eng.shutdown()


def test_phase_fill_writes_and_threshold_count_as_waits_off_the_cpu():
    """A lane fill's writes from the host (numbers, CPU tensors) onto a
    non-CPU state that PyTorch makes as copies run in one ``wait.fill``
    span that counts them; a tensor already on the state's device, a
    one-element host value written over a larger slice (a fill), and any
    write onto a CPU state, is no wait. A move between the host and the
    card is one wait, a read back one on any device. The lane step's
    threshold schedule (β copied from the host) is a ``wait.tau`` off the
    CPU only. (The meta device stands in for a card.)"""
    from repro_torch.obs import FakeClock, MetricsRegistry
    from repro_torch.serving import engine as PE
    reg = MetricsRegistry()
    ph = PhaseRecorder(FakeClock(0.0, auto_tick=1.0), reg)
    copies = PE._FillCopies(ph)
    meta = [torch.zeros(4, device="meta") for _ in range(3)]
    cond = torch.zeros(4, 3, device="meta")
    copies.put(1, [(meta[0], 5), (meta[1], torch.tensor(2.0)),
                   (meta[2], torch.zeros((), device="meta")),
                   (cond, torch.zeros(3)), (cond, 0),
                   (cond, torch.tensor(1.0))])
    cpu = torch.zeros(4)
    copies.put(2, [(cpu, 7), (cpu, torch.tensor(1.0))])
    assert cpu.tolist() == [0.0, 0.0, 1.0, 0.0]
    assert [x.name for x in ph.spans()] == ["wait.fill"]
    assert ph.spans()[0].attrs == (("n", 3),)
    assert copies.to(torch.ones(2), "cpu").device.type == "cpu"
    assert copies.to(torch.ones(2), "meta").device.type == "meta"
    assert copies.item(torch.tensor(3)) == 3
    snap = {(r["name"], r["labels"].get("reason")): r["value"]
            for r in reg.snapshot()}
    assert snap["speca_device_waits_total", "fill"] == 5.0
    assert [x.attrs for x in ph.spans()] == [(("n", n),) for n in (3, 1, 1)]

    class WL:
        scfg = PC.SpeCaConfig()

        def __init__(self, device):
            self.device = torch.device(device)

        def t_frac(self, s):
            return torch.ones(s.shape, device=s.device)
    for dev, waits in (("cpu", 0), ("meta", 1)):
        step = type("T", (), {"wl": WL(dev)})()
        tau = PLS.LaneStep._tau(step, ph, torch.zeros(2, dtype=torch.int32,
                                                      device=dev),
                                torch.ones(2, device=dev))
        assert tau.shape == (2,) and tau.device.type == dev
        assert sum(x.name == "wait.tau" for x in ph.spans()) == waits


def _record_reference_errors(monkeypatch):
    """Every error the reference's accumulators fold in, as numpy."""
    from repro.obs import lane_metrics as JLM
    seen = []
    update = JLM.LaneAccumulator.update

    def spy(acc, flags):
        seen.append(np.asarray(flags["chain_err"] if "chain_err" in flags
                               else flags["err"]).ravel())
        return update(acc, flags)
    monkeypatch.setattr(JLM.LaneAccumulator, "update", spy)
    return seen


def _assert_obs_equal(jobs, pobs, ref_errs):
    """Events, traces, and every metric equal; the ``speca_chain_err``
    buckets equal except where a reference error lies within rtol 1e-4
    (the verify bar) of the edge the two bucket counts disagree at."""
    assert pobs.recorder.events() == jobs.recorder.events()
    assert pobs.recorder.dropped == jobs.recorder.dropped
    jtr, ptr = jobs.recorder.traces(), pobs.recorder.traces()
    assert [t.ticket_id for t in ptr] == [t.ticket_id for t in jtr]
    for a, b in zip(jtr, ptr):
        assert (b.request_id, b.workload, b.tenant, b.completed) == \
            (a.request_id, a.workload, a.tenant, a.completed)
        assert b.timings == port_record(type(b.timings), a.timings)
        assert [(s.name, s.t0, s.t1, s.tick0, s.tick1, s.attrs)
                for s in b.spans] == \
            [(s.name, s.t0, s.t1, s.tick0, s.tick1, s.attrs)
             for s in a.spans]
    # the phase counters are the port's own (no reference counterpart)
    jsnap = jobs.metrics.snapshot()
    psnap = [r for r in pobs.metrics.snapshot()
             if r["name"] not in PHASE_METRICS]
    assert [(r["name"], r["labels"]) for r in psnap] == \
        [(r["name"], r["labels"]) for r in jsnap]
    errs = np.concatenate(ref_errs) if ref_errs else np.zeros(0)
    errs = errs[np.isfinite(errs)]
    for a, b in zip(jsnap, psnap):
        if a["name"] != "speca_chain_err":
            assert b == a, a["name"]
            continue
        assert (b["edges"], b["count"]) == (a["edges"], a["count"])
        assert b["sum"] == pytest.approx(a["sum"], rel=1e-4)
        edges = [0.0] + list(a["edges"]) + [math.inf]
        for i, (ca, cb) in enumerate(zip(a["counts"], b["counts"])):
            if ca != cb:
                near = [e for e in edges[i:i + 2] if 0 < e < math.inf
                        and np.any(np.abs(errs - e) <= 1e-4 * e)]
                assert near, f"chain_err bucket {i}: {ca} != {cb}"
        if a["counts"] == b["counts"]:
            assert (b.get("p50"), b.get("p90"), b.get("p99")) == \
                (a.get("p50"), a.get("p90"), a.get("p99"))


@pytest.mark.parametrize("case", OBS_CASES)
def test_obs_on_fake_clocks_matches_reference(both, engines, case,
                                              monkeypatch):
    """Under ``FakeClock(auto_tick=0.25)`` the port's ``obs=True`` engine
    and the reference's record equal events (compile, submit, admit,
    finish, both kinds of drop), traces with exact span times, and equal
    counters, gauges, histograms and series, across lifecycle serving, a
    mid-flight ``shutdown`` and a one-shot ``serve_batched``; the clocks
    are read equally often. The port's phase spans (no reference
    counterpart) read their bundle's own clock here, two reads a span."""
    from repro.obs import FakeClock as JFakeClock
    from repro_torch.obs import FakeClock
    (cfg, dcfg, params), _ = both
    jscfg, _ = _scfgs(tau0=0.4, max_draft=8)
    ref_errs = _record_reference_errors(monkeypatch)
    clocks = (JFakeClock(100.0, auto_tick=0.25),
              FakeClock(100.0, auto_tick=0.25))
    jeng = JEngine(cfg, params, dcfg, jscfg, obs=True, clock=clocks[0],
                   **_obs_engine_kw(case))
    phase_clock = FakeClock(0.0, auto_tick=0.25)
    peng = _port_obs_engine(both, engines, case,
                            obs=Observability(clock=phase_clock),
                            clock=clocks[1])
    assert peng.clock is clocks[1] and peng.obs.clock is phase_clock
    results = []
    for i, eng in enumerate((jeng, peng)):
        _, res = _drive_life(eng, _obs_reqs(case)[i])
        tickets = [eng.submit(r) for r in _obs_reqs(case, 3, first=4)[i]]
        eng.tick(3)
        drained = eng.shutdown()
        served = eng.serve_batched(_obs_reqs(case, 2, first=7)[i], lanes=2)
        results.append((res, drained, served, [eng.trace(t)
                                               for t in tickets]))
    for a, b in zip(*(r[0] + r[1] + r[2] for r in results)):
        assert (b.accepts, b.num_full, b.num_spec, b.completed) == \
            (a.accepts, a.num_full, a.num_spec, a.completed)
    kinds = [e["kind"] for e in peng.obs.recorder.events()]
    for k in ("compile", "submit", "admit", "finish", "drop"):
        assert k in kinds, k
    assert any(e.get("started") is False
               for e in peng.obs.recorder.events())
    # the queued ticket never started: no trace; the drained one has one
    assert results[1][3].count(None) == results[0][3].count(None) >= 1
    _assert_obs_equal(jeng.obs, peng.obs, ref_errs)
    assert clocks[1].reads == clocks[0].reads
    ph = peng.obs.phases
    assert phase_clock.reads == 2 * (len(ph.spans()) + ph.dropped) > 0
    pq = peng.obs.metrics.series("speca_queue_depth")
    assert pq.points()[0] == (0.0, 4.0)


def test_obs_trace_spans_and_observability_injection(both, engines):
    """A served request's trace: queued, running, and one span per service
    tick inside the running span, with the tick's counters as attrs; a
    caller-built ``Observability`` is adopted with its clock; the
    exporters render the engine's state."""
    from repro_torch.obs import FakeClock
    obs = Observability(clock=FakeClock(5.0, auto_tick=0.5))
    eng = _port_obs_engine(both, engines, "depth1", obs=obs)
    assert eng.obs is obs and eng.clock is obs.clock
    tickets, res = _drive_life(eng, _obs_reqs("depth1", 3)[1])
    for t, r in zip(tickets, res):
        tr = eng.trace(t)
        assert tr.completed and tr.workload == "diffusion"
        assert [s.name for s in tr.spans[:2]] == ["queued", "running"]
        ticks = tr.tick_spans()
        assert len(ticks) == r.timings.service_ticks
        running = tr.spans[1]
        for s in ticks:
            assert running.t0 <= s.t0 <= s.t1 <= running.t1
            assert s.tick1 == s.tick0 + 1
        assert sum(s.attr_dict["full"] for s in ticks) == r.num_full
        assert sum(s.attr_dict["n_spec"] for s in ticks) == r.num_spec
    assert eng.trace(987654) is None
    snap = eng.metrics_snapshot()
    doc = json.loads(json.dumps(obs.chrome_trace()))
    assert len([e for e in doc["traceEvents"] if e["ph"] == "X"]) == sum(
        2 + r.timings.service_ticks for r in res)
    assert "# TYPE speca_requests_completed_total counter" in \
        obs.prometheus()
    assert len(obs.events_jsonl().splitlines()) == \
        len(obs.recorder.events())
    done = [r for r in snap if r["name"] == "speca_requests_completed_total"]
    assert sum(r["value"] for r in done) == 3.0
    eng.shutdown()


# ---------------------------------------------------------------------------
# Diffusion and decode lanes on one engine (the analogue of
# tests/test_decode_workload.py::test_mixed_diffusion_decode_lifecycle)
# ---------------------------------------------------------------------------

def test_mixed_diffusion_decode_lifecycle(both, engines):
    """One engine, one scheduler, both workloads in flight at once: each
    side equals its solo run at the same width (samples bitwise), and
    the reference's mixed engine (accepts, counters, flops; latents within
    1e-5, tokens equal), with per-workload FLOPs."""
    from repro.configs import get_config, reduced
    from repro.core.workload import DecodeWorkload as JDecodeWorkload
    from repro_torch.core.workload import DecodeWorkload
    (cfg, dcfg, params), (pcfg, pdcfg, tp) = both
    _, pe = engines
    lm = reduced(get_config("llama3-8b"))
    lm_params = JM.init_params(lm, jax.random.PRNGKey(0))
    plm = port_record(PC.ModelConfig, lm)
    plm_params = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        lm_params),
                                 device="cpu")
    P, G = 8, 10
    jscfg, pscfg = _scfgs(tau0=0.05)
    jwl = JDecodeWorkload(lm, lm_params, JSpeCaConfig(tau0=5.0),
                          max_new_tokens=G, max_seq_len=P + G)

    def pwl():
        return DecodeWorkload(plm, plm_params, PC.SpeCaConfig(tau0=5.0),
                              max_new_tokens=G, max_seq_len=P + G,
                              device="cpu")
    prompts = [np.asarray(jax.random.randint(jax.random.PRNGKey(s), (1, P),
                                             0, lm.vocab_size), np.int32)
               for s in (3, 4)]

    def reqs(Req, Pol, lab):
        d = [Req(request_id=10, cond={"labels": lab([3])}, seed=1),
             Req(request_id=11, cond={"labels": lab([3])}, seed=2,
                 policy=Pol(guidance_scale=2.0))]
        t = [Req(request_id=20 + i, cond={"tokens": p},
                 policy=Pol(workload="decode", tau0=5.0))
             for i, p in enumerate(prompts)]
        return d, t

    jd, jt = reqs(JRequest, JRequestPolicy, jnp.asarray)
    pd, pt = reqs(Request, RequestPolicy, torch.tensor)
    jmixed = JEngine(cfg, params, dcfg, jscfg, workloads={"decode": jwl},
                     lanes=2)
    mixed = SpeCaEngine(pcfg, tp, pdcfg, pscfg, noise_fn=pe.workload.noise_fn,
                        workloads={"decode": pwl()}, lanes=2, device="cpu")
    jres = jmixed.results([jmixed.submit(r) for r in jd + jt])
    tickets = [mixed.submit(r) for r in pd + pt]
    mixed.tick(2)
    assert mixed.in_flight() >= 2 and set(mixed._sessions) == {
        "diffusion", "decode"}
    res = mixed.results(tickets)
    assert [r.workload for r in res] == ["diffusion"] * 2 + ["decode"] * 2
    assert all(r.completed for r in res)
    solo_d = SpeCaEngine(pcfg, tp, pdcfg, pscfg,
                         noise_fn=pe.workload.noise_fn, lanes=2,
                         device="cpu")
    solo_t = SpeCaEngine(workloads={"decode": pwl()}, lanes=2, device="cpu")
    solo = [solo_d.result(solo_d.submit(r)) for r in pd] + \
        [solo_t.result(solo_t.submit(r)) for r in pt]
    for got, want, ref in zip(res, solo, jres):
        assert got.workload == ref.workload
        assert got.accepts == want.accepts == ref.accepts
        assert (got.num_full, got.num_spec, got.num_drafted) == \
            (want.num_full, want.num_spec, want.num_drafted) == \
            (ref.num_full, ref.num_spec, ref.num_drafted)
        assert got.flops == want.flops == pytest.approx(ref.flops,
                                                        rel=1e-12)
        assert torch.equal(got.sample, want.sample)
        if got.workload == "decode":
            assert got.sample.tolist() == np.asarray(ref.sample).tolist()
        else:
            np.testing.assert_allclose(got.sample.numpy(),
                                       np.asarray(ref.sample), **TOL)
    assert res[0].flops != res[2].flops
    assert sum(r.num_spec for r in res[2:]) > 0


# ---------------------------------------------------------------------------
# The paper's baselines (repro.core.baselines) on the trained tiny DiT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["fora3", "taylorseer4", "taylorseer4_newton",
                                  "ab2_4", "teacache2", "step_reduction"])
def test_baselines_match_reference(both, name):
    """Each non-verifying baseline against the reference's from the same
    noise: the anchor schedule (``full_step``) identical, the latents
    within rtol = atol = 1e-5. TeaCache at threshold 2.0 fires every
    third step here (a change of 0.953 a step on this schedule), so the
    run mixes anchors and reuse."""
    from repro.core import baselines as JB
    from repro_torch.core import baselines as PB
    (cfg, dcfg, params), (pcfg, pdcfg, tp) = both
    make = {"fora3": lambda m: m.fora(3),
            "taylorseer4": lambda m: m.taylorseer(4),
            "taylorseer4_newton": lambda m: m.taylorseer(
                4, draft_mode="newton"),
            "ab2_4": lambda m: m.ab2(4),
            "teacache2": lambda m: m.teacache(2.0)}
    labels = [2, 5]
    key = jax.random.PRNGKey(13)
    noise = np.array(jax.random.normal(key, latent_shape(cfg, dcfg, 2),
                                       jnp.float32))
    jcond = {"labels": jnp.asarray(labels)}
    pcond = {"labels": torch.tensor(labels)}
    if name == "step_reduction":
        xj, sj = JB.step_reduction_sample(cfg, params, dcfg, 0.5, key,
                                          jcond, 2)
        xp, sp = PB.step_reduction_sample(pcfg, tp, pdcfg, 0.5, pcond, 2,
                                          noise=torch.from_numpy(noise),
                                          device="cpu")
        assert sp == {k: int(v) for k, v in sj.items()}
    else:
        xj, sj = jax.jit(lambda k: JB.cached_sample(
            cfg, params, dcfg, make[name](JB), k, jcond, 2))(key)
        xp, sp = PB.cached_sample(pcfg, tp, pdcfg, make[name](PB), pcond, 2,
                                  noise=torch.from_numpy(noise),
                                  device="cpu")
        np.testing.assert_array_equal(sp["full_step"].numpy(),
                                      np.asarray(sj["full_step"]))
        assert sp["num_full"] == int(sj["num_full"])
        assert 0 < sp["num_spec"] < sp["num_steps"]
        assert sp["alpha"] == pytest.approx(float(sj["alpha"]))
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), **TOL)


# ---------------------------------------------------------------------------
# Lane-sharded serving (SpeCaEngine(mesh=)): the port's analogues of
# tests/test_serving_sharded.py
# ---------------------------------------------------------------------------

def _sig(results):
    """What sharding must not change: per request its accepts, counters,
    FLOPs and completion."""
    return [(r.request_id, r.accepts, r.num_full, r.num_spec, r.num_drafted,
             r.flops, r.completed) for r in results]


def _shard_reqs(n, policy_of=lambda i: None):
    return [Request(request_id=i, cond={"labels": torch.tensor([i % 8])},
                    seed=70 + i, policy=policy_of(i)) for i in range(n)]


def _max_diff(a, b):
    return max(float((x.sample - y.sample).abs().max()) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def mesh_engine(engines):
    """Port engines like the ``engines`` fixture's (its parameters and the
    reference's noise), unsharded (D None) or on D CPU shards."""
    from repro_torch.launch.mesh import make_lane_mesh
    wl = engines[1].workload

    def make(D, **kw):
        mesh = None if D is None else make_lane_mesh(D, device="cpu")
        return SpeCaEngine(wl.cfg, wl.params, wl.dcfg, wl.scfg,
                           noise_fn=wl.noise_fn, device="cpu", mesh=mesh,
                           **kw)
    return make


@pytest.fixture
def shard_ticks(monkeypatch):
    """Per-shard flags of every sharded tick, and the per-shard answers
    to every batch-accept request ("every drafting lane passed")."""
    ticks, alls = [], []
    call, answer = PLS.ShardedStep.__call__, PLS.ShardedStep._answer_all

    def probe(step, shards):
        new, flags = call(step, shards)
        ticks.append(flags)
        return new, flags

    def probe_answer(step, op, args):
        if op == "all":
            alls.append([bool(a[0]) for a in args])
        return answer(step, op, args)
    monkeypatch.setattr(PLS.ShardedStep, "__call__", probe)
    monkeypatch.setattr(PLS.ShardedStep, "_answer_all", probe_answer)
    return ticks, alls


def _shards_decide_differently(ticks):
    """Some tick where a drafting lane of one shard was accepted and a
    drafting lane of another was not."""
    for flags in ticks:
        acc = [f["accepted"][f["attempted"]] for f in flags]
        if any(a.any() and any((~b).any() for j, b in enumerate(acc)
                               if j != i) for i, a in enumerate(acc)):
            return True
    return False


@pytest.mark.parametrize("D", [1, 2, 4])
def test_sharded_engine_matches_unsharded(mesh_engine, shard_ticks, D):
    """D ∈ {1, 2, 4} CPU shards serve every request the unsharded engine's
    accepts, counters and FLOPs at the same host syncs; samples bitwise at
    D = 1 and within 2e-5 at D ∈ {2, 4} (the reference's bar: a shard's
    backbone products run at W/D rows); a repeated run is bitwise."""
    reqs = _shard_reqs(6)
    base = mesh_engine(None)
    want = base.serve_batched(reqs, lanes=4)
    eng = mesh_engine(D)
    got = eng.serve_batched(reqs, lanes=4)
    assert _sig(got) == _sig(want)
    assert eng.host_syncs == base.host_syncs
    if D == 1:
        assert all(torch.equal(a.sample, b.sample) for a, b in zip(want, got))
    else:
        assert _max_diff(want, got) <= 2e-5
    assert sum(r.num_spec for r in got) > 0 and \
        sum(r.num_full for r in got) > 0
    ticks, _ = shard_ticks
    assert ticks and all(len(f) == D for f in ticks)
    if D > 1:
        assert _shards_decide_differently(ticks)
    again = mesh_engine(D).serve_batched(reqs, lanes=4)
    assert _sig(again) == _sig(got)
    assert all(torch.equal(a.sample, b.sample) for a, b in zip(got, again))


def test_sharded_engine_at_one_shard_matches_reference(both, engines,
                                                       mesh_engine):
    """D = 1 against the reference's engine on ``make_lane_mesh(1)`` at the
    parity bar: accepts and counters exact, latents within 1e-5."""
    from repro.launch.mesh import make_lane_mesh as jmake_lane_mesh
    (cfg, dcfg, params), _ = both
    je = JEngine(cfg, params, dcfg, _scfgs(tau0=0.4, max_draft=8)[0],
                 mesh=jmake_lane_mesh(1))
    jreqs = [JRequest(request_id=i, cond={"labels": jnp.asarray([i % 8])},
                      seed=70 + i) for i in range(6)]
    jres = je.serve_batched(jreqs, lanes=4)
    pres = mesh_engine(1).serve_batched(_shard_reqs(6), lanes=4)
    _assert_results_equal(jres, pres)


SHARD_CASES = {
    # guided pairs (two scales, a negative prompt) beside unguided lanes
    "guided": ({}, lambda i: None),
    "chain": (dict(max_draft_depth=4),
              lambda i: RequestPolicy(draft_depth=1 + i % 4)),
    "spectral_chain": (dict(max_draft_depth=4, forecaster="spectral"),
                       lambda i: RequestPolicy(draft_depth=4)),
    "batch": (dict(accept_mode="batch"), lambda i: None),
}


@pytest.mark.parametrize("case", sorted(SHARD_CASES))
def test_sharded_engine_cases_at_two_shards(mesh_engine, shard_ticks, case):
    """Guided pairs beside unguided lanes (the width rounds to 2·D),
    depth-4 Taylor and spectral chains and ``accept_mode="batch"`` at
    D = 2: the unsharded engine's accepts, counters and FLOPs at its host
    syncs, samples within 2e-5, and the two shards' lanes decided apart
    (batch mode: one shard's drafting lanes all passed while the other's
    did not, so the decision had to be global)."""
    kw, policy_of = SHARD_CASES[case]
    reqs = _mixed_batch()[1] + _shard_reqs(2) if case == "guided" \
        else _shard_reqs(6, policy_of)
    base = mesh_engine(None, **kw)
    want = base.serve_batched(reqs, lanes=4)
    eng = mesh_engine(2, **kw)
    got = eng.serve_batched(reqs, lanes=4)
    assert _sig(got) == _sig(want)
    assert eng.host_syncs == base.host_syncs
    assert _max_diff(want, got) <= 2e-5
    ticks, alls = shard_ticks
    assert sum(r.num_spec for r in got) > 0
    if case == "batch":
        assert any(len(set(a)) > 1 for a in alls)
    else:
        assert _shards_decide_differently(ticks)
    if case == "guided":
        assert any(bool(f[0]["attempted"][:2].all()) for f in ticks)


def test_sharded_lifecycle_and_obs_match_unsharded(mesh_engine):
    """submit/tick/stream at D = 2 (a pair-capable session of width 4)
    equals the unsharded lifecycle; with ``obs=True`` at the same host
    syncs, its lane totals are the Results' sums (every shard's flags
    reach the accumulator) and the ticks counted once."""
    reqs = _shard_reqs(6)
    base = mesh_engine(None, lanes=4)
    _, want = _drive_life(base, reqs)
    runs = {}
    for obs in (False, True):
        eng = mesh_engine(2, lanes=4, obs=obs)
        _, got = _drive_life(eng, reqs)
        assert _sig(got) == _sig(want)
        assert _max_diff(want, got) <= 2e-5
        runs[obs] = eng
    assert runs[True].host_syncs == runs[False].host_syncs == base.host_syncs
    on = runs[True]
    snap = {(r["name"], tuple(sorted(r["labels"].items()))): r
            for r in on.metrics_snapshot()}
    lab = (("workload", "diffusion"),)
    for key, attr in (("n_spec", "num_spec"), ("n_drafted", "num_drafted"),
                      ("full", "num_full")):
        assert snap[f"speca_{key}_total", lab]["value"] == sum(
            getattr(r, attr) for r in want), key
    assert snap["speca_obs_ticks_total", lab]["value"] == on._tick_count


def test_sharded_engine_validation_and_widths(both, mesh_engine):
    """A mesh needs a "data" axis and the engine's device; widths round to
    streams × D (the reference's cases at tests/test_serving_sharded.py),
    2·D once a request is guided."""
    from repro_torch.launch.mesh import LaneMesh
    _, (pcfg, pdcfg, tp) = both
    scfg = PC.SpeCaConfig()
    with pytest.raises(ValueError, match="data"):
        SpeCaEngine(pcfg, tp, pdcfg, scfg, device="cpu",
                    mesh=LaneMesh(["cpu"], axis_names=("model",)))
    with pytest.raises(ValueError, match="not a device of"):
        SpeCaEngine(pcfg, tp, pdcfg, scfg, device="cpu",
                    mesh=LaneMesh(["meta", "meta"]))
    eng = mesh_engine(1)
    assert eng.lane_width(4, 100) == 4
    assert eng.lane_width(4, 3) == 3
    eng._lane_shards = 4          # as on a 4-shard ("data",) mesh
    assert eng.lane_width(4, 3) == 4
    assert eng.lane_width(6, 100) == 8
    assert eng.lane_width(1, 1) == 4
    eng2 = mesh_engine(2)
    un, gd = RequestPolicy(), RequestPolicy(guidance_scale=2.0)
    assert eng2._width_for(3, [un, un, un]) == 4
    assert eng2._width_for(2, [gd, un]) == 4        # 2·D
    assert eng2._width_for(8, [gd, gd, gd]) == 8    # 6 streams -> 8
    eng2.start(lanes=3)
    assert eng2._sessions["diffusion"].W == 4


def test_sharded_engine_equals_reference_four_device_mesh(both, engines,
                                                          tmp_path):
    """The reference's ``make_lane_mesh(4)`` engine in a subprocess with 4
    forced host devices against the port at D = 4 on the same parameters,
    written once through the repo's checkpoint format: per request the
    same accepts, counters and FLOPs, latents within 2e-5."""
    import os
    import subprocess
    import sys
    import textwrap
    from repro.checkpoint import save_checkpoint as jsave
    from repro_torch.convert import params_from_checkpoint
    from repro_torch.launch.mesh import make_lane_mesh
    (cfg, dcfg, params), _ = both
    ck = str(tmp_path / "dit")
    jsave(ck, params)
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import dataclasses, json
        import jax, jax.numpy as jnp, numpy as np
        from repro.checkpoint import restore_checkpoint
        from repro.configs import (DiffusionConfig, SpeCaConfig,
                                   get_config, reduced)
        from repro.launch.mesh import make_lane_mesh
        from repro.layers.model import init_params
        from repro.serving import Request, SpeCaEngine
        cfg = dataclasses.replace(reduced(get_config("dit-xl2")),
                                  num_layers=2, d_model=128, d_ff=256,
                                  num_heads=4, num_kv_heads=4,
                                  num_classes=8)
        dcfg = DiffusionConfig(num_inference_steps=20, latent_size=8,
                               schedule="cosine")
        params = restore_checkpoint({ck!r},
                                    init_params(cfg, jax.random.PRNGKey(0)))
        scfg = SpeCaConfig(taylor_order=2, max_draft=8, tau0=0.4, beta=0.9)
        eng = SpeCaEngine(cfg, params, dcfg, scfg, mesh=make_lane_mesh(4))
        res = eng.serve_batched(
            [Request(request_id=i, cond={{"labels": jnp.asarray([i % 8])}},
                     seed=70 + i) for i in range(6)], lanes=4)
        print(json.dumps({{
            "devices": jax.device_count(), "cfg": repr(cfg),
            "dcfg": repr(dcfg),
            "sig": [[r.request_id, r.accepts, r.num_full, r.num_spec,
                     r.num_drafted, r.flops, r.completed] for r in res],
            "samples": [np.asarray(r.sample).tolist() for r in res]}}))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    assert ref["devices"] == 4
    assert ref["cfg"] == repr(cfg) and ref["dcfg"] == repr(dcfg)
    wl = engines[1].workload
    eng = SpeCaEngine(wl.cfg, params_from_checkpoint(ck, device="cpu"),
                      wl.dcfg, wl.scfg, noise_fn=wl.noise_fn, device="cpu",
                      mesh=make_lane_mesh(4, device="cpu"))
    got = eng.serve_batched(_shard_reqs(6), lanes=4)
    assert [list(s) for s in _sig(got)] == ref["sig"]
    assert sum(r.num_spec for r in got) > 0
    for r, s in zip(got, ref["samples"]):
        np.testing.assert_allclose(r.sample.numpy(),
                                   np.asarray(s, np.float32),
                                   rtol=2e-5, atol=2e-5)
