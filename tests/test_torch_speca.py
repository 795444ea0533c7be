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
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SpeCaConfig as JSpeCaConfig
from repro.core.speca import speca_sample as jspeca_sample
from repro.diffusion.pipeline import latent_shape
from repro.layers import model as JM
from repro.serving import Request as JRequest
from repro.serving import SpeCaEngine as JEngine
from repro_torch import configs as PC
from repro_torch.convert import params_from_jax
from repro_torch.core.speca import speca_sample
from repro_torch.layers import model as PM
from repro_torch.serving import Request, SpeCaEngine, allocation_report

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
