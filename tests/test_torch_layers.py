"""The port's layers, schedules, verification and Taylor tables against
the JAX package, on the same numpy inputs (f32, small shapes).

Elementwise functions agree to f32 rounding; functions with matrix
products or reductions to rtol=atol=1e-5 (the two frameworks sum in
different orders); the Taylor weights and the schedule tables exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import DiffusionConfig as JDiffusionConfig
from repro.configs import SpeCaConfig as JSpeCaConfig
from repro.configs import get_config, reduced
from repro.core import taylor as jtaylor
from repro.core import verify as jverify
from repro.diffusion import pipeline as jpipe
from repro.diffusion import schedule as jsch
from repro.layers import attention as jattn
from repro.layers import embeddings as jemb
from repro.layers import mlp as jmlp
from repro.layers import model as JM
from repro.layers import norms as jnorms
from repro_torch import configs as PC
from repro_torch.convert import params_from_jax
from repro_torch.core import taylor as ptaylor
from repro_torch.core import verify as pverify
from repro_torch.diffusion import pipeline as ppipe
from repro_torch.diffusion import schedule as psch
from repro_torch.layers import attention as pattn
from repro_torch.layers import embeddings as pemb
from repro_torch.layers import mlp as pmlp
from repro_torch.layers import model as PM
from repro_torch.layers import norms as pnorms

torch.set_num_threads(2)
CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(x)


def port_record(cls, ref):
    """The port's record ``cls`` with the reference record's values."""
    return cls(**{f.name: getattr(ref, f.name)
                  for f in dataclasses.fields(cls)})


@pytest.mark.parametrize("port_cls, ref", [
    (PC.ModelConfig, get_config("dit-xl2")),
    (PC.SpeCaConfig, JSpeCaConfig()),
    (PC.DiffusionConfig, JDiffusionConfig())])
def test_configs_mirror_reference(port_cls, ref):
    """Every field the port keeps has the reference's name and default
    (DiT-XL/2: the reference's values)."""
    port = PC.DIT_XL2 if port_cls is PC.ModelConfig else port_cls()
    assert port == port_record(port_cls, ref)
    assert PC.DIT_XL2.torch_dtype == torch.bfloat16


@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (3, 4, 6, 2)])
def test_patchify_roundtrip_matches(shape):
    x = _rand(*shape)
    tj = np.asarray(jemb.patchify(_j(x), 2))
    tt = pemb.patchify(_t(x), 2)
    np.testing.assert_array_equal(tt.numpy(), tj)
    back = pemb.unpatchify(tt, 2, shape[1], shape[2], shape[3])
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("dim", [64, 65])
def test_timestep_embedding_and_time_mlp(dim):
    t = np.array([0.0, 3.5, 999.0], np.float32)
    # sin/cos of arguments near 1e3 rad: the two libraries' range
    # reductions differ by a few ulp of the argument (seen: 1.7e-6)
    np.testing.assert_allclose(
        pemb.timestep_embedding(_t(t), dim).numpy(),
        np.asarray(jemb.timestep_embedding(_j(t), dim)), **TOL)
    p = {"w1": _rand(dim, dim, seed=1, scale=0.1), "b1": _rand(dim, seed=2),
         "w2": _rand(dim, dim, seed=3, scale=0.1), "b2": _rand(dim, seed=4)}
    np.testing.assert_allclose(
        pemb.time_mlp({k: _t(v) for k, v in p.items()}, _t(t), dim).numpy(),
        np.asarray(jemb.time_mlp({k: _j(v) for k, v in p.items()}, _j(t),
                                 dim)), **TOL)


def test_label_embed_null_class_is_last_row():
    table = _rand(9, 16)
    labels = np.array([0, 8, 3])
    np.testing.assert_array_equal(
        pemb.label_embed(_t(table), _t(labels)).numpy(),
        np.asarray(jemb.label_embed(_j(table), _j(labels))))


def test_layer_norm_population_variance_and_modulate():
    x, w, b = _rand(2, 5, 32), _rand(32, seed=1), _rand(32, seed=2)
    np.testing.assert_allclose(
        pnorms.layer_norm(_t(x), _t(w), _t(b)).numpy(),
        np.asarray(jnorms.layer_norm(_j(x), _j(w), _j(b))), **TOL)
    sh, sc = _rand(2, 32, seed=3), _rand(2, 32, seed=4)
    np.testing.assert_allclose(
        pnorms.modulate(_t(x), _t(sh), _t(sc)).numpy(),
        np.asarray(jnorms.modulate(_j(x), _j(sh), _j(sc))), rtol=1e-6,
        atol=1e-6)


def test_gelu_mlp_tanh_approximation():
    x = _rand(2, 5, 16)
    wu, wd = _rand(16, 32, seed=1, scale=0.3), _rand(32, 16, seed=2,
                                                      scale=0.3)
    np.testing.assert_allclose(
        pmlp.gelu_mlp(_t(x), _t(wu), _t(wd)).numpy(),
        np.asarray(jmlp.gelu_mlp(_j(x), _j(wu), _j(wd))), **TOL)


def test_attention_core_bidirectional():
    q, k, v = (_rand(2, 6, 4, 8, seed=s) for s in (1, 2, 3))
    np.testing.assert_allclose(
        pattn.attention_core(_t(q), _t(k), _t(v)).numpy(),
        np.asarray(jattn.attention_core(_j(q), _j(k), _j(v), None)), **TOL)


@pytest.mark.parametrize("kind", ["linear", "cosine"])
def test_schedule_tables_identical(kind):
    sj = jsch.make_schedule(kind, 1000)
    sp = psch.make_schedule(kind, 1000, CPU)
    np.testing.assert_array_equal(sp.alphas_bar.numpy(),
                                  np.asarray(sj.alphas_bar))
    np.testing.assert_array_equal(sp.betas.numpy(), np.asarray(sj.betas))
    np.testing.assert_array_equal(
        psch.inference_timesteps(1000, 50, CPU).numpy(),
        np.asarray(jsch.inference_timesteps(1000, 50)))
    np.testing.assert_array_equal(psch.rf_timesteps(20, CPU).numpy(),
                                  np.asarray(jsch.rf_timesteps(20)))


def test_ddim_and_rf_steps_per_lane():
    sj = jsch.make_schedule("cosine", 1000)
    sp = psch.make_schedule("cosine", 1000, CPU)
    x, eps = _rand(3, 4, 4, 2), _rand(3, 4, 4, 2, seed=1)
    t, tp = np.array([999, 500, 20]), np.array([979, 480, -1])
    np.testing.assert_allclose(
        psch.ddim_step(sp, _t(x), _t(eps), _t(t), _t(tp)).numpy(),
        np.asarray(jsch.ddim_step(sj, _j(x), _j(eps), _j(t), _j(tp))),
        rtol=1e-6, atol=1e-6)
    sig, nxt = np.array([1.0, 0.5, 0.1], np.float32), \
        np.array([0.9, 0.4, 0.0], np.float32)
    np.testing.assert_allclose(
        psch.rf_euler_step(_t(x), _t(eps), _t(sig), _t(nxt)).numpy(),
        np.asarray(jsch.rf_euler_step(_j(x), _j(eps), _j(sig), _j(nxt))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("schedule", ["cosine", "rectified_flow"])
def test_stepper_matches(schedule):
    dcfg = dict(num_inference_steps=10, schedule=schedule, latent_size=4)
    sj = jpipe.make_stepper(JDiffusionConfig(**dcfg))
    sp = ppipe.make_stepper(PC.DiffusionConfig(**dcfg), CPU)
    np.testing.assert_array_equal(sp.t_model.numpy(), np.asarray(sj.t_model))
    np.testing.assert_array_equal(sp.t_frac.numpy(), np.asarray(sj.t_frac))
    x, out = _rand(2, 4, 4, 4), _rand(2, 4, 4, 4, seed=1)
    s = np.array([0, 9])
    np.testing.assert_allclose(
        sp.advance(_t(x), _t(out), _t(s)).numpy(),
        np.asarray(sj.advance(_j(x), _j(out), _j(s))), rtol=1e-6,
        atol=1e-6)


@pytest.mark.parametrize("metric", ["rel_l2", "rel_l1", "rel_linf",
                                    "cosine"])
def test_relative_error_metrics(metric):
    p, r = _rand(3, 4, 5), _rand(3, 4, 5, seed=1)
    for axis in (0, 1):
        np.testing.assert_allclose(
            pverify.relative_error(_t(p), _t(r), metric=metric,
                                   batch_axis=axis).numpy(),
            np.asarray(jverify.relative_error(_j(p), _j(r), metric=metric,
                                              batch_axis=axis)), **TOL)


def test_threshold_schedule():
    tf = np.linspace(0, 1, 7).astype(np.float32)
    tau0 = np.array([0.3] * 7, np.float32)
    np.testing.assert_allclose(
        pverify.threshold_schedule(_t(tf), _t(tau0), 0.9).numpy(),
        np.asarray(jverify.threshold_schedule(_j(tf), _j(tau0), 0.9)),
        rtol=1e-6)


@pytest.mark.parametrize("mode", ["taylor", "newton", "reuse", "ab2"])
@pytest.mark.parametrize("order", [2, 3])
def test_prediction_weights_all_modes(mode, order):
    d = np.array([1, 2, 3, 5], np.float32)
    gap = np.array([1, 2, 4, 3], np.float32)
    n = np.array([0, 1, 3, 4], np.int32)
    cap = np.array([3, 0, 1, 2], np.int32)
    for oc in (None, cap):
        wj = jtaylor.prediction_weights(
            order, _j(d), _j(gap), _j(n), mode,
            order_cap=None if oc is None else _j(oc))
        wp = ptaylor.prediction_weights(
            order, _t(d), _t(gap), _t(n), mode,
            order_cap=None if oc is None else _t(oc))
        np.testing.assert_array_equal(wp.numpy(), np.asarray(wj))


def test_taylor_lane_tables_match():
    """A few masked refreshes and forecasts through both packages'
    kernel paths: tables bitwise, forecasts to FMA rounding."""
    feat = (2, 2, 3, 4, 8)
    sj = jtaylor.init_state(2, feat, jnp.float32, lanes=3)
    sp = ptaylor.init_state(2, feat, torch.float32, 3, CPU)
    masks = [[1, 1, 1], [1, 0, 1], [1, 1, 0], [0, 1, 1], [1, 1, 1]]
    for k, m in enumerate(masks):
        f = _rand(*feat, seed=10 + k)
        step = np.array([k, k, k], np.int32)
        mask = np.array(m, bool)
        sj = jtaylor.update_lanes(sj, _j(f), _j(step), _j(mask))
        sp = ptaylor.update_lanes(sp, _t(f), _t(step), _t(mask))
        for key in ("diffs", "n_anchors", "anchor_step", "gap"):
            np.testing.assert_array_equal(sp[key].numpy(),
                                          np.asarray(sj[key]), key)
        nxt = np.array([k + 1, k + 2, k + 1], np.int32)
        np.testing.assert_allclose(
            ptaylor.predict_lanes(sp, _t(nxt)).numpy(),
            np.asarray(jtaylor.predict_lanes(sj, _j(nxt))), rtol=1e-6,
            atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["taylor", "newton"])
def test_taylor_scalar_tables_match(dtype, mode):
    """Whole-batch anchors (``init_state(lanes=None)``): a few refreshes at
    uneven steps and forecasts past each, through both packages' plain
    ``update``/``predict``: tables and metadata bitwise, forecasts to FMA
    rounding (f32) or one bf16 ulp."""
    feat = (2, 2, 3, 4, 8)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    sj = jtaylor.init_state(2, feat, jd)
    sp = ptaylor.init_state(2, feat, td, device=CPU)
    assert all(sp[k].shape == () for k in ("n_anchors", "anchor_step",
                                           "gap"))
    for k, step in enumerate([0, 2, 3, 6]):
        f = _rand(*feat, seed=20 + k)
        sj = jtaylor.update(sj, _j(f), step)
        sp = ptaylor.update(sp, _t(f), step)
        for key in ("diffs", "n_anchors", "anchor_step", "gap"):
            np.testing.assert_array_equal(
                sp[key].to(torch.float32).numpy() if key == "diffs"
                else sp[key].numpy(),
                np.asarray(sj[key].astype(jnp.float32) if key == "diffs"
                           else sj[key]), key)
        for ahead in (1, 2):
            pj = jtaylor.predict(sj, step + ahead, mode)
            pp = ptaylor.predict(sp, step + ahead, mode)
            assert pp.dtype == td
            tol = 1e-6 if dtype == "float32" else 2.0 ** -8
            np.testing.assert_allclose(pp.to(torch.float32).numpy(),
                                       np.asarray(pj.astype(jnp.float32)),
                                       rtol=tol, atol=tol)


def _tiny_random_dit():
    cfg = dataclasses.replace(reduced(get_config("dit-xl2")), num_layers=3,
                              d_model=32, d_ff=64, num_heads=4,
                              num_kv_heads=4, num_classes=5)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(0)
    # AdaLN-Zero leaves start at zero; give them weight so every branch
    # contributes (otherwise the comparison is vacuous)
    for grp, keys in (("blocks", ("mod_w", "mod_b")),
                      ("head", ("w", "b", "mod_w", "mod_b"))):
        for k in keys:
            params[grp][k] = rng.normal(0, 0.1, params[grp][k].shape
                                        ).astype(np.float32)
    return cfg, port_record(PC.ModelConfig, cfg), params


def test_dit_forward_random_params_and_sample_full():
    cfg, pcfg, params = _tiny_random_dit()
    tp = params_from_jax(params, device="cpu")
    lat = _rand(2, 8, 8, 4, seed=3)
    inp = {"latents": lat, "t": np.array([999.0, 20.0], np.float32),
           "labels": np.array([1, 5])}
    oj, ej = JM.dit_forward(cfg, jax.tree_util.tree_map(_j, params),
                            {k: _j(v) for k, v in inp.items()},
                            collect_branches=True)
    op, ep = PM.dit_forward(pcfg, tp, {k: _t(v) for k, v in inp.items()},
                            collect_branches=True)
    np.testing.assert_allclose(op.numpy(), np.asarray(oj), **TOL)
    np.testing.assert_allclose(ep["branches"].numpy(),
                               np.asarray(ej["branches"]), **TOL)
    dcfg = dict(num_inference_steps=5, latent_size=8)
    key = jax.random.PRNGKey(4)
    cond = {"labels": np.array([2, 3])}
    xj, _ = jpipe.sample_full(cfg, jax.tree_util.tree_map(_j, params),
                              JDiffusionConfig(**dcfg), key,
                              {"labels": _j(cond["labels"])}, 2)
    noise = np.asarray(jax.random.normal(key, (2, 8, 8, 4), jnp.float32))
    xp = ppipe.sample_full(pcfg, tp, PC.DiffusionConfig(**dcfg),
                           {"labels": _t(cond["labels"])}, 2,
                           noise=_t(noise), device="cpu")
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), **TOL)


def test_init_params_layout_matches_reference():
    cfg, pcfg, params = _tiny_random_dit()
    tp = PM.init_params(pcfg, torch.Generator().manual_seed(0),
                        device="cpu")
    conv = params_from_jax(params, device="cpu")

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict)
                else (tuple(v.shape), v.dtype) for k, v in tree.items()}

    assert shapes(tp) == shapes(conv)
    assert not tp["blocks"]["mod_w"].any() and not tp["head"]["w"].any()


def test_null_cond_like_maps_labels_to_null_class():
    cfg, pcfg, _ = _tiny_random_dit()
    out = ppipe.null_cond_like(pcfg, {"labels": torch.tensor([1, 2]),
                                      "cond": torch.ones(2, 3)})
    assert out["labels"].tolist() == [5, 5]
    assert not out["cond"].any()
