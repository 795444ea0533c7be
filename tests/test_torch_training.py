"""The port's training side against the JAX package, on the CPU.

AdamW (three steps over f32 and bf16 leaves, clipping active and not)
and the cosine warmup schedule; ``diffusion_loss`` under DDPM and
rectified flow for a label and a continuous-conditioning DiT, its value
and every gradient leaf against ``jax.grad``; ten
``diffusion_train_step``s on the reference's batches and draws, and one
step of each paper DiT at two reduced layers; the registry, the FLOP
counters and the reference's entry-point names; the train launcher on
the CPU. The LM side (``lm_loss``, ``train_step``, the MoE load-balance
loss) is in ``tests/test_torch_training_lm.py``.

jax.random cannot be reproduced, so every draw (timesteps, σ, noise,
batches) is the reference's, handed to the port as numpy. Parameters
are the reference's ``init_params`` with small seeded noise added to
every leaf (the zero-initialised AdaLN and head leaves would otherwise
leave most gradients at zero), converted with ``params_from_jax``.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED as J_ASSIGNED
from repro.configs import PAPER_ARCHS as J_PAPER
from repro.configs import DiffusionConfig as JDiffusionConfig
from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.configs import reduced as jreduced
from repro.core import complexity as JC
from repro.diffusion.loss import diffusion_loss as jdiffusion_loss
from repro.layers import model as JM
from repro.optim import adamw as JA
from repro.training import diffusion_trainer as JDT
from repro_torch import configs as PC
from repro_torch.convert import params_from_jax
from repro_torch.core import complexity as PCX
from repro_torch.core import lane_step as PLS
from repro_torch.core.workload import (DiffusionWorkload,
                                       make_diffusion_workload)
from repro_torch.diffusion.loss import diffusion_loss
from repro_torch.layers import model as PM
from repro_torch.optim import adamw as PA
from repro_torch.training import diffusion_trainer as PDT
from repro_torch.training.autodiff import value_and_grad
from repro_torch.tree import tree_flatten_with_paths

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]


def port_cfg(ref, cls=PC.ModelConfig):
    """The port's record ``cls`` with the reference record's values."""
    return cls(**{f.name: getattr(ref, f.name)
                  for f in dataclasses.fields(cls)})


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _noisy(params, seed=0, scale=0.05):
    """The reference tree with N(0, scale²) added to every float leaf."""
    rng = np.random.default_rng(seed)

    def add(a):
        a = np.asarray(a)
        if a.dtype.kind != "f" and a.dtype != ml_dtypes.bfloat16:
            return a
        noise = rng.normal(0, scale, a.shape).astype(np.float32)
        return (a.astype(np.float32) + noise).astype(a.dtype)
    return jax.tree_util.tree_map(add, params)


def _paths(tree):
    """{path: numpy f32} of a JAX or port tree, in sorted key order."""
    out = {}
    for path, leaf in tree_flatten_with_paths(tree):
        if isinstance(leaf, torch.Tensor):
            out[path] = leaf.detach().to(torch.float32).numpy()
        else:
            out[path] = np.asarray(leaf, np.float32)
    return out


def _assert_grads_close(gp, gj, frac=1e-4):
    """Every port gradient leaf within ``frac``·max|g| of the reference's
    (the port's tree may hold fewer leaves: ``params_from_jax`` keeps the
    family's keys)."""
    pj, pp = _paths(gj), _paths(gp)
    assert set(pp) <= set(pj), sorted(set(pp) - set(pj))
    for k, g in pp.items():
        scale = max(float(np.abs(pj[k]).max()), 1e-30)
        np.testing.assert_allclose(g, pj[k], rtol=0, atol=frac * scale,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _opt_trees(seed):
    rng = np.random.default_rng(seed)
    params = {"b": {"w": rng.normal(size=(4, 3)).astype(np.float32)},
              "a": rng.normal(size=(5,)).astype(ml_dtypes.bfloat16),
              "c": rng.normal(size=(2, 2, 2)).astype(np.float32)}
    grads = [{"b": {"w": rng.normal(size=(4, 3)).astype(np.float32)},
              "a": rng.normal(size=(5,)).astype(ml_dtypes.bfloat16),
              "c": rng.normal(size=(2, 2, 2)).astype(np.float32) * 3}
             for _ in range(3)]
    return params, grads


def _torch_tree(tree):
    """A numpy tree (bf16 leaves as ml_dtypes) as CPU tensors."""
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("clip_norm", [0.5, 100.0], ids=["clipped",
                                                         "unclipped"])
def test_adamw_three_steps_match_reference(clip_norm):
    """Three AdamW steps at a decaying LR scale: f32 leaves and the f32
    moments at rtol 1e-6, bf16 leaves within one ulp, the global norm at
    rtol 1e-6 — with clipping active (norm ≫ 0.5) and inactive."""
    params, grads = _opt_trees(1)
    cfg = JA.AdamWConfig(lr=1e-2, clip_norm=clip_norm)
    pcfg = PA.AdamWConfig(lr=1e-2, clip_norm=clip_norm)
    jp, js = _jax_tree(params), JA.init_opt_state(_jax_tree(params))
    tp = _torch_tree(params)
    ts = PA.init_opt_state(tp)
    for i, g in enumerate(grads):
        scale = np.float32(1.0 - 0.25 * i)
        jp, js, jm = jax.jit(JA.adamw_update, static_argnums=0)(
            cfg, jp, _jax_tree(g), js, scale)
        tp, ts, tm = PA.adamw_update(pcfg, tp, _torch_tree(g), ts, scale)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        if clip_norm < 1:
            assert float(jm["grad_norm"]) > clip_norm
    assert int(ts["count"]) == int(js["count"]) == 3
    assert tp["a"].dtype == torch.bfloat16
    for k in ("b/w", "c"):
        np.testing.assert_allclose(_paths(tp)[k], _paths(jp)[k], rtol=1e-6)
    for moment in ("mu", "nu"):
        for k, v in _paths(ts[moment]).items():
            np.testing.assert_allclose(v, _paths(js[moment])[k], rtol=1e-6)
    a_t = tp["a"].to(torch.float32).numpy()
    a_j = np.asarray(jp["a"], np.float32)
    ulp = np.abs(a_j) * 2.0 ** -7
    assert np.all(np.abs(a_t - a_j) <= ulp), (a_t, a_j)


def test_cosine_warmup_schedule_matches_reference():
    for warmup, total in [(3, 10), (0, 5), (10, 10)]:
        jfn = JA.cosine_warmup_schedule(warmup, total)
        pfn = PA.cosine_warmup_schedule(warmup, total)
        for step in range(total + 3):
            np.testing.assert_allclose(float(pfn(step)), float(jfn(step)),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{warmup}/{total}@{step}")


# ---------------------------------------------------------------------------
# Diffusion loss and trainer
# ---------------------------------------------------------------------------

def _dit(cond_dim=0, arch="dit-xl2", layers=2, d=64):
    cfg = dataclasses.replace(jreduced(jget_config(arch)), num_layers=layers,
                              d_model=d, d_ff=2 * d, num_heads=4,
                              num_kv_heads=4)
    if cond_dim:
        cfg = dataclasses.replace(cfg, cond_dim=cond_dim, num_classes=0)
    elif cfg.num_classes:
        cfg = dataclasses.replace(cfg, num_classes=8)
    return cfg


def _dit_params(cfg, seed=0):
    jp = _noisy(JM.init_params(cfg, jax.random.PRNGKey(seed)), seed)
    return _jax_tree(jp), params_from_jax(_np_tree(jp), device="cpu")


def _ref_draws(dcfg, key, x0_shape):
    """The draws the reference's ``diffusion_loss`` makes from ``key``."""
    k_t, k_n = jax.random.split(key)
    noise = np.asarray(jax.random.normal(k_n, x0_shape, jnp.float32))
    B = x0_shape[0]
    if dcfg.schedule == "rectified_flow":
        t = np.asarray(jax.random.uniform(k_t, (B,), jnp.float32))
    else:
        t = np.asarray(jax.random.randint(k_t, (B,), 0,
                                          dcfg.num_train_timesteps))
    return t, noise


def _cond(cfg, B, seed=3):
    rng = np.random.default_rng(seed)
    if cfg.cond_dim:
        return {"cond": rng.normal(0, 0.1, (B, 4, cfg.cond_dim)
                                   ).astype(np.float32)}
    return {"labels": rng.integers(0, cfg.num_classes, B).astype(np.int32)}


@pytest.mark.parametrize("schedule", ["cosine", "rectified_flow"])
@pytest.mark.parametrize("cond_dim", [0, 32], ids=["labels", "cond"])
def test_diffusion_loss_and_grads_match_reference(schedule, cond_dim):
    cfg = _dit(cond_dim, arch="flux-like" if cond_dim else "dit-xl2")
    pcfg = port_cfg(cfg)
    dcfg = JDiffusionConfig(schedule=schedule, latent_size=8)
    pdcfg = port_cfg(dcfg, PC.DiffusionConfig)
    jp, tp = _dit_params(cfg)
    B = 3
    x0 = np.random.default_rng(5).normal(
        size=(B, 8, 8, cfg.in_channels)).astype(np.float32)
    cond = _cond(cfg, B)
    key = jax.random.PRNGKey(11)
    t, noise = _ref_draws(dcfg, key, x0.shape)
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: jdiffusion_loss(cfg, dcfg, p, key, jnp.asarray(x0),
                                  _jax_tree(cond)), has_aux=True))(jp)
    (lp, mp), gp = value_and_grad(
        lambda p: diffusion_loss(pcfg, pdcfg, p, torch.from_numpy(x0),
                                 {k: torch.from_numpy(v)
                                  for k, v in cond.items()},
                                 t=torch.from_numpy(t.copy()),
                                 noise=torch.from_numpy(noise.copy())), tp)
    np.testing.assert_allclose(float(lp), float(lj), rtol=1e-6)
    assert float(mp["aux"]) == float(mj["aux"]) == 0.0
    _assert_grads_close(gp, gj)


def _jstate(jp):
    return {"params": jp, "opt": JA.init_opt_state(jp),
            "step": jnp.zeros((), jnp.int32)}


def _pstate(tp):
    return {"params": tp, "opt": PA.init_opt_state(tp),
            "step": torch.zeros((), dtype=torch.int32)}


def test_ten_diffusion_train_steps_match_reference():
    """Ten steps of the reference's trainer step on its own batches and
    draws (the GM latents, its fold-in keys) against the port's: every
    loss at rtol 1e-5, the parameters at rtol 1e-4 after the tenth."""
    from repro.data import synthetic as jsyn
    cfg = _dit()
    pcfg = port_cfg(cfg)
    dcfg = JDiffusionConfig(latent_size=8)
    pdcfg = port_cfg(dcfg, PC.DiffusionConfig)
    jp, tp = _dit_params(cfg)
    opt = JA.AdamWConfig(lr=1e-3, weight_decay=0.1, clip_norm=1.0)
    popt = PA.AdamWConfig(lr=1e-3, weight_decay=0.1, clip_norm=1.0)
    sched = JA.cosine_warmup_schedule(2, 10)
    data = jsyn.GMLatentConfig(num_classes=8, latent_size=8,
                               channels=cfg.in_channels)
    jstep = jax.jit(lambda s, b, k, lr: JDT.diffusion_train_step(
        cfg, dcfg, opt, s, b, k, lr))
    js, ps = _jstate(jp), _pstate(tp)
    k_loop = jax.random.PRNGKey(7)
    for step in range(10):
        batch = jsyn.gm_latent_batch(data, jnp.arange(8 * step,
                                                      8 * step + 8))
        k = jax.random.fold_in(k_loop, step)
        lr = np.float32(sched(step))
        js, jm = jstep(js, batch, k, lr)
        t, noise = _ref_draws(dcfg, k, batch["latents"].shape)
        ps, pm = PDT.diffusion_train_step(
            pcfg, pdcfg, popt, ps,
            {k_: torch.from_numpy(np.array(v)) for k_, v in batch.items()},
            t=torch.from_numpy(t.copy()),
            noise=torch.from_numpy(noise.copy()),
            lr_scale=lr)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"step {step}")
    assert int(ps["step"]) == 10
    pj, pp = _paths(js["params"]), _paths(ps["params"])
    for k, v in pp.items():
        np.testing.assert_allclose(v, pj[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("arch", sorted(J_PAPER))
def test_paper_arch_train_step_matches_reference(arch):
    """One trainer step of each paper DiT at two reduced layers (the
    reduced record, as ``tests/test_configs_smoke.py`` sizes it): loss
    and global norm at rtol 1e-5, every new parameter within 2·lr of the
    reference's (the first Adam step is lr·g/(|g| + ε): an element whose
    gradient is near ε or near 0 turns the gradient's rounding into up
    to 2·lr of difference; ``test_ten_diffusion_train_steps_match_
    reference`` holds the parameters at rtol 1e-4)."""
    cfg = dataclasses.replace(jreduced(jget_config(arch)), num_layers=2)
    if cfg.cond_dim:
        cfg = dataclasses.replace(cfg, cond_dim=32)
    pcfg = port_cfg(cfg)
    sched = "rectified_flow" if cfg.cond_dim else "cosine"
    dcfg = JDiffusionConfig(schedule=sched, latent_size=8)
    pdcfg = port_cfg(dcfg, PC.DiffusionConfig)
    jp, tp = _dit_params(cfg, seed=2)
    opt = JA.AdamWConfig(lr=1e-3)
    popt = PA.AdamWConfig(lr=1e-3)
    B = 2
    batch = {"latents": np.random.default_rng(1).normal(
        size=(B, 8, 8, cfg.in_channels)).astype(np.float32)}
    cond = _cond(cfg, B)
    batch.update(cond)
    key = jax.random.PRNGKey(4)
    js, jm = jax.jit(lambda s, b: JDT.diffusion_train_step(
        cfg, dcfg, opt, s, b, key, 1.0))(_jstate(jp), _jax_tree(batch))
    t, noise = _ref_draws(dcfg, key, batch["latents"].shape)
    ps, pm = PDT.diffusion_train_step(
        pcfg, pdcfg, popt, _pstate(tp),
        {k: torch.from_numpy(v) for k, v in batch.items()},
        t=torch.from_numpy(t.copy()), noise=torch.from_numpy(noise.copy()))
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    _assert_first_step_close(ps["params"], js["params"], lr=1e-3)


def _assert_first_step_close(pp, pj, lr):
    pj, pp = _paths(pj), _paths(pp)
    for k, v in pp.items():
        np.testing.assert_allclose(v, pj[k], rtol=0, atol=2 * lr,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# The registry, the FLOP counters, the entry-point names
# ---------------------------------------------------------------------------

def _shared(a, b):
    names = {f.name for f in dataclasses.fields(a)} \
        & {f.name for f in dataclasses.fields(b)}
    return {n: (getattr(a, n), getattr(b, n)) for n in sorted(names)}


def test_registry_lists_match_reference():
    assert PC.list_archs() == jlist_archs()
    assert sorted(PC.ASSIGNED) == sorted(J_ASSIGNED)
    assert sorted(PC.PAPER_ARCHS) == sorted(J_PAPER)
    with pytest.raises(KeyError):
        PC.get_config("no-such-arch")
    for arch in ("llama3-8b", "gemma3-27b"):
        p, j = PC.get_config(arch + "+swa"), jget_config(arch + "+swa")
        assert p.name == j.name and p.attn_window == j.attn_window == 4096
        assert p.global_every == j.global_every == 0


@pytest.mark.parametrize("arch", jlist_archs())
def test_record_and_reduced_match_reference(arch):
    """Every shared field of the record, of its ``reduced()`` variant and
    of a reduced variant with other knobs, equal to the reference's."""
    for p, j in [(PC.get_config(arch), jget_config(arch)),
                 (PC.reduced(PC.get_config(arch)),
                  jreduced(jget_config(arch))),
                 (PC.reduced(PC.get_config(arch), layers=1, d_model=128,
                             vocab=64, experts=2, heads=2),
                  jreduced(jget_config(arch), layers=1, d_model=128,
                           vocab=64, experts=2, heads=2))]:
        for name, (a, b) in _shared(p, j).items():
            assert a == b, (arch, name, a, b)
        assert p.is_diffusion == j.is_diffusion
        assert p.param_count() == j.param_count()
        assert p.active_param_count() == j.active_param_count()


@pytest.mark.parametrize("arch", jlist_archs())
def test_flop_counters_match_reference(arch):
    p, j = PC.get_config(arch), jget_config(arch)
    for tokens in (256, 4096):
        assert PCX.forward_flops(p, tokens) == JC.forward_flops(j, tokens)
        assert PCX.train_step_flops(p, tokens) \
            == JC.train_step_flops(j, tokens)
        assert PCX.model_flops_6nd(p, tokens) \
            == JC.model_flops_6nd(j, tokens)
        for full in (50, 17, 0):
            assert PCX.run_flops(p, tokens, 50, full) \
                == JC.run_flops(j, tokens, 50, full)


def _tiny_dit():
    cfg = PC.ModelConfig(name="t", num_layers=2, d_model=32, num_heads=2,
                         d_ff=64, num_classes=4, dtype="float32")
    dcfg = PC.DiffusionConfig(num_inference_steps=6, latent_size=4)
    params = PM.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    return cfg, dcfg, PC.SpeCaConfig(tau0=5.0), params


def _bitwise(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            # the NaN "did not draft" sentinel must sit at the same places
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0,
                                       equal_nan=True, msg=k)
        elif isinstance(a[k], dict):
            _bitwise(a[k], b[k])


def test_init_lane_state_is_init_workload_state():
    cfg, dcfg, scfg, _ = _tiny_dit()
    cond = {"labels": torch.tensor([1])}
    x = torch.randn(3, 4, 4, 4, generator=torch.Generator().manual_seed(1))
    for kw in (dict(), dict(x=x, active=True)):
        got = PLS.init_lane_state(cfg, dcfg, scfg, 3, cond, device="cpu",
                                  **kw)
        want = PLS.init_workload_state(
            DiffusionWorkload(cfg, None, dcfg, scfg, device="cpu"), 3,
            cond, **kw)
        _bitwise(got, want)


@pytest.mark.parametrize("depth", [1, 3])
def test_build_lane_step_is_build_workload_step(depth):
    """The reference's names drive the same step: three ticks bitwise
    the workload-step forms (``make_diffusion_workload`` inside)."""
    cfg, dcfg, scfg, params = _tiny_dit()
    cond = {"labels": torch.tensor([1, 2])}
    noise = torch.randn(2, 4, 4, 4, generator=torch.Generator().manual_seed(2))
    wl = make_diffusion_workload(cfg, params, dcfg, scfg, device="cpu")
    assert isinstance(wl, DiffusionWorkload)
    kw = dict(lanes=2, max_draft_depth=depth)
    a = PLS.build_lane_step(cfg, params, dcfg, scfg, device="cpu", **kw)
    b = PLS.build_workload_step(DiffusionWorkload(cfg, params, dcfg, scfg,
                                                  device="cpu"), **kw)
    sa = PLS.init_workload_state(wl, 2, cond, x=noise, active=True)
    sb = PLS.init_workload_state(wl, 2, cond, x=noise, active=True)
    for _ in range(3):
        sa, fa = a(sa)
        sb, fb = b(sb)
        _bitwise(sa, sb)
        _bitwise(fa, fb)


def test_train_launcher_runs_on_cpu(tmp_path):
    """``python -m repro_torch.launch.train --arch qwen1.5-0.5b --reduced
    --steps 3 --device cpu`` exits 0, and ``--ckpt`` writes a checkpoint
    that ``params_from_checkpoint`` reads."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    ck = tmp_path / "ck"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen1.5-0.5b", "--reduced", "--steps", "3", "--device", "cpu",
         "--seq-len", "32", "--ckpt", str(ck)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "step     2 loss" in out.stdout
    from repro_torch.convert import params_from_checkpoint
    params = params_from_checkpoint(str(ck), device="cpu")
    assert params["embed"]["tok"].shape[1] == 256
