"""The port's LM training against the JAX package, on the CPU:
``lm_loss`` and ``train_step`` over the ten assigned LM architectures'
``reduced()`` configurations (MoE aux, audio, the VLM patch prefix,
SSD), remat on against off, and the MoE load-balance loss. Parameters
and tolerances as ``tests/test_torch_training.py``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED as J_ASSIGNED
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.layers import model as JM
from repro.layers import moe as jmoe
from repro.optim import adamw as JA
from repro.training import lm as JT
from repro_torch.convert import params_from_jax
from repro_torch.layers import moe as pmoe
from repro_torch.optim import adamw as PA
from repro_torch.training import lm as PT
from repro_torch.training.autodiff import value_and_grad
from repro_torch.tree import tree_flatten_with_paths
from test_torch_training import (_assert_first_step_close,
                                 _assert_grads_close, _jax_tree, _jstate,
                                 _noisy, _np_tree, _pstate, port_cfg)

torch.set_num_threads(2)

B_LM, T_LM = 2, 16


def _lm_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    V = cfg.vocab_size
    if cfg.arch_type == "audio":
        toks = rng.integers(0, V, (B_LM, cfg.num_codebooks, T_LM + 1))
        return {"tokens": toks[..., :-1].astype(np.int32),
                "labels": toks[..., 1:].astype(np.int32)}
    if cfg.arch_type == "vlm":
        n_img = 4
        toks = rng.integers(0, V, (B_LM, T_LM - n_img + 1))
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32),
                "patch_embeds": rng.normal(
                    size=(B_LM, n_img, cfg.d_model)).astype(np.float32)}
    toks = rng.integers(0, V, (B_LM, T_LM + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


@pytest.mark.parametrize("arch", sorted(J_ASSIGNED))
def test_lm_loss_and_train_step_match_reference(arch):
    """``lm_loss`` (its CE and MoE aux) and one ``train_step`` of the
    reduced arch: the loss at rtol 1e-5, every gradient leaf within
    1e-4·max|g|, the new parameters as the paper DiTs' step; remat on
    equals off bitwise (loss and gradients)."""
    cfg = jreduced(jget_config(arch))
    pcfg = port_cfg(cfg)
    jp = _noisy(JM.init_params(cfg, jax.random.PRNGKey(0)), seed=1,
                scale=0.02)
    tp = params_from_jax(_np_tree(jp), device="cpu")
    jp = _jax_tree(jp)
    batch = _lm_batch(cfg)
    jb = _jax_tree(batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: JT.lm_loss(cfg, p, jb), has_aux=True))(jp)
    (lp, mp), gp = value_and_grad(lambda p: PT.lm_loss(pcfg, p, tb), tp)
    np.testing.assert_allclose(float(lp), float(lj), rtol=1e-5)
    np.testing.assert_allclose(float(mp["aux"]), float(mj["aux"]),
                               rtol=1e-6)
    if cfg.is_moe:
        assert float(mp["aux"]) > 0
    _assert_grads_close(gp, gj)
    (lo, _), go = value_and_grad(
        lambda p: PT.lm_loss(pcfg, p, tb, remat=False), tp)
    assert torch.equal(lo, lp)
    for (k, a), (_, b) in zip(tree_flatten_with_paths(gp),
                              tree_flatten_with_paths(go)):
        assert torch.equal(a, b), k
    opt = JA.AdamWConfig(lr=1e-3)
    js, jm = jax.jit(lambda s: JT.train_step(cfg, opt, s, jb))(_jstate(jp))
    ps, pm = PT.train_step(pcfg, PA.AdamWConfig(lr=1e-3), _pstate(tp), tb)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    _assert_first_step_close(ps["params"], js["params"], lr=1e-3)


@pytest.mark.parametrize("capacity_factor", [4.0, 0.1])
def test_moe_aux_loss_matches_reference(capacity_factor):
    rng = np.random.default_rng(0)
    E, K, D, F_ = 4, 2, 32, 48
    prm = {"router": rng.normal(0, 0.3, (D, E)).astype(np.float32),
           "w_gate": rng.normal(0, 0.2, (E, D, F_)).astype(np.float32),
           "w_up": rng.normal(0, 0.2, (E, D, F_)).astype(np.float32),
           "w_down": rng.normal(0, 0.2, (E, F_, D)).astype(np.float32)}
    x = rng.normal(size=(2, 9, D)).astype(np.float32)
    kw = dict(num_experts=E, top_k=K, capacity_factor=capacity_factor)
    yj, aj = jmoe.moe_forward(_jax_tree(prm), jnp.asarray(x), **kw)
    yp, ap = pmoe.moe_forward({k: torch.from_numpy(v)
                               for k, v in prm.items()},
                              torch.from_numpy(x), **kw)
    assert ap.dtype == torch.float32 and ap.shape == ()
    np.testing.assert_allclose(float(ap), float(aj), rtol=1e-6)
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
