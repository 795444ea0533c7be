"""The port's mixture-of-experts layers and MoE decode against the JAX
package, on the CPU.

``moe_forward`` at reduced widths (d 64, 4 experts top-2, numpy-seeded
inputs and weights in f32): the output within rtol = atol = 1e-5 at
capacity factor 4.0, at a low factor that really drops slots,
and with tied router logits (duplicated router columns: the lower expert
index wins the tie, as ``lax.top_k`` picks it). Then reduced
granite-moe-1b-a400m and mixtral-8x7b (the reference's ``reduced``: 2
layers, d 256, 4 experts top-2, capacity factor 4.0; the reference's
``init_params`` converted with ``params_from_jax``, seeded noise on the
norms): ``lm_forward`` with its cache and ``decode_branches_step``
masked and unmasked within 1e-5; granite-moe's decode engine ticket by
ticket against the reference's (tokens, counters, FLOPs); the analytic
FLOP counts of every new family equal to the reference's.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import complexity as JC
from repro.layers import model as JM
from repro.layers import moe as jmoe
from repro_torch import configs as PC
from repro_torch.core import complexity as PCX
from repro_torch.layers import model as PM
from repro_torch.layers import moe as pmoe
from repro.serving import Request as JRequest
from repro.serving import RequestPolicy as JRequestPolicy
from repro_torch.serving import Request, RequestPolicy
from test_torch_decode import (TOL, _assert_decode_results_equal, _engines,
                               _lm, _prompt, _reqs, port_cfg)

torch.set_num_threads(2)
D, E, K, F_ = 64, 4, 2, 96


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _moe_params(act="silu", tie=False, seed=0):
    p = {"router": _rand(D, E, seed=seed, scale=D ** -0.5),
         "w_up": _rand(E, D, F_, seed=seed + 1, scale=D ** -0.5),
         "w_down": _rand(E, F_, D, seed=seed + 2, scale=F_ ** -0.5)}
    if act == "silu":
        p["w_gate"] = _rand(E, D, F_, seed=seed + 3, scale=D ** -0.5)
    if tie:
        # experts 0/1 and 2/3 get equal router columns: every token's
        # logits tie in pairs
        p["router"][:, 1] = p["router"][:, 0]
        p["router"][:, 3] = p["router"][:, 2]
    return p


def _both(params, x, **kw):
    yj, _ = jmoe.moe_forward({k: jnp.asarray(v) for k, v in params.items()},
                             jnp.asarray(x), num_experts=E, top_k=K, **kw)
    yp, _ = pmoe.moe_forward({k: torch.from_numpy(v)
                              for k, v in params.items()},
                             torch.from_numpy(x), num_experts=E, top_k=K,
                             **kw)
    return np.asarray(yj), yp.numpy()


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_moe_forward_matches_reference(act):
    params, x = _moe_params(act), _rand(2, 9, D, seed=5)
    yj, yp = _both(params, x, act=act, capacity_factor=4.0)
    np.testing.assert_allclose(yp, yj, **TOL)


def _kept(params, x, cf):
    """Whether each (token, choice) slot of the port's dispatch is kept."""
    xf = torch.from_numpy(x).reshape(-1, D)
    probs = torch.softmax(xf @ torch.from_numpy(params["router"]), -1)
    idx = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[:, :K]
    flat = idx.reshape(-1)
    rank = (torch.cumsum(torch.nn.functional.one_hot(flat, E), 0) - 1
            ).gather(1, flat[:, None])[:, 0]
    return rank < pmoe.capacity(xf.shape[0], K, E, cf)


def test_moe_low_capacity_drops_slots_as_reference():
    """64 tokens at capacity factor 0.1: 8 slots an expert for ~32
    choices, so most slots are dropped; the outputs still agree, and a
    token whose slots were all dropped gets zeros."""
    params, x = _moe_params(), _rand(4, 16, D, seed=6)
    keep = _kept(params, x, 0.1)
    assert pmoe.capacity(64, K, E, 0.1) == 8
    assert (~keep).sum() > 32, "no slot was dropped"
    yj, yp = _both(params, x, capacity_factor=0.1)
    np.testing.assert_allclose(yp, yj, **TOL)
    gone = ~keep.reshape(-1, K).any(dim=1)
    assert gone.any() and not yp.reshape(-1, D)[gone.numpy()].any()
    _, full = _both(params, x, capacity_factor=4.0)
    assert np.abs(full - yp).max() > 1e-2


def test_moe_tied_router_logits_pick_the_lower_expert():
    """Tied logits in pairs (0, 1) and (2, 3): top-2 takes the lower index
    of a tie first, as ``lax.top_k``; gates 0.5 each."""
    params, x = _moe_params(tie=True), _rand(2, 7, D, seed=7)
    yj, yp = _both(params, x, capacity_factor=4.0)
    np.testing.assert_allclose(yp, yj, **TOL)
    xf = torch.from_numpy(x).reshape(-1, D)
    probs = torch.softmax(xf @ torch.from_numpy(params["router"]), -1)
    top = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[:, :K]
    assert torch.equal(top[:, 1] - top[:, 0],
                       torch.ones(14, dtype=torch.long))
    assert set(top[:, 0].tolist()) <= {0, 2}


def test_capacity_rounds_as_reference():
    for n, cf in ((1, 1.25), (4, 1.25), (64, 0.1), (1000, 1.25), (7, 4.0)):
        want = jmoe.round_up(max(int(math.ceil(cf * n * 8 / 32)), 8), 8)
        assert pmoe.capacity(n, 8, 32, cf) == want
    assert pmoe.round_up(13, 8) == jmoe.round_up(13, 8) == 16


# ---------------------------------------------------------------------------
# MoE LMs: granite-moe (tied embeddings) and mixtral (every layer windowed)
# ---------------------------------------------------------------------------

MOE_ARCHS = ["granite-moe-1b-a400m", "mixtral-8x7b"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_lm_forward_and_cache_match_reference(arch):
    cfg, jp, pc, tp = _lm(arch, noisy=True)
    assert pc.is_moe and pc.num_experts == 4 and pc.moe_capacity_factor == 4
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 9), 0,
                                         cfg.vocab_size), np.int32)
    lj, ej = JM.lm_forward(cfg, jp, {"tokens": jnp.asarray(toks)},
                           collect_cache=True)
    lp, ep = PM.lm_forward(pc, tp, {"tokens": torch.from_numpy(toks)},
                           collect_cache=True)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), **TOL)
    assert set(ep["cache"]) == set(ej["cache"]) == {"k", "v"}
    for k in ("k", "v"):
        np.testing.assert_allclose(ep["cache"][k].numpy(),
                                   np.asarray(ej["cache"][k]), **TOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_branches_step_matches_reference(arch, masked):
    cfg, jp, pc, tp = _lm(arch, noisy=True)
    B, S, L = 3, 16, cfg.num_layers
    shape = (L, B, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    cache = {"k": _rand(*shape, seed=11), "v": _rand(*shape, seed=12)}
    tok = np.array([[5], [77], [300]], np.int32)
    pos = np.array([2, 9, 15], np.int32)
    kw_j, kw_p = {}, {}
    if masked:
        preds = _rand(L, 2, B, 1, cfg.d_model, seed=13, scale=0.1)
        mask = [layer == L - 1 for layer in range(L)]
        kw_j = dict(branch_preds=jnp.asarray(preds),
                    compute_mask=jnp.asarray(mask))
        kw_p = dict(branch_preds=torch.from_numpy(preds), compute_mask=mask)
    lj, cj, bj = JM.decode_branches_step(
        cfg, jp, jnp.asarray(tok), {k: jnp.asarray(v) for k, v in
                                    cache.items()},
        jnp.asarray(pos), collect_branches=True, **kw_j)
    lp, cp, bp = PM.decode_branches_step(
        pc, tp, torch.from_numpy(tok), {k: torch.from_numpy(v) for k, v in
                                        cache.items()},
        torch.from_numpy(pos), collect_branches=True, **kw_p)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(bp.numpy(), np.asarray(bj), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(cp[k].numpy(), np.asarray(cj[k]), **TOL)


def test_moe_decode_engine_matches_reference_ticket_by_ticket():
    """granite-moe decode lanes at τ0 = 5, lanes = 2, three requests:
    tokens, counters, accepts and FLOPs equal the reference's."""
    cfg = _lm("granite-moe-1b-a400m")[0]
    prompts = [_prompt(cfg, seed=30 + i, length=n)
               for i, n in enumerate((3, 8, 5))]
    je, pe = _engines("granite-moe-1b-a400m", 5.0, lanes=2)
    out = []
    for eng, Req, Pol in ((je, JRequest, JRequestPolicy),
                          (pe, Request, RequestPolicy)):
        tickets = [eng.submit(r) for r in _reqs(Req, Pol, prompts)]
        out.append(eng.results(tickets))
    _assert_decode_results_equal(*out)
    assert sum(r.num_spec for r in out[1]) > 0
    assert sum(r.num_full for r in out[1]) > 0


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-130m",
                                  "hymba-1.5b", "mixtral-8x7b",
                                  "musicgen-medium", "llama3-8b"])
def test_flop_model_equals_reference(arch):
    """The analytic FLOPs the engine accounts, at the published widths and
    at the reduced ones: equal to the reference's, bit for bit."""
    from repro.configs import reduced
    for cfg in (get_config(arch), reduced(get_config(arch))):
        pc = port_cfg(cfg)
        for kv in (1, 192, 4096):
            assert PCX.decode_forward_flops(pc, kv) == \
                JC.decode_forward_flops(cfg, kv)
            assert PCX.decode_verify_flops(pc, kv) == \
                JC.decode_verify_flops(cfg, kv)
            assert PCX.decode_block_flops(pc, kv) == \
                JC.decode_block_flops(cfg, kv)
        assert PCX.decode_spec_cache_flops(pc) == \
            JC.decode_spec_cache_flops(cfg)
        for t in (1, 128):
            assert PCX.block_flops(pc, t) == JC.block_flops(cfg, t)


def test_configs_match_reference_records():
    """The five new records field for field with the reference's files."""
    for rec in (PC.GRANITE_MOE_1B_A400M, PC.MAMBA2_130M, PC.HYMBA_1_5B,
                PC.MIXTRAL_8X7B, PC.MUSICGEN_MEDIUM):
        assert rec == port_cfg(get_config(rec.name)), rec.name
        ref = get_config(rec.name)
        for prop in ("is_moe", "is_ssm", "is_hybrid", "has_attention",
                     "ssm_d_inner", "resolved_ssm_heads", "padded_vocab",
                     "resolved_head_dim"):
            assert getattr(rec, prop) == getattr(ref, prop), (rec.name, prop)
