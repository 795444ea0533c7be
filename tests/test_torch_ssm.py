"""The port's Mamba2 SSD mixer, and SSM and hybrid decode, against the JAX
package, on the CPU.

The mixer at reduced widths (numpy-seeded f32 inputs): ``segsum``,
``ssd_chunked`` (two chunks, with and without an initial state),
``causal_conv``, ``softplus`` past 20, ``mamba2_forward`` at T = 37 with
chunk 16 (padded to 48: output, final state and conv tail) and from an
initial state, ``mamba2_decode``, all within rtol = atol = 1e-5. Then
reduced mamba2-130m and hymba-1.5b (the reference's ``reduced``: 2
layers, d 256, state 16, head dim 32, chunk 16; the reference's
``init_params`` converted with ``params_from_jax``, seeded noise on the
norms and conv biases): ``lm_forward`` with its cache, and
``decode_branches_step`` masked and unmasked within 1e-5; the port's
prefill plus one decode step against its own full forward; τ0 = 0 engine
tokens equal to the reference's greedy decode; a depth-3 chain bitwise
on depth 1 on every payload leaf (``ssm_state`` and ``conv_state``
included); the decode engine ticket by ticket against the reference's
(tokens, counters, accepts, FLOPs).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.layers import model as JM
from repro.layers import ssm as jssm
from repro.serving import Request as JRequest
from repro.serving import RequestPolicy as JRequestPolicy
from repro_torch import configs as PC
from repro_torch.convert import params_from_jax
from repro_torch.core import lane_step as PLS
from repro_torch.core.workload import DecodeWorkload
from repro_torch.layers import model as PM
from repro_torch.layers import ssm as pssm
from repro_torch.serving import Request, RequestPolicy, SpeCaEngine
from test_torch_decode import (TOL, G, P, _assert_decode_results_equal,
                               _engines, _prompt, _reqs, port_cfg)

torch.set_num_threads(2)
ARCHS = ["mamba2-130m", "hymba-1.5b"]


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# The mixer
# ---------------------------------------------------------------------------

def test_segsum_and_softplus_match_reference():
    x = _rand(2, 3, 8, seed=1)
    sj, sp = np.asarray(jssm.segsum(jnp.asarray(x))), \
        pssm.segsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isneginf(sj), np.isneginf(sp))
    np.testing.assert_allclose(sp[np.isfinite(sp)], sj[np.isfinite(sj)],
                               **TOL)
    v = np.array([-40.0, -3.0, 0.0, 0.5, 19.0, 20.5, 25.0, 60.0],
                 np.float32)
    np.testing.assert_allclose(pssm.softplus(torch.from_numpy(v)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(v))),
                               rtol=1e-7, atol=0)


def _ssd_inputs(b=2, t=32, h=3, p=8, n=5, seed=0):
    x = _rand(b, t, h, p, seed=seed)
    dA = -np.abs(_rand(b, t, h, seed=seed + 1, scale=0.3))
    B, C = _rand(b, t, n, seed=seed + 2), _rand(b, t, n, seed=seed + 3)
    return x, dA, B, C


@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_chunked_matches_reference(with_init):
    x, dA, B, C = _ssd_inputs()
    init = _rand(2, 3, 8, 5, seed=9) if with_init else None
    yj, sj = jssm.ssd_chunked(*_j(x, dA, B, C), 16,
                              initial_state=None if init is None
                              else jnp.asarray(init))
    yp, sp = pssm.ssd_chunked(*_t(x, dA, B, C), 16,
                              initial_state=None if init is None
                              else torch.from_numpy(init))
    assert yp.dtype == torch.float32 and sp.dtype == torch.float32
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(sp.numpy(), np.asarray(sj), **TOL)


def test_causal_conv_matches_reference():
    x, w, b = _rand(2, 11, 6, seed=1), _rand(4, 6, seed=2), _rand(6, seed=3)
    np.testing.assert_allclose(
        pssm.causal_conv(*_t(x, w, b)).numpy(),
        np.asarray(jssm.causal_conv(*_j(x, w, b))), **TOL)


DI, NS, NH, HP, CH, DM = 64, 8, 4, 16, 16, 32


def _mixer_params(seed=0):
    cc = DI + 2 * NS
    rng = np.random.default_rng(seed)
    return {"w_in": _rand(DM, 2 * DI + 2 * NS + NH, seed=seed, scale=0.2),
            "conv_w": _rand(4, cc, seed=seed + 1, scale=0.5),
            "conv_b": _rand(cc, seed=seed + 2, scale=0.1),
            "A_log": np.log(rng.uniform(1, 16, NH)).astype(np.float32),
            "Dp": np.ones(NH, np.float32),
            "dt_bias": np.log(np.expm1(rng.uniform(1e-3, 1e-1, NH))
                              ).astype(np.float32),
            "ssm_norm": _rand(DI, seed=seed + 3, scale=0.1),
            "w_out": _rand(DI, DM, seed=seed + 4, scale=0.15)}


KW = dict(d_inner=DI, n_state=NS, n_heads=NH, head_dim=HP)


@pytest.mark.parametrize("T, with_init", [(37, False), (37, True),
                                          (32, False), (3, False)])
def test_mamba2_forward_matches_reference(T, with_init):
    """T = 37 pads to 48 (dA = 0 on the padding keeps the final state);
    T = 3 is shorter than the conv (its tail has zeros ahead)."""
    prm = _mixer_params()
    x = _rand(2, T, DM, seed=4)
    init = _rand(2, NH, HP, NS, seed=8, scale=0.5) if with_init else None
    oj = jssm.mamba2_forward({k: jnp.asarray(v) for k, v in prm.items()},
                             jnp.asarray(x), chunk=CH, **KW,
                             initial_state=None if init is None
                             else jnp.asarray(init))
    op = pssm.mamba2_forward({k: torch.from_numpy(v) for k, v in prm.items()},
                             torch.from_numpy(x), chunk=CH, **KW,
                             initial_state=None if init is None
                             else torch.from_numpy(init))
    for a, b in zip(op, oj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_mamba2_decode_matches_reference_and_leaves_its_inputs():
    prm = _mixer_params(seed=3)
    x = _rand(3, 1, DM, seed=5)
    st = _rand(3, NH, HP, NS, seed=6, scale=0.5)
    cv = _rand(3, 4, DI + 2 * NS, seed=7)
    oj = jssm.mamba2_decode({k: jnp.asarray(v) for k, v in prm.items()},
                            *_j(x, st, cv), **KW)
    tst, tcv = _t(st, cv)
    op = pssm.mamba2_decode({k: torch.from_numpy(v) for k, v in prm.items()},
                            torch.from_numpy(x), tst, tcv, **KW)
    assert op[1].dtype == torch.float32
    for a, b in zip(op, oj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert np.array_equal(tst.numpy(), st) and np.array_equal(tcv.numpy(), cv)


# ---------------------------------------------------------------------------
# SSM and hybrid LMs
# ---------------------------------------------------------------------------

def _noisy(params, seed=3):
    """The reference tree with N(0, 0.1²) norm weights and SSD conv
    biases (the reference initialises them to zero)."""
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(seed)
    blocks = dict(params["blocks"])
    for k in ("ln1", "ln2"):
        if k in blocks:
            blocks[k] = rng.normal(0, 0.1, blocks[k].shape).astype(np.float32)
    ssm = dict(blocks["ssm"])
    for k in ("ssm_norm", "conv_b"):
        ssm[k] = rng.normal(0, 0.1, ssm[k].shape).astype(np.float32)
    blocks["ssm"] = ssm
    out = dict(params, blocks=blocks)
    out["final_norm"] = rng.normal(0, 0.1, params["final_norm"].shape
                                   ).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _lm(arch):
    """(reference cfg, reference params, port cfg, port params), noisy."""
    cfg = reduced(get_config(arch))
    params = _noisy(JM.init_params(cfg, jax.random.PRNGKey(0)))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    return cfg, jp, port_cfg(cfg), params_from_jax(params, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_lm_forward_and_cache_match_reference(arch):
    cfg, jp, pc, tp = _lm(arch)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 21), 0,
                                         cfg.vocab_size), np.int32)
    lj, ej = JM.lm_forward(cfg, jp, {"tokens": jnp.asarray(toks)},
                           collect_cache=True)
    lp, ep = PM.lm_forward(pc, tp, {"tokens": torch.from_numpy(toks)},
                           collect_cache=True)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), **TOL)
    assert set(ep["cache"]) == set(ej["cache"]) == set(PM.cache_keys(pc))
    for k, v in ep["cache"].items():
        assert v.dtype == (torch.float32 if k == "ssm_state" else
                           pc.torch_dtype)
        np.testing.assert_allclose(v.numpy(), np.asarray(ej["cache"][k]),
                                   **TOL)


def _cache(pc, B, S, seed=11):
    cache = {k: v.numpy() for k, v in
             PM.init_cache(pc, B, S, device="cpu").items()}
    return {k: _rand(*v.shape, seed=seed + i, scale=0.5)
            for i, (k, v) in enumerate(sorted(cache.items()))}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_decode_branches_step_matches_reference(arch, masked):
    """Three lanes over a random cache: logits, branches and every cache
    leaf; masked, every layer advances its SSD state from the forecast
    stream (``spec_cache``)."""
    cfg, jp, pc, tp = _lm(arch)
    B, L = 3, cfg.num_layers
    cache = _cache(pc, B, 16)
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
    assert set(cp) == set(cj) == set(cache)
    for k in cache:
        np.testing.assert_allclose(cp[k].numpy(), np.asarray(cj[k]), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_prefill_plus_decode_step_matches_full_forward(arch):
    """The port's prefill of T tokens (its final state and conv tail handed
    to ``lm_decode_step``) decodes token T+1 as position T of its own full
    forward over T+1 tokens."""
    _, _, pc, tp = _lm(arch)
    B, T = 2, 21
    toks = torch.from_numpy(np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (B, T + 1), 0, pc.vocab_size), np.int32))
    full, _ = PM.lm_forward(pc, tp, {"tokens": toks})
    _, ex = PM.lm_forward(pc, tp, {"tokens": toks[:, :T]},
                          collect_cache=True)
    dec = PM.init_cache(pc, B, 32, device="cpu")
    for k in dec:
        if k in ("k", "v"):
            dec[k][:, :, :T] = ex["cache"][k]
        else:
            dec[k] = ex["cache"][k]
    logits, _ = PM.lm_decode_step(pc, tp, toks[:, T:T + 1], dec, T)
    got, want = logits[:, 0].numpy(), full[:, T].numpy()
    assert np.max(np.abs(got - want)) / max(np.abs(want).max(), 1.0) < 5e-4


def _greedy_ref(cfg, params, prompt, gen, max_len):
    """The reference's plain greedy decode: prefill, the prefix's K/V
    scattered and its SSD state taken whole, then ``lm_decode_step``."""
    logits, extras = JM.lm_forward(cfg, params,
                                   {"tokens": jnp.asarray(prompt)},
                                   collect_cache=True)
    cache, n = extras["cache"], prompt.shape[1]
    dec = JM.init_cache(cfg, 1, max_len)
    for k in dec:
        dec[k] = dec[k].at[:, :, :n].set(cache[k]) if k in ("k", "v") \
            else cache[k]
    tok = jnp.argmax(logits[:, -1:], axis=-1)
    step = jax.jit(functools.partial(JM.lm_decode_step, cfg, params))
    out = []
    for pos in range(n, n + gen):
        la, dec = step(tok, dec, pos)
        tok = jnp.argmax(la, axis=-1)
        out.append(int(tok[0, 0]))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_tau0_zero_engine_is_the_reference_greedy_decode(arch):
    cfg, jp, pc, tp = _lm(arch)
    prompt = _prompt(cfg)
    want = _greedy_ref(cfg, jp, prompt, G, P + G)
    wl = DecodeWorkload(pc, tp, PC.SpeCaConfig(tau0=0.0), max_new_tokens=G,
                        max_seq_len=P + G, device="cpu")
    eng = SpeCaEngine(workloads={"decode": wl}, device="cpu")
    res = eng.serve_batched(_reqs(Request, RequestPolicy, [prompt]),
                            lanes=1)[0]
    assert res.completed and res.num_full == G and res.num_spec == 0
    assert res.sample.tolist() == want


@pytest.mark.parametrize("arch", ARCHS)
def test_draft_chain_rollback_bitwise(arch):
    """A depth-3 chain lands bitwise on the depth-1 state — ``tok``,
    ``tokens`` and every cache leaf, the f32 SSD state and the conv state
    included — in fewer ticks."""
    cfg, _, pc, tp = _lm(arch)
    gen = 16
    wl = DecodeWorkload(pc, tp, PC.SpeCaConfig(tau0=5.0),
                        max_new_tokens=gen, max_seq_len=P + gen,
                        device="cpu")
    req = _reqs(Request, RequestPolicy, [_prompt(cfg)])[0]

    def run(depth):
        state = PLS.init_workload_state(wl, 1, {}, active=True)
        state = wl.fill_payload(state, 0, req, gen)
        state["draft_k"][0] = depth
        step = PLS.build_workload_step(wl, lanes=1, verify_backend="fused",
                                       max_draft_depth=depth)
        spec = ticks = 0
        while int(state["step"][0]) < gen:
            state, flags = step(state)
            spec += int(flags["n_spec"][0])
            ticks += 1
        return state, spec, ticks

    s1, spec1, t1 = run(1)
    s3, spec3, t3 = run(3)
    assert spec1 > 0 and spec3 == spec1 and t3 < t1
    keys = {"tok", "tokens", "ssm_state", "conv_state"}
    if pc.has_attention:
        keys |= {"k", "v"}
    assert set(wl.dyn_keys) == keys
    assert s1["ssm_state"].dtype == torch.float32
    for k in wl.dyn_keys:
        assert s1[k].dtype == s3[k].dtype and torch.equal(s1[k], s3[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_decode_engine_matches_reference_ticket_by_ticket(arch):
    """lanes = 2, three requests (prompts 3, 8 and 5 tokens) at τ0 = 5 on
    the reference's own (noise-free) parameters: tokens, counters, accepts
    and FLOPs equal the reference's."""
    cfg = reduced(get_config(arch))
    prompts = [_prompt(cfg, seed=40 + i, length=n)
               for i, n in enumerate((3, 8, 5))]
    je, pe = _engines(arch, 5.0, lanes=2)
    out = []
    for eng, Req, Pol in ((je, JRequest, JRequestPolicy),
                          (pe, Request, RequestPolicy)):
        tickets = [eng.submit(r) for r in _reqs(Req, Pol, prompts)]
        out.append(eng.results(tickets))
    _assert_decode_results_equal(*out)
    assert sum(r.num_spec for r in out[1]) > 0
