"""The port's dense LM decode lanes against the JAX package, on the CPU.

Reduced f32 configurations of llama3-8b (GQA), qwen1.5-0.5b (QKV bias,
tied embeddings), granite-20b (MQA, GELU MLP), qwen2-vl-72b (M-RoPE,
text tokens, and patch embeddings ahead of them) and gemma3-27b (windowed
and global layers mixed: ``reduced`` keeps ``global_every = 2``, window 64,
and window 4 where the window has to bite within a short decode): the
reference's
``init_params`` converted with ``params_from_jax``, with small seeded
noise on the norm weights and the QKV biases (which the reference
initialises to zero) where a layer is held on its own. Held: the rotary,
norm, MLP and decode-attention layers and the LM forward, its cache and
the lane-batched decode step within rtol = atol = 1e-5, the cache writes
exactly (a start past S − n clamped as the reference's); the port's
prefill plus one decode step against its own full forward; greedy
tokens, speculative token and accept trajectories and the engine's
counters and FLOPs equal to the reference's; a depth-3 chain bitwise on
depth 1; the engine's validation, warmup and obs on/off inertness.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SpeCaConfig as JSpeCaConfig
from repro.configs import get_config, reduced
from repro.core import lane_step as JLS
from repro.core.workload import DecodeWorkload as JDecodeWorkload
from repro.layers import attention as jattn
from repro.layers import mlp as jmlp
from repro.layers import model as JM
from repro.layers import norms as jnorms
from repro.layers import rope as jrope
from repro.serving import Request as JRequest
from repro.serving import RequestPolicy as JRequestPolicy
from repro.serving import SpeCaEngine as JEngine
from repro_torch import configs as PC
from repro_torch.convert import params_from_jax
from repro_torch.core import lane_step as PLS
from repro_torch.core.workload import DecodeWorkload
from repro_torch.layers import attention as pattn
from repro_torch.layers import mlp as pmlp
from repro_torch.layers import model as PM
from repro_torch.layers import norms as pnorms
from repro_torch.layers import rope as prope
from repro_torch.serving import (Observability, Request, RequestPolicy,
                                 SpeCaEngine)

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
P, G = 8, 10          # prompt length / new tokens (max_seq_len = P + G)
ARCHS = ["llama3-8b", "qwen1.5-0.5b", "granite-20b", "qwen2-vl-72b",
         "gemma3-27b"]


def port_cfg(ref) -> PC.ModelConfig:
    """The port's ModelConfig with the reference config's values."""
    return PC.ModelConfig(**{f.name: getattr(ref, f.name)
                             for f in dataclasses.fields(PC.ModelConfig)})


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _noisy(params, seed=3):
    """The reference tree with N(0, 0.1²) norm weights and QKV biases."""
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(seed)
    blocks = dict(params["blocks"])
    for k in ("ln1", "ln2", "bq", "bk", "bv"):
        if k in blocks:
            blocks[k] = rng.normal(0, 0.1, blocks[k].shape).astype(np.float32)
    out = dict(params, blocks=blocks)
    out["final_norm"] = rng.normal(0, 0.1, params["final_norm"].shape
                                   ).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _lm(arch, noisy=False, window=None):
    """(reference cfg, reference params, port cfg, port params);
    ``window`` replaces the reduced config's attention window."""
    cfg = reduced(get_config(arch))
    if window is not None:
        cfg = dataclasses.replace(cfg, attn_window=window)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    if noisy:
        params = _noisy(params)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                         device="cpu")
    return cfg, jp, port_cfg(cfg), tp


def _prompt(cfg, seed=7, length=P):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed),
                                         (1, length), 0, cfg.vocab_size),
                      np.int32)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def test_rope_angles_and_apply_match_reference():
    hd, theta = 32, 5e5
    pos = np.array([[0, 3, 17, 100], [5, 6, 7, 8]], np.int32)
    aj = np.asarray(jrope.rope_angles(jnp.asarray(pos), hd, theta))
    ap = prope.rope_angles(torch.from_numpy(pos), hd, theta)
    np.testing.assert_allclose(ap.numpy(), aj, **TOL)
    sections = (hd // 2 - 2 * (hd // 8), hd // 8, hd // 8)
    pos3 = np.stack([pos, pos * 2 + 1, pos // 3], axis=-1).astype(np.int32)
    mj = np.asarray(jrope.mrope_angles(jnp.asarray(pos3), hd, theta,
                                       sections))
    mp = prope.mrope_angles(torch.from_numpy(pos3), hd, theta, sections)
    np.testing.assert_allclose(mp.numpy(), mj, **TOL)
    x = _rand(2, 4, 3, hd, seed=1)
    for ang in (aj, aj[0]):                 # [B, S, half] and [S, half]
        oj = np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(ang)))
        op = prope.apply_rope(torch.from_numpy(x),
                              torch.from_numpy(np.array(ang)))
        np.testing.assert_allclose(op.numpy(), oj, **TOL)


def test_rms_norm_and_swiglu_match_reference():
    x, w = _rand(3, 5, 64, seed=2), _rand(64, seed=3, scale=0.1)
    np.testing.assert_allclose(
        pnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w))), **TOL)
    wg, wu = _rand(64, 96, seed=4, scale=0.1), _rand(64, 96, seed=5,
                                                     scale=0.1)
    wd = _rand(96, 64, seed=6, scale=0.1)
    oj = jmlp.swiglu(*map(jnp.asarray, (x, wg, wu, wd)))
    op = pmlp.swiglu(*map(torch.from_numpy, (x, wg, wu, wd)))
    np.testing.assert_allclose(op.numpy(), np.asarray(oj), **TOL)


@pytest.mark.parametrize("window", [0, 8])
def test_decode_attention_lanes_matches_reference(window):
    """B = 3 lanes at different positions, GQA 4:1; the lane cache write
    is exact and leaves its inputs as they were."""
    B, S, H, KV, hd = 3, 20, 8, 2, 16
    q = _rand(B, 1, H, hd, seed=1)
    kc, vc = _rand(B, S, KV, hd, seed=2), _rand(B, S, KV, hd, seed=3)
    kn, vn = _rand(B, 1, KV, hd, seed=4), _rand(B, 1, KV, hd, seed=5)
    pos = np.array([3, 11, 19], np.int32)
    kj, vj = jattn.update_kv_cache_lanes(*map(jnp.asarray,
                                              (kc, vc, kn, vn, pos)))
    tk, tv = torch.from_numpy(kc), torch.from_numpy(vc)
    kp, vp = pattn.update_kv_cache_lanes(tk, tv, torch.from_numpy(kn),
                                         torch.from_numpy(vn),
                                         torch.from_numpy(pos))
    assert np.array_equal(kp.numpy(), np.asarray(kj))
    assert np.array_equal(vp.numpy(), np.asarray(vj))
    assert np.array_equal(tk.numpy(), kc) and np.array_equal(tv.numpy(), vc)
    oj = jattn.decode_attention_lanes(jnp.asarray(q), kj, vj,
                                      jnp.asarray(pos), window)
    op = pattn.decode_attention_lanes(torch.from_numpy(q), kp, vp,
                                      torch.from_numpy(pos), window)
    np.testing.assert_allclose(op.numpy(), np.asarray(oj), **TOL)


# ---------------------------------------------------------------------------
# The LM forward, the lane-batched decode step, decode consistency
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_and_cache_match_reference(arch):
    cfg, jp, pc, tp = _lm(arch, noisy=True)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 9), 0,
                                         cfg.vocab_size), np.int32)
    lj, ej = JM.lm_forward(cfg, jp, {"tokens": jnp.asarray(toks)},
                           collect_cache=True)
    lp, ep = PM.lm_forward(pc, tp, {"tokens": torch.from_numpy(toks)},
                           collect_cache=True)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(ep["cache"][k].numpy(),
                                   np.asarray(ej["cache"][k]), **TOL)


@pytest.mark.parametrize("collect_cache", [False, True])
def test_vlm_patch_embeds_lead_the_tokens_as_in_reference(collect_cache):
    """A VLM's ``patch_embeds`` go ahead of the token embeddings, and the
    default M-RoPE positions run over the joined length (reduced
    qwen2-vl-72b, tokens 1..6, patch embeddings N(0, 0.5²) [1, 4, d])."""
    cfg, jp, pc, tp = _lm("qwen2-vl-72b")
    toks = np.arange(1, 7, dtype=np.int32)[None]
    patches = _rand(1, 4, cfg.d_model, seed=0, scale=0.5)
    lj, ej = JM.lm_forward(cfg, jp, {"tokens": jnp.asarray(toks),
                                     "patch_embeds": jnp.asarray(patches)},
                           collect_cache=collect_cache)
    lp, ep = PM.lm_forward(pc, tp, {"tokens": torch.from_numpy(toks),
                                    "patch_embeds": torch.from_numpy(patches)},
                           collect_cache=collect_cache)
    assert tuple(lp.shape) == np.asarray(lj).shape == (1, 10, 512)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), **TOL)
    for k in ("k", "v") if collect_cache else ():
        np.testing.assert_allclose(ep["cache"][k].numpy(),
                                   np.asarray(ej["cache"][k]), **TOL)
    # the patches change what the text positions see
    alone, _ = PM.lm_forward(pc, tp, {"tokens": torch.from_numpy(toks)})
    assert (lp[:, 4:] - alone).abs().max() > 1e-3


@pytest.mark.parametrize("n, pos, rows", [(1, 8, [7]), (1, 9, [7]),
                                          (4, 6, [4, 5, 6, 7]),
                                          (2, 3, [3, 4])])
def test_update_kv_cache_clamps_the_start_as_in_reference(n, pos, rows):
    """A write at a position past S − n lands on the last n rows, as
    ``lax.dynamic_update_slice`` clamps its start; the inputs stay."""
    S = 8
    kc, vc = np.zeros((1, S, 2, 4), np.float32), np.zeros((1, S, 2, 4),
                                                          np.float32)
    kn = np.ones((1, n, 2, 4), np.float32)
    vn = 2 * kn
    jk, jv = jattn.update_kv_cache(*(jnp.asarray(a) for a in (kc, vc, kn,
                                                               vn)), pos)
    pk, pv = pattn.update_kv_cache(*(torch.from_numpy(a) for a in (kc, vc,
                                                                   kn, vn)),
                                   pos)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    written = np.flatnonzero(pk.numpy()[0].any(axis=(1, 2)))
    assert written.tolist() == rows
    assert not kc.any() and not vc.any()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_branches_step_matches_reference(arch, masked):
    """Three lanes at different positions over a random cache: logits,
    every cache leaf and the branches; masked = the speculative forward
    (forecast increments, the verify layer real, every layer's cache
    written from the forecast stream)."""
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


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_plus_decode_step_matches_full_forward(arch):
    """The port's prefill of T tokens, its cache handed to
    ``lm_decode_step``, decodes token T+1 as position T of its own full
    forward over T+1 tokens (the bar of tests/test_decode_consistency.py)."""
    _, _, pc, tp = _lm(arch, noisy=True)
    B, T = 2, 17
    toks = torch.from_numpy(np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (B, T + 1), 0, pc.vocab_size), np.int32))
    full, _ = PM.lm_forward(pc, tp, {"tokens": toks})
    _, ex = PM.lm_forward(pc, tp, {"tokens": toks[:, :T]},
                          collect_cache=True)
    dec = PM.init_cache(pc, B, 32, device="cpu")
    for k in dec:
        dec[k][:, :, :T] = ex["cache"][k]
    logits, new = PM.lm_decode_step(pc, tp, toks[:, T:T + 1], dec, T)
    got, want = logits[:, 0].numpy(), full[:, T].numpy()
    assert np.max(np.abs(got - want)) / max(np.abs(want).max(), 1.0) < 5e-4
    assert not dec["k"][:, :, T].any() and new["k"][:, :, T].any()


def test_padding_columns_never_win():
    cfg = dataclasses.replace(reduced(get_config("llama3-8b")),
                              vocab_size=500)
    pc = port_cfg(cfg)
    tp = PM.init_params(pc, torch.Generator().manual_seed(0), device="cpu")
    logits, _ = PM.lm_forward(pc, tp, {"tokens": torch.tensor([[1, 2]])})
    assert logits.shape[-1] == pc.padded_vocab == 512
    assert (logits[..., 500:] == -1e30).all()


@pytest.mark.parametrize("arch", ARCHS + ["granite-moe-1b-a400m",
                                          "mamba2-130m", "hymba-1.5b",
                                          "mixtral-8x7b", "musicgen-medium"])
def test_init_params_layout_matches_reference(arch):
    cfg, _, pc, conv = _lm(arch)
    tp = PM.init_params(pc, torch.Generator().manual_seed(0), device="cpu")

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict)
                else (tuple(v.shape), v.dtype) for k, v in tree.items()}
    assert shapes(tp) == shapes(conv)
    assert not tp["blocks"]["ln1"].any() and not tp["final_norm"].any()
    assert ("head" in tp) == (not cfg.tie_embeddings
                              or cfg.arch_type == "audio")


@pytest.mark.parametrize("arch, match", [
    ("musicgen-medium", "multi-codebook audio"),
    ("mixtral-8x7b", "ring-buffer decode caches"),
    ("llama3-8b+swa", "ring-buffer decode caches")])
def test_decode_workload_rejects_audio_and_ring_as_reference(arch, match):
    """The reference's ``DecodeWorkload`` refuses these configurations with
    these messages; the port's says the same."""
    cfg = reduced(get_config(arch))
    with pytest.raises(ValueError, match=match) as want:
        JDecodeWorkload(cfg, None, JSpeCaConfig(), max_new_tokens=2,
                        max_seq_len=8)
    with pytest.raises(ValueError, match=match) as got:
        DecodeWorkload(port_cfg(cfg), None, PC.SpeCaConfig(),
                       max_new_tokens=2, max_seq_len=8, device="cpu")
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Decode lanes through the lane step and the engine
# ---------------------------------------------------------------------------

def _greedy_ref(cfg, params, prompt, gen, max_len):
    """The reference's plain greedy decode: prefill + ``lm_decode_step``."""
    logits, extras = JM.lm_forward(cfg, params,
                                   {"tokens": jnp.asarray(prompt)},
                                   collect_cache=True)
    dec = JM.init_cache(cfg, 1, max_len)
    n = prompt.shape[1]
    for k in ("k", "v"):
        dec[k] = dec[k].at[:, :, :n].set(extras["cache"][k])
    tok = jnp.argmax(logits[:, -1:], axis=-1)
    step = jax.jit(functools.partial(JM.lm_decode_step, cfg, params))
    out = []
    for pos in range(n, n + gen):
        la, dec = step(tok, dec, pos)
        tok = jnp.argmax(la, axis=-1)
        out.append(int(tok[0, 0]))
    return out


def _engines(arch, tau0, lanes=1, window=None, **kw):
    """(reference engine, port engine) serving decode lanes only."""
    cfg, jp, pc, tp = _lm(arch, window=window)
    jwl = JDecodeWorkload(cfg, jp, JSpeCaConfig(tau0=tau0),
                          max_new_tokens=G, max_seq_len=P + G)
    pwl = DecodeWorkload(pc, tp, PC.SpeCaConfig(tau0=tau0),
                         max_new_tokens=G, max_seq_len=P + G, device="cpu")
    return (JEngine(workloads={"decode": jwl}, lanes=lanes, **kw),
            SpeCaEngine(workloads={"decode": pwl}, lanes=lanes,
                        device="cpu", **kw))


def _reqs(Req, Pol, prompts, **pol):
    return [Req(request_id=i, cond={"tokens": p},
                policy=Pol(workload="decode", **pol))
            for i, p in enumerate(prompts)]


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen1.5-0.5b"])
def test_tau0_zero_engine_is_the_reference_greedy_decode(arch):
    cfg, jp, _, _ = _lm(arch)
    prompt = _prompt(cfg)
    want = _greedy_ref(cfg, jp, prompt, G, P + G)
    _, pe = _engines(arch, 0.0)
    res = pe.serve_batched(_reqs(Request, RequestPolicy, [prompt]),
                           lanes=1)[0]
    assert res.workload == "decode" and res.completed
    assert res.num_full == G and res.num_spec == 0
    assert res.sample.dtype == torch.int32
    assert res.sample.tolist() == want


def test_speculative_lifecycle_matches_reference_oracle():
    """τ0 = 5 through submit → result: the tokens and the accept count of
    the reference's raw-step oracle, with accepts."""
    _assert_speculative_tokens_match_oracle("llama3-8b")


def _assert_speculative_tokens_match_oracle(arch, window=None):
    cfg, jp, _, _ = _lm(arch, window=window)
    prompt = _prompt(cfg)
    jwl = JDecodeWorkload(cfg, jp, JSpeCaConfig(tau0=5.0), max_new_tokens=G,
                          max_seq_len=P + G)
    req = _reqs(JRequest, JRequestPolicy, [prompt])[0]
    state = JLS.init_workload_state(jwl, 1, {}, active=True)
    state = jwl.fill_payload(state, 0, req, G)
    step = jax.jit(JLS.build_workload_step(jwl, lanes=1,
                                           verify_backend="fused"))
    n_spec = 0
    while int(state["step"][0]) < G:
        state, flags = step(state)
        n_spec += int(flags["n_spec"][0])
    oracle = np.asarray(state["tokens"][0]).tolist()
    assert n_spec > 0
    _, pe = _engines(arch, 5.0, window=window)
    res = pe.result(pe.submit(_reqs(Request, RequestPolicy, [prompt])[0]))
    assert res.workload == "decode" and res.completed
    assert res.sample.tolist() == oracle
    assert res.num_spec == n_spec and res.num_full + res.num_spec == G
    assert res.flops > 0 and res.draft_accept_rate > 0


@pytest.mark.parametrize("window", [64, 4])
def test_gemma3_windowed_and_global_layers_match_reference(window):
    """Reduced gemma3-27b, layer 0 windowed and layer 1 global: the
    forward's logits and cache on seeded tokens [2, 12], then 12
    ``lm_decode_step``s from an empty cache (logits every step, the cache
    after the last); at window 4 the window cuts into both."""
    cfg, jp, pc, tp = _lm("gemma3-27b", noisy=True, window=window)
    assert [cfg.layer_window(i) for i in range(cfg.num_layers)] \
        == [window, 0]
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 12), 0,
                                         cfg.vocab_size), np.int32)
    lj, ej = JM.lm_forward(cfg, jp, {"tokens": jnp.asarray(toks)},
                           collect_cache=True)
    lp, ep = PM.lm_forward(pc, tp, {"tokens": torch.from_numpy(toks)},
                           collect_cache=True)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(ep["cache"][k].numpy(),
                                   np.asarray(ej["cache"][k]), **TOL)
    cj, cp = JM.init_cache(cfg, 2, 16), PM.init_cache(pc, 2, 16,
                                                      device="cpu")
    step = jax.jit(functools.partial(JM.lm_decode_step, cfg, jp))
    for pos in range(12):
        tok = toks[:, pos:pos + 1]
        la, cj = step(jnp.asarray(tok), cj, pos)
        lb, cp = PM.lm_decode_step(pc, tp, torch.from_numpy(tok), cp, pos)
        np.testing.assert_allclose(lb.numpy(), np.asarray(la), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(cp[k].numpy(), np.asarray(cj[k]), **TOL)


def test_gemma3_engine_tokens_match_reference():
    """Reduced gemma3-27b at window 4 through the engine: τ0 = 0 gives the
    reference's greedy tokens, τ0 = 5 the tokens and accepts of the
    reference's raw-step oracle."""
    cfg, jp, _, _ = _lm("gemma3-27b", window=4)
    prompt = _prompt(cfg)
    want = _greedy_ref(cfg, jp, prompt, G, P + G)
    _, pe = _engines("gemma3-27b", 0.0, window=4)
    res = pe.serve_batched(_reqs(Request, RequestPolicy, [prompt]),
                           lanes=1)[0]
    assert res.completed and res.num_full == G and res.num_spec == 0
    assert res.sample.tolist() == want
    _assert_speculative_tokens_match_oracle("gemma3-27b", window=4)


def test_draft_chain_rollback_bitwise():
    """A depth-3 chain lands bitwise on the depth-1 state — ``tok``,
    ``tokens`` and both caches — in fewer ticks."""
    cfg, _, pc, tp = _lm("llama3-8b")
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
    assert set(wl.dyn_keys) == {"tok", "tokens", "k", "v"}
    for k in wl.dyn_keys:
        assert s1[k].dtype == s3[k].dtype and torch.equal(s1[k], s3[k]), k


def _assert_decode_results_equal(jres, pres):
    for a, b in zip(jres, pres):
        assert b.workload == a.workload == "decode"
        assert b.sample.tolist() == np.asarray(a.sample).tolist()
        assert (b.num_spec, b.num_full, b.num_drafted, b.accepts,
                b.completed) == (a.num_spec, a.num_full, a.num_drafted,
                                 a.accepts, a.completed)
        assert b.flops == pytest.approx(a.flops, rel=1e-12)


def test_decode_engine_matches_reference_ticket_by_ticket():
    """lanes = 2, four requests with prompt lengths 3, 8, 5 and 6 (one
    capped at 7 steps): tokens, counters, FLOPs and accepts per ticket."""
    cfg, _, _, _ = _lm("llama3-8b")
    prompts = [_prompt(cfg, seed=20 + i, length=n)
               for i, n in enumerate((3, 8, 5, 6))]
    je, pe = _engines("llama3-8b", 5.0, lanes=2)
    out = []
    for eng, Req, Pol in ((je, JRequest, JRequestPolicy),
                          (pe, Request, RequestPolicy)):
        reqs = _reqs(Req, Pol, prompts)
        reqs[2] = Req(request_id=2, cond={"tokens": prompts[2]},
                      policy=Pol(workload="decode", max_steps=7))
        tickets = [eng.submit(r) for r in reqs]
        out.append(eng.results(tickets))
    _assert_decode_results_equal(*out)
    assert sum(r.num_spec for r in out[1]) > 0
    assert sum(r.num_full for r in out[1]) > 0
    assert pe.host_syncs > 0


def test_validation_and_warmup():
    cfg, jp, pc, tp = _lm("llama3-8b")
    _, eng = _engines("llama3-8b", 0.0)
    wl = eng.workloads["decode"]
    prompt = _prompt(cfg)
    with pytest.raises(ValueError, match="unknown workload"):
        eng.resolve_policy(Request(request_id=0, cond={},
                                   policy=RequestPolicy(workload="video")))
    with pytest.raises(ValueError, match="unknown workload"):
        eng.submit(Request(request_id=1, cond={"labels": np.array([0])}))
    with pytest.raises(ValueError, match="guided"):
        eng.resolve_policy(Request(
            request_id=2, cond={"tokens": prompt},
            policy=RequestPolicy(workload="decode", guidance_scale=2.0)))
    with pytest.raises(ValueError, match="does not match"):
        SpeCaEngine(workloads={"llm": wl}, device="cpu")
    with pytest.raises(ValueError, match="at least one workload"):
        SpeCaEngine(device="cpu")
    with pytest.raises(ValueError, match="guidance=True"):
        SpeCaEngine(workloads={"decode": wl}, guidance=True, device="cpu")
    dit = port_cfg(reduced(get_config("dit-xl2")))
    scfg = PC.SpeCaConfig(tau0=0.0)
    with pytest.raises(ValueError, match="autoregressive"):
        DecodeWorkload(dit, None, scfg, max_new_tokens=4, max_seq_len=8,
                       device="cpu")
    with pytest.raises(ValueError, match="max_new_tokens"):
        DecodeWorkload(pc, tp, scfg, max_new_tokens=0, max_seq_len=8,
                       device="cpu")
    with pytest.raises(ValueError, match="ring"):
        DecodeWorkload(dataclasses.replace(pc, attn_window=4), tp, scfg,
                       max_new_tokens=2, max_seq_len=8, device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.serve_batched(_reqs(Request, RequestPolicy,
                                [np.zeros((1, P + G), np.int32)]), lanes=1)
    with pytest.raises(ValueError, match=r"\[1, P\] prompt"):
        eng.submit(_reqs(Request, RequestPolicy,
                         [np.zeros((2, 3), np.int32)])[0])
    assert not eng._sessions and eng.pending() == 0
    assert not eng._lane_fns
    eng.warmup({"tokens": prompt}, lanes=1, workload="decode")
    assert ("decode", 1, False) in eng._lane_fns
    with pytest.raises(ValueError, match="unknown workload"):
        eng.warmup({"tokens": prompt}, workload="diffusion")


@pytest.mark.parametrize("K", [1, 3])
def test_obs_on_is_bitwise_inert_on_decode(K):
    """Decode lanes at depth K: an ``obs=True`` engine serves bitwise what
    an ``obs=False`` one serves, at equal host syncs, and its lane totals
    agree with the Results; its device waits count one ``fill`` a
    prefill and, with the branch and ``advanced`` reads, add up to the
    host syncs."""
    cfg, _, pc, tp = _lm("llama3-8b")
    prompts = [_prompt(cfg, seed=40 + i, length=4 + i) for i in range(3)]
    out = {}
    for obs in (False, True):
        wl = DecodeWorkload(pc, tp, PC.SpeCaConfig(tau0=5.0),
                            max_new_tokens=G, max_seq_len=P + G,
                            device="cpu")
        eng = SpeCaEngine(workloads={"decode": wl}, lanes=2,
                          max_draft_depth=K, obs=obs, device="cpu")
        tickets = [eng.submit(r) for r in _reqs(
            Request, RequestPolicy, prompts, draft_depth=K)]
        out[obs] = (eng, eng.results(tickets), eng.host_syncs)
    (off, roff, soff), (on, ron, son) = out[False], out[True]
    assert son == soff
    for a, b in zip(roff, ron):
        assert torch.equal(a.sample, b.sample)
        assert (a.accepts, a.num_full, a.num_spec, a.num_drafted,
                a.flops) == (b.accepts, b.num_full, b.num_spec,
                             b.num_drafted, b.flops)
    assert sum(r.num_spec for r in ron) > 0
    assert isinstance(on.obs, Observability)
    snap = {(r["name"], tuple(sorted(r["labels"].items()))): r
            for r in on.metrics_snapshot()}
    lab = (("workload", "decode"),)
    for key, attr in (("n_spec", "num_spec"), ("full", "num_full")):
        assert snap[f"speca_{key}_total", lab]["value"] == sum(
            getattr(r, attr) for r in ron), key
    assert all(e["workload"] == "decode"
               for e in on.obs.recorder.events() if "workload" in e)
    waits = {r["labels"]["reason"]: r["value"]
             for r in snap.values() if r["name"] == "speca_device_waits_total"}
    assert waits["fill"] == len(prompts)
    assert sum(waits.get(k, 0.0) for k in ("draft", "chain", "full",
                                           "advanced", "fill")) == son
    fills = [x for x in on.obs.phases.spans() if x.name == "wait.fill"]
    assert len(fills) == len(prompts)
    assert {x.workload for x in fills} == {"decode"}


@pytest.mark.parametrize("K", [1, 3])
def test_decode_lanes_on_two_shards_match_unsharded(K):
    """Reduced Llama-3-8B decode lanes at D = 2 CPU shards (lanes 4, two a
    shard): every request's tokens, accepts, counters and FLOPs equal the
    unsharded engine's at equal host syncs, at depth 1 and 3; a prefill
    writes only its owning shard's cache slice."""
    from repro_torch.launch.mesh import make_lane_mesh
    from repro_torch.serving import engine as PE
    cfg, _, pc, tp = _lm("llama3-8b")
    prompts = [_prompt(cfg, seed=60 + i, length=3 + i) for i in range(5)]
    out = []
    for mesh in (None, make_lane_mesh(2, device="cpu")):
        wl = DecodeWorkload(pc, tp, PC.SpeCaConfig(tau0=5.0),
                            max_new_tokens=G, max_seq_len=P + G,
                            device="cpu")
        eng = SpeCaEngine(workloads={"decode": wl}, lanes=4,
                          max_draft_depth=K, mesh=mesh, device="cpu")
        res = eng.serve_batched(_reqs(Request, RequestPolicy, prompts,
                                      draft_depth=K), lanes=4)
        out.append((res, eng.host_syncs))
    (want, s0), (got, s1) = out
    assert s1 == s0
    for a, b in zip(want, got):
        assert b.sample.tolist() == a.sample.tolist()
        assert (a.accepts, a.num_full, a.num_spec, a.num_drafted,
                a.flops) == (b.accepts, b.num_full, b.num_spec,
                             b.num_drafted, b.flops)
    assert sum(r.num_spec for r in got) > 0
    assert sum(r.num_full for r in got) > 0
    # one admission into lane 2 (shard 1): shard 0's caches stay zero
    wl = DecodeWorkload(pc, tp, PC.SpeCaConfig(tau0=5.0), max_new_tokens=G,
                        max_seq_len=P + G, device="cpu")
    eng = SpeCaEngine(workloads={"decode": wl}, lanes=4,
                      mesh=make_lane_mesh(2, device="cpu"), device="cpu")
    eng.start(workload="decode")
    sess = eng._sessions["decode"]
    sess.lane_entry[:2] = ["held", "held"]
    eng.submit(_reqs(Request, RequestPolicy, prompts[:1])[0])
    PE._admit_into(eng._sessions, eng._sched)
    assert sess.lane_entry[2] is not None
    s0, s1 = sess.state
    assert not s0["k"].any() and not s0["v"].any()
    assert s1["k"][:, 0].any() and not s1["k"][:, 1].any()
    assert int(s1["pos0"][0]) == prompts[0].shape[1]
