"""The port's ring-buffer decode cache and multi-codebook audio LM against
the JAX package, on the CPU.

Ring: the slot write and the ring attention's mask (B = 2, window 8,
positions before, at and past the wrap) within rtol = atol = 1e-5 and
the writes exactly; ``init_cache`` sizes the K/V to the window; reduced
mixtral-8x7b with ``attn_window=8`` (the reference's
``tests/test_ring_cache.py`` setting: 2 sequences of 21 seeded tokens
through ``lm_decode_step`` from position 0, past the window) gives the
reference's logits at every step within 1e-5 and its own full forward's
last position within 2e-3. Audio: ``codebook_embed`` within 1e-5;
reduced musicgen-medium's ``lm_forward`` (its hidden stream and cache
within 1e-5, the logits [B, T, K, V] within rtol 1e-5, atol 1e-4: see
``LOGIT_TOL``) and ``lm_decode_step`` from the prefill's cache.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.layers import attention as jattn
from repro.layers import embeddings as jemb
from repro.layers import model as JM
from repro_torch.convert import params_from_jax
from repro_torch.layers import attention as pattn
from repro_torch.layers import blocks as pblk
from repro_torch.layers import embeddings as pemb
from repro_torch.layers import model as PM
from test_torch_decode import TOL, port_cfg

torch.set_num_threads(2)


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("pos", [3, 7, 8, 13, 30])
def test_ring_write_and_attention_match_reference(pos):
    B, W, H, KV, hd = 2, 8, 4, 2, 16
    kc, vc = _rand(B, W, KV, hd, seed=1), _rand(B, W, KV, hd, seed=2)
    kn, vn = _rand(B, 1, KV, hd, seed=3), _rand(B, 1, KV, hd, seed=4)
    q = _rand(B, 1, H, hd, seed=5)
    kj, vj = jattn.update_kv_cache_ring(*map(jnp.asarray, (kc, vc, kn, vn)),
                                        pos)
    tk, tv = torch.from_numpy(kc), torch.from_numpy(vc)
    kp, vp = pattn.update_kv_cache_ring(tk, tv, torch.from_numpy(kn),
                                        torch.from_numpy(vn), pos)
    assert np.array_equal(kp.numpy(), np.asarray(kj))
    assert np.array_equal(vp.numpy(), np.asarray(vj))
    assert np.array_equal(tk.numpy(), kc) and np.array_equal(tv.numpy(), vc)
    oj = jattn.decode_attention_ring(jnp.asarray(q), kj, vj, pos)
    op = pattn.decode_attention_ring(torch.from_numpy(q), kp, vp, pos)
    np.testing.assert_allclose(op.numpy(), np.asarray(oj), **TOL)


def test_ring_cache_is_the_window():
    for arch, ring in (("mixtral-8x7b", True), ("llama3-8b+swa", True),
                       ("hymba-1.5b", False), ("llama3-8b", False)):
        cfg = port_cfg(get_config(arch))
        assert pblk.uses_ring_cache(cfg) == ring, arch
    pc = port_cfg(reduced(get_config("mixtral-8x7b")))
    cache = PM.init_cache(pc, 1, 512, device="cpu")
    assert cache["k"].shape[2] == pc.attn_window == 64
    assert PM.init_cache(pc, 1, 32, device="cpu")["v"].shape[2] == 32


@functools.lru_cache(maxsize=None)
def _ring_lm():
    cfg = dataclasses.replace(reduced(get_config("mixtral-8x7b")),
                              attn_window=8)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                         device="cpu")
    return cfg, params, port_cfg(cfg), tp


def test_ring_decode_past_the_window_matches_reference():
    cfg, jp, pc, tp = _ring_lm()
    B, T = 2, 20
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (B, T + 1),
                                         0, cfg.vocab_size), np.int32)
    jcache, pcache = JM.init_cache(cfg, B, 32), PM.init_cache(pc, B, 32,
                                                              device="cpu")
    assert pcache["k"].shape[2] == 8
    step = jax.jit(functools.partial(JM.lm_decode_step, cfg, jp))
    for pos in range(T + 1):
        lj, jcache = step(jnp.asarray(toks[:, pos:pos + 1]), jcache, pos)
        lp, pcache = PM.lm_decode_step(
            pc, tp, torch.from_numpy(toks[:, pos:pos + 1]), pcache, pos)
        np.testing.assert_allclose(lp.numpy(), np.asarray(lj), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(pcache[k].numpy(), np.asarray(jcache[k]),
                                   **TOL)
    full, _ = PM.lm_forward(pc, tp, {"tokens": torch.from_numpy(toks)})
    assert (lp[:, 0] - full[:, T]).abs().max() < 2e-3


# ---------------------------------------------------------------------------
# Audio (musicgen-style multi-codebook decode)
# ---------------------------------------------------------------------------

def test_codebook_embed_matches_reference():
    tables = _rand(4, 50, 16, seed=1)
    toks = np.random.default_rng(2).integers(0, 50, (3, 4, 6)).astype(
        np.int32)
    np.testing.assert_allclose(
        pemb.codebook_embed(torch.from_numpy(tables),
                            torch.from_numpy(toks)).numpy(),
        np.asarray(jemb.codebook_embed(jnp.asarray(tables),
                                       jnp.asarray(toks))), **TOL)


@functools.lru_cache(maxsize=None)
def _audio_lm():
    cfg = reduced(get_config("musicgen-medium"))
    params = jax.tree_util.tree_map(np.asarray,
                                    JM.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    blocks = dict(params["blocks"])
    for k in ("ln1", "ln2"):
        blocks[k] = rng.normal(0, 0.1, blocks[k].shape).astype(np.float32)
    params = dict(params, blocks=blocks)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    return cfg, jp, port_cfg(cfg), params_from_jax(params, device="cpu")


# The reference's fan-in rule reads the codebook axis of the [K, d, V]
# audio head, so its weights are N(0, 1/K) and the logits reach ~40: the
# f32 rounding of one 256-term head product is then ~2e-5. The logits are
# held at rtol 1e-5, atol 1e-4; the hidden stream and the caches at 1e-5.
LOGIT_TOL = dict(rtol=1e-5, atol=1e-4)


def test_audio_lm_forward_and_decode_match_reference():
    """Prefill 9 frames of 4 codebooks, then two ``lm_decode_step``s from
    the prefill's cache: the hidden stream and the caches within 1e-5 of
    the reference's, the logits [B, T, 4, V] and [B, 1, 4, V] within
    ``LOGIT_TOL``."""
    cfg, jp, pc, tp = _audio_lm()
    K, T = cfg.num_codebooks, 9
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, K, T + 2)).astype(np.int32)
    ej = JM.embed_inputs(cfg, jp, {"tokens": jnp.asarray(toks[..., :T])})
    ep = PM.embed_inputs(pc, tp, {"tokens": torch.from_numpy(toks[..., :T])})
    np.testing.assert_allclose(
        PM.forward_full(pc, tp, ep["h"], angles=ep["angles"])[0].numpy(),
        np.asarray(JM.forward_full(cfg, jp, ej["h"],
                                   angles=ej["angles"])[0]), **TOL)
    lj, ej = JM.lm_forward(cfg, jp, {"tokens": jnp.asarray(toks[..., :T])},
                           collect_cache=True)
    lp, ep = PM.lm_forward(pc, tp, {"tokens": torch.from_numpy(
        toks[..., :T])}, collect_cache=True)
    assert tuple(lp.shape) == (2, T, K, pc.padded_vocab)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), **LOGIT_TOL)
    jc, pcache = JM.init_cache(cfg, 2, 16), PM.init_cache(pc, 2, 16,
                                                          device="cpu")
    for k in ("k", "v"):
        np.testing.assert_allclose(ep["cache"][k].numpy(),
                                   np.asarray(ej["cache"][k]), **TOL)
        jc[k] = jc[k].at[:, :, :T].set(ej["cache"][k])
        pcache[k][:, :, :T] = ep["cache"][k]
    for pos in (T, T + 1):
        sl = toks[..., pos:pos + 1]
        dj, jc = JM.lm_decode_step(cfg, jp, jnp.asarray(sl), jc, pos)
        dp, pcache = PM.lm_decode_step(pc, tp, torch.from_numpy(sl), pcache,
                                       pos)
        assert tuple(dp.shape) == (2, 1, K, pc.padded_vocab)
        np.testing.assert_allclose(dp.numpy(), np.asarray(dj), **LOGIT_TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(pcache[k].numpy(), np.asarray(jc[k]),
                                   **TOL)
    full, _ = PM.lm_forward(pc, tp, {"tokens": torch.from_numpy(toks)})
    assert (dp[:, 0] - full[:, T + 1]).abs().max() < 2e-3
