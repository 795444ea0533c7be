"""The text- and video-conditioned DiTs (FLUX-like, HunyuanVideo-like)
against the JAX package, on the CPU.

Reduced configurations: ``reduced(get_config("flux-like"))`` and
``reduced(get_config("hunyuan-video-like"))`` at 2 layers, d 256, a
``cond_dim`` of 32 and 4 input channels, 20 rectified-flow steps on 8×8
latents (16 tokens; the video config at 4 frames, 64 tokens). Parameters
are the reference's ``init_params(PRNGKey(0))`` with the random-weight
taming applied to the numpy tree before either package sees it (small
AdaLN noise, a non-zero final layer, and only the timestep sinusoids that
turn at most 0.2 rad a sampler step), then converted by
``params_from_jax``. Conditioning is a seeded text stub [1, 8, 32] of
scale 0.1, as the reference's ``cond_stub_batch``.

Held: ``patchify``/``unpatchify`` on 5-D latents (equal to the
reference's, a round trip), ``latent_shape`` and ``num_tokens``; the
forward with ``cond`` (masked and unmasked) and without it within
rtol = atol = 1e-5; ``speca_sample`` unguided and guided (null = the
zeroed ``cond``), ``serve_batched`` at lanes 1 and 2, a guided request
beside unguided ones, and a depth-3 chain serve of the video config
against the reference under its own bar (``tests/test_lane_step.py``):
identical accept trajectories and counters, latents within 1e-5, verify
errors within rtol 1e-4, with accepts and rejects in every run; the
conversion of ``cond_w``/``cond_b`` bit for bit; γ and the speedup model
against the reference's.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import DiffusionConfig as JDiffusionConfig
from repro.configs import SpeCaConfig as JSpeCaConfig
from repro.configs import get_config, reduced
from repro.core import complexity as JCX
from repro.core import lane_step as JLS
from repro.core.speca import speca_sample as jspeca_sample
from repro.diffusion import pipeline as JPL
from repro.layers import embeddings as jemb
from repro.layers import model as JM
from repro.serving import Request as JRequest
from repro.serving import RequestPolicy as JRequestPolicy
from repro.serving import SpeCaEngine as JEngine
from repro_torch import configs as PC
from repro_torch.convert import params_from_jax
from repro_torch.core import complexity as PCX
from repro_torch.core import lane_step as PLS
from repro_torch.core.speca import speca_sample
from repro_torch.diffusion import pipeline as PPL
from repro_torch.layers import embeddings as pemb
from repro_torch.layers import model as PM
from repro_torch.serving import Request, RequestPolicy, SpeCaEngine

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
COND_DIM, TEXT_TOKENS = 32, 8
ARCHS = {"flux-like": 1, "hunyuan-video-like": 4}      # arch -> frames
TAU0 = 0.4
GS = 3.5


def port_record(cls, ref):
    """The port's record ``cls`` with the reference record's values."""
    return cls(**{f.name: getattr(ref, f.name)
                  for f in dataclasses.fields(cls)})


def _tame(tree, cfg, dcfg, seed=1):
    """The random-weight taming on a numpy tree: AdaLN-Zero leaves and the
    final layer from small seeded noise, and the time MLP's first layer
    restricted to the sinusoids that turn at most 0.2 rad a sampler step
    (else t_emb jumps at random between steps and every draft rejects)."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    tree = jax.tree_util.tree_map(np.array, tree)

    def noise(a, scale):
        return (rng.normal(size=a.shape) * scale).astype(a.dtype)
    b, h = tree["blocks"], tree["head"]
    b["mod_w"] = noise(b["mod_w"], 0.4 / math.sqrt(d))
    b["mod_b"] = noise(b["mod_b"], 0.02)
    h["mod_w"] = noise(h["mod_w"], 0.4 / math.sqrt(d))
    h["mod_b"] = noise(h["mod_b"], 0.02)
    h["w"] = noise(h["w"], 1.0 / math.sqrt(d))
    h["b"] = noise(h["b"], 0.02)
    half = d // 2
    freq = np.exp(-math.log(10_000.0) * np.arange(half, dtype=np.float32)
                  / half)
    dt = dcfg.num_train_timesteps / dcfg.num_inference_steps
    keep = (dt * freq <= 0.2).astype(np.float32)
    tree["embed"]["time"]["w1"] = tree["embed"]["time"]["w1"] \
        * np.concatenate([keep, keep])[:, None]
    return tree


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(reference (cfg, dcfg, params), port (cfg, dcfg, params))."""
    cfg = dataclasses.replace(reduced(get_config(arch)), num_layers=2,
                              cond_dim=COND_DIM, in_channels=4)
    dcfg = JDiffusionConfig(num_inference_steps=20, latent_size=8,
                            schedule="rectified_flow",
                            num_frames=ARCHS[arch])
    tree = _tame(JM.init_params(cfg, jax.random.PRNGKey(0)), cfg, dcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = params_from_jax(tree, device="cpu")
    return ((cfg, dcfg, jp),
            (port_record(PC.ModelConfig, cfg),
             port_record(PC.DiffusionConfig, dcfg), tp))


def _stub(idx, batch=1):
    """A seeded text-embedding stub [batch, 8, 32] of scale 0.1."""
    rng = np.random.default_rng(1000 + idx)
    return (rng.normal(size=(batch, TEXT_TOKENS, COND_DIM)) * 0.1
            ).astype(np.float32)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# Shapes, configs, conversion, cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frames", [1, 3])
def test_patchify_frames_match_reference_and_round_trip(frames):
    lat = np.random.default_rng(frames).normal(
        size=(2, frames, 6, 4, 3) if frames > 1 else (2, 6, 4, 3)
    ).astype(np.float32)
    tj = np.asarray(jemb.patchify(jnp.asarray(lat), 2))
    tp = pemb.patchify(torch.from_numpy(lat), 2)
    assert tuple(tp.shape) == (2, frames * 6, 12)
    np.testing.assert_array_equal(tp.numpy(), tj)
    back = pemb.unpatchify(tp, 2, 6, 4, 3, frames=frames)
    np.testing.assert_array_equal(back.numpy(), lat)
    np.testing.assert_array_equal(
        back.numpy(),
        np.asarray(jemb.unpatchify(jnp.asarray(tj), 2, 6, 4, 3,
                                   frames=frames)))
    if frames > 1:      # frame-major: frame f's tokens are its own patches
        one = pemb.patchify(torch.from_numpy(lat[:, 1]), 2)
        np.testing.assert_array_equal(tp[:, 6:12].numpy(), one.numpy())


@pytest.mark.parametrize("arch", list(ARCHS))
def test_latent_shape_and_num_tokens_match_reference(arch):
    (cfg, dcfg, _), (pcfg, pdcfg, _) = _model(arch)
    for b in (1, 3):
        assert PPL.latent_shape(pcfg, pdcfg, b) == \
            tuple(JPL.latent_shape(cfg, dcfg, b))
    assert PLS.num_tokens(pcfg, pdcfg) == JLS.num_tokens(cfg, dcfg) == \
        16 * ARCHS[arch]
    assert len(PPL.latent_shape(pcfg, pdcfg, 1)) == \
        (5 if ARCHS[arch] > 1 else 4)


@pytest.mark.parametrize("name", ["flux-like", "hunyuan-video-like"])
def test_full_configs_match_reference(name):
    ref = get_config(name)
    port = {"flux-like": PC.FLUX_LIKE,
            "hunyuan-video-like": PC.HUNYUAN_VIDEO_LIKE}[name]
    assert port == port_record(PC.ModelConfig, ref)
    assert (port.d_model, port.num_heads, port.d_ff, port.cond_dim,
            port.in_channels, port.patch_size, port.dtype) == \
        (3072, 24, 12288, 768, 16, 2, "bfloat16")
    assert port.num_layers == {"flux-like": 38,
                               "hunyuan-video-like": 40}[name]
    assert PC.DiffusionConfig().num_frames == \
        JDiffusionConfig().num_frames == 1


@pytest.mark.parametrize("arch", list(ARCHS))
def test_params_from_jax_carries_cond_leaves_bitwise(arch):
    (cfg, _, jp), (_, _, tp) = _model(arch)
    for k in ("cond_w", "cond_b"):
        np.testing.assert_array_equal(tp["embed"][k].numpy(),
                                      np.asarray(jp["embed"][k]))
    assert tuple(tp["embed"]["cond_w"].shape) == (COND_DIM, cfg.d_model)
    # a bf16 tree travels as its raw bits
    bf = {"embed": {k: np.asarray(jp["embed"][k]).astype(jnp.bfloat16)
                    for k in ("patch_w", "patch_b", "cond_w", "cond_b")}
          | {"time": {}}, "blocks": {}, "head": {}}
    got = params_from_jax(bf, device="cpu")["embed"]["cond_w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        bf["embed"]["cond_w"].view(np.int16))


def test_init_params_draws_the_cond_projection():
    _, (pcfg, _, _) = _model("flux-like")
    cfg = dataclasses.replace(pcfg, cond_dim=64, d_model=128, dtype="bfloat16")
    p = PM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    w, b = p["embed"]["cond_w"], p["embed"]["cond_b"]
    assert tuple(w.shape) == (64, 128) and w.dtype == torch.bfloat16
    assert tuple(b.shape) == (128,) and not b.any()
    assert abs(w.float().std().item() - 1 / 8) < 0.01
    no = PM.init_params(dataclasses.replace(cfg, cond_dim=0),
                        torch.Generator().manual_seed(0), device="cpu")
    assert "cond_w" not in no["embed"] and "cond_b" not in no["embed"]


@pytest.mark.parametrize("name", ["dit-xl2", "flux-like",
                                  "hunyuan-video-like"])
def test_gamma_and_speedup_model_match_reference(name):
    """The paper's verification-overhead figures (3.5 %, 1.75 %, 1.67 %):
    the analytic γ at 4096 tokens is the reference's and of the same
    magnitude, and eq. (8) is the reference's."""
    port = {"dit-xl2": PC.DIT_XL2, "flux-like": PC.FLUX_LIKE,
            "hunyuan-video-like": PC.HUNYUAN_VIDEO_LIKE}[name]
    ref = get_config(name)
    g = PCX.gamma(port, 4096)
    assert g == pytest.approx(JCX.gamma(ref, 4096), rel=1e-12)
    assert 1.0 / (2 * port.num_layers) < g < \
        {"dit-xl2": 0.08}.get(name, 0.06)
    for alpha, oh in ((0.85, 0.0), (0.6, 0.01)):
        assert PCX.speedup_model(alpha, g, oh) == pytest.approx(
            JCX.speedup_model(alpha, g, oh), rel=1e-12)


@pytest.mark.parametrize("name", ["dit-xl2", "flux-like",
                                  "hunyuan-video-like"])
def test_cost_model_terms_sum_to_reference(name):
    """The attention-score and modulation terms a forward's bound reads
    apart: 4·T²·d and 12·d² a sample, and with the projections, the MLP,
    the embeddings and the head they sum to the reference's block and glue
    counts."""
    port = {"dit-xl2": PC.DIT_XL2, "flux-like": PC.FLUX_LIKE,
            "hunyuan-video-like": PC.HUNYUAN_VIDEO_LIKE}[name]
    ref = get_config(name)
    T, d = 1024, port.d_model
    p2c = port.patch_size ** 2 * port.in_channels
    assert PCX.attention_score_flops(port, T) == 4.0 * T * T * d
    assert PCX.modulation_flops(port) == 12.0 * d * d
    assert PCX.block_flops(port, T) - PCX.attention_score_flops(port, T) \
        == 8.0 * T * d * d + 4.0 * T * d * port.d_ff
    assert PCX.glue_flops(port, T) - port.num_layers * \
        PCX.modulation_flops(port) == 2.0 * T * d + 4.0 * T * p2c * d
    assert PCX.block_flops(port, T) == JCX.block_flops(ref, T)
    assert PCX.glue_flops(port, T) == JCX.glue_flops(ref, T)


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("case", ["cond", "masked", "no_cond"])
def test_dit_forward_with_cond_matches_reference(arch, case):
    (cfg, dcfg, jp), (pcfg, pdcfg, tp) = _model(arch)
    rng = np.random.default_rng(5)
    B, T = 2, JLS.num_tokens(cfg, dcfg)
    lat = rng.normal(size=JPL.latent_shape(cfg, dcfg, B)).astype(np.float32)
    inp = {"latents": lat, "t": np.array([980.0, 310.0], np.float32)}
    if case != "no_cond":
        inp["cond"] = np.concatenate([_stub(0), _stub(1)])
    kw_j, kw_p = {}, {}
    if case == "masked":
        preds = (rng.normal(size=(cfg.num_layers, 2, B, T, cfg.d_model))
                 * 0.1).astype(np.float32)
        mask = [layer == cfg.num_layers - 1
                for layer in range(cfg.num_layers)]
        kw_j = dict(branch_preds=jnp.asarray(preds),
                    compute_mask=jnp.asarray(mask))
        kw_p = dict(branch_preds=torch.from_numpy(preds), compute_mask=mask)
    oj, ej = JM.dit_forward(cfg, jp, {k: jnp.asarray(v)
                                      for k, v in inp.items()},
                            collect_branches=True, **kw_j)
    op, ep = PM.dit_forward(pcfg, tp, {k: torch.from_numpy(v)
                                       for k, v in inp.items()},
                            collect_branches=True, **kw_p)
    assert tuple(op.shape) == lat.shape
    np.testing.assert_allclose(op.numpy(), np.asarray(oj), **TOL)
    np.testing.assert_allclose(ep["branches"].numpy(),
                               np.asarray(ej["branches"]), **TOL)
    if case == "cond":      # the text stub moves the output
        inp.pop("cond")
        on, _ = PM.dit_forward(pcfg, tp, {k: torch.from_numpy(v)
                                          for k, v in inp.items()})
        assert (on - op).abs().max() > 1e-4


# ---------------------------------------------------------------------------
# The sampler and the engine against the reference
# ---------------------------------------------------------------------------

def _scfgs(tau0=TAU0, max_draft=8):
    kw = dict(taylor_order=2, max_draft=max_draft, tau0=tau0, beta=0.9)
    return JSpeCaConfig(**kw), PC.SpeCaConfig(**kw)


def _assert_sampler_parity(sj, sp, xj, xp):
    for k in ("accept_b", "spec_step", "spec_attempted",
              "per_sample_accepts"):
        np.testing.assert_array_equal(_np(sp[k]), np.asarray(sj[k]), k)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), **TOL)
    ej, ep = np.asarray(sj["err"]), sp["err"].numpy()
    np.testing.assert_array_equal(np.isnan(ep), np.isnan(ej))
    drafted = np.isfinite(ej)
    np.testing.assert_allclose(ep[drafted], ej[drafted], rtol=1e-4)
    acc = sp["accept_b"].numpy()
    assert acc.any() and (drafted & ~acc).any()     # accepts and rejects


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("guided", [False, True])
def test_speca_sample_with_cond_matches_reference(arch, guided):
    (cfg, dcfg, jp), (pcfg, pdcfg, tp) = _model(arch)
    jscfg, pscfg = _scfgs()
    key = jax.random.PRNGKey(11)
    cond = np.concatenate([_stub(2), _stub(3)])
    gs = GS if guided else None
    xj, sj = jax.jit(lambda k: jspeca_sample(
        cfg, jp, dcfg, jscfg, k, {"cond": jnp.asarray(cond)}, 2,
        accept_mode="per_sample", guidance_scale=gs))(key)
    noise = jax.random.normal(key, JPL.latent_shape(cfg, dcfg, 2),
                              jnp.float32)
    xp, sp = speca_sample(pcfg, tp, pdcfg, pscfg,
                          {"cond": torch.from_numpy(cond)}, 2,
                          noise=torch.from_numpy(np.array(noise)),
                          accept_mode="per_sample", guidance_scale=gs,
                          device="cpu")
    assert tuple(xp.shape) == JPL.latent_shape(cfg, dcfg, 2)
    _assert_sampler_parity(sj, sp, xj, xp)


@functools.lru_cache(maxsize=None)
def _engines(arch, kmax=1):
    (cfg, dcfg, jp), (pcfg, pdcfg, tp) = _model(arch)
    jscfg, pscfg = _scfgs()

    def noise_fn(seed):
        return np.asarray(jax.random.normal(
            jax.random.PRNGKey(seed), JPL.latent_shape(cfg, dcfg, 1),
            jnp.float32))
    return (JEngine(cfg, jp, dcfg, jscfg, max_draft_depth=kmax),
            SpeCaEngine(pcfg, tp, pdcfg, pscfg, noise_fn=noise_fn,
                        max_draft_depth=kmax, device="cpu"))


def _requests(n, policies=None):
    """(reference requests, port requests) with seeded text stubs."""
    policies = policies or [{}] * n

    def build(Req, Pol, arr):
        return [Req(request_id=i, cond={"cond": arr(_stub(10 + i))},
                    seed=60 + i, policy=Pol(**policies[i]))
                for i in range(n)]
    return (build(JRequest, JRequestPolicy, jnp.asarray),
            build(Request, RequestPolicy, torch.from_numpy))


def _assert_results_equal(jres, pres, S):
    for a, b in zip(jres, pres):
        assert a.request_id == b.request_id
        assert b.accepts == a.accepts, a.request_id
        assert (b.num_full, b.num_spec, b.num_drafted, b.finish_tick) == \
            (a.num_full, a.num_spec, a.num_drafted, a.finish_tick)
        assert b.flops == a.flops and b.completed
        assert b.num_full + b.num_spec == S
        np.testing.assert_allclose(b.sample.numpy(), np.asarray(a.sample),
                                   **TOL)
    assert sum(r.num_spec for r in pres) > 0
    assert sum(r.num_drafted - r.num_spec for r in pres) > 0


@pytest.mark.parametrize("lanes", [1, 2])
def test_serve_batched_with_cond_matches_reference(lanes):
    (_, dcfg, _), _ = _model("flux-like")
    je, pe = _engines("flux-like")
    jreqs, preqs = _requests(3)
    jres = je.serve_batched(jreqs, lanes=lanes)
    pres = pe.serve_batched(preqs, lanes=lanes)
    _assert_results_equal(jres, pres, dcfg.num_inference_steps)
    assert tuple(pres[0].sample.shape) == (1, 8, 8, 4)


def test_guided_request_beside_unguided_matches_reference():
    """One guided request (null = the zeroed text stub) beside two
    unguided ones at lanes=4; the unguided ones keep their lanes=1
    trajectories."""
    (_, dcfg, _), _ = _model("flux-like")
    je, pe = _engines("flux-like")
    jreqs, preqs = _requests(3, [dict(guidance_scale=GS), {}, {}])
    jres = je.serve_batched(jreqs, lanes=4)
    pres = pe.serve_batched(preqs, lanes=4)
    _assert_results_equal(jres, pres, dcfg.num_inference_steps)
    _, solo = _requests(3)
    alone = pe.serve_batched(solo[1:], lanes=1)
    for a, b in zip(pres[1:], alone):
        assert a.accepts == b.accepts
        np.testing.assert_allclose(a.sample.numpy(), b.sample.numpy(), **TOL)


def test_video_chain_serve_matches_reference():
    """The video config on a depth-3 chain engine (draft depths 3, 1, 3)
    against the reference's; the depth-3 requests keep their depth-1
    trajectories in fewer ticks."""
    (_, dcfg, _), _ = _model("hunyuan-video-like")
    je, pe = _engines("hunyuan-video-like", kmax=3)
    depths = [3, 1, 3]
    jreqs, preqs = _requests(3, [dict(draft_depth=k) for k in depths])
    jres = je.serve_batched(jreqs, lanes=2)
    pres = pe.serve_batched(preqs, lanes=2)
    _assert_results_equal(jres, pres, dcfg.num_inference_steps)
    assert tuple(pres[0].sample.shape) == (1, 4, 8, 8, 4)
    _, flat = _requests(3)
    d1 = pe.serve_batched(flat, lanes=2)
    for a, b in zip(pres, d1):
        assert a.accepts == b.accepts
        np.testing.assert_allclose(a.sample.numpy(), b.sample.numpy(), **TOL)
    assert max(r.finish_tick for r in pres) < \
        max(r.finish_tick for r in d1)
