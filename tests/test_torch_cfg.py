"""Classifier-free guidance in the port: the kernel surface against the
JAX package, without trained parameters.

The same numpy inputs (seeded) go through both packages. On the CPU the
port's ``ops.verify_accept_mixed`` runs its plain version
(``ref.verify_accept_mixed_ref``) and the reference's Pallas sums kernel
runs in interpret mode. Bars: the mixed planes bitwise the reference's
``_mixed_planes`` (three f32 roundings, no contraction, on both sides);
err within rtol 1e-4 (f32 sums in another order) with equal accept bits
wherever |e − τ| > 1e-5; the port's own pins bitwise — ``paired``
all-False is ``verify_accept``, all-True is ``verify_accept_pairs`` on
both rows of a pair, a mixed mask the per-slot composition.
``guided_output``, ``null_cond_like`` and ``_interleave_cond`` against
the reference's; the lane state's guidance keys and the guidance errors.
The end-to-end guided parity on the trained tiny DiT is in
``tests/test_torch_speca.py``; the kernel's own pins on the card in
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ModelConfig as JModelConfig
from repro.core.speca import _interleave_cond as j_interleave_cond
from repro.diffusion import pipeline as jpipe
from repro.kernels import ops as jops
from repro_torch import configs as PC
from repro_torch.core import lane_step as PLS
from repro_torch.core.speca import _interleave_cond
from repro_torch.core.workload import DiffusionWorkload
from repro_torch.diffusion import pipeline as ppipe
from repro_torch.kernels import ops, ref

torch.set_num_threads(2)

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(W, N, seed):
    """pred/ref planes, τ straddling each row's error, pair-equal scales
    from {1.0, 1.5, 4.0} and a random pair-equal mask (a trailing odd
    lane is never paired, whatever its flag)."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(W, N)).astype(np.float32)
    r = (p + rng.uniform(0.02, 0.2, size=(W, 1))
         * rng.normal(size=(W, N))).astype(np.float32)
    slots = (W + 1) // 2
    gs = np.repeat(rng.choice([1.0, 1.5, 4.0], size=slots),
                   2)[:W].astype(np.float32)
    paired = np.repeat(rng.random(slots) < 0.6, 2)[:W]
    if W >= 2:
        paired[:2] = True                  # at least one guided pair
    tau = rng.uniform(0.02, 0.2, size=W).astype(np.float32)
    return p, r, gs, paired, tau


def _port(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


@pytest.mark.parametrize("W", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_accept_mixed_matches_reference(dtype, W):
    p, r, gs, paired, tau = _inputs(W, 300,
                                    10 * W + int(dtype is torch.bfloat16))
    jd = JDT[dtype]
    ej, aj = jops.verify_accept_mixed(jnp.asarray(p).astype(jd),
                                      jnp.asarray(r).astype(jd),
                                      jnp.asarray(tau), jnp.asarray(gs),
                                      jnp.asarray(paired))
    ep, ap = ops.verify_accept_mixed(_port(p, dtype), _port(r, dtype),
                                     _port(tau), _port(gs),
                                     torch.from_numpy(paired))
    ej, aj = np.asarray(ej), np.asarray(aj)
    np.testing.assert_allclose(ep.numpy(), ej, rtol=1e-4)
    far = np.abs(ej - tau) > 1e-5
    np.testing.assert_array_equal(ap.numpy()[far], aj[far])
    assert ep.dtype == torch.float32 and ap.dtype == torch.bool
    # the planes are the reference's, bit for bit
    pj, rj = jops._mixed_planes(jnp.asarray(p).astype(jd),
                                jnp.asarray(r).astype(jd), jnp.asarray(gs),
                                jnp.asarray(paired))
    pp, rp = ref.mixed_planes_ref(_port(p, dtype), _port(r, dtype),
                                  _port(gs), torch.from_numpy(paired))
    np.testing.assert_array_equal(pp.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(rp.numpy(), np.asarray(rj))
    # a guided pair's rows carry one plane and one decision
    if W >= 2:
        assert torch.equal(pp[0], pp[1]) and ep[0] == ep[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_accept_mixed_reduces_to_both_parents(dtype):
    """As ``tests/test_kernels.py``: ``paired`` all-False is
    ``verify_accept`` bitwise; all-True is ``verify_accept_pairs``, each
    pair's value on both of its rows."""
    W = 6
    p, r, _, _, _ = _inputs(W, 300, 5)
    pt, rt = _port(p, dtype), _port(r, dtype)
    tau = torch.tensor([0.01, 0.2, 0.05, 0.5, 10.0, 0.0])
    gs = torch.tensor([4.0, 4.0, 1.0, 1.0, 7.5, 7.5])
    em, am = ops.verify_accept_mixed(pt, rt, tau, gs,
                                     torch.zeros(W, dtype=torch.bool))
    ev, av = ops.verify_accept(pt, rt, tau)
    assert torch.equal(em, ev) and torch.equal(am, av)
    tau = torch.repeat_interleave(tau[0::2], 2)
    em, am = ops.verify_accept_mixed(pt, rt, tau, gs,
                                     torch.ones(W, dtype=torch.bool))
    ep, ap = ops.verify_accept_pairs(pt, rt, tau[0::2], gs[0::2])
    assert torch.equal(em[0::2], ep) and torch.equal(em[1::2], ep)
    assert torch.equal(am[0::2], ap) and torch.equal(am[1::2], ap)
    # and the pair values are the reference's pair kernel's
    jd = JDT[dtype]
    ej, aj = jops.verify_accept_pairs(jnp.asarray(p).astype(jd),
                                      jnp.asarray(r).astype(jd),
                                      jnp.asarray(tau[0::2].numpy()),
                                      jnp.asarray(gs[0::2].numpy()))
    np.testing.assert_allclose(ep.numpy(), np.asarray(ej), rtol=1e-4)


def test_verify_accept_mixed_composes_per_slot():
    """A mixed mask is the per-slot composition of the two parents, and
    an odd trailing lane is always unpaired (as ``tests/test_kernels.py``)."""
    rng = np.random.default_rng(9)
    W, F = 5, 257
    p = torch.from_numpy(rng.normal(size=(W, F)).astype(np.float32))
    r = p + 0.03 * torch.from_numpy(rng.normal(size=(W, F))
                                    .astype(np.float32))
    tau = torch.tensor([0.05, 0.05, 0.2, 0.02, 0.5])
    gs = torch.tensor([3.0, 3.0, 1.0, 1.0, 1.0])
    paired = torch.tensor([True, True, False, False, True])    # tail: no
    err, ok = ops.verify_accept_mixed(p, r, tau, gs, paired)
    ep, ap = ops.verify_accept_pairs(p[:2], r[:2], tau[:1], gs[:1])
    assert torch.equal(err[:2], ep.repeat(2))
    assert torch.equal(ok[:2], ap.repeat(2))
    el, al = ops.verify_accept(p[2:], r[2:], tau[2:])
    assert torch.equal(err[2:], el) and torch.equal(ok[2:], al)


@pytest.mark.parametrize("case", ["tau_shape", "gscale_dtype",
                                  "paired_dtype", "pairs_odd"])
def test_mixed_verify_rejects_bad_arguments(case):
    p = torch.ones(4, 8)
    tau, gs = torch.ones(4), torch.ones(4)
    paired = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError):
        if case == "tau_shape":
            ops.verify_accept_mixed(p, p, torch.ones(3), gs, paired)
        elif case == "gscale_dtype":
            ops.verify_accept_mixed(p, p, tau, gs.double(), paired)
        elif case == "paired_dtype":
            ops.verify_accept_mixed(p, p, tau, gs, paired.int())
        else:
            ops.verify_accept_pairs(p[:3], p[:3], tau[:1], gs[:1])


@pytest.mark.parametrize("scale", ["scalar", "per_row", "one"])
def test_guided_output_matches_reference(scale):
    rng = np.random.default_rng(3)
    c = rng.normal(size=(3, 4, 4, 2)).astype(np.float32)
    u = rng.normal(size=(3, 4, 4, 2)).astype(np.float32)
    s = {"scalar": 4.0, "one": 1.0,
         "per_row": np.array([1.0, 1.5, 4.0], np.float32)}[scale]
    gj = jpipe.guided_output(jnp.asarray(c), jnp.asarray(u),
                             jnp.asarray(s) if scale == "per_row" else s)
    gp = ppipe.guided_output(torch.from_numpy(c), torch.from_numpy(u),
                             torch.from_numpy(s) if scale == "per_row"
                             else s)
    assert gp.dtype == torch.float32
    np.testing.assert_array_equal(gp.numpy(), np.asarray(gj))
    if scale == "one":                    # u + 1·(c − u) rounds to near c
        np.testing.assert_allclose(gp.numpy(), c, rtol=1e-6, atol=1e-6)


def test_guided_output_of_bf16_streams_is_f32():
    """The reference's promotion: c − u in bf16, then f32."""
    rng = np.random.default_rng(4)
    c, u = rng.normal(size=(2, 8)), rng.normal(size=(2, 8))
    gj = jpipe.guided_output(jnp.asarray(c, jnp.bfloat16),
                             jnp.asarray(u, jnp.bfloat16), 1.5)
    gp = ppipe.guided_output(torch.tensor(c).to(torch.bfloat16),
                             torch.tensor(u).to(torch.bfloat16), 1.5)
    assert gp.dtype == torch.float32 and gj.dtype == jnp.float32
    np.testing.assert_array_equal(gp.numpy(), np.asarray(gj))


def _model_cfgs():
    kw = dict(name="tiny", num_layers=2, d_model=16, num_heads=2, d_ff=32,
              num_classes=5, dtype="float32")
    return (JModelConfig(arch_type="dit", num_kv_heads=2, vocab_size=0,
                         **kw), PC.ModelConfig(**kw))


@pytest.mark.parametrize("null", ["derived", "given"])
def test_interleave_cond_and_null_cond_match_reference(null):
    jcfg, pcfg = _model_cfgs()
    cond = {"labels": np.array([1, 3]),
            "cond": np.arange(6, dtype=np.float32).reshape(2, 3)}
    ncond = None if null == "derived" else \
        {"labels": np.array([4, 4]), "cond": np.ones((2, 3), np.float32)}
    jn = jpipe.null_cond_like(jcfg, {k: jnp.asarray(v)
                                     for k, v in cond.items()})
    pn = ppipe.null_cond_like(pcfg, {k: torch.from_numpy(v)
                                     for k, v in cond.items()})
    for k in cond:
        np.testing.assert_array_equal(pn[k].numpy(), np.asarray(jn[k]))
    jout = j_interleave_cond(
        jcfg, {k: jnp.asarray(v) for k, v in cond.items()},
        None if ncond is None else {k: jnp.asarray(v)
                                    for k, v in ncond.items()}, 2)
    pout = _interleave_cond(
        pcfg, {k: torch.from_numpy(v) for k, v in cond.items()},
        None if ncond is None else {k: torch.from_numpy(v)
                                    for k, v in ncond.items()}, 2)
    for k in cond:
        np.testing.assert_array_equal(pout[k].numpy(), np.asarray(jout[k]))
    # cond rows at 2k, the null (or given) rows at 2k+1
    assert pout["labels"][0::2].tolist() == [1, 3]


def _workload():
    _, pcfg = _model_cfgs()
    return DiffusionWorkload(pcfg, None, PC.DiffusionConfig(
        num_inference_steps=4, latent_size=4), PC.SpeCaConfig(),
        device="cpu")


@pytest.mark.parametrize("guidance", [False, True, "mixed"])
def test_init_workload_state_guidance_keys(guidance):
    st = PLS.init_workload_state(_workload(), 4,
                                 {"labels": torch.tensor([0])},
                                 guidance=guidance)
    if not guidance:
        assert "gscale" not in st and "paired" not in st
        return
    assert st["gscale"].dtype == torch.float32
    assert st["gscale"].tolist() == [1.0] * 4
    assert st["paired"].dtype == torch.bool
    assert st["paired"].tolist() == [guidance is True] * 4


@pytest.mark.parametrize("case", ["odd_lanes_state", "odd_lanes_step",
                                  "unknown_mode", "no_pairing"])
def test_guidance_validation_errors(case):
    """As ``test_guided_validation_errors``: guidance=True packs lane
    pairs, so an odd width raises; so do an unknown mode and a workload
    without pairs."""
    wl = _workload()
    cond = {"labels": torch.tensor([0])}
    match = {"odd_lanes_state": "even", "odd_lanes_step": "even",
             "unknown_mode": "guidance mode",
             "no_pairing": "guided lane pairs"}[case]
    with pytest.raises(ValueError, match=match):
        if case == "odd_lanes_state":
            PLS.init_workload_state(wl, 3, cond, guidance=True)
        elif case == "odd_lanes_step":
            PLS.build_workload_step(wl, lanes=3, guidance=True)
        elif case == "unknown_mode":
            PLS.build_workload_step(wl, lanes=4, guidance="pairs")
        else:
            wl.supports_pairing = False
            PLS.init_workload_state(wl, 4, cond, guidance="mixed")
    # an odd width is fine in the mixed program: its tail lane is unpaired
    PLS.build_workload_step(_workload(), lanes=3, guidance="mixed")


def test_policy_streams():
    from repro_torch.serving import RequestPolicy
    assert RequestPolicy().streams == 1 and not RequestPolicy().guided
    pol = RequestPolicy(guidance_scale=1.5)
    assert pol.guided and pol.streams == 2
