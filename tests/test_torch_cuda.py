"""The port's CUDA kernels and engine on a card (marked ``cuda``; each
test skips without a CUDA device — the kernels have no CPU mode).

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine without them:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

Tolerances against the plain PyTorch versions on the same card: the
refresh bitwise; the predict within one bf16 ulp (rtol 2^-8) of the plain
f32 sum, in f32 to FMA rounding (1e-6); the verify error to rtol 1e-5,
accept bits equal wherever |e − τ| > 1e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs as PC
from repro_torch.kernels import ops, ref

SHAPES = [(3, 2, 2, 3, 5, 7),        # C = 35: scalar path, ragged rows
          (3, 2, 2, 4, 8, 16),       # C = 128: one partial block
          (3, 2, 2, 4, 64, 72),      # C = 4608: vector path, full blocks
          (2, 1, 2, 5, 3, 1000),     # m = 1, odd lane count
          (5, 2, 2, 2, 9, 64)]       # m = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(shape, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    m1, W = shape[0], shape[3]
    d = torch.randn(shape, generator=g, device=dev).to(dtype)
    f = torch.randn(shape[1:], generator=g, device=dev).to(dtype)
    w = torch.rand((m1, W), generator=g, device=dev) + 0.1
    w[1:, 0] = 0.0                      # a cold lane: order 0 only
    mask = torch.arange(W, device=dev) % 2 == 1
    return d, f, w, mask


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_card(cuda, shape, dtype):
    d, f, w, mask = _inputs(shape, dtype, cuda)
    ops.reset_launch_counts()
    pk = ops.taylor_predict_lanes(d, w)
    p32 = ref.taylor_predict_lanes_ref(d.float(), w)
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(pk.float(), p32, rtol=tol, atol=1e-6)
    uk = ops.taylor_update_lanes(d, f, mask)
    assert torch.equal(uk, ref.taylor_update_lanes_ref(d, f, mask))
    W = shape[3]
    pred, real = f.reshape(W, -1), (f.float() * 1.1).to(dtype).reshape(W, -1)
    tau = torch.full((W,), 0.05, device=cuda)
    ek, ak = ops.verify_accept(pred, real, tau)
    er, ar = ref.verify_accept_ref(pred, real, tau)
    torch.testing.assert_close(ek, er, rtol=1e-5, atol=0.0)
    far = (er - tau).abs() > 1e-5
    assert torch.equal(ak[far], ar[far])
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"taylor_predict_lanes": 1,
                                   "taylor_update_lanes": 1,
                                   "verify_accept": 1}


@pytest.mark.cuda
def test_verify_is_reproducible_and_mixed_dtypes(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    pred = torch.randn((4, 300_000), generator=g, device=cuda)
    real = pred + 0.1 * torch.randn((4, 300_000), generator=g, device=cuda)
    tau = torch.full((4,), 0.1, device=cuda)
    e1, a1 = ops.verify_accept(pred, real, tau)
    e2, a2 = ops.verify_accept(pred, real, tau)
    assert torch.equal(e1, e2) and torch.equal(a1, a2)
    # a bf16 plane against an f32 plane widens both, exactly
    em, _ = ops.verify_accept(pred.to(torch.bfloat16), real, tau)
    eb, _ = ref.verify_accept_ref(pred.to(torch.bfloat16), real, tau)
    torch.testing.assert_close(em, eb, rtol=1e-5, atol=0.0)


@pytest.mark.cuda
def test_cuda_tensors_never_fall_back(cuda):
    d = torch.zeros((3, 2, 2, 2, 4, 8), dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        ops.taylor_predict_lanes(d, torch.ones((3, 2), device=cuda))
    with pytest.raises(ValueError):
        ops.taylor_predict_lanes(d.float().transpose(1, 2),
                                 torch.ones((3, 2), device=cuda))


@pytest.mark.cuda
def test_engine_lane_width_keeps_trajectories_on_card(cuda):
    """A small f32 DiT served at lanes 1 and 3: identical per-request
    counters (the engine's trajectory-exactness on the card)."""
    from repro_torch.layers.model import init_params
    from repro_torch.serving import Request, SpeCaEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = PC.ModelConfig(name="t", num_layers=2, d_model=64, num_heads=4,
                         d_ff=128, num_classes=10, dtype="float32")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    for grp, k in (("blocks", "mod_w"), ("head", "mod_w"), ("head", "w")):
        t = params[grp][k]
        t.copy_(torch.randn(t.shape, generator=g, device=cuda) * 0.05)
    # keep only the slow sinusoids of the time embedding (see chip_smoke)
    half = cfg.d_model // 2
    freq = torch.exp(-np.log(1e4) * torch.arange(half, device=cuda) / half)
    keep = (50.0 * freq <= 0.2).float()
    params["embed"]["time"]["w1"] *= torch.cat([keep, keep])[:, None]
    dcfg = PC.DiffusionConfig(num_inference_steps=20, latent_size=8)
    engine = SpeCaEngine(cfg, params, dcfg, PC.SpeCaConfig(), device=cuda)
    reqs = [Request(request_id=i, cond={"labels": torch.tensor([i])},
                    seed=i) for i in range(3)]
    ops.reset_launch_counts()
    r3 = engine.serve_batched(reqs, lanes=3)
    assert all(n > 0 for n in ops.launch_counts().values())
    r1 = engine.serve_batched(reqs, lanes=1)
    for a, b in zip(r1, r3):
        assert (a.num_full, a.num_spec, a.accepts) == \
            (b.num_full, b.num_spec, b.accepts)
        torch.testing.assert_close(a.sample, b.sample, rtol=1e-4,
                                   atol=1e-4)
    # two branch syncs per tick: 20 ticks at lanes=3, 3 × 20 at lanes=1
    assert engine.host_syncs == 2 * 20 + 2 * 20 * 3
