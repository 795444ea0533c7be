"""The port's three kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the Pallas
kernels run as the reference's own tests run them (interpret mode). The
same numpy inputs go through both. Tolerances: the predict to FMA
rounding in f32 (rtol=atol=1e-6; the Pallas kernel and the plain version
may fuse the multiply-add differently) and to one bf16 ulp for bf16
tables; the refresh bitwise; the verify error to rtol=1e-5 (f32 sums in
another order) with identical accept bits. ``tests/test_torch_cuda.py``
holds the CUDA kernels against the plain versions on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref

torch.set_num_threads(2)

TABLE_SHAPES = [(3, 2, 2, 3, 5, 7),      # C = 35: not a vector multiple
                (3, 2, 2, 4, 8, 16)]     # C = 128


def _table(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape).astype(np.float32)


def _weights(m1, lanes, seed):
    """Taylor-like weight columns; lane 0 is cold (only order 0 valid) and
    lane 1 fully cold — weights of invalid orders are exactly 0."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.1, 2.0, size=(m1, lanes)).astype(np.float32)
    w[1:, 0] = 0.0
    w[:, 1] = 0.0
    return w


def _both(x, dtype):
    """(jax array, torch tensor) of the same numpy data in ``dtype``."""
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.is_floating_point() \
            else x.numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if jnp.issubdtype(x.dtype, jnp.floating) else np.asarray(x)


@pytest.mark.parametrize("shape", TABLE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_predict_plain_matches_pallas(shape, dtype):
    d = _table(shape, 0)
    w = _weights(shape[0], shape[3], 1)
    dj, dt = _both(d, dtype)
    pj = jops.taylor_predict_lanes(dj, jnp.asarray(w), lane_axis=2)
    pt = ops.taylor_predict_lanes(dt, torch.from_numpy(w), lane_axis=2)
    assert pt.dtype == dtype and tuple(pt.shape) == shape[1:]
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    np.testing.assert_allclose(_np(pt), _np(pj), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", TABLE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_update_plain_bitwise_matches_pallas(shape, dtype):
    old = _table(shape, 2)
    feats = _table(shape[1:], 3) * 4.0
    mask = np.arange(shape[3]) % 2 == 0          # mixed mask
    oj, ot = _both(old, dtype)
    fj, ft = _both(feats, dtype)
    nj = jops.taylor_update_lanes(oj, fj, jnp.asarray(mask), lane_axis=2)
    nt = ops.taylor_update_lanes(ot, ft, torch.from_numpy(mask),
                                 lane_axis=2)
    np.testing.assert_array_equal(_np(nt), _np(nj))
    # lanes outside the mask keep their rows bit for bit
    keep = ~mask
    np.testing.assert_array_equal(_np(nt)[:, :, :, keep],
                                  _np(ot)[:, :, :, keep])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [300, 1024])
def test_verify_plain_matches_pallas(dtype, n):
    rng = np.random.default_rng(4)
    W = 4
    r = rng.normal(size=(W, n)).astype(np.float32)
    p = r + rng.normal(size=(W, n)).astype(np.float32) \
        * np.array([0.01, 0.1, 0.5, 1.0], np.float32)[:, None]
    pj, pt = _both(p, dtype)
    rj, rt = _both(r, dtype)
    err_ref = np.asarray(ref.verify_accept_ref(
        pt, rt, torch.ones(W))[0])
    # thresholds a factor 2 on either side of each lane's error
    tau = (err_ref * np.array([2.0, 0.5, 2.0, 0.5])).astype(np.float32)
    ej, aj = jops.verify_accept(pj, rj, jnp.asarray(tau), eps=1e-8)
    et, at = ops.verify_accept(pt, rt, torch.from_numpy(tau), eps=1e-8)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-5)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert at.dtype == torch.bool and at.numpy().tolist() == \
        [True, False, True, False]


def test_verify_nan_never_accepts():
    p = torch.tensor([[float("nan"), 1.0], [1.0, 1.0]])
    r = torch.ones(2, 2)
    err, acc = ops.verify_accept(p, r, torch.full((2,), 10.0))
    assert np.isnan(err[0].item()) and not acc[0] and acc[1]


def test_cpu_path_does_not_count_launches():
    ops.reset_launch_counts()
    d = torch.zeros(3, 2, 2, 2, 4, 8)
    ops.taylor_predict_lanes(d, torch.ones(3, 2))
    ops.taylor_update_lanes(d, torch.zeros(2, 2, 2, 4, 8),
                            torch.tensor([True, False]))
    ops.verify_accept(torch.ones(2, 8), torch.ones(2, 8), torch.ones(2))
    assert ops.launch_counts() == {"taylor_predict_lanes": 0,
                                   "taylor_update_lanes": 0,
                                   "verify_accept": 0}


@pytest.mark.parametrize("case", ["weights_shape", "weights_dtype",
                                  "mask_dtype", "feats_shape", "tau_shape",
                                  "devices"])
def test_wrappers_reject_bad_arguments(case):
    d = torch.zeros(3, 2, 2, 2, 4, 8)
    f = torch.zeros(2, 2, 2, 4, 8)
    with pytest.raises((ValueError, TypeError)):
        if case == "weights_shape":
            ops.taylor_predict_lanes(d, torch.ones(3, 3))
        elif case == "weights_dtype":
            ops.taylor_predict_lanes(d, torch.ones(3, 2, dtype=torch.float64))
        elif case == "mask_dtype":
            ops.taylor_update_lanes(d, f, torch.tensor([1, 0]))
        elif case == "feats_shape":
            ops.taylor_update_lanes(d, f[:, :, :1], torch.tensor([True,
                                                                  False]))
        elif case == "tau_shape":
            ops.verify_accept(torch.ones(2, 8), torch.ones(2, 8),
                              torch.ones(3))
        else:
            ops.taylor_predict_lanes(d, torch.ones(3, 2, device="meta"))
