"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the Pallas
kernels run as the reference's own tests run them (interpret mode). The
same numpy inputs go through both. Tolerances: the predict to FMA
rounding in f32 (rtol=atol=1e-6; the Pallas kernel and the plain version
may fuse the multiply-add differently) and to one bf16 ulp for bf16
tables; the refresh bitwise; the verify error to rtol=1e-5 (f32 sums in
another order) with identical accept bits. The chain predict like the
predict, and each of its positions bitwise the port's own predict; the
rollback and the ring shift bitwise; the spectral weights to rtol 1e-6
(PyTorch's cos and pow are not XLA's). The scalar-anchor surface: the
predict like the lane predict and bitwise the port's lane predict with
the weights broadcast; the scalar refresh bitwise against the Pallas
kernel (f32 chain, one rounding per plane) in f32 and bf16; the τ-less
verify sums and error to rtol 1e-5. Flash attention: f32 to
rtol=atol=1e-5 (online against materialised softmax); bf16 within one
bf16 ulp of the f32 result (rtol 2^-8 plus the f32 atol against the
reference run on the same bf16 inputs in f32, rtol 2^-7 against the
reference's own bf16 output, which rounds its own f32 result). The card
kernels' arithmetic, emulated: the bf16 kernel's P split at those
tolerances, the f32 kernel's 3×TF32 products at the card's f32 check
(rtol = atol = 2e-5) on full-mantissa f32 inputs.
``tests/test_torch_cuda.py`` holds the CUDA kernels against the plain
versions on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import forecaster as jfc
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.verify_error import verify_sums as jverify_sums
from repro_torch.core import forecaster as pfc
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
    mask = torch.tensor([True, False])
    ops.taylor_predict_lanes(d, torch.ones(3, 2))
    ops.taylor_update_lanes(d, torch.zeros(2, 2, 2, 4, 8), mask)
    ops.verify_accept(torch.ones(2, 8), torch.ones(2, 8), torch.ones(2))
    ops.verify_accept_mixed(torch.ones(2, 8), torch.ones(2, 8),
                            torch.ones(2), torch.ones(2),
                            torch.tensor([True, True]))
    ops.taylor_predict_chain_lanes(d, torch.ones(3, 4, 2))
    ops.lane_rollback(d, torch.tensor([0, 2], dtype=torch.int32))
    ops.lane_rollback(list(d), torch.tensor([0, 2], dtype=torch.int32))
    ops.spectral_update_lanes(d, torch.zeros(2, 2, 2, 4, 8), mask)
    ops.taylor_predict(d, torch.ones(3))
    ops.taylor_update(d, torch.zeros(2, 2, 2, 4, 8))
    ops.verify_sums(torch.ones(2, 8), torch.ones(2, 8))
    ops.verify_error(torch.ones(2, 8), torch.ones(2, 8))
    q = torch.zeros(1, 8, 2, 16)
    ops.flash_attention(q, q, q)
    # the sharded routings over CPU blocks count nothing either
    from repro_torch.launch.mesh import make_lane_mesh
    mesh = make_lane_mesh(2, device="cpu")
    ops.taylor_predict_lanes_sharded(list(d.split(1, dim=3)),
                                     list(torch.ones(3, 2).split(1, dim=1)),
                                     mesh=mesh)
    assert ops.launch_counts() == {"taylor_predict_lanes": 0,
                                   "taylor_update_lanes": 0,
                                   "verify_accept": 0,
                                   "verify_accept_mixed": 0,
                                   "taylor_predict_chain_lanes": 0,
                                   "lane_rollback": 0,
                                   "spectral_update_lanes": 0,
                                   "taylor_predict": 0,
                                   "taylor_update": 0,
                                   "verify_sums": 0,
                                   "verify_error": 0,
                                   "flash_attention": 0,
                                   "flash_attention_sm90": 0,
                                   **{k: 0 for k in ops.SHARDED_ROUTINGS}}


@pytest.mark.parametrize("case", ["weights_shape", "weights_dtype",
                                  "mask_dtype", "feats_shape", "tau_shape",
                                  "devices", "chain_weights_shape",
                                  "rollback_idx_dtype", "rollback_idx_shape",
                                  "ring_mask_dtype", "scalar_weights_shape",
                                  "scalar_feats_shape", "sums_shape",
                                  "flash_shape"])
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
        elif case == "chain_weights_shape":
            ops.taylor_predict_chain_lanes(d, torch.ones(3, 2))
        elif case == "rollback_idx_dtype":
            ops.lane_rollback(d, torch.tensor([0, 1]))
        elif case == "rollback_idx_shape":
            ops.lane_rollback(d, torch.zeros(3, dtype=torch.int32))
        elif case == "ring_mask_dtype":
            ops.spectral_update_lanes(d, f, torch.tensor([1, 0]))
        elif case == "scalar_weights_shape":
            ops.taylor_predict(d, torch.ones(3, 2))
        elif case == "scalar_feats_shape":
            ops.taylor_update(d, f[:, :, :1])
        elif case == "sums_shape":
            ops.verify_sums(torch.ones(2, 8), torch.ones(2, 9))
        elif case == "flash_shape":
            # unequal head counts: repeat the KV heads first
            ops.flash_attention(torch.zeros(1, 8, 4, 16),
                                torch.zeros(1, 8, 2, 16),
                                torch.zeros(1, 8, 2, 16))
        else:
            ops.taylor_predict_lanes(d, torch.ones(3, 2, device="meta"))


def _chain_weights(m1, K, lanes, seed):
    """[m+1, K, lanes] chain weights with the cold lanes of ``_weights``."""
    return np.stack([_weights(m1, lanes, seed + k) for k in range(K)],
                    axis=1)


@pytest.mark.parametrize("shape", TABLE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1, 3])
def test_chain_predict_plain_matches_pallas(shape, dtype, K):
    d = _table(shape, 5)
    w = _chain_weights(shape[0], K, shape[3], 6)
    dj, dt = _both(d, dtype)
    pj = jops.taylor_predict_chain_lanes(dj, jnp.asarray(w), lane_axis=2)
    pt = ops.taylor_predict_chain_lanes(dt, torch.from_numpy(w),
                                        lane_axis=2)
    assert pt.dtype == dtype and tuple(pt.shape) == (K,) + shape[1:]
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    np.testing.assert_allclose(_np(pt), _np(pj), rtol=tol, atol=tol)
    # position k is bitwise the port's predict with weights[:, k]
    for k in range(K):
        pk = ops.taylor_predict_lanes(dt, torch.from_numpy(w[:, k].copy()))
        assert torch.equal(pt[k], pk), k


@pytest.mark.parametrize("shape", TABLE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rollback_plain_bitwise_matches_pallas(shape, dtype):
    K = 3
    chain = _table((K + 1,) + shape[1:], 7)
    idx = (np.arange(shape[3]) * 2) % (K + 1)           # covers 0..K
    cj, ct = _both(chain, dtype)
    oj = jops.lane_rollback(cj, jnp.asarray(idx), lane_axis=2)
    ot = ops.lane_rollback(ct, torch.from_numpy(idx.astype(np.int32)),
                           lane_axis=2)
    np.testing.assert_array_equal(_np(ot), _np(oj))
    for lane, k in enumerate(idx):
        assert torch.equal(ot[:, :, lane], ct[k][:, :, lane])


def test_rollback_plain_int_leaves_and_clamp():
    """int32 leaves restore bitwise against the reference's oracle (the
    reference sends them through a gather, whose result is the same), and
    an index outside 0..K selects snapshot 0 or K as the where-chain
    does."""
    rng = np.random.default_rng(8)
    chain = rng.integers(-1000, 1000, size=(4, 5, 3, 6)).astype(np.int32)
    idx = np.array([0, 3, 1, 2, 3], np.int32)
    oj = jref.lane_rollback_ref(jnp.asarray(chain), jnp.asarray(idx),
                                lane_axis=0)
    ot = ops.lane_rollback(torch.from_numpy(chain), torch.from_numpy(idx),
                           lane_axis=0)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    wild = torch.tensor([-2, 9, 1, 7, -1], dtype=torch.int32)
    out = ops.lane_rollback(torch.from_numpy(chain), wild, lane_axis=0)
    for lane, k in enumerate([0, 3, 1, 3, 0]):
        assert torch.equal(out[lane], torch.from_numpy(chain[k, lane]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("lane_axis", [0, 2])
def test_rollback_snapshot_list_bitwise_matches_stacked_and_pallas(
        dtype, lane_axis):
    """``ops.lane_rollback`` over a list of K+1 snapshots (the chain step's
    form) is bitwise the restore of the stacked tensor and the JAX
    package's ``lane_rollback`` on the same numpy inputs; indices below 0
    and above K clamp to snapshot 0 and K."""
    K = 3
    rng = np.random.default_rng(13)
    feat = (4, 3, 5, 6) if lane_axis == 0 else (2, 3, 4, 5)    # 4 lanes
    if dtype == torch.int32:
        chain = rng.integers(-1000, 1000, size=(K + 1,) + feat,
                             dtype=np.int32)
        cj, ct = jnp.asarray(chain), torch.from_numpy(chain)
    else:
        cj, ct = _both(rng.normal(size=(K + 1,) + feat)
                       .astype(np.float32), dtype)
    idx = np.array([-2, 3, 1, 7], np.int32)
    it = torch.from_numpy(idx)
    snaps = [ct[k].clone() for k in range(K + 1)]
    out = ops.lane_rollback(snaps, it, lane_axis=lane_axis)
    assert out.dtype == dtype and out.shape == ct.shape[1:]
    assert torch.equal(out, ops.lane_rollback(ct, it, lane_axis=lane_axis))
    np.testing.assert_array_equal(
        _np(out), _np(jops.lane_rollback(cj, jnp.asarray(idx),
                                         lane_axis=lane_axis)))
    for lane, k in enumerate([0, 3, 1, 3]):
        assert torch.equal(out.select(lane_axis, lane),
                           snaps[k].select(lane_axis, lane))
    # a tuple and a generator are sequences too; one snapshot restores
    # itself
    assert torch.equal(ops.lane_rollback(tuple(snaps), it,
                                         lane_axis=lane_axis), out)
    assert torch.equal(ops.lane_rollback((t for t in snaps), it,
                                         lane_axis=lane_axis), out)
    assert torch.equal(ops.lane_rollback(snaps[:1], it, lane_axis=lane_axis),
                       snaps[0])


@pytest.mark.parametrize("case", ["shape", "dtype", "empty", "devices",
                                  "non_contiguous", "not_a_tensor"])
def test_rollback_snapshot_list_rejects_bad_snapshots(case):
    """A snapshot sequence must hold at least one tensor, every snapshot
    of snapshot 0's shape, dtype and device, and contiguous."""
    x = torch.zeros(3, 2, 4, 5)
    snaps = {"shape": [x, x, x[:, :, :3]],
             "dtype": [x, x.to(torch.bfloat16)],
             "empty": [],
             "devices": [x, torch.zeros(3, 2, 4, 5, device="meta")],
             "non_contiguous": [x, x.transpose(2, 3).contiguous()
                                .transpose(2, 3)],
             "not_a_tensor": [x, x.numpy()]}[case]
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises((ValueError, TypeError)):
        ops.lane_rollback(snaps, idx)


def test_workload_rollback_int_and_float_leaves():
    """``Workload.rollback`` restores a float leaf and an integer leaf (lane
    axis 1) through the rollback wrapper, bitwise against the reference's
    kernel oracle and its integer gather
    (``repro.core.workload._gather_rollback``)."""
    from repro.core.workload import _gather_rollback
    from repro_torch.core.workload import Workload
    rng = np.random.default_rng(12)
    x = rng.normal(size=(4, 3, 5)).astype(np.float32)
    tok = rng.integers(0, 50, size=(4, 2, 3, 6)).astype(np.int32)
    n_acc = np.array([0, 3, 2], np.int32)
    wl = Workload()
    wl.dyn_axes = {"x": 0, "tok": 1}
    out = wl.rollback({"x": torch.from_numpy(x), "tok": torch.from_numpy(tok)},
                      torch.from_numpy(n_acc))
    np.testing.assert_array_equal(
        out["x"].numpy(), np.asarray(jref.lane_rollback_ref(
            jnp.asarray(x), jnp.asarray(n_acc), lane_axis=0)))
    assert out["tok"].dtype == torch.int32
    np.testing.assert_array_equal(
        out["tok"].numpy(), np.asarray(_gather_rollback(
            jnp.asarray(tok), jnp.asarray(n_acc), 1)))


@pytest.mark.parametrize("shape", TABLE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask_kind", ["all", "none", "mixed"])
def test_ring_shift_plain_bitwise_matches_pallas(shape, dtype, mask_kind):
    old = _table(shape, 9)
    feats = _table(shape[1:], 10) * 3.0
    lanes = shape[3]
    mask = {"all": np.ones(lanes, bool), "none": np.zeros(lanes, bool),
            "mixed": np.arange(lanes) % 2 == 1}[mask_kind]
    oj, ot = _both(old, dtype)
    fj, ft = _both(feats, dtype)
    nj = jops.spectral_update_lanes(oj, fj, jnp.asarray(mask), lane_axis=2)
    nt = ops.spectral_update_lanes(ot, ft, torch.from_numpy(mask),
                                   lane_axis=2)
    np.testing.assert_array_equal(_np(nt), _np(nj))
    on = _np(ot)
    for lane in range(lanes):
        got = _np(nt)[:, :, :, lane]
        if mask[lane]:
            np.testing.assert_array_equal(got[0], _np(ft)[:, :, lane])
            np.testing.assert_array_equal(got[1:], on[:-1, :, :, lane])
        else:
            np.testing.assert_array_equal(got, on[:, :, :, lane])


@pytest.mark.parametrize("kind", ["scalar", "lanes", "chain"])
def test_spectral_weights_match_reference(kind):
    rng = np.random.default_rng(11)
    B, K, order = 4, 3, 2
    shape = {"scalar": (), "lanes": (B,), "chain": (K, B)}[kind]
    d = rng.integers(0, 7, size=shape).astype(np.float32)
    gap = (rng.integers(1, 4, size=shape[-1:]) if shape else
           np.array(2)).astype(np.float32)
    n = (np.array([0, 1, 2, 3]) if shape else np.array(3)).astype(np.int32)
    wj = jfc.spectral_weights(order, jnp.asarray(d), jnp.asarray(gap),
                              jnp.asarray(n))
    wt = pfc.spectral_weights(order, torch.from_numpy(d),
                              torch.from_numpy(gap), torch.from_numpy(n))
    assert tuple(wt.shape) == (order + 1,) + shape
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-6,
                               atol=1e-7)
    # τ = 0 reproduces the newest anchor exactly
    w0 = pfc.spectral_weights(order, torch.zeros(()), torch.ones(()),
                              torch.tensor(3))
    assert w0.tolist() == pytest.approx([1.0, 0.0, 0.0], abs=1e-7)


SCALAR_SHAPES = [(1, 64), (3, 17), (4, 2, 2, 33, 40), (2, 1000), (5, 8, 128)]


@pytest.mark.parametrize("shape", SCALAR_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scalar_predict_plain_matches_pallas(shape, dtype):
    d = _table(shape, 13)
    w = np.random.default_rng(14).normal(size=shape[0]).astype(np.float32)
    dj, dt = _both(d, dtype)
    pj = jops.taylor_predict(dj, jnp.asarray(w))
    pt = ops.taylor_predict(dt, torch.from_numpy(w))
    assert pt.dtype == dtype and tuple(pt.shape) == shape[1:]
    if dtype == torch.float32:
        # FMA rounding: a few f32 ulps of the largest term |w_i·Δⁱ|
        terms = np.abs(w).reshape((-1,) + (1,) * (d.ndim - 1)) * np.abs(d)
        np.testing.assert_array_less(np.abs(_np(pt) - _np(pj)),
                                     2.0 ** -21 * terms.sum(0) + 1e-30)
    else:
        np.testing.assert_allclose(_np(pt), _np(pj), rtol=2.0 ** -8,
                                   atol=2.0 ** -8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scalar_predict_is_lane_predict_with_broadcast_weights(dtype):
    """The degenerate invariant, bitwise: the scalar predict is the lane
    predict with one weight column broadcast to every lane (the port runs
    the same kernel on a one-lane fold)."""
    feat = (2, 2, 3, 12, 24)
    d = torch.from_numpy(_table((3,) + feat, 15)).to(dtype)
    w = torch.from_numpy(
        np.random.default_rng(16).normal(size=3).astype(np.float32))
    lanes = ops.taylor_predict_lanes(d, w[:, None].expand(3, feat[2])
                                     .contiguous(), lane_axis=2)
    assert torch.equal(ops.taylor_predict(d, w), lanes)


@pytest.mark.parametrize("shape", [(2, 40), (4, 3, 130), (3, 8, 128),
                                   (3, 2, 2, 4, 8, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("feats_f32", [False, True])
def test_scalar_update_plain_bitwise_matches_pallas(shape, dtype, feats_f32):
    """The scalar refresh chains its differences in f32 and rounds once
    per plane, bit for bit the Pallas kernel (f32 subtraction is exact
    and both casts round to nearest even) — also with f32 features into
    a bf16 table, whose Δ¹ starts from the unrounded features."""
    old = _table(shape, 17)
    feats = _table(shape[1:], 18) * 4.0
    oj, ot = _both(old, dtype)
    fj, ft = _both(feats, torch.float32 if feats_f32 else dtype)
    nj = jops.taylor_update(oj, fj)
    nt = ops.taylor_update(ot, ft)
    assert nt.dtype == dtype
    np.testing.assert_array_equal(_np(nt), _np(nj))


def test_scalar_update_is_not_the_lane_refresh_in_bf16():
    """The trap the port keeps apart: in bf16 the scalar kernel's f32
    chain differs from the lane refresh's per-Δ rounding (and from the
    reference's jnp oracle, which rounds like the lane refresh)."""
    shape = (3, 2, 2, 4, 8, 16)
    old = torch.from_numpy(_table(shape, 19)).to(torch.bfloat16)
    feats = torch.from_numpy(_table(shape[1:], 20) * 4.0).to(torch.bfloat16)
    scalar = ops.taylor_update(old, feats)
    lanes = ops.taylor_update_lanes(old, feats,
                                    torch.ones(shape[3], dtype=torch.bool))
    oracle = jref.taylor_update_ref(jnp.asarray(_np(old)).astype(
        jnp.bfloat16), jnp.asarray(_np(feats)).astype(jnp.bfloat16))
    np.testing.assert_array_equal(_np(lanes), _np(oracle))
    assert torch.equal(scalar[:2], lanes[:2])        # Δ⁰ and Δ¹ agree
    assert not torch.equal(scalar[2], lanes[2])      # Δ² does not


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [64, 127, 1000, 4096])
def test_verify_sums_and_error_plain_match_pallas(dtype, n):
    rng = np.random.default_rng(21)
    B = 3
    r = rng.normal(size=(B, n)).astype(np.float32)
    p = r + rng.normal(size=(B, n)).astype(np.float32) \
        * np.array([0.01, 0.3, 1.0], np.float32)[:, None]
    pj, pt = _both(p, dtype)
    rj, rt = _both(r, dtype)
    pad = (-n) % 128                   # the Pallas kernel takes N % 128 == 0
    sj = jverify_sums(jnp.pad(pj, ((0, 0), (0, pad))),
                      jnp.pad(rj, ((0, 0), (0, pad))),
                      block_c=128, interpret=True)
    st = ops.verify_sums(pt, rt)
    assert st.dtype == torch.float32 and tuple(st.shape) == (B, 2)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5)
    ej = jops.verify_error(pj, rj)
    et = ops.verify_error(pt, rt)
    assert et.dtype == torch.float32 and tuple(et.shape) == (B,)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-5)


FLASH_CASES = [(64, 2, 32, True, 0),      # the reference's cases
               (64, 2, 32, True, 16),
               (128, 4, 64, True, 0),
               (64, 2, 32, False, 0),
               (96, 1, 16, True, 8),
               (48, 2, 72, False, 0),     # DiT-XL/2's head dim, bidirectional
               (80, 2, 16, False, 12)]    # a window without causal


def _flash_inputs(s, h, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, s, h, hd)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("s,h,hd,causal,window", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_plain_matches_pallas(s, h, hd, causal, window,
                                              dtype):
    q, k, v = _flash_inputs(s, h, hd, s + hd)
    both = [_both(x, dtype) for x in (q, k, v)]
    jq, jk, jv = (b[0] for b in both)
    tq, tk, tv = (b[1] for b in both)
    kw = dict(causal=causal, window=window)
    oj = jops.flash_attention(jq, jk, jv, **kw)
    ot = ops.flash_attention(tq, tk, tv, **kw)
    assert ot.dtype == dtype and tuple(ot.shape) == (2, s, h, hd)
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(ot), _np(oj), rtol=1e-5, atol=1e-5)
    else:
        # the f32 function of the same bf16 inputs, through the reference
        o32 = _np(jops.flash_attention(*(x.astype(jnp.float32)
                                         for x in (jq, jk, jv)), **kw))
        np.testing.assert_allclose(_np(ot), o32, rtol=2.0 ** -8, atol=1e-5)
        np.testing.assert_allclose(_np(ot), _np(oj), rtol=2.0 ** -7,
                                   atol=1e-5)


def _flash_sm90_emulation(q, k, v, *, causal, window, split=True,
                          block_q=128, block_k=128):
    """The arithmetic of ``csrc/flash_attention_sm90.cu`` in PyTorch on
    bf16-exact f32 operands [B, S, H, hd]: 128-row query tiles that skip
    the key tiles hidden from the whole tile, 128-key tiles, f32 products
    of bf16 values, −1e30 on masked scores (keys past S too), the scale
    folded into exp2 as p = exp2((s − m)·c), P split into bf16 hi and lo
    halves whose two products with V add into one f32 accumulator, and
    l == 0 -> 1 (``split=False`` drops P_lo). Returns the f32 output
    before its rounding to bf16."""
    B, S, H, hd = q.shape
    c = torch.tensor(np.float32(np.log2(np.e)) / np.float32(np.sqrt(hd)))
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    out = torch.zeros(B, H, S, hd)
    for q0 in range(0, S, block_q):
        rows = torch.arange(q0, min(q0 + block_q, S))
        k_hi = rows[-1].item() if causal else S - 1
        k_lo = max(0, q0 - window + 1) if window > 0 else 0
        m = torch.full((B, H, len(rows), 1), ref.NEG_INF)
        l = torch.zeros(B, H, len(rows), 1)
        acc = torch.zeros(B, H, len(rows), hd)
        for k0 in range(k_lo // block_k * block_k, k_hi + 1, block_k):
            keys = torch.arange(k0, k0 + block_k)
            kt = torch.zeros(B, H, block_k, hd)      # zero fill past S
            vt = torch.zeros(B, H, block_k, hd)
            n = min(block_k, S - k0)
            kt[:, :, :n], vt[:, :, :n] = kf[:, :, k0:k0 + n], \
                vf[:, :, k0:k0 + n]
            s = qf[:, :, rows] @ kt.transpose(-1, -2)
            ok = (keys[None, :] < S).expand(len(rows), block_k)
            if causal:
                ok = ok & (keys[None, :] <= rows[:, None])
            if window > 0:
                ok = ok & (rows[:, None] - keys[None, :] < window)
            s = torch.where(ok, s, torch.tensor(ref.NEG_INF))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2((m - m_new) * c)
            p = torch.exp2((s - m_new) * c)
            l = alpha * l + p.sum(-1, keepdim=True)
            p_hi = p.to(torch.bfloat16).float()
            p_lo = (p - p_hi).to(torch.bfloat16).float() if split \
                else torch.zeros_like(p)
            acc = acc * alpha + p_hi @ vt + p_lo @ vt
            m = m_new
        out[:, :, rows] = acc / torch.where(l == 0, torch.ones_like(l), l)
    return out.permute(0, 2, 1, 3)


@pytest.mark.parametrize("s,h,hd,causal,window",
                         FLASH_CASES + [(512, 2, 128, True, 100)])
def test_flash_sm90_arithmetic_meets_the_card_check(s, h, hd, causal,
                                                    window):
    """The bf16 tensor-core kernel's numerics, emulated on the CPU, hold
    the unchanged tolerances against the Pallas kernel (interpret mode):
    one bf16 ulp (rtol 2^-8, atol 1e-5) of the f32 function of the same
    bf16 inputs, rtol 2^-7 of the reference's own bf16 output."""
    q, k, v = _flash_inputs(s, h, hd, s + hd)
    both = [_both(x, torch.bfloat16) for x in (q, k, v)]
    jq, jk, jv = (b[0] for b in both)
    kw = dict(causal=causal, window=window)
    got = _flash_sm90_emulation(*(b[1] for b in both), **kw)
    got = got.to(torch.bfloat16).float().numpy()
    o32 = _np(jops.flash_attention(*(x.astype(jnp.float32)
                                     for x in (jq, jk, jv)), **kw))
    np.testing.assert_allclose(got, o32, rtol=2.0 ** -8, atol=1e-5)
    oj = _np(jops.flash_attention(jq, jk, jv, **kw))
    np.testing.assert_allclose(got, oj, rtol=2.0 ** -7, atol=1e-5)


def test_flash_sm90_emulation_needs_the_split():
    """Rounding P to bf16 once, instead of splitting it, leaves the check:
    without P_lo the emulation falls outside one bf16 ulp of the f32
    function; with it, it stays inside."""
    q, k, v = _flash_inputs(512, 2, 128, 7)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    want = ref.flash_attention_ref(tq.float(), tk.float(), tv.float(),
                                   causal=True)
    kw = dict(causal=True, window=0)
    got = _flash_sm90_emulation(tq, tk, tv, **kw)
    torch.testing.assert_close(got.to(torch.bfloat16).float(), want,
                               rtol=2.0 ** -8, atol=1e-5)
    once = _flash_sm90_emulation(tq, tk, tv, split=False, **kw)
    bad = ~torch.isclose(once.to(torch.bfloat16).float(), want,
                         rtol=2.0 ** -8, atol=1e-5)
    assert bad.float().mean() > 0.01


def _tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds it: to nearest, ties
    away from zero, in the top 19 bits of the f32 pattern."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _flash_tf32_emulation(q, k, v, *, causal, window, split=True,
                          block_q=128):
    """The arithmetic of ``csrc/flash_attention.cu`` in PyTorch on f32
    operands [B, S, H, hd]: 128-row query tiles that skip the key tiles
    hidden from the whole tile, key tiles of 32 (hd 128) or 64, −1e30 on
    masked scores (keys past S too), every product of two f32 values as
    three TF32 products a_hi·b_hi + a_hi·b_lo + a_lo·b_hi into an f32 sum
    (``split=False``: one product of the TF32-rounded values), the scale
    folded into exp2 as p = exp2((s − m)·c), and l == 0 -> 1."""
    B, S, H, hd = q.shape
    block_k = 32 if hd == 128 else 64
    c = torch.tensor(np.float32(np.log2(np.e)) / np.float32(np.sqrt(hd)))

    def mm(a, b):
        if not split:
            return _tf32(a) @ _tf32(b)
        (ah, al), (bh, bl) = _split(a), _split(b)
        return ah @ bl + al @ bh + ah @ bh

    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    out = torch.zeros(B, H, S, hd)
    for q0 in range(0, S, block_q):
        rows = torch.arange(q0, min(q0 + block_q, S))
        k_hi = rows[-1].item() if causal else S - 1
        k_lo = max(0, q0 - window + 1) if window > 0 else 0
        m = torch.full((B, H, len(rows), 1), ref.NEG_INF)
        l = torch.zeros(B, H, len(rows), 1)
        acc = torch.zeros(B, H, len(rows), hd)
        for k0 in range(k_lo // block_k * block_k, k_hi + 1, block_k):
            keys = torch.arange(k0, k0 + block_k)
            kt = torch.zeros(B, H, block_k, hd)      # zero fill past S
            vt = torch.zeros(B, H, block_k, hd)
            n = min(block_k, S - k0)
            kt[:, :, :n], vt[:, :, :n] = kf[:, :, k0:k0 + n], \
                vf[:, :, k0:k0 + n]
            s = mm(qf[:, :, rows], kt.transpose(-1, -2))
            ok = (keys[None, :] < S).expand(len(rows), block_k)
            if causal:
                ok = ok & (keys[None, :] <= rows[:, None])
            if window > 0:
                ok = ok & (rows[:, None] - keys[None, :] < window)
            s = torch.where(ok, s, torch.tensor(ref.NEG_INF))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2((m - m_new) * c)
            p = torch.exp2((s - m_new) * c)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + mm(p, vt)
            m = m_new
        out[:, :, rows] = acc / torch.where(l == 0, torch.ones_like(l), l)
    return out.permute(0, 2, 1, 3)


@pytest.mark.parametrize("s,h,hd,causal,window",
                         FLASH_CASES + [(512, 2, 128, True, 100)])
def test_flash_tf32x3_arithmetic_meets_the_card_check(s, h, hd, causal,
                                                      window):
    """The f32 tensor-core kernel's numerics (3×TF32), emulated on the
    CPU on inputs drawn in f32 (full mantissas, which TF32 does not hold),
    hold the card's f32 tolerance (rtol = atol = 2e-5) against the Pallas
    kernel (interpret mode) on the same inputs."""
    q, k, v = _flash_inputs(s, h, hd, s + hd)
    kw = dict(causal=causal, window=window)
    got = _flash_tf32_emulation(*(torch.from_numpy(x) for x in (q, k, v)),
                                **kw)
    want = _np(jops.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                    **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("s,hd,causal", [(512, 128, True), (256, 72, False)])
def test_flash_tf32_emulation_needs_the_split(s, hd, causal):
    """One TF32 product per f32 product leaves the f32 check: without the
    lo parts the emulation falls outside rtol = atol = 2e-5 of the f32
    function on full-mantissa inputs; with them it stays inside."""
    q, k, v = (torch.from_numpy(x) for x in _flash_inputs(s, 2, hd, 7))
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    kw = dict(causal=causal, window=0)
    torch.testing.assert_close(_flash_tf32_emulation(q, k, v, **kw), want,
                               rtol=2e-5, atol=2e-5)
    once = _flash_tf32_emulation(q, k, v, split=False, **kw)
    bad = ~torch.isclose(once, want, rtol=2e-5, atol=2e-5)
    assert bad.float().mean() > 0.01


@pytest.mark.parametrize("case", ["base", "s_stride", "h_stride"])
def test_flash_tma_strides_reject_misaligned_bf16(case):
    """The bf16 route's TMA maps need a 16-byte-aligned base and strides
    that are multiples of 16 bytes: the wrapper's check raises on the
    rest, on any device, before a launch."""
    big = torch.zeros(2, 8, 4, 72 + 8, dtype=torch.bfloat16)
    t = {"base": big[..., 1:73],                 # base 2 bytes off
         "s_stride": torch.zeros(2, 8, 4 * 72 + 4, dtype=torch.bfloat16)
         [..., :4 * 72].unflatten(2, (4, 72)),   # S stride 580 elements
         "h_stride": torch.zeros(2, 8, 4, 73, dtype=torch.bfloat16)
         [..., :72]}[case]
    with pytest.raises(ValueError, match="16 bytes"):
        ops._tma_strides(t)


def test_flash_tma_strides_of_packed_and_size_one_dims():
    """Packed ``qkv.unbind`` views keep their strides; a dimension of size
    1 takes a dense stride, whatever the view says."""
    qkv = torch.zeros(2, 130, 3, 4, 64, dtype=torch.bfloat16)
    q, _, _ = qkv.unbind(2)
    assert ops._tma_strides(q) == (130 * 3 * 4 * 64, 3 * 4 * 64, 64)
    one = torch.zeros(1, 16, 1, 72, dtype=torch.bfloat16)
    assert ops._tma_strides(one) == (16 * 72, 72, 72)
