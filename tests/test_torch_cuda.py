"""The port's CUDA kernels and engine on a card (marked ``cuda``; each
test skips without a CUDA device — the kernels have no CPU mode).

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine without them:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

Tolerances against the plain PyTorch versions on the same card: the
refresh bitwise; the predict within one bf16 ulp (rtol 2^-8) of the plain
f32 sum, in f32 to FMA rounding (1e-6); the verify error to rtol 1e-5,
accept bits equal wherever |e − τ| > 1e-5, and bitwise the same at every
lane width; the chain predict like the
predict and each position bitwise the depth-1 kernel; the rollback (from
a stacked chain or a list of snapshots) and the ring shift bitwise; the
τ-less error one kernel a call, bitwise the fused verify's err. The
mixed guided/unguided verify one kernel a call, its unpaired rows
bitwise ``verify_accept`` on the same planes and its paired rows bitwise
``verify_accept`` on the plain f32 planes (``ref.mixed_planes_ref``),
rtol 1e-5 against its plain version; guided serving keeps its counters
across lane widths; so does serving under the controller, and ``warmup``
loads every kernel library the step launches, so that serving after it
loads none. The lane-sharded routings at D = 2 shards on one card:
bitwise the unsharded kernels, one launch a shard; a non-contiguous block
raises before anything is allocated; a sharded engine keeps the unsharded
engine's counters. The predicts' tile walk at more rows than gridDim.y
took, fewer tiles than SMs, more tiles than resident blocks, m+1 = 1 and
8, a chain past the 12,288 weights the old design staged, an unaligned
table on the element path (bitwise the aligned table's tile walk), and
the launch floor's empty kernel, which writes and counts nothing.
"""
import warnings

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
# the predicts' tile walk (csrc/predict_tiles.cuh: tiles of one row × 2,048
# bytes a plane; a grid of a quarter of the tiles, never fewer blocks than
# fit the SMs: 132 × 16 of 128 threads on an H100)
PREDICT_SHAPES = [(2, 8200, 2, 4, 1, 8),     # R = 65,600 > gridDim.y's cap
                  (3, 1, 2, 2, 1, 4096),     # 16 bf16 tiles: fewer than SMs
                  # 2,652 bf16 / 5,148 f32 tiles, past the resident blocks
                  # and no multiple of the grid; each row's last tile 32 /
                  # 64 bytes (two / four threads live)
                  (3, 26, 2, 3, 8, 2050),
                  (1, 2, 2, 4, 8, 16),       # m+1 = 1
                  (8, 2, 2, 3, 5, 600)]      # m+1 = 8


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
                                   "verify_accept": 1,
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + PREDICT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1, 4])
def test_chain_predict_matches_plain_and_depth1_kernel(cuda, shape, dtype,
                                                       K):
    d, _, _, _ = _inputs(shape, dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    w = torch.rand((shape[0], K, shape[3]), generator=g, device=cuda) + 0.1
    w[1:, :, 0] = 0.0
    ops.reset_launch_counts()
    pk = ops.taylor_predict_chain_lanes(d, w)
    p32 = ref.taylor_predict_chain_lanes_ref(d.float(), w)
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(pk.float(), p32, rtol=tol, atol=1e-6)
    for k in range(K):
        assert torch.equal(pk[k], ops.taylor_predict_lanes(
            d, w[:, k].contiguous())), k
    torch.cuda.synchronize()
    assert ops.launch_counts()["taylor_predict_chain_lanes"] == 1


def _hold_predicts(d, w):
    """The chain predict (w [m+1, K, W]) against its plain version and each
    position bitwise the lane predict, itself against its plain version."""
    tol = 1e-6 if d.dtype == torch.float32 else 2.0 ** -8
    pk = ops.taylor_predict_chain_lanes(d, w)
    torch.testing.assert_close(
        pk.float(), ref.taylor_predict_chain_lanes_ref(d.float(), w),
        rtol=tol, atol=1e-6)
    for k in range(w.shape[1]):
        lk = ops.taylor_predict_lanes(d, w[:, k].contiguous())
        assert torch.equal(pk[k], lk), k
    torch.testing.assert_close(
        lk.float(), ref.taylor_predict_lanes_ref(d.float(), w[:, -1]),
        rtol=tol, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_predict_takes_k_past_the_old_weight_cap_on_card(cuda, dtype):
    """K = 4,100 at m+1 = 3: past the 12,288 weights the parent design
    staged in shared memory; the tile walk reads weights through L1, so
    the wrapper takes any K."""
    d, _, _, _ = _inputs((3, 1, 2, 2, 2, 16), dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    w = torch.rand((3, 4100, 2), generator=g, device=cuda) + 0.1
    ops.reset_launch_counts()
    _hold_predicts(d, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["taylor_predict_chain_lanes"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_predict_unaligned_table_takes_the_element_path_on_card(cuda, dtype):
    """A table one element off a 16-byte boundary (and a ragged C) goes
    through the element path: the same bits as an aligned copy's tile
    walk, position by position."""
    shape = (3, 2, 2, 4, 8, 16)
    d, _, w, _ = _inputs(shape, dtype, cuda)
    buf = torch.empty(d.numel() + 1, dtype=dtype, device=cuda)
    buf[1:] = d.flatten()
    odd = buf[1:].view(shape)
    assert odd.data_ptr() % 16 != 0 and odd.is_contiguous()
    wk = torch.stack([w, w * 0.5], dim=1).contiguous()
    assert torch.equal(ops.taylor_predict_chain_lanes(odd, wk),
                       ops.taylor_predict_chain_lanes(d, wk))
    assert torch.equal(ops.taylor_predict_lanes(odd, w),
                       ops.taylor_predict_lanes(d, w))
    _hold_predicts(odd, wk)
    _hold_predicts(_inputs((3, 2, 2, 3, 5, 7), dtype, cuda)[0],
                   torch.rand((3, 3, 3), device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [None, 4])
def test_predict_launch_floor_writes_and_counts_nothing_on_card(cuda, K):
    d, _, w, _ = _inputs((3, 4, 2, 4, 8, 64), torch.bfloat16, cuda)
    if K is not None:
        w = torch.stack([w] * K, dim=1).contiguous()
    before = d.clone()
    ops.reset_launch_counts()
    ops.predict_launch_floor(d, w)
    torch.cuda.synchronize()
    assert torch.equal(d, before)
    assert not any(ops.launch_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_rollback_bitwise_on_card(cuda, shape, dtype):
    K = 4
    g = torch.Generator(device=cuda).manual_seed(3)
    chain = (torch.randn((K + 1,) + shape[1:], generator=g, device=cuda)
             * 100).to(dtype)
    W = shape[3]
    idx = (torch.arange(W, device=cuda, dtype=torch.int32) * 3) % (K + 1)
    idx[0] = -1                         # clamps to snapshot 0
    out = ops.lane_rollback(chain, idx)
    assert torch.equal(out, ref.lane_rollback_ref(chain, idx, lane_axis=2))
    for lane in range(W):
        k = max(0, min(int(idx[lane]), K))
        assert torch.equal(out[:, :, lane], chain[k][:, :, lane])
    # the serving layout: a latent chain with the lane axis first
    x = torch.randn((K + 1, W, 8, 8, 4), generator=g, device=cuda)
    assert torch.equal(ops.lane_rollback(x, idx, lane_axis=0),
                       ref.lane_rollback_ref(x, idx, lane_axis=0))


# (snapshot shape, dtype, K+1, elements by which snapshots 1..K sit off
# their aligned bases, lane axis): the serving latent (16-byte unit),
# rows of 24, 12, 18 and 15 bytes (8-, 4-, 2- and 1-byte units), bases 4
# bytes off (the unit drops to 4), int32 leaves, a table layout, and
# K+1 = 1, 2, kMaxSnapshots and one more (stacked first)
SNAPSHOT_CASES = [((4, 32, 32, 4), torch.float32, 5, 0, 0),
                  ((4, 3, 2), torch.float32, 5, 0, 0),
                  ((4, 3, 1), torch.float32, 5, 0, 0),
                  ((4, 3, 3), torch.bfloat16, 5, 0, 0),
                  ((4, 5, 3), torch.uint8, 5, 0, 0),
                  ((4, 8, 8), torch.float32, 5, 1, 0),
                  ((4, 9, 16), torch.int32, 5, 0, 0),
                  ((2, 2, 4, 5, 7), torch.bfloat16, 5, 0, 2),
                  ((4, 8, 8), torch.float32, 1, 0, 0),
                  ((4, 8, 8), torch.float32, 2, 0, 0),
                  ((4, 2, 8), torch.float32, 256, 0, 0),
                  ((4, 2, 8), torch.float32, 257, 0, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,n,offset,lane_axis", SNAPSHOT_CASES)
def test_rollback_snapshots_bitwise_on_card(cuda, shape, dtype, n, offset,
                                            lane_axis):
    """The rollback over a list of snapshots (the chain step's form; up to
    kMaxSnapshots read where they lie, more stacked first) is one launch,
    bitwise the plain version and the stacked entry."""
    g = torch.Generator(device=cuda).manual_seed(n)
    numel = int(np.prod(shape))
    size = (n * numel + offset,)
    if dtype.is_floating_point:
        buf = (torch.randn(size, generator=g, device=cuda) * 100).to(dtype)
    else:
        lo, hi = (0, 256) if dtype == torch.uint8 else (-2 ** 30, 2 ** 30)
        buf = torch.randint(lo, hi, size, generator=g, device=cuda,
                            dtype=dtype)
    snaps = [buf[k * numel + (offset if k else 0):][:numel].view(shape)
             for k in range(n)]
    W = shape[lane_axis]
    idx = (torch.arange(W, device=cuda, dtype=torch.int32) * 3 + 1) % n
    idx[0], idx[-1] = -1, n + 5            # clamp to snapshots 0 and K
    ops.reset_launch_counts()
    out = ops.lane_rollback(snaps, idx, lane_axis=lane_axis)
    torch.cuda.synchronize()
    assert ops.launch_counts()["lane_rollback"] == 1
    assert out.dtype == dtype and out.shape == shape
    assert torch.equal(out, ref.lane_rollback_ref(snaps, idx,
                                                  lane_axis=lane_axis))
    assert torch.equal(out, ops.lane_rollback(torch.stack(snaps), idx,
                                              lane_axis=lane_axis))
    for lane in range(W):
        k = max(0, min(int(idx[lane]), n - 1))
        assert torch.equal(out.select(lane_axis, lane),
                           snaps[k].select(lane_axis, lane)), lane


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask_kind", ["all", "none", "mixed"])
def test_ring_shift_bitwise_on_card(cuda, shape, dtype, mask_kind):
    d, f, _, mixed = _inputs(shape, dtype, cuda)
    mask = {"all": torch.ones_like(mixed), "none": torch.zeros_like(mixed),
            "mixed": mixed}[mask_kind]
    out = ops.spectral_update_lanes(d, f, mask)
    assert torch.equal(out, ref.spectral_update_lanes_ref(d, f, mask))


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


VERIFY_N = [256 * 1152, 1000, 2048 * 3 + 5]   # serving, scalar, ragged


def _verify_planes(cuda, W, N, dtype, seed=1):
    g = torch.Generator(device=cuda).manual_seed(seed)
    real = torch.randn((W, N), generator=g, device=cuda)
    scale = torch.linspace(0.05, 1.0, W, device=cuda)[:, None]
    pred = real + scale * torch.randn((W, N), generator=g, device=cuda)
    return pred.to(dtype), real.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", VERIFY_N)
def test_verify_err_is_bitwise_independent_of_lane_width(cuda, dtype, N):
    """The one-launch verify sums each lane in an order fixed by N alone:
    at W = 4 every lane's err is bitwise its W = 1 call's, so the engine's
    trajectories do not depend on the lane width."""
    pred, real = _verify_planes(cuda, 4, N, dtype)
    tau = torch.full((4,), 0.3, device=cuda)
    e4, a4 = ops.verify_accept(pred, real, tau)
    for w in range(4):
        e1, a1 = ops.verify_accept(pred[w:w + 1].contiguous(),
                                   real[w:w + 1].contiguous(), tau[w:w + 1])
        assert torch.equal(e1, e4[w:w + 1]) and torch.equal(a1, a4[w:w + 1])
    er, _ = ref.verify_accept_ref(pred, real, tau)
    torch.testing.assert_close(e4, er, rtol=1e-5, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_tickets_reset_between_calls(cuda, dtype):
    """The per-lane tickets go back to 0 after every call: two calls in a
    row, and a call after one of another W and N, give the same bits (the
    τ-less entry shares the tickets)."""
    pred, real = _verify_planes(cuda, 4, 256 * 1152, dtype)
    tau = torch.full((4,), 0.3, device=cuda)
    e1, a1 = ops.verify_accept(pred, real, tau)
    e2, a2 = ops.verify_accept(pred, real, tau)
    assert torch.equal(e1, e2) and torch.equal(a1, a2)
    p7, r7 = _verify_planes(cuda, 7, 3001, dtype, seed=2)
    ops.verify_accept(p7, r7, torch.full((7,), 0.3, device=cuda))
    ops.verify_sums(p7, r7)
    ops.verify_sums(pred, real)
    e3, a3 = ops.verify_accept(pred, real, tau)
    assert torch.equal(e1, e3) and torch.equal(a1, a3)
    s1 = ops.verify_sums(p7, r7)
    torch.testing.assert_close(s1, ref.verify_sums_ref(p7, r7), rtol=1e-5,
                               atol=0.0)
    assert torch.equal(s1, ops.verify_sums(p7, r7))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_accept_and_nan_on_card(cuda, dtype):
    """accept = err <= τ, finished on the device: a NaN lane never
    accepts (its err is NaN), a zero reference gives err = ‖p‖/ε, a lane
    at twice its τ rejects."""
    pred, real = _verify_planes(cuda, 4, 5000, dtype)
    pred[1, 17] = float("nan")
    real[2] = 0.0
    e0, _ = ref.verify_accept_ref(pred, real, torch.ones(4, device=cuda))
    tau = e0.clone()
    tau[3] = e0[3] * 0.5
    ek, ak = ops.verify_accept(pred, real, tau)
    er, ar = ref.verify_accept_ref(pred, real, tau)
    assert torch.isnan(ek[1]) and not ak[1]
    torch.testing.assert_close(ek, er, rtol=1e-5, atol=0.0, equal_nan=True)
    far = (er - tau).abs() > 1e-5
    assert torch.equal(ak[far], ar[far])
    assert not ak[3] and ak.dtype == torch.bool and ek.dtype == torch.float32


@pytest.mark.cuda
def test_cuda_tensors_never_fall_back(cuda):
    d = torch.zeros((3, 2, 2, 2, 4, 8), dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        ops.taylor_predict_lanes(d, torch.ones((3, 2), device=cuda))
    with pytest.raises(ValueError):
        ops.taylor_predict_lanes(d.float().transpose(1, 2),
                                 torch.ones((3, 2), device=cuda))
    with pytest.raises(TypeError):
        ops.taylor_predict_chain_lanes(d, torch.ones((3, 2, 2), device=cuda))
    with pytest.raises(TypeError):
        ops.spectral_update_lanes(d, d[0], torch.ones(2, dtype=torch.bool,
                                                      device=cuda))
    with pytest.raises(ValueError):
        ops.lane_rollback(d.float().transpose(1, 2),
                          torch.zeros(2, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):           # no kernel for head dim 48
        q48 = torch.zeros((1, 8, 2, 48), device=cuda)
        ops.flash_attention(q48, q48, q48)
    with pytest.raises(TypeError):
        q16 = torch.zeros((1, 8, 2, 16), dtype=torch.float16, device=cuda)
        ops.flash_attention(q16, q16, q16)
    with pytest.raises(TypeError):
        ops.taylor_update(d, d[0])
    # a CUDA tensor never reaches a plain version (nor, on the flash path
    # of full_attention, SDPA): with them replaced by a trap, every
    # wrapper still computes
    from repro_torch.layers import attention
    calls = []
    saved = {n: getattr(ref, n) for n in dir(ref) if n.endswith("_ref")}
    sdpa = attention.F.scaled_dot_product_attention
    try:
        for n in saved:
            setattr(ref, n, lambda *a, _n=n, **k: calls.append(_n))
        attention.F.scaled_dot_product_attention = \
            lambda *a, **k: calls.append("sdpa")
        t = torch.randn((3, 2, 2, 2, 4, 8), device=cuda)
        mask = torch.tensor([True, False], device=cuda)
        idx = torch.tensor([0, 2], dtype=torch.int32, device=cuda)
        q = torch.randn((1, 8, 4, 16), device=cuda)
        kv = torch.randn((1, 8, 2, 16), device=cuda)
        outs = [ops.taylor_predict_lanes(t, torch.ones((3, 2), device=cuda)),
                ops.taylor_update_lanes(t, t[0], mask),
                ops.verify_accept(t[0, 0, 0], t[0, 0, 1],
                                  torch.ones(2, device=cuda))[0],
                ops.taylor_predict_chain_lanes(
                    t, torch.ones((3, 4, 2), device=cuda)),
                ops.lane_rollback(t, idx),
                ops.spectral_update_lanes(t, t[0], mask),
                ops.taylor_predict(t, torch.ones(3, device=cuda)),
                ops.taylor_update(t, t[0]),
                ops.verify_sums(t[0, 0, 0], t[0, 0, 1]),
                ops.verify_error(t[0, 0, 0], t[0, 0, 1]),
                ops.flash_attention(q, q, q, causal=False),
                attention.full_attention(q, kv, kv, 3, use_flash=True),
                ops.flash_attention(*(q.bfloat16(),) * 3, causal=False),
                attention.full_attention(q.bfloat16(), kv.bfloat16(),
                                         kv.bfloat16(), 3, use_flash=True)]
    finally:
        for n, fn in saved.items():
            setattr(ref, n, fn)
        attention.F.scaled_dot_product_attention = sdpa
    torch.cuda.synchronize()
    assert calls == [] and all(o.is_cuda for o in outs)


def _kernels_per_call(fn, iters: int = 10, attempts: int = 5) -> float:
    """CUDA kernels launched per call of ``fn``, from torch.profiler. The
    profiler now and then loses some or all events of a window, whatever
    runs in it (``tools/profiler_windows.py``): a window with no CUDA
    event, or a count that is no multiple of ``iters``, is no reading,
    so it is measured again, up to ``attempts`` windows, with a warning
    for each window measured again."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for used in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        n = sum(e.device_type == torch.autograd.DeviceType.CUDA
                for e in prof.events())
        if n and n % iters == 0:
            break
        warnings.warn(f"profiler window {used} of {attempts} recorded {n} "
                      f"CUDA events for {iters} calls")
    return n / iters


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("N", VERIFY_N)
def test_verify_error_one_kernel_bitwise_on_card(cuda, dtype, W, N):
    """The τ-less error is finished in the verify kernel: one kernel a
    call, bitwise verify_accept's err and the two-step finish over
    verify_sums on the same planes, rtol 1e-5 against the plain version."""
    pred, real = _verify_planes(cuda, W, N, dtype)
    tau = torch.full((W,), 0.3, device=cuda)
    for eps in (1e-8, 1e-3):
        ops.reset_launch_counts()
        err = ops.verify_error(pred, real, eps=eps)
        torch.cuda.synchronize()
        n = ops.launch_counts()
        assert (n["verify_error"], n["verify_sums"]) == (1, 0)
        assert err.shape == (W,) and err.dtype == torch.float32
        assert torch.equal(err, ops.verify_accept(pred, real, tau,
                                                  eps=eps)[0])
        sums = ops.verify_sums(pred, real)
        assert torch.equal(err, torch.sqrt(sums[:, 0])
                           / (torch.sqrt(sums[:, 1]) + eps))
        torch.testing.assert_close(err, ref.verify_error_ref(pred, real,
                                                             eps=eps),
                                   rtol=1e-5, atol=0.0)
    assert _kernels_per_call(lambda: ops.verify_error(pred, real)) == 1


SCALAR_SHAPES = [(1, 64), (3, 17), (3, 2, 2, 4, 8, 16), (2, 1000),
                 (5, 8, 128), (3, 4, 300, 77)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SCALAR_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scalar_kernels_match_plain_on_card(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(2)
    d = torch.randn(shape, generator=g, device=cuda).to(dtype)
    f32 = torch.randn(shape[1:], generator=g, device=cuda) * 4.0
    w = torch.randn((shape[0],), generator=g, device=cuda)
    ops.reset_launch_counts()
    pk = ops.taylor_predict(d, w)
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(pk.float(),
                               ref.taylor_predict_ref(d.float(), w),
                               rtol=tol, atol=1e-5)
    # bitwise the lane kernel with the weights broadcast to every lane,
    # on another fold of the table (other rows, columns and vector path)
    axis = max(len(shape) - 3, 0)
    lanes = ops.taylor_predict_lanes(
        d, w[:, None].expand(shape[0], shape[1 + axis]).contiguous(),
        lane_axis=axis)
    assert torch.equal(pk, lanes)
    for feats in (f32.to(dtype), f32):       # table dtype, and f32 features
        uk = ops.taylor_update(d, feats)
        assert torch.equal(uk, ref.taylor_update_ref(d, feats)), feats.dtype
    pred = d[0].reshape(shape[1], -1) if d.dim() > 2 else d[:1]
    real = (pred.float() * 1.05 + 0.01).to(dtype)
    torch.testing.assert_close(ops.verify_sums(pred, real),
                               ref.verify_sums_ref(pred, real), rtol=1e-5,
                               atol=0.0)
    torch.testing.assert_close(ops.verify_error(pred, real),
                               ref.verify_error_ref(pred, real), rtol=1e-5,
                               atol=0.0)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["taylor_predict"], counts["taylor_update"],
            counts["verify_sums"], counts["verify_error"]) == (1, 2, 1, 1)


def _flash_tol(dtype):
    return dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32 else \
        dict(rtol=2.0 ** -8, atol=1e-5)


def _flash_launched(dtype):
    """The launch counts one flash call leaves: bf16 runs the bf16
    tensor-core kernel, f32 the 3×TF32 one."""
    sm90 = dtype == torch.bfloat16
    return {"flash_attention": int(not sm90),
            "flash_attention_sm90": int(sm90)}


def _flash_counts():
    n = ops.launch_counts()
    return {k: n[k] for k in ("flash_attention", "flash_attention_sm90")}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 72, 128])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 37),
                                           (False, 0), (False, 20)])
@pytest.mark.parametrize("s", [100, 257])
def test_flash_matches_plain_on_card(cuda, dtype, hd, causal, window, s):
    g = torch.Generator(device=cuda).manual_seed(hd + s)
    q, k, v = (torch.randn((2, s, 3, hd), generator=g, device=cuda)
               .to(dtype) for _ in range(3))
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal, window=window)
    torch.cuda.synchronize()
    assert _flash_counts() == _flash_launched(dtype)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want, **_flash_tol(dtype))


@pytest.mark.cuda
def test_flash_bf16_long_causal_on_card(cuda):
    """The tensor-core kernel at gemma3's head dim and sequence length:
    S 4096, hd 128, causal, 64 key tiles deep and 32 query tiles."""
    g = torch.Generator(device=cuda).manual_seed(4096)
    q, k, v = (torch.randn((1, 4096, 2, 128), generator=g, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=True)
    torch.cuda.synchronize()
    assert _flash_counts() == _flash_launched(torch.bfloat16)
    torch.testing.assert_close(got.float(), want,
                               **_flash_tol(torch.bfloat16))


@pytest.mark.cuda
def test_flash_f32_long_causal_strided_on_card(cuda):
    """The 3×TF32 kernel at gemma3's head dim, 2048 keys deep, causal, on
    full-mantissa f32 inputs read as strided views of one packed
    [B, S, 3, H, hd] tensor."""
    g = torch.Generator(device=cuda).manual_seed(2048)
    qkv = torch.randn((1, 2048, 3, 2, 128), generator=g, device=cuda)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert _flash_counts() == _flash_launched(torch.float32)
    torch.testing.assert_close(got, want, **_flash_tol(torch.float32))


@pytest.mark.cuda
def test_flash_f32_misaligned_raises_on_card(cuda):
    """The f32 kernel is TMA-fed too: a base or stride that is not a
    multiple of 16 bytes raises and launches nothing."""
    big = torch.zeros((1, 64, 2, 80), device=cuda)
    padded = torch.zeros((1, 64, 2, 74), device=cuda)
    ops.reset_launch_counts()
    for q in (big[..., 1:73], padded[..., :72]):
        with pytest.raises(ValueError, match="16 bytes"):
            ops.flash_attention(q, q, q)
    assert _flash_counts() == {"flash_attention": 0,
                               "flash_attention_sm90": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_reads_strided_inputs_and_full_attention_on_card(cuda, dtype):
    """q/k/v as views of one packed [B, S, 3, H, hd] tensor (strides, not
    copies), and ``full_attention(use_flash=True)`` with GQA against its
    mask path (in bf16 within one bf16 ulp: the mask path rounds its own
    f32 result)."""
    g = torch.Generator(device=cuda).manual_seed(9)
    qkv = torch.randn((2, 130, 3, 4, 64), generator=g, device=cuda).to(dtype)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=True, window=50)
    torch.cuda.synchronize()
    assert _flash_counts() == _flash_launched(dtype)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=True, window=50)
    torch.testing.assert_close(got.float(), want, **_flash_tol(dtype))
    from repro_torch.layers.attention import full_attention
    kv = qkv[:, :, 1:, :2]                       # 2 KV heads for 4 q heads
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32 else \
        dict(rtol=2.0 ** -7, atol=1e-5)
    for window in (0, 40):
        fl = full_attention(q, kv[:, :, 0], kv[:, :, 1], window,
                            use_flash=True)
        plain = full_attention(q, kv[:, :, 0], kv[:, :, 1], window)
        torch.testing.assert_close(fl.float(), plain.float(), **tol)


@pytest.mark.cuda
def test_flash_bf16_misaligned_raises_on_card(cuda):
    """The tensor-core kernel's TMA maps need 16-byte-aligned bases and
    strides: a misaligned bf16 operand raises and launches nothing."""
    big = torch.zeros((1, 64, 2, 80), dtype=torch.bfloat16, device=cuda)
    q = big[..., 1:73]                           # base 2 bytes off
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="16 bytes"):
        ops.flash_attention(q, q, q)
    padded = torch.zeros((1, 64, 2, 73), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16 bytes"):
        ops.flash_attention(padded[..., :72], padded[..., :72],
                            padded[..., :72])
    assert _flash_counts() == {"flash_attention": 0,
                               "flash_attention_sm90": 0}


def _small_dit(cuda):
    """A small f32 DiT with seeded random weights whose features move
    smoothly from step to step (see chip_smoke)."""
    from repro_torch.layers.model import init_params
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
    return cfg, params, PC.DiffusionConfig(num_inference_steps=20,
                                           latent_size=8)


@pytest.mark.cuda
def test_engine_lane_width_keeps_trajectories_on_card(cuda):
    """A small f32 DiT served at lanes 1 and 3: identical per-request
    counters (the engine's trajectory-exactness on the card)."""
    from repro_torch.serving import Request, SpeCaEngine
    cfg, params, dcfg = _small_dit(cuda)
    engine = SpeCaEngine(cfg, params, dcfg, PC.SpeCaConfig(), device=cuda)
    reqs = [Request(request_id=i, cond={"labels": torch.tensor([i])},
                    seed=i) for i in range(3)]
    ops.reset_launch_counts()
    r3 = engine.serve_batched(reqs, lanes=3)
    n = ops.launch_counts()
    assert all(n[k] > 0 for k in ("taylor_predict_lanes",
                                  "taylor_update_lanes", "verify_accept"))
    r1 = engine.serve_batched(reqs, lanes=1)
    for a, b in zip(r1, r3):
        assert (a.num_full, a.num_spec, a.accepts) == \
            (b.num_full, b.num_spec, b.accepts)
        torch.testing.assert_close(a.sample, b.sample, rtol=1e-4,
                                   atol=1e-4)
    # two branch syncs per tick: 20 ticks at lanes=3, 3 × 20 at lanes=1
    assert engine.host_syncs == 2 * 20 + 2 * 20 * 3


@pytest.mark.cuda
@pytest.mark.parametrize("forecaster", ["taylor", "spectral"])
def test_deep_engine_keeps_trajectories_on_card(cuda, forecaster):
    """Depth-3 requests on the card: the depth-1 engine's accept
    trajectories in fewer ticks, through the chain and rollback kernels
    (and the ring shift for the spectral forecaster)."""
    from repro_torch.serving import Request, RequestPolicy, SpeCaEngine
    cfg, params, dcfg = _small_dit(cuda)
    scfg = PC.SpeCaConfig()
    reqs = [Request(request_id=i, cond={"labels": torch.tensor([i])},
                    seed=i) for i in range(3)]
    deep = [Request(request_id=i, cond={"labels": torch.tensor([i])},
                    seed=i, policy=RequestPolicy(draft_depth=3))
            for i in range(3)]
    ref1 = SpeCaEngine(cfg, params, dcfg, scfg, forecaster=forecaster,
                       device=cuda).serve_batched(reqs, lanes=3)
    ops.reset_launch_counts()
    got = SpeCaEngine(cfg, params, dcfg, scfg, forecaster=forecaster,
                      max_draft_depth=3, device=cuda).serve_batched(
        deep, lanes=3)
    n = ops.launch_counts()
    assert n["taylor_predict_chain_lanes"] > 0 and n["lane_rollback"] > 0
    assert (n["spectral_update_lanes"] > 0) == (forecaster == "spectral")
    for a, b in zip(ref1, got):
        assert (a.accepts, a.num_full, a.num_spec) == \
            (b.accepts, b.num_full, b.num_spec)
        torch.testing.assert_close(a.sample, b.sample, rtol=1e-5,
                                   atol=1e-5)
    assert sum(r.finish_tick for r in got) < sum(r.finish_tick
                                                 for r in ref1)


MIXED_MASKS = {"none": [False] * 5, "all": [True] * 5,
               "head": [True, True, False, False, False],
               # rows paired on their own; the tail lane's flag is ignored
               "rows": [False, True, True, False, True]}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W", [4, 5])
@pytest.mark.parametrize("N", VERIFY_N + [3000])   # 3000: N % 8 == 4
@pytest.mark.parametrize("mask", sorted(MIXED_MASKS))
def test_verify_accept_mixed_pins_on_card(cuda, dtype, W, N, mask):
    """The mixed entry in one launch: unpaired rows (and an odd W's tail)
    bitwise ``verify_accept`` on the same planes (pin a), paired rows
    bitwise ``verify_accept`` on the plain f32 planes (pin b), each row's
    accept against its own τ; the tickets stay clean for the next call."""
    pred, real = _verify_planes(cuda, W, N, dtype)
    paired = torch.tensor(MIXED_MASKS[mask][:W], device=cuda)
    gs = torch.tensor([1.5, 1.5, 4.0, 4.0, 2.0][:W], device=cuda)
    eff = paired & (torch.arange(W, device=cuda) < 2 * (W // 2))
    e0, _ = ref.verify_accept_mixed_ref(pred, real, torch.ones(W,
                                                               device=cuda),
                                        gs, paired)
    tau = (e0 * torch.tensor([2.0, 0.5, 1.0, 0.9, 1.1][:W],
                             device=cuda)).contiguous()
    ev, av = ops.verify_accept(pred, real, tau)
    ops.reset_launch_counts()
    em, am = ops.verify_accept_mixed(pred, real, tau, gs, paired)
    torch.cuda.synchronize()
    n = ops.launch_counts()
    assert (n["verify_accept_mixed"], n["verify_accept"]) == (1, 0)
    assert torch.equal(em[~eff], ev[~eff]) and torch.equal(am[~eff],
                                                           av[~eff])
    p32, r32 = ref.mixed_planes_ref(pred, real, gs, paired)
    eb, ab = ops.verify_accept(p32, r32, tau)
    assert torch.equal(em[eff], eb[eff]) and torch.equal(am[eff], ab[eff])
    er, ar = ref.verify_accept_mixed_ref(pred, real, tau, gs, paired)
    torch.testing.assert_close(em, er, rtol=1e-5, atol=0.0)
    far = (er - tau).abs() > 1e-5
    assert torch.equal(am[far], ar[far])
    ev2, av2 = ops.verify_accept(pred, real, tau)
    assert torch.equal(ev2, ev) and torch.equal(av2, av)
    assert torch.equal(ops.verify_accept_mixed(pred, real, tau, gs,
                                               paired)[0], em)
    assert _kernels_per_call(lambda: ops.verify_accept_mixed(
        pred, real, tau, gs, paired)) == 1


@pytest.mark.cuda
def test_guided_engine_on_card(cuda):
    """A mixed guided/unguided batch on a small f32 DiT: every row is
    verified through the mixed entry (``verify_accept`` never launches in
    a paired session), and lanes 2 keep lanes 4's counters; unguided-only
    traffic keeps the plain entry."""
    from repro_torch.serving import Request, RequestPolicy, SpeCaEngine
    cfg, params, dcfg = _small_dit(cuda)
    engine = SpeCaEngine(cfg, params, dcfg, PC.SpeCaConfig(), device=cuda)
    pols = [RequestPolicy(guidance_scale=4.0),
            RequestPolicy(guidance_scale=1.5,
                          negative_cond={"labels": torch.tensor([3])}),
            RequestPolicy(), RequestPolicy(tau0=0.5)]
    reqs = [Request(request_id=i, cond={"labels": torch.tensor([i])},
                    seed=i, policy=p) for i, p in enumerate(pols)]
    ops.reset_launch_counts()
    r4 = engine.serve_batched(reqs, lanes=4)
    n = ops.launch_counts()
    assert n["verify_accept_mixed"] > 0 and n["verify_accept"] == 0
    assert n["taylor_predict_lanes"] > 0 and n["taylor_update_lanes"] > 0
    r2 = engine.serve_batched(reqs, lanes=2)
    for a, b in zip(r4, r2):
        assert (a.num_full, a.num_spec, a.accepts, a.flops) == \
            (b.num_full, b.num_spec, b.accepts, b.flops)
        torch.testing.assert_close(a.sample, b.sample, rtol=1e-4,
                                   atol=1e-4)
    ops.reset_launch_counts()
    engine.serve_batched(reqs[2:], lanes=2)
    n = ops.launch_counts()
    assert n["verify_accept"] > 0 and n["verify_accept_mixed"] == 0


@pytest.mark.cuda
def test_controller_engine_keeps_counters_on_card(cuda):
    """Controlled and controller-free requests on ``SpeCaEngine(
    controller=True, max_draft_depth=3)`` on the card: lanes 4 and 2 keep
    every request's counters, through the chain predict and the rollback;
    the controller-free request keeps its static trajectory; a controlled
    request speculates deeper than one step a tick."""
    from repro_torch.serving import (ControllerPolicy, Request,
                                     RequestPolicy, SpeCaEngine)
    cfg, params, dcfg = _small_dit(cuda)
    scfg = PC.SpeCaConfig()
    ctls = [None, ControllerPolicy(), ControllerPolicy(target_accept=0.9),
            ControllerPolicy(slo="deadline", deadline_ticks=8,
                             tau_max=2 * scfg.tau0),
            ControllerPolicy(order_max=1)]
    reqs = [Request(request_id=i, cond={"labels": torch.tensor([i])},
                    seed=i, policy=RequestPolicy(controller=c))
            for i, c in enumerate(ctls)]
    engine = SpeCaEngine(cfg, params, dcfg, scfg, controller=True,
                         max_draft_depth=3, device=cuda)
    ops.reset_launch_counts()
    r4 = engine.serve_batched(reqs, lanes=4)
    n = ops.launch_counts()
    assert n["taylor_predict_chain_lanes"] > 0 and n["lane_rollback"] > 0
    r2 = engine.serve_batched(reqs, lanes=2)
    for a, b in zip(r4, r2):
        assert (a.num_full, a.num_spec, a.num_drafted, a.accepts) == \
            (b.num_full, b.num_spec, b.num_drafted, b.accepts)
        torch.testing.assert_close(a.sample, b.sample, rtol=1e-4,
                                   atol=1e-4)
    static = SpeCaEngine(cfg, params, dcfg, scfg, device=cuda) \
        .serve_batched(reqs[:1], lanes=1)[0]
    assert (static.num_full, static.num_spec, static.accepts) == \
        (r4[0].num_full, r4[0].num_spec, r4[0].accepts)
    S = dcfg.num_inference_steps
    assert any(r.timings.service_ticks < S for r in r4[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"max_draft_depth": 2,
                                     "forecaster": "spectral"}])
def test_warmup_leaves_nothing_to_build_on_card(cuda, kw):
    """From a cleared library loader, ``warmup(mixed=True)`` loads exactly
    the step's kernel libraries, and lifecycle serving after it loads no
    other."""
    from repro_torch.kernels import build
    from repro_torch.serving import Request, RequestPolicy, SpeCaEngine
    cfg, params, dcfg = _small_dit(cuda)
    engine = SpeCaEngine(cfg, params, dcfg, PC.SpeCaConfig(), lanes=2,
                         device=cuda, **kw)
    saved = dict(build._loaded)
    build._loaded.clear()
    try:
        engine.warmup({"labels": torch.tensor([1])}, lanes=2, mixed=True)
        loaded = set(build._loaded)
        assert loaded == set(engine.kernel_sources())
        depth = kw.get("max_draft_depth")
        tickets = [engine.submit(Request(
            request_id=i, cond={"labels": torch.tensor([i])}, seed=i,
            policy=RequestPolicy(guidance_scale=2.0 if i == 0 else None,
                                 draft_depth=depth)))
            for i in range(3)]
        assert all(r.completed for r in engine.results(tickets))
        assert set(build._loaded) == loaded
    finally:
        build._loaded.update(saved)


def _acc_flags(W, K, seed):
    """One tick's seeded flags: counters, and errors [K, W] with NaN, ±Inf
    and values exactly on an edge of the default grid."""
    from repro_torch.obs.lane_metrics import DEFAULT_ERR_EDGES
    rng = np.random.default_rng(seed)
    err = rng.lognormal(-2.5, 2.0, (K, W)).astype(np.float32)
    pick = rng.random((K, W))
    edges = np.asarray(DEFAULT_ERR_EDGES, np.float32)
    err = np.where(pick < 0.2, edges[rng.integers(0, len(edges), (K, W))],
                   err)
    err = np.where((pick >= 0.2) & (pick < 0.3), np.nan, err)
    err = np.where((pick >= 0.3) & (pick < 0.35), np.inf, err)
    err = np.where((pick >= 0.35) & (pick < 0.4), -np.inf, err)
    n_drafted = rng.integers(0, K + 1, W).astype(np.int32)
    n_spec = np.minimum(n_drafted, rng.integers(0, K + 1, W)).astype(
        np.int32)
    full = n_spec < np.maximum(n_drafted, 1)
    flags = {"attempted": n_drafted > 0, "n_spec": n_spec,
             "n_drafted": n_drafted, "full": full,
             "advanced": (n_spec + full).astype(np.int32)}
    flags["chain_err" if K > 1 else "err"] = err if K > 1 else err[0]
    return {k: torch.from_numpy(np.asarray(v)) for k, v in flags.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 4])
def test_lane_accumulator_sync_free_and_equal_to_cpu_on_card(cuda, K):
    """``LaneAccumulator.update`` on the card, its first call (the buffer's
    allocation) included, raises nothing under sync-debug mode "error";
    its flush equals the CPU accumulator's on the same flags (counts and
    totals exact, the f32 error sum within rtol 1e-6)."""
    from repro_torch.obs import LaneAccumulator, MetricsRegistry
    ticks = [_acc_flags(8, K, seed) for seed in range(6)]
    gpu, cpu = LaneAccumulator(), LaneAccumulator()
    on_card = [{k: v.to(cuda) for k, v in f.items()} for f in ticks]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for f in on_card:
            gpu.update(f)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for f in ticks:
        cpu.update(f)
    regs = MetricsRegistry(), MetricsRegistry()
    gpu.flush_into(regs[0], workload="diffusion")
    cpu.flush_into(regs[1], workload="diffusion")
    for a, b in zip(*(r.snapshot() for r in regs)):
        inexact = ("sum", "mean")
        assert {k: v for k, v in a.items() if k not in inexact} == \
            {k: v for k, v in b.items() if k not in inexact}
        for k in inexact:
            if k in b:
                assert a[k] == pytest.approx(b[k], rel=1e-6)
    h = regs[0].histogram("speca_chain_err", workload="diffusion")
    key = "chain_err" if K > 1 else "err"
    assert h.count == sum(int(torch.isfinite(f[key]).sum()) for f in ticks)
    assert gpu._acc.device.type == "cuda"
    assert not bool(gpu._acc.any())          # flushed: reset in place


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"controller": True,
                                     "max_draft_depth": 3}])
def test_obs_engine_bitwise_inert_on_card(cuda, kw):
    """On the card an ``obs=True`` engine serves bitwise what an
    ``obs=False`` one serves, with the same host syncs; its lane totals
    equal the Results' sums."""
    from repro_torch.serving import (ControllerPolicy, Request,
                                     RequestPolicy, SpeCaEngine)
    cfg, params, dcfg = _small_dit(cuda)
    deep = bool(kw)
    reqs = [Request(request_id=i, cond={"labels": torch.tensor([i])},
                    seed=i, policy=RequestPolicy(
                        draft_depth=3 if deep else None,
                        controller=ControllerPolicy() if deep and i == 1
                        else None))
            for i in range(4)]
    out = []
    for obs in (False, True):
        engine = SpeCaEngine(cfg, params, dcfg, PC.SpeCaConfig(), lanes=2,
                             obs=obs, device=cuda, **kw)
        res = engine.results([engine.submit(r) for r in reqs])
        out.append((engine, res))
    (off, roff), (on, ron) = out
    assert on.host_syncs == off.host_syncs > 0
    for a, b in zip(roff, ron):
        assert torch.equal(a.sample, b.sample)
        assert (a.accepts, a.num_full, a.num_spec, a.num_drafted) == \
            (b.accepts, b.num_full, b.num_spec, b.num_drafted)
    snap = {r["name"]: r for r in on.metrics_snapshot()}
    assert snap["speca_n_spec_total"]["value"] == sum(r.num_spec
                                                      for r in ron)
    assert snap["speca_n_drafted_total"]["value"] == sum(r.num_drafted
                                                         for r in ron)
    assert snap["speca_chain_err"]["count"] == sum(r.num_drafted
                                                   for r in ron)
    assert snap["speca_requests_completed_total"]["value"] == 4


def _f32(*shape, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g) * scale


@pytest.fixture
def exact_f32():
    """f32 products without TF32 for one test; the flag is restored
    after it."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = was


def moe_case(capacity_factor):
    """The MoE FFN's CPU inputs (d 64, 4 experts top-2, 64 tokens) ->
    (params, x, keyword arguments)."""
    D, E, F = 64, 4, 96
    prm = {"router": _f32(D, E, seed=0, scale=D ** -0.5),
           "w_gate": _f32(E, D, F, seed=1, scale=D ** -0.5),
           "w_up": _f32(E, D, F, seed=2, scale=D ** -0.5),
           "w_down": _f32(E, F, D, seed=3, scale=F ** -0.5)}
    return prm, _f32(4, 16, D, seed=4), dict(
        num_experts=E, top_k=2, capacity_factor=capacity_factor)


def ssd_case():
    """The SSD chunk scan's CPU inputs (T = 48, chunk 16, an initial
    state) -> (x, dA, B, C, chunk, initial_state)."""
    x, dA = _f32(2, 48, 3, 8, seed=0), -_f32(2, 48, 3, seed=1).abs() * 0.3
    return (x, dA, _f32(2, 48, 5, seed=2), _f32(2, 48, 5, seed=3), 16,
            _f32(2, 3, 8, 5, seed=4))


def mamba2_decode_case():
    """One recurrent decode step's CPU inputs -> (params, (x, ssm_state,
    conv_state), keyword arguments)."""
    DI, NS, NH, HP, DM = 64, 8, 4, 16, 32
    cc = DI + 2 * NS
    prm = {"w_in": _f32(DM, 2 * DI + 2 * NS + NH, seed=5, scale=0.2),
           "conv_w": _f32(4, cc, seed=6, scale=0.5),
           "conv_b": _f32(cc, seed=7, scale=0.1),
           "A_log": torch.log(torch.linspace(1.0, 16.0, NH)),
           "Dp": torch.ones(NH),
           "dt_bias": torch.log(torch.expm1(torch.linspace(1e-3, 0.1, NH))),
           "ssm_norm": _f32(DI, seed=8, scale=0.1),
           "w_out": _f32(DI, DM, seed=9, scale=0.15)}
    args = (_f32(3, 1, DM, seed=10), _f32(3, NH, HP, NS, seed=11),
            _f32(3, 4, cc, seed=12))
    return prm, args, dict(d_inner=DI, n_state=NS, n_heads=NH, head_dim=HP)


@pytest.mark.cuda
@pytest.mark.parametrize("capacity_factor", [4.0, 0.1])
def test_moe_forward_on_card_matches_cpu(cuda, exact_f32, capacity_factor):
    """The MoE FFN (``moe_case``; at capacity factor 0.1 most slots drop)
    on the card against the same call on the CPU, f32 with TF32 off,
    rtol = atol = 1e-5."""
    from repro_torch.layers.moe import moe_forward
    prm, x, kw = moe_case(capacity_factor)
    want = moe_forward(prm, x, **kw)
    got = moe_forward({k: v.to(cuda) for k, v in prm.items()}, x.to(cuda),
                      **kw)
    for g, w in zip(got, want):      # the output and the aux loss
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_ssd_chunked_and_mamba2_decode_on_card_match_cpu(cuda, exact_f32):
    """The SSD chunk scan (``ssd_case``) and one recurrent decode step
    (``mamba2_decode_case``) on the card against the same calls on the
    CPU, f32 with TF32 off, rtol = atol = 1e-5."""
    from repro_torch.layers import ssm
    *tensors, chunk, init = ssd_case()
    want = ssm.ssd_chunked(*tensors, chunk, initial_state=init)
    got = ssm.ssd_chunked(*(t.to(cuda) for t in tensors), chunk,
                          initial_state=init.to(cuda))
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
    prm, args, kw = mamba2_decode_case()
    want = ssm.mamba2_decode(prm, *args, **kw)
    got = ssm.mamba2_decode({k: v.to(cuda) for k, v in prm.items()},
                            *(a.to(cuda) for a in args), **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_decode_lanes_bitwise_alone_on_card(cuda, exact_f32, dtype):
    """One decode step of 3 lanes (``mamba2_decode_case``) on the card is
    bitwise each lane's step alone: the step's products run on lanes
    padded to ``norms.DECODE_ROWS`` (fault W2: cuBLAS summed one lane's SSD
    state product in another order than several)."""
    from repro_torch.layers import ssm
    prm, (x, state, conv), kw = mamba2_decode_case()
    prm = {k: v.to(cuda, dtype) for k, v in prm.items()}
    x, conv, state = x.to(cuda, dtype), conv.to(cuda, dtype), state.to(cuda)
    whole = ssm.mamba2_decode(prm, x, state, conv, **kw)
    for lane in range(x.shape[0]):
        one = ssm.mamba2_decode(prm, x[lane:lane + 1], state[lane:lane + 1],
                                conv[lane:lane + 1], **kw)
        for a, b in zip(whole, one):
            assert torch.equal(a[lane:lane + 1], b), lane


# --- lane-sharded routings ---------------------------------------------------

def _shard_cases(dev, dtype):
    """(routing, unsharded call, (tensor, lane axis) arguments, lane axes
    of the outputs) at W = 4 lanes, table [3, 2, 2, 4, 9, 72]."""
    g = torch.Generator(device=dev).manual_seed(3)
    W, K, table = 4, 3, (3, 2, 2, 4, 9, 72)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    d, f = rn(*table).to(dtype), rn(*table[1:]).to(dtype)
    w = torch.rand((3, W), generator=g, device=dev) + 0.1
    wc = torch.rand((3, K, W), generator=g, device=dev) + 0.1
    mask = torch.tensor([True, False, False, True], device=dev)
    chain = rn(K + 1, *table[1:]).to(dtype)
    idx = torch.tensor([0, 3, 1, 2], dtype=torch.int32, device=dev)
    p = rn(W, 3000).to(dtype)
    r = (p.float() + 0.05 * rn(W, 3000)).to(dtype)
    tau = torch.tensor([0.01, 0.1, 1.0, 10.0], device=dev)
    gs = torch.tensor([3.0, 3.0, 1.5, 1.5], device=dev)
    paired = torch.tensor([True, True, False, False], device=dev)
    return {
        "taylor_predict_lanes_sharded": (
            ops.taylor_predict_lanes, [(d, 3), (w, 1)], [2]),
        "taylor_predict_chain_lanes_sharded": (
            ops.taylor_predict_chain_lanes, [(d, 3), (wc, 2)], [3]),
        "lane_rollback_sharded": (ops.lane_rollback, [(chain, 3), (idx, 0)],
                                  [2]),
        "taylor_update_lanes_sharded": (
            ops.taylor_update_lanes, [(d, 3), (f, 2), (mask, 0)], [3]),
        "spectral_update_lanes_sharded": (
            ops.spectral_update_lanes, [(d, 3), (f, 2), (mask, 0)], [3]),
        "verify_accept_sharded": (ops.verify_accept,
                                  [(p, 0), (r, 0), (tau, 0)], [0, 0]),
        "verify_accept_mixed_sharded": (
            ops.verify_accept_mixed,
            [(p, 0), (r, 0), (tau, 0), (gs, 0), (paired, 0)], [0, 0]),
        "verify_accept_pairs_sharded": (
            ops.verify_accept_pairs,
            [(p, 0), (r, 0), (tau[0::2], 0), (gs[0::2], 0)], [0, 0]),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(ops.SHARDED_ROUTINGS))
def test_sharded_routings_bitwise_on_card(cuda, dtype, name):
    """Each routing at D = 2 shards on one card: bitwise the unsharded
    kernel's lanes, one launch a shard (counted under the kernel and the
    routing)."""
    from repro_torch.launch.mesh import LaneMesh
    from repro_torch.sharding import specs as SH
    mesh = LaneMesh([torch.device("cuda", torch.cuda.current_device())] * 2)
    plain, args, axes = _shard_cases(cuda, dtype)[name]
    blocks = [SH.split_lanes(t, mesh, a) for t, a in args]
    want = plain(*[t for t, _ in args])
    want = list(want) if isinstance(want, tuple) else [want]
    ops.reset_launch_counts()
    got = getattr(ops, name)(*blocks, mesh=mesh)
    got = list(got) if isinstance(got, tuple) else [got]
    torch.cuda.synchronize()
    n = ops.launch_counts()
    assert n[name] == 2 and sum(n.values()) == 4, n
    for g, w, a in zip(got, want, axes):
        assert all(b.device.type == "cuda" for b in g)
        assert torch.equal(SH.gather_lanes(g, a), w), name


@pytest.mark.cuda
def test_sharded_routing_rejects_non_contiguous_block_on_card(cuda):
    """A lane block that is a view of the whole table (lane axis 3: not
    contiguous) raises on the card and allocates nothing: the routing
    never copies a block."""
    from repro_torch.launch.mesh import LaneMesh
    mesh = LaneMesh([torch.device("cuda", torch.cuda.current_device())] * 2)
    d, f, w, mask = _inputs((3, 2, 2, 4, 8, 16), torch.float32, cuda)
    views = [d[:, :, :, :2], d[:, :, :, 2:]]
    ws = [w[:, :2].contiguous(), w[:, 2:].contiguous()]
    fs = [f[:, :, :2].contiguous(), f[:, :, 2:].contiguous()]
    ms = [mask[:2].contiguous(), mask[2:].contiguous()]
    assert not views[0].is_contiguous()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="contiguous"):
        ops.taylor_predict_lanes_sharded(views, ws, mesh=mesh)
    with pytest.raises(ValueError, match="contiguous"):
        ops.taylor_update_lanes_sharded(views, fs, ms, mesh=mesh)
    assert torch.cuda.memory_allocated() == before
    assert sum(ops.launch_counts().values()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("D", [2, 4])
def test_sharded_engine_keeps_counters_on_card(cuda, D):
    """The small DiT at lanes 4 over D shards on one card: the unsharded
    engine's counters and host syncs, samples within 1e-5, every kernel
    of the path launched through its routing."""
    from repro_torch.launch.mesh import LaneMesh
    from repro_torch.serving import Request, SpeCaEngine
    cfg, params, dcfg = _small_dit(cuda)
    reqs = [Request(request_id=i, cond={"labels": torch.tensor([i])},
                    seed=i) for i in range(6)]
    base = SpeCaEngine(cfg, params, dcfg, PC.SpeCaConfig(), device=cuda)
    want = base.serve_batched(reqs, lanes=4)
    dev = torch.device("cuda", torch.cuda.current_device())
    eng = SpeCaEngine(cfg, params, dcfg, PC.SpeCaConfig(), device=cuda,
                      mesh=LaneMesh([dev] * D))
    ops.reset_launch_counts()
    got = eng.serve_batched(reqs, lanes=4)
    n = ops.launch_counts()
    assert all(n[k] > 0 for k in ("taylor_predict_lanes_sharded",
                                  "taylor_update_lanes_sharded",
                                  "verify_accept_sharded")), n
    assert n["verify_accept"] == n["verify_accept_sharded"]
    assert eng.host_syncs == base.host_syncs
    for a, b in zip(want, got):
        assert (a.num_full, a.num_spec, a.accepts, a.flops) == \
            (b.num_full, b.num_spec, b.accepts, b.flops)
        torch.testing.assert_close(a.sample, b.sample, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 4])
def test_sharded_flags_reach_the_accumulator_sync_free_on_card(cuda, K):
    """Two shards' flags joined on the card (``lane_step.gather_flags``,
    as the engine joins them for its accumulator) and folded in under
    sync-debug mode "error": no sync, and the flush equals the flags'
    unsharded flush."""
    from repro_torch.core.lane_step import gather_flags
    from repro_torch.obs import LaneAccumulator, MetricsRegistry
    ticks = [{k: v.to(cuda) for k, v in _acc_flags(8, K, s).items()}
             for s in range(4)]
    shards = [[{k: v[..., i * 4:(i + 1) * 4].contiguous()
                for k, v in f.items()} for i in range(2)] for f in ticks]
    whole, joined = LaneAccumulator(), LaneAccumulator()
    for f in ticks:
        whole.update(f)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for sh in shards:
            joined.update(gather_flags(sh))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    regs = MetricsRegistry(), MetricsRegistry()
    whole.flush_into(regs[0], workload="diffusion")
    joined.flush_into(regs[1], workload="diffusion")
    assert regs[0].snapshot() == regs[1].snapshot()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forecast_in_column_blocks_equals_it_whole_on_card(cuda, dtype):
    """The whole-batch forecast over column blocks (the path of a table
    over more elements than ``taylor.MAX_ELEMENTS``, here 3,000 elements:
    1,000 columns a block) equals the forecast in one product on the card
    to the product's rounding: cuBLAS picks another kernel for another width, so f32 within a few
    ulps of the largest term Σ|w_i·Δⁱ| (2^-21 of it), bf16 within one
    ulp."""
    from repro_torch.core import taylor
    g = torch.Generator(device=cuda).manual_seed(3)
    state = {"diffs": torch.randn((3, 4, 2, 2, 64, 72), generator=g,
                                  device=cuda).to(dtype),
             "n_anchors": torch.tensor(3, dtype=torch.int32, device=cuda),
             "anchor_step": torch.tensor(2, dtype=torch.int32, device=cuda),
             "gap": torch.tensor(2.0, device=cuda)}
    step = torch.tensor(5, dtype=torch.int32, device=cuda)
    whole = taylor.predict(state, step)
    w = taylor.prediction_weights(2, torch.tensor(3.0, device=cuda),
                                  state["gap"], state["n_anchors"])
    blocks = taylor._contract(w, state["diffs"], max_elements=3000)
    assert blocks.dtype == dtype and blocks.shape == whole.shape
    if dtype == torch.float32:
        terms = (w.reshape(-1, *[1] * 5).abs()
                 * state["diffs"].abs()).sum(0)
        assert bool(((blocks - whole).abs() <= 2.0 ** -21 * terms).all())
    else:
        torch.testing.assert_close(blocks, whole, rtol=2.0 ** -8,
                                   atol=2.0 ** -8)

