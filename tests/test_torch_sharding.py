"""Lane sharding of the port (``repro_torch.sharding.specs``,
``repro_torch.launch.mesh`` and the ``ops.*_sharded`` routings) against
the JAX package's lane rules and sharded kernel wrappers, on the CPU.

Held: the lane rules key by key and the width multiples against
``repro.sharding.specs`` (whose functions read a mesh's ``shape``, so
they take the port's mesh as they are); split then gather bitwise on
every lane-state key; ``init_workload_state(mesh=)`` bitwise the split
unsharded state, and its width rules; every routing at D ∈ {1, 2, 4} CPU
shards bitwise the port's unsharded call, in f32 and bf16, counting no
launch on the CPU; at D = 1 the routings against the reference's
``ops.*_sharded`` on ``make_lane_mesh(1)``, at the kernel parity bars of
``tests/test_torch_kernels.py`` (bitwise where the kernel copies or
subtracts: the refresh, the ring shift, the rollback; the predicts to
FMA rounding, the verify error to rtol 1e-5 with identical accept bits);
the 2·D pair rule raising ``ValueError``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.launch.mesh import make_lane_mesh as jmake_lane_mesh
from repro.sharding import specs as JSH
from repro_torch import configs as PC
from repro_torch.core import lane_step as PLS
from repro_torch.core.workload import DecodeWorkload, DiffusionWorkload
from repro_torch.kernels import ops
from repro_torch.launch.mesh import LaneMesh, make_lane_mesh
from repro_torch.layers.model import init_params
from repro_torch.sharding import specs as SH

torch.set_num_threads(2)

DS = (1, 2, 4)
DTYPES = (torch.float32, torch.bfloat16)
W, K = 8, 3
TABLE = (3, 2, 2, W, 5, 12)      # [m+1, L, 2, W, T, D]: C = 60


def _mesh(D):
    return make_lane_mesh(D, device="cpu")


# --- the lane rules ----------------------------------------------------------

def test_lane_rules_match_reference():
    assert SH.LANE_AXIS == JSH.LANE_AXIS == "data"
    assert SH.LANE_STATE_AXES == JSH.LANE_STATE_AXES
    assert SH.lane_shard_count(None) == JSH.lane_shard_count(None) == 1
    assert SH.lane_shard_count(jmake_lane_mesh(1)) == 1
    for D in DS:
        mesh = _mesh(D)
        assert SH.lane_shard_count(mesh) == JSH.lane_shard_count(mesh) == D
        for streams in (1, 2):
            assert SH.lane_width_multiple(mesh, streams=streams) == \
                JSH.lane_width_multiple(mesh, streams=streams) == streams * D


def test_make_lane_mesh_on_the_cpu_and_explicit_devices():
    mesh = make_lane_mesh(4, device="cpu")
    assert mesh.size == 4 and mesh.axis_names == ("data",)
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert mesh.distinct_devices() == [torch.device("cpu")]
    assert make_lane_mesh(device="cpu").size == 1
    with pytest.raises(ValueError, match=">= 1"):
        make_lane_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="1-D"):
        LaneMesh(["cpu"], axis_names=("data", "model"))
    with pytest.raises(ValueError, match="no 'data' axis"):
        SH.lane_shard_count(LaneMesh(["cpu"], axis_names=("model",)))


def _random_state(seed=0):
    """Every lane-state key (decode's caches and the controller's vectors
    included) filled from a numpy seed, W lanes, plus one unknown key."""
    rng = np.random.default_rng(seed)

    def t(shape, dtype=np.float32):
        if dtype == np.int32:
            return torch.from_numpy(rng.integers(-50, 50, size=shape)
                                    .astype(np.int32))
        if dtype == bool:
            return torch.from_numpy(rng.random(size=shape) < 0.5)
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    st = {}
    for key, axis in SH.LANE_STATE_AXES.items():
        shape = {"x": (W, 4, 4, 2), "diffs": TABLE, "tok": (W, 1),
                 "tokens": (W, 6), "k": (2, W, 7, 2, 4), "v": (2, W, 7, 2, 4),
                 "ssm_state": (2, W, 2, 3, 4),
                 "conv_state": (2, W, 3, 5)}.get(key, (W,))
        assert shape[axis] == W, key
        dtype = bool if key in ("active", "paired", "ctl_on", "ctl_dl") \
            else np.int32 if key in ("since", "step", "draft_k", "tok",
                                     "tokens", "pos0", "n_anchors") \
            else np.float32
        st[key] = t(shape, dtype)
    st["diffs"] = st["diffs"].to(torch.bfloat16)
    st["cond"] = {"labels": t((W,), np.int32), "text": t((W, 3, 4))}
    st["extra"] = t((5,))
    return st


@pytest.mark.parametrize("D", DS)
def test_split_then_gather_is_bitwise(D):
    mesh = _mesh(D)
    st = _random_state()
    shards = SH.split_lane_state(st, mesh)
    assert len(shards) == D
    for i, sh in enumerate(shards):
        for key, axis in SH.LANE_STATE_AXES.items():
            block = sh[key]
            assert block.is_contiguous() and block.shape[axis] == W // D
            want = st[key].narrow(axis, i * (W // D), W // D)
            assert torch.equal(block, want), key
            assert block.data_ptr() != st[key].data_ptr()     # a copy
        assert torch.equal(sh["extra"], st["extra"])           # replicated
        assert sh["cond"]["text"].shape == (W // D, 3, 4)
    back = SH.gather_lane_state(shards)
    assert set(back) == set(st)
    for key in SH.LANE_STATE_AXES:
        assert back[key].dtype == st[key].dtype
        assert torch.equal(back[key], st[key]), key
    for k in st["cond"]:
        assert torch.equal(back["cond"][k], st["cond"][k])
    assert torch.equal(back["extra"], st["extra"])
    if D > 1:
        with pytest.raises(ValueError, match="not divisible"):
            SH.split_lane_state({"since": torch.zeros(W + 1)}, mesh)


def _tiny_dit():
    cfg = PC.ModelConfig(name="t", num_layers=2, d_model=16, num_heads=2,
                         d_ff=32, num_classes=4, dtype="float32")
    dcfg = PC.DiffusionConfig(num_inference_steps=4, latent_size=4)
    return cfg, dcfg


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("guidance, controller", [(False, False),
                                                  ("mixed", True)])
def test_init_state_on_a_mesh_is_the_split_state(D, guidance, controller):
    cfg, dcfg = _tiny_dit()
    wl = DiffusionWorkload(cfg, None, dcfg, PC.SpeCaConfig(), device="cpu")
    cond = {"labels": torch.tensor([3])}
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(W, 4, 4, cfg.in_channels)).astype(np.float32))
    kw = dict(x=x, guidance=guidance, controller=controller)
    whole = PLS.init_workload_state(wl, W, cond, **kw)
    shards = PLS.init_workload_state(wl, W, cond, mesh=_mesh(D), **kw)
    want = SH.split_lane_state(whole, _mesh(D))
    assert len(shards) == D
    for got, exp in zip(shards, want):
        assert set(got) == set(exp)
        for key in got:
            if key == "cond":
                assert torch.equal(got[key]["labels"], exp[key]["labels"])
            else:
                assert torch.equal(got[key], exp[key]), key
    for i, sh in enumerate(shards):
        assert sh["diffs"].is_contiguous()
    # the width rules: W by D, and by 2·D in a guidance mode
    with pytest.raises(ValueError, match="lane-shard count 4"):
        PLS.init_workload_state(wl, 6, cond, mesh=_mesh(4))
    with pytest.raises(ValueError, match="straddle a shard"):
        PLS.init_workload_state(wl, 4, cond, guidance="mixed",
                                mesh=_mesh(4))
    with pytest.raises(ValueError, match="straddle a shard"):
        PLS.build_workload_step(wl, lanes=6, guidance=True, mesh=_mesh(2))


def test_workload_replicas_are_made_once_per_device():
    cfg, dcfg = _tiny_dit()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    wl = DiffusionWorkload(cfg, params, dcfg, PC.SpeCaConfig(), device="cpu")
    assert wl.on("cpu") is wl
    lm = PC.ModelConfig(name="lm", arch_type="dense", num_layers=1,
                        d_model=8, num_heads=2, num_kv_heads=1, d_ff=16,
                        vocab_size=20, dtype="float32")
    dec = DecodeWorkload(lm, init_params(lm, torch.Generator(),
                                         device="cpu"),
                         PC.SpeCaConfig(), max_new_tokens=3, max_seq_len=8,
                         device="cpu")
    # another device's replica copies the parameters once; on the CPU the
    # copy is made with _replica directly
    for w in (wl, dec):
        rep = w._replica(torch.device("cpu"))
        assert type(rep) is type(w) and rep.num_steps == w.num_steps
        assert rep.dyn_axes == w.dyn_axes


# --- the routings ------------------------------------------------------------

def _np32(x):
    return x.to(torch.float32).numpy() if x.is_floating_point() \
        else x.numpy()


def _inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    m1 = TABLE[0]

    def f(shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale)
                                .astype(np.float32))
    table = f(TABLE).to(dtype)
    feats = f(TABLE[1:]).to(dtype)
    w = torch.from_numpy(rng.uniform(0.1, 2.0, size=(m1, W))
                         .astype(np.float32))
    w[1:, 0] = 0.0
    wc = torch.from_numpy(rng.uniform(-1.0, 2.0, size=(m1, K, W))
                          .astype(np.float32))
    mask = torch.from_numpy(rng.random(W) < 0.5)
    chain = f((K + 1,) + TABLE[1:]).to(dtype)
    idx = torch.from_numpy(rng.integers(-1, K + 2, size=W).astype(np.int32))
    pred = f((W, 60)).to(dtype)
    real = (pred.float() + f((W, 60), 0.05)).to(dtype)
    tau = torch.from_numpy(np.array([0.01, 0.1, 1.0, 10.0] * (W // 4),
                                    np.float32))
    gs = torch.from_numpy(rng.uniform(1.0, 5.0, size=W).astype(np.float32))
    gs = gs.reshape(-1, 2)[:, :1].expand(-1, 2).reshape(W).contiguous()
    paired = torch.tensor([True, True, False, False] * (W // 4))
    return dict(table=table, feats=feats, w=w, wc=wc, mask=mask,
                chain=chain, idx=idx, pred=pred, real=real, tau=tau, gs=gs,
                paired=paired)


def _cases(x):
    """(routing, unsharded call, per-shard arguments as (tensor, lane axis)
    pairs and keywords)."""
    sp = lambda t, axis: (t, axis)                       # noqa: E731
    return {
        "taylor_predict_lanes_sharded": (
            ops.taylor_predict_lanes, [sp(x["table"], 3), sp(x["w"], 1)],
            lambda o: [(o, 2)]),
        "spectral_predict_lanes_sharded": (
            ops.spectral_predict_lanes, [sp(x["table"], 3), sp(x["w"], 1)],
            lambda o: [(o, 2)]),
        "taylor_predict_chain_lanes_sharded": (
            ops.taylor_predict_chain_lanes,
            [sp(x["table"], 3), sp(x["wc"], 2)], lambda o: [(o, 3)]),
        "spectral_predict_chain_lanes_sharded": (
            ops.spectral_predict_chain_lanes,
            [sp(x["table"], 3), sp(x["wc"], 2)], lambda o: [(o, 3)]),
        "lane_rollback_sharded": (
            ops.lane_rollback, [sp(x["chain"], 3), sp(x["idx"], 0)],
            lambda o: [(o, 2)]),
        "taylor_update_lanes_sharded": (
            ops.taylor_update_lanes,
            [sp(x["table"], 3), sp(x["feats"], 2), sp(x["mask"], 0)],
            lambda o: [(o, 3)]),
        "spectral_update_lanes_sharded": (
            ops.spectral_update_lanes,
            [sp(x["table"], 3), sp(x["feats"], 2), sp(x["mask"], 0)],
            lambda o: [(o, 3)]),
        "verify_accept_sharded": (
            ops.verify_accept,
            [sp(x["pred"], 0), sp(x["real"], 0), sp(x["tau"], 0)],
            lambda o: [(o[0], 0), (o[1], 0)]),
        "verify_accept_mixed_sharded": (
            ops.verify_accept_mixed,
            [sp(x["pred"], 0), sp(x["real"], 0), sp(x["tau"], 0),
             sp(x["gs"], 0), sp(x["paired"], 0)],
            lambda o: [(o[0], 0), (o[1], 0)]),
        "verify_accept_pairs_sharded": (
            ops.verify_accept_pairs,
            [sp(x["pred"], 0), sp(x["real"], 0), sp(x["tau"][0::2], 0),
             sp(x["gs"][0::2], 0)],
            lambda o: [(o[0], 0), (o[1], 0)]),
    }


def _run_sharded(name, args, mesh):
    blocks = [SH.split_lanes(t, mesh, axis) for t, axis in args]
    return getattr(ops, name)(*blocks, mesh=mesh)


ROUTINGS = sorted(_cases(_inputs(torch.float32)))


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ROUTINGS)
def test_routing_is_bitwise_the_unsharded_call(name, dtype, D):
    x = _inputs(dtype)
    plain, args, outs = _cases(x)[name]
    mesh = _mesh(D)
    want = plain(*[t for t, _ in args])
    ops.reset_launch_counts()
    got = _run_sharded(name, args, mesh)
    assert sum(ops.launch_counts().values()) == 0        # CPU: plain path
    got = [got] if isinstance(got, list) else list(got)
    assert all(len(g) == D for g in got)
    for g, (w, axis) in zip(got, outs(want)):
        assert all(b.device == torch.device("cpu") for b in g)
        joined = SH.gather_lanes(g, axis)
        assert joined.dtype == w.dtype
        assert torch.equal(joined, w), name


def test_routing_rollback_from_snapshot_lists():
    """The chain step's form: each shard's snapshots as a list."""
    x = _inputs(torch.float32)
    mesh = _mesh(2)
    snaps = [SH.split_lanes(s, mesh, 2) for s in x["chain"]]
    per_shard = [[s[i] for s in snaps] for i in range(2)]
    got = ops.lane_rollback_sharded(per_shard, SH.split_lanes(x["idx"], mesh),
                                    mesh=mesh)
    assert torch.equal(SH.gather_lanes(got, 2),
                       ops.lane_rollback(x["chain"], x["idx"]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ROUTINGS)
def test_routing_at_one_shard_matches_reference(name, dtype):
    """D = 1 against the reference's routing on its one-device mesh, at
    the kernel parity bars."""
    x = _inputs(dtype)
    _, args, outs = _cases(x)[name]

    def jarr(t):
        if t.dtype == torch.bfloat16:       # exact through f32
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(t.numpy())
    jargs = [jarr(t) for t, _ in args]
    jmesh = jmake_lane_mesh(1)
    kw = {} if name.startswith("verify") else {"lane_axis": 2}
    jout = getattr(jops, name)(*jargs, mesh=jmesh, **kw)
    jout = list(jout) if isinstance(jout, tuple) else [jout]
    got = _run_sharded(name, args, _mesh(1))
    got = [got] if isinstance(got, list) else list(got)
    exact = name in ("lane_rollback_sharded", "taylor_update_lanes_sharded",
                     "spectral_update_lanes_sharded")
    for g, j in zip(got, jout):
        p = _np32(g[0])
        r = np.asarray(j.astype(jnp.float32)) \
            if jnp.issubdtype(j.dtype, jnp.floating) else np.asarray(j)
        if exact or p.dtype == bool:
            np.testing.assert_array_equal(p, r)
        elif name.startswith("verify"):
            np.testing.assert_allclose(p, r, rtol=1e-5)
        else:
            tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
            np.testing.assert_allclose(p, r, rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ["verify_accept_mixed_sharded",
                                  "verify_accept_pairs_sharded"])
@pytest.mark.parametrize("D, lanes", [(8, 8), (2, 6), (4, 4)])
def test_pair_rule_raises(name, D, lanes):
    """W must be a multiple of 2·D so no pair straddles a shard: W = 8 on
    8 shards (a lane a shard), 6 on 2 (odd blocks), 4 on 4."""
    x = _inputs(torch.float32)
    _, args, _ = _cases(x)[name]
    lane_sizes = [lanes // D] * D

    def blocks(t):
        if t.shape[0] == W:                      # per lane
            return list(torch.split(t[:lanes], lane_sizes))
        # per pair: whatever is left of each shard's whole pairs
        return [t[:0]] * D
    mesh = _mesh(D)
    with pytest.raises(ValueError, match=f"2·D={2 * D}"):
        getattr(ops, name)(*[blocks(t) for t, _ in args], mesh=mesh)


def test_routing_rejects_blocks_that_do_not_fit_the_mesh():
    x = _inputs(torch.float32)
    mesh = _mesh(2)
    d = SH.split_lanes(x["table"], mesh, 3)
    w = SH.split_lanes(x["w"], mesh, 1)
    with pytest.raises(ValueError, match="3 blocks for a mesh of 2"):
        ops.taylor_predict_lanes_sharded(d + d[:1], w + w[:1], mesh=mesh)
    with pytest.raises(ValueError, match="block 1 lies on meta"):
        ops.taylor_predict_lanes_sharded([d[0], d[1].to("meta")], w,
                                         mesh=mesh)
    with pytest.raises(ValueError, match="no 'data' axis"):
        ops.taylor_predict_lanes_sharded(
            d, w, mesh=LaneMesh(["cpu", "cpu"], axis_names=("model",)))
