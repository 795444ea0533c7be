"""The port's production-mesh dry run against the JAX package, on the CPU.

Held:
- spec for spec: every leaf of the params, the optimizer state, the batch
  and the cache of every assigned arch (the ``+swa`` variant where
  ``long_context_arch`` picks it) × the 4 shapes × both production meshes
  gets the reference's ``PartitionSpec``; the local shard shape DTensor
  computes for rank 0 equals the reference's
  ``NamedSharding.shard_shape``, and the summed argument bytes are equal.
  The reference's side runs in a subprocess with 512 forced host devices
  (``jax.eval_shape`` only, nothing compiled), as
  ``tests/test_sharding.py`` runs its mini dry run;
- a dim split over several axes ("pod", "data"; the long-context cache's
  every axis) splits major to minor: DTensor's offsets at several mesh
  coordinates equal the reference's ``devices_indices_map``;
- FLOPs are per device: on a (1, 1) mesh the dry run's count equals
  ``FlopCounterMode`` over the same step on plain fake tensors exactly
  (both counting the CPU flash-attention entries as their CUDA
  counterparts), and a hand-built row-parallel matmul on (2, 4) counts
  1/8 of the (1, 1) FLOPs and one all-reduce of its result at k = 4;
- ``calibrate`` equals the direct count at L = 3;
- the collective aggregation reproduces the reference parser's numbers;
- the reference's own mini case (reduced mixtral-8x7b, 4 experts,
  d_model 256, on (2, 4)) runs train, prefill and decode;
- no process group outlives a dry run, and the CLI completes one
  full-width combination.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import \
    _compute_local_shape_and_global_offset
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ASSIGNED, SHAPES, ShapeConfig, get_config,
                                 reduced)
from repro_torch.launch import cost_analysis as C
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import (fake_world, make_local_mesh,
                                     make_production_mesh)
from repro_torch.launch.steps import build_step
from repro_torch.layers import model as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = sorted(ASSIGNED)
MESHES = ["pod16x16", "pod2x16x16"]
COORDS = [(0, 0, 1), (0, 1, 0), (1, 0, 0), (1, 15, 15), (0, 3, 7)]

_REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import json
    import jax
    from jax.sharding import NamedSharding
    from repro.configs import ASSIGNED, SHAPES, get_config
    from repro.launch.dryrun import arch_for_shape
    from repro.launch.mesh import make_production_mesh
    from repro.launch.steps import build_step

    def key(path):
        return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)

    def spec(sh):
        return [list(e) if isinstance(e, tuple) else e for e in sh.spec]

    COORDS = %r
    out = {}
    for mp, name in ((False, "pod16x16"), (True, "pod2x16x16")):
        mesh = make_production_mesh(multi_pod=mp)
        for arch in sorted(ASSIGNED):
            for shape_name, shape in SHAPES.items():
                cfg = get_config(arch_for_shape(arch, shape_name))
                fn, args, in_sh, out_sh = build_step(cfg, shape, mesh)
                leaves = {}
                pairs = zip(jax.tree_util.tree_flatten_with_path(args)[0],
                            jax.tree_util.tree_leaves(in_sh))
                for (path, a), sh in pairs:
                    if not a.shape:
                        continue             # scalars: replicated
                    rec = {"spec": spec(sh), "shape": list(a.shape),
                           "bytes": a.dtype.itemsize,
                           "shard": list(sh.shard_shape(a.shape))}
                    if len(mesh.axis_names) == 3:
                        idx = sh.devices_indices_map(a.shape)
                        rec["starts"] = [
                            [s.start or 0 for s in idx[mesh.devices[tuple(c)]]]
                            for c in COORDS]
                    leaves["in/" + key(path)] = rec
                if shape.kind == "prefill":
                    cache = jax.eval_shape(
                        lambda: __import__("repro.layers.model",
                                           fromlist=["m"]).init_cache(
                            cfg, shape.global_batch, shape.seq_len))
                    for k, sh in out_sh[1].items():
                        leaves["out/cache/" + k] = {
                            "spec": spec(sh),
                            "shard": list(sh.shard_shape(cache[k].shape))}
                out[f"{name}/{arch}/{shape_name}"] = leaves
    print(json.dumps(out))
""") % (COORDS,)


@pytest.fixture(scope="module")
def reference_layout():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _REFERENCE], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def _spec(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.fixture(scope="module")
def port_layout():
    out = {}
    for name, multi_pod in (("pod16x16", False), ("pod2x16x16", True)):
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod)
            for arch in ARCHS:
                for shape_name, shape in SHAPES.items():
                    cfg = get_config(D.arch_for_shape(arch, shape_name))
                    with FakeTensorMode():
                        _, args, in_sh, out_sh = build_step(cfg, shape, mesh)
                    leaves = {}
                    shardings = dict(_flat(in_sh))
                    for path, a in _flat(args):
                        if not isinstance(a, DTensor) or not a.shape:
                            continue
                        sh = shardings[path]
                        local, _ = _compute_local_shape_and_global_offset(
                            a.shape, mesh.shape, [0] * mesh.ndim,
                            a.placements)
                        rec = {"spec": _spec(sh.spec),
                               "shape": list(a.shape),
                               "bytes": a.dtype.itemsize,
                               "shard": list(local),
                               "local": list(a.to_local().shape)}
                        if multi_pod:
                            rec["starts"] = [list(
                                _compute_local_shape_and_global_offset(
                                    a.shape, mesh.shape, list(c),
                                    a.placements)[1]) for c in COORDS]
                        leaves["in/" + path] = rec
                    if shape.kind == "prefill":
                        with FakeTensorMode():
                            cache = M.init_cache(cfg, shape.global_batch,
                                                 shape.seq_len, device="cpu")
                        for k, sh in out_sh[1].items():
                            local, _ = _compute_local_shape_and_global_offset(
                                cache[k].shape, mesh.shape, [0] * mesh.ndim,
                                sh.placements)
                            leaves["out/cache/" + k] = {
                                "spec": _spec(sh.spec), "shard": list(local)}
                    out[f"{name}/{arch}/{shape_name}"] = leaves
        assert not dist.is_initialized()
    return out


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_shards_match_reference(reference_layout, port_layout,
                                          arch, mesh):
    for shape_name in SHAPES:
        key = f"{mesh}/{arch}/{shape_name}"
        want, got = reference_layout[key], port_layout[key]
        assert sorted(got) == sorted(want), key
        arg_bytes = {"ref": 0, "port": 0}
        for path, w in want.items():
            g = got[path]
            assert g["spec"] == w["spec"], (key, path)
            if path.startswith("out/"):
                assert g["shard"] == w["shard"], (key, path)
                continue
            assert g["shape"] == w["shape"], (key, path)
            assert g["shard"] == w["shard"] == g["local"], (key, path)
            if "starts" in w:
                assert g["starts"] == w["starts"], (key, path)
            n = 1
            for d in w["shard"]:
                n *= d
            arg_bytes["ref"] += n * w["bytes"]
            n = 1
            for d in g["local"]:
                n *= d
            arg_bytes["port"] += n * g["bytes"]
        assert arg_bytes["port"] == arg_bytes["ref"], key


def test_every_axis_cache_and_pod_batch_split_major_to_minor(
        reference_layout, port_layout):
    """The long-context cache's sequence over ("pod", "data", "model") and
    the batch over ("pod", "data") start where the reference's do at
    several mesh coordinates (already inside the per-arch test; here the
    two leaves are named so the split is seen to be multi-axis)."""
    key = "pod2x16x16/llama3-8b/long_500k"
    cache = port_layout[key]["in/2/k"]
    assert cache["spec"] == [None, None, ["pod", "data", "model"], None,
                             None]
    assert cache["starts"] == reference_layout[key]["in/2/k"]["starts"]
    assert len({tuple(s) for s in cache["starts"]}) == len(COORDS)
    key = "pod2x16x16/llama3-8b/train_4k"
    tokens = port_layout[key]["in/1/tokens"]
    assert tokens["spec"] == [["pod", "data"], None]
    assert tokens["starts"] == reference_layout[key]["in/1/tokens"]["starts"]


@pytest.fixture
def no_process_group_after():
    yield
    assert not dist.is_initialized()


def _plain_flops(cfg, shape):
    """FlopCounterMode over the step on plain fake tensors (the (1, 1)
    mesh's local shards are the whole tensors)."""
    with fake_world(1):
        mesh = make_local_mesh((1, 1))
        with FakeTensorMode():
            fn, args, _, _ = build_step(cfg, shape, mesh)
            plain = _to_local(args)
            extra = {k: v.__wrapped__ for k, v in
                     C.EXTRA_FLOP_FORMULAS.items()}
            with FlopCounterMode(display=False, custom_mapping=extra) as fc:
                fn(*plain)
    return fc.get_total_flops()


def _to_local(tree):
    if isinstance(tree, dict):
        return {k: _to_local(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_local(v) for v in tree)
    return tree.to_local() if isinstance(tree, DTensor) else tree


@pytest.mark.parametrize("arch", ["llama3-8b", "mixtral-8x7b",
                                  "hymba-1.5b", "musicgen-medium"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_one_by_one_mesh_flops_equal_plain_flop_counter(
        arch, kind, no_process_group_after):
    cfg = reduced(get_config(arch))
    shape = ShapeConfig(name=kind, seq_len=32, global_batch=2, kind=kind)
    with fake_world(1):
        m = D.measure_step(cfg, shape, make_local_mesh((1, 1)))
    assert m["flops"] > 0 and m["collectives"] == {}
    assert m["flops"] == _plain_flops(cfg, shape)


def test_row_parallel_matmul_counts_one_device(no_process_group_after):
    """[64, 1024] @ [1024, 512] in f32, x split (data, model) over rows
    and the contraction, w over the contraction: each of 8 ranks does
    1/8 of the (1, 1) FLOPs, and the partial sums are all-reduced over
    the 4-wide model axis (result [32, 512] f32, wire 2·3/4 of it)."""
    M, K, N = 64, 1024, 512

    def run(shape):
        with fake_world(shape[0] * shape[1]):
            mesh = make_local_mesh(shape)
            with FakeTensorMode():
                x = DTensor.from_local(
                    torch.empty(M // shape[0], K // shape[1]), mesh,
                    [Shard(0), Shard(1)], run_check=False)
                w = DTensor.from_local(torch.empty(K // shape[1], N), mesh,
                                       [Replicate(), Shard(0)],
                                       run_check=False)
                with C.StepRecorder((x, w)) as rec:
                    (x @ w).redistribute(mesh, [Shard(0), Replicate()])
        return rec

    one, eight = run((1, 1)), run((2, 4))
    assert one.flops == 2 * M * K * N and one.collectives() == {}
    assert eight.flops * 8 == one.flops
    result = (M // 2) * N * 4
    assert eight.collectives() == {"all-reduce": {
        "count": 1, "result_bytes": result, "wire_bytes": result * 1.5}}


def test_calibrated_equals_direct_count(no_process_group_after):
    cfg = dataclasses.replace(reduced(get_config("llama3-8b")), num_layers=3)
    shape = ShapeConfig(name="prefill", seq_len=32, global_batch=4,
                        kind="prefill")
    with fake_world(8):
        mesh = make_local_mesh((2, 4))
        direct = D.measure_step(cfg, shape, mesh)
        cal = D.calibrate(cfg, shape, mesh)
    assert cal["l2"]["flops"] > cal["l1"]["flops"] > 0
    assert cal["corrected"]["flops"] == direct["flops"]
    assert cal["corrected"]["wire"] == C.total_wire_bytes(
        direct["collectives"])


def test_aggregation_reproduces_the_reference_parser():
    """The events of the reference parser's HLO text, (op, result bytes,
    k): the same record."""
    from repro.launch.hlo_analysis import parse_collectives
    txt = """
  %all-reduce.1 = f32[8,256]{1,0} all-reduce(%dot.1), channel_id=1, replica_groups=[2,4]<=[8], use_global_device_ids=true
  %all-gather.2 = bf16[16,128]{1,0} all-gather(%p), replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}
  %rs = f32[4,64]{1,0} reduce-scatter(%x), replica_groups=[1,8]<=[8]
  %nothing = f32[2,2]{1,0} add(%a, %b)
  %ar2 = (f32[10]{0}, f32[20]{0}) all-reduce(%a, %b), replica_groups=[2,4]<=[8]
"""
    events = [("all-reduce", 8 * 256 * 4, 4), ("all-gather", 16 * 128 * 2, 4),
              ("reduce-scatter", 4 * 64 * 4, 8),
              ("all-reduce", (10 + 20) * 4, 4)]
    got = C.aggregate(events)
    assert got == parse_collectives(txt)
    assert got["all-reduce"]["count"] == 2
    assert got["all-reduce"]["result_bytes"] == 8192 + (10 + 20) * 4
    assert got["reduce-scatter"]["wire_bytes"] == 4 * 64 * 4 * 7
    assert C.total_wire_bytes(got) > 0


def test_reference_mini_case_on_two_by_four(no_process_group_after):
    cfg = dataclasses.replace(reduced(get_config("mixtral-8x7b")),
                              num_experts=4, d_model=256)
    with fake_world(8):
        mesh = make_local_mesh((2, 4))
        for kind in ("train", "prefill", "decode"):
            shape = ShapeConfig(name=kind, seq_len=64, global_batch=4,
                                kind=kind)
            m = D.measure_step(cfg, shape, mesh)
            assert m["flops"] > 0 and m["argument_bytes"] > 0, kind
            assert C.total_wire_bytes(m["collectives"]) > 0, kind


def test_long_context_decode_reduces_across_ranks(no_process_group_after):
    """Batch 1: the cache's sequence is split over every axis, so decode
    attention's max, sum and output are all-reduced."""
    cfg = reduced(get_config("llama3-8b+swa"))
    shape = ShapeConfig(name="long", seq_len=64, global_batch=1,
                        kind="decode")
    with fake_world(8):
        m = D.measure_step(cfg, shape, make_local_mesh((2, 4)))
    assert m["collectives"]["all-reduce"]["count"] >= 3 * cfg.num_layers


def test_cli_completes_one_full_width_combination(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen1.5-0.5b", "--shape", "decode_32k", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads((tmp_path / "qwen1.5-0.5b_decode_32k_pod16x16.json")
                     .read_text())
    assert rec["num_devices"] == 256 and rec["flops_per_device"] > 0
    assert rec["memory"]["generated_code_bytes"] is None
    assert set(rec) >= {"arch", "shape", "mesh", "kind", "seq_len",
                        "global_batch", "bytes_per_device", "collectives",
                        "collective_wire_bytes_per_device", "memory",
                        "trace_s"}
