"""The port's SpeCa-step dry run against the JAX package, on the CPU.

Held:
- leaf for leaf: ``flux-like`` (latent 128) and ``dit-xl2`` (latent 32)
  at full width and depth × ``pod16x16`` at batch 16 and ``pod2x16x16``
  at batch 32 × a ``bfloat16`` and a ``float32`` table, no step run:
  every argument leaf and every output of both steps gets the reference's
  ``PartitionSpec``, its rank-0 local shape equals the reference's
  ``NamedSharding.shard_shape``, and the summed argument bytes (scalars
  counted, 4 bytes each) are equal. The reference's side runs in a
  subprocess (importing its module sets ``XLA_FLAGS`` to 512 host
  devices) and calls only ``build`` and ``jax.eval_shape``;
- batch 16 on ``pod2x16x16`` raises in both packages (32 data shards);
- numbers: reduced ``flux-like`` and ``dit-xl2`` (2 layers, d_model 256,
  f32), the reference's weights carried across by ``params_from_jax``,
  latents, cond or labels and a filled table drawn from a numpy seed: the
  port's ``full_step`` and ``spec_step`` on plain CPU tensors against the
  reference's closures from ``build`` on a one-device mesh. Next latents
  within rtol = atol = 1e-5; the refreshed table within 1e-5 in f32 and
  one bf16 ulp with a ``bfloat16`` table (each plane's rounding adds at
  most one ulp to what the plane below it carries, ``_hold_bf16_refresh``);
  ``err`` within rtol 1e-4;
- FLOPs per device: on a (1, 1) mesh the dry count of each step equals
  ``FlopCounterMode`` over the same step on plain fake tensors, exactly;
- the CLI writes one full-width record with both steps' fields, a
  refused layout exits non-zero naming the cause, and no process group
  outlives a dry run.
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import \
    _compute_local_shape_and_global_offset
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (DiffusionConfig, SpeCaConfig, get_config,
                                 reduced)
from repro_torch.convert import params_from_jax
from repro_torch.launch import cost_analysis as C
from repro_torch.launch import dryrun_speca as DS
from repro_torch.launch.dryrun import measure
from repro_torch.launch.mesh import (fake_world, make_local_mesh,
                                     make_production_mesh)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LATENT = {"flux-like": 128, "dit-xl2": 32}
# (arch, mesh, batch, table dtype)
LAYOUTS = [(arch, mesh, batch, dt) for arch in LATENT
           for mesh, batch in (("pod16x16", 16), ("pod2x16x16", 32))
           for dt in ("bfloat16", "float32")]
NUMBERS = [(arch, dt) for arch in LATENT for dt in ("bfloat16", "float32")]
NUM_BATCH, NUM_LATENT, NUM_STEP = 2, 16, 4    # the step: 2 past the anchor
TOL = dict(rtol=1e-5, atol=1e-5)

_REFERENCE = textwrap.dedent("""
    import json, math, sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import (DiffusionConfig, SpeCaConfig, get_config,
                               reduced)
    from repro.launch import dryrun_speca as DS
    from repro.launch.mesh import make_production_mesh
    from repro.layers import model as M

    LATENT, LAYOUTS, NUMBERS = %r, %r, %r
    NUM_BATCH, NUM_LATENT, NUM_STEP = %r, %r, %r
    out_dir = sys.argv[1]

    def key(path):
        return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)

    def spec(sh):
        return [list(e) if isinstance(e, tuple) else e for e in sh.spec]

    def leaves(tree, shardings):
        out = {}
        pairs = zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                    jax.tree_util.tree_leaves(shardings))
        for (path, a), sh in pairs:
            out[key(path)] = {"spec": spec(sh), "shape": list(a.shape),
                              "bytes": a.dtype.itemsize,
                              "shard": list(sh.shard_shape(a.shape))}
        return out

    def configs(cfg, latent):
        return (DiffusionConfig(num_inference_steps=50, latent_size=latent,
                                schedule="rectified_flow"),
                SpeCaConfig(taylor_order=2))

    layouts = {}
    meshes = {"pod16x16": make_production_mesh(),
              "pod2x16x16": make_production_mesh(multi_pod=True)}
    for arch, mesh, batch, dt in LAYOUTS:
        cfg = get_config(arch)
        fns, args, in_sh, outs = DS.build(
            cfg, *configs(cfg, LATENT[arch]), batch=batch,
            table_dtype=jnp.dtype(dt), mesh=meshes[mesh])
        rec = {"in": leaves(args, in_sh)}
        for fn, out_sh, name in zip(fns, outs, ("full", "spec")):
            rec[name] = leaves(jax.eval_shape(fn, *args), out_sh)
        layouts[f"{arch}/{mesh}/{batch}/{dt}"] = rec
    refused = {}
    for arch in LATENT:
        cfg = get_config(arch)
        _, args, in_sh, _ = DS.build(cfg, *configs(cfg, LATENT[arch]),
                                     batch=16, table_dtype=jnp.bfloat16,
                                     mesh=meshes["pod2x16x16"])
        try:
            in_sh[1].shard_shape(args[1].shape)
            refused[arch] = None
        except ValueError as e:
            refused[arch] = str(e)

    def tame(tree, d, rng):
        # AdaLN-Zero and the final layer from small seeded noise (zeros
        # at init would zero every branch increment)
        tree = jax.tree_util.tree_map(np.array, tree)
        def noise(a, scale):
            return (rng.normal(size=a.shape) * scale).astype(a.dtype)
        for group in (tree["blocks"], tree["head"]):
            group["mod_w"] = noise(group["mod_w"], 0.4 / math.sqrt(d))
            group["mod_b"] = noise(group["mod_b"], 0.02)
        tree["head"]["w"] = noise(tree["head"]["w"], 1.0 / math.sqrt(d))
        tree["head"]["b"] = noise(tree["head"]["b"], 0.02)
        return tree

    def flat(tree, prefix):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(flat(v, f"{prefix}/{k}"))
            return out
        return {prefix: np.asarray(tree, dtype=np.float32)
                if np.asarray(tree).dtype == jnp.bfloat16
                else np.asarray(tree)}

    one = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    for arch, dt in NUMBERS:
        cfg = reduced(get_config(arch))
        dcfg, scfg = configs(cfg, NUM_LATENT)
        rng = np.random.default_rng(7)
        params = tame(M.init_params(cfg, jax.random.PRNGKey(0)),
                      cfg.d_model, rng)
        n_tok = (NUM_LATENT // cfg.patch_size) ** 2
        feat = (scfg.taylor_order + 1, cfg.num_layers, 2, NUM_BATCH, n_tok,
                cfg.d_model)
        inputs = {
            "x": rng.normal(size=(NUM_BATCH, NUM_LATENT, NUM_LATENT,
                                  cfg.in_channels)).astype(np.float32),
            "diffs": (rng.normal(size=feat) * 0.1).astype(np.float32)}
        if cfg.cond_dim:
            inputs["cond"] = (rng.normal(size=(NUM_BATCH, 8, cfg.cond_dim))
                              * 0.1).astype(np.float32)
        else:
            inputs["labels"] = rng.integers(
                0, cfg.num_classes, size=(NUM_BATCH,)).astype(np.int32)
        (full, spec_fn), _, _, _ = DS.build(cfg, dcfg, scfg,
                                            batch=NUM_BATCH,
                                            table_dtype=jnp.dtype(dt),
                                            mesh=one)
        tstate = {"diffs": jnp.asarray(inputs["diffs"]).astype(dt),
                  "n_anchors": jnp.int32(3), "anchor_step": jnp.int32(2),
                  "gap": jnp.float32(1.0)}
        cond = {k: jnp.asarray(inputs[k]) for k in ("cond", "labels")
                if k in inputs}
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        s = jnp.int32(NUM_STEP)
        x_full, table = jax.jit(full)(jp, jnp.asarray(inputs["x"]), tstate,
                                      s, cond)
        x_spec, err = jax.jit(spec_fn)(jp, jnp.asarray(inputs["x"]), tstate,
                                       s, cond)
        out = {**flat(params, "params"), **inputs, "x_full": x_full,
               "x_spec": x_spec, "err": err,
               **{f"table/{k}": v for k, v in table.items()}}
        np.savez(f"{out_dir}/{arch}_{dt}.npz",
                 **{k: np.asarray(v, dtype=np.float32)
                    if np.asarray(v).dtype == jnp.bfloat16
                    else np.asarray(v) for k, v in out.items()})
    print(json.dumps({"layouts": layouts, "refused": refused}))
""") % (LATENT, LAYOUTS, NUMBERS, NUM_BATCH, NUM_LATENT, NUM_STEP)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("speca_reference")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _REFERENCE, str(out_dir)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    rec["dir"] = out_dir
    return rec


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


def _local(shape, mesh, sharding):
    return list(_compute_local_shape_and_global_offset(
        torch.Size(shape), mesh.shape, [0] * mesh.ndim,
        sharding.placements)[0])


def _configs(latent):
    return (DiffusionConfig(num_inference_steps=50, latent_size=latent,
                            schedule="rectified_flow"),
            SpeCaConfig(taylor_order=2))


@pytest.fixture(scope="module")
def port_layout():
    out = {}
    for name, multi_pod in (("pod16x16", False), ("pod2x16x16", True)):
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod)
            for arch, mesh_name, batch, dt in LAYOUTS:
                if mesh_name != name:
                    continue
                cfg = get_config(arch)
                with FakeTensorMode():
                    _, args, in_sh, outs = DS.build(
                        cfg, *_configs(LATENT[arch]), batch=batch,
                        table_dtype=DS.table_dtype_of(dt), mesh=mesh)
                shardings = dict(_flat(in_sh))
                rec = {"in": {}}
                for path, a in _flat(args):
                    sh = shardings[path]
                    rec["in"][path] = {
                        "spec": _spec(sh.spec), "shape": list(a.shape),
                        "bytes": a.dtype.itemsize,
                        "shard": _local(a.shape, mesh, sh),
                        "local": list(a.to_local().shape)}
                for out_sh, step in zip(outs, ("full", "spec")):
                    rec[step] = {p: {"spec": _spec(sh.spec), "sharding": sh}
                                 for p, sh in _flat(out_sh)}
                rec["mesh"] = mesh
                out[f"{arch}/{name}/{batch}/{dt}"] = rec
        assert not dist.is_initialized()
    return out


@pytest.mark.parametrize("case", LAYOUTS,
                         ids=lambda c: "-".join(map(str, c)))
def test_specs_and_shards_match_reference(reference, port_layout, case):
    arch, mesh, batch, dt = case
    key = f"{arch}/{mesh}/{batch}/{dt}"
    want, got = reference["layouts"][key], port_layout[key]
    assert sorted(got["in"]) == sorted(want["in"]), key
    arg_bytes = {"ref": 0, "port": 0}
    for path, w in want["in"].items():
        g = got["in"][path]
        assert g["spec"] == w["spec"], (key, path)
        assert g["shape"] == w["shape"], (key, path)
        assert g["shard"] == w["shard"] == g["local"], (key, path)
        arg_bytes["ref"] += math.prod(w["shard"]) * w["bytes"]
        arg_bytes["port"] += math.prod(g["local"]) * g["bytes"]
    assert arg_bytes["port"] == arg_bytes["ref"] > 0, key
    # the outputs: the reference's shapes, the port's shardings
    for step in ("full", "spec"):
        assert sorted(got[step]) == sorted(want[step]), (key, step)
        for path, w in want[step].items():
            g = got[step][path]
            assert g["spec"] == w["spec"], (key, step, path)
            assert _local(w["shape"], got["mesh"], g["sharding"]) \
                == w["shard"], (key, step, path)


def test_table_splits_batch_and_tokens(port_layout):
    """The table's layout is the one the reference states: batch over the
    data axes, tokens over "model" (already inside the test above; named
    here so the two splits are seen)."""
    rec = port_layout["flux-like/pod2x16x16/32/bfloat16"]["in"]["2/diffs"]
    assert rec["spec"] == [None, None, None, ["pod", "data"], "model", None]
    assert rec["local"] == [3, 38, 2, 1, 256, 3072]


@pytest.fixture
def no_process_group_after():
    yield
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", sorted(LATENT))
def test_batch_16_on_two_pods_is_refused_by_both(reference, arch,
                                                 no_process_group_after):
    assert "divide" in reference["refused"][arch]
    cfg = get_config(arch)
    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True)
        with FakeTensorMode(), pytest.raises(ValueError, match="divide"):
            DS.build(cfg, *_configs(LATENT[arch]), batch=16,
                     table_dtype=torch.bfloat16, mesh=mesh)


def _unflatten(npz, prefix):
    tree = {}
    for k in npz.files:
        if not k.startswith(prefix + "/"):
            continue
        node = tree
        *path, leaf = k[len(prefix) + 1:].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = npz[k]
    return tree


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.float32(2.0 ** -126))))
    return np.exp2(e - 7)


def _hold_bf16_refresh(got: np.ndarray, want: np.ndarray) -> None:
    """A bf16 table refreshed from branches that agree to the f32 bar:
    Δ⁰ = bf16(F) within one bf16 ulp beyond that bar; each Δⁱ =
    bf16(Δⁱ⁻¹ − Δⁱ⁻¹_old) carries Δⁱ⁻¹'s difference (the subtraction is
    exact, then rounded) and adds at most one bf16 ulp of its own
    rounding: |eᵢ − eᵢ₋₁| ≤ one ulp, eᵢ = port − reference."""
    ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    err = got - want
    bar = ulp[0] + TOL["atol"] + TOL["rtol"] * np.abs(want[0])
    assert np.all(np.abs(err[0]) <= bar), np.max(np.abs(err[0]) / bar)
    for i in range(1, err.shape[0]):
        step = np.abs(err[i] - err[i - 1])
        assert np.all(step <= ulp[i]), (i, np.max(step / ulp[i]))


@pytest.mark.parametrize("case", NUMBERS, ids="-".join)
def test_steps_match_reference_numbers(reference, case):
    arch, dt = case
    ref = np.load(reference["dir"] / f"{arch}_{dt}.npz")
    cfg = reduced(get_config(arch))
    dtype = DS.table_dtype_of(dt)
    full, spec = DS.make_steps(cfg, *_configs(NUM_LATENT), "cpu")
    params = params_from_jax(_unflatten(ref, "params"), device="cpu")
    x = torch.from_numpy(ref["x"])
    tstate = {"diffs": torch.from_numpy(ref["diffs"]).to(dtype),
              "n_anchors": torch.tensor(3, dtype=torch.int32),
              "anchor_step": torch.tensor(2, dtype=torch.int32),
              "gap": torch.tensor(1.0)}
    cond = {k: torch.from_numpy(ref[k]) for k in ("cond", "labels")
            if k in ref.files}
    s = torch.tensor(NUM_STEP, dtype=torch.int32)
    with torch.no_grad():
        x_full, table = full(params, x, tstate, s, cond)
        x_spec, err = spec(params, x, tstate, s, cond)

    np.testing.assert_allclose(x_full.numpy(), ref["x_full"], **TOL)
    np.testing.assert_allclose(x_spec.numpy(), ref["x_spec"], **TOL)
    np.testing.assert_allclose(err.numpy(), ref["err"], rtol=1e-4)
    assert table["diffs"].dtype == dtype
    got, want = table["diffs"].float().numpy(), ref["table/diffs"]
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, **TOL)
    else:
        _hold_bf16_refresh(got, want)
    assert int(table["n_anchors"]) == int(ref["table/n_anchors"]) == 4
    assert int(table["anchor_step"]) == int(ref["table/anchor_step"])
    assert float(table["gap"]) == float(ref["table/gap"]) == 2.0
    # the draft really differs from the real layer: the error is no zero
    assert np.all(ref["err"] > 0)


def _to_local(tree):
    if isinstance(tree, dict):
        return {k: _to_local(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_local(v) for v in tree)
    return tree.to_local() if isinstance(tree, DTensor) else tree


@pytest.mark.parametrize("arch", sorted(LATENT))
def test_one_by_one_mesh_flops_equal_plain_flop_counter(
        arch, no_process_group_after):
    cfg = reduced(get_config(arch))
    extra = {k: v.__wrapped__ for k, v in C.EXTRA_FLOP_FORMULAS.items()}
    with fake_world(1):
        mesh = make_local_mesh((1, 1))
        with FakeTensorMode():
            fns, args, _, outs = DS.build(cfg, *_configs(NUM_LATENT),
                                          batch=NUM_BATCH,
                                          table_dtype=torch.bfloat16,
                                          mesh=mesh)
            for fn, out_sh in zip(fns, outs):
                dry = measure(fn, args, out_sh)
                with FlopCounterMode(display=False,
                                     custom_mapping=extra) as fc:
                    fn(*_to_local(args))
                assert dry["flops"] > 0 and dry["collectives"] == {}
                assert dry["flops"] == fc.get_total_flops()


def test_cli_writes_one_full_width_record(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun_speca"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads((tmp_path / "build" / "dryrun"
                      / "speca_step_flux-like_bfloat16_m2.json").read_text())
    assert {k: rec[k] for k in ("arch", "batch", "latent", "tokens",
                                "table_dtype", "order", "tag", "mesh")} == {
        "arch": "flux-like", "batch": 16, "latent": 128, "tokens": 4096,
        "table_dtype": "bfloat16", "order": 2, "tag": "",
        "mesh": "pod16x16"}
    for step in ("full_step", "spec_step"):
        assert set(rec[step]) == {"flops_per_device", "bytes_per_device",
                                  "wire_bytes", "temp_GiB", "arg_GiB",
                                  "trace_s"}
        assert rec[step]["flops_per_device"] > 0
        assert rec[step]["wire_bytes"] > 0
        assert f"{step}: flops_per_device=" in out.stdout
    # the full step runs every layer, the draft one
    assert rec["full_step"]["flops_per_device"] \
        > 10 * rec["spec_step"]["flops_per_device"]
    assert rec["full_step"]["arg_GiB"] == rec["spec_step"]["arg_GiB"]


def test_refused_layout_exits_naming_the_cause(no_process_group_after):
    with pytest.raises(SystemExit, match="does not divide"):
        DS.main(["--multi-pod", "--batch", "16"])
    with pytest.raises(ValueError, match="not understood"):
        DS.table_dtype_of("bf16")


def test_run_leaves_no_process_group(tmp_path, no_process_group_after):
    rec = DS.run("dit-xl2", latent=32, tag="t", save_dir=str(tmp_path))
    assert (tmp_path / "speca_step_dit-xl2_bfloat16_m2_t.json").exists()
    assert rec["tokens"] == 256 and rec["mesh"] == "pod16x16"
    assert rec["spec_step"]["temp_GiB"] >= 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forecast_in_column_blocks_equals_it_whole(dtype):
    """The whole-batch forecast of a table over more elements than a
    product may take (here 21 elements of a [3, 2, 2, 2, 5, 4] table: 160
    columns in 23 blocks of 7) is bitwise the forecast in one product."""
    from repro_torch.core import taylor
    g = torch.Generator().manual_seed(3)
    state = {"diffs": torch.randn((3, 2, 2, 2, 5, 4), generator=g).to(dtype),
             "n_anchors": torch.tensor(3, dtype=torch.int32),
             "anchor_step": torch.tensor(2, dtype=torch.int32),
             "gap": torch.tensor(2.0)}
    whole = taylor.predict(state, torch.tensor(5, dtype=torch.int32))
    w = taylor.prediction_weights(2, torch.tensor(3.0), state["gap"],
                                  state["n_anchors"])
    blocks = taylor._contract(w, state["diffs"], max_elements=21)
    assert blocks.dtype == dtype and blocks.shape == whole.shape
    assert torch.equal(blocks, whole)
    one = torch.tensordot(w, state["diffs"].float(), dims=([0], [0]))
    assert torch.equal(whole, one.to(dtype))
