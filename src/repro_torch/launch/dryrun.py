"""Multi-pod dry run: lay out every (arch × shape × mesh) on a fake
256/512-rank mesh and read its per-device cost (the reference's
``repro.launch.dryrun``).

No array is allocated: parameters, optimizer state, caches and batches
are DTensors over a ``fake`` process group (``launch.mesh.fake_world``)
whose local shards are fake tensors, and the port's own train, prefill
and decode steps run on them eagerly under
``cost_analysis.StepRecorder``. A combination that cannot be laid out
raises, and ``main`` exits non-zero naming it.

Each record has the reference's fields, with these differences in kind:

- ``flops_per_device``: the FLOPs of one rank's local ops on its shards,
  by ``torch.utils.flop_counter``'s formulas, not XLA's
  ``cost_analysis()``: elementwise work is not counted.
- ``bytes_per_device``: the bytes one rank's local ops read and write,
  each op that is not a view on its own (XLA's "bytes accessed" counts a
  fusion's operands and results once).
- ``memory.argument_bytes`` / ``output_bytes``: the bytes of one rank's
  local shards of the arguments and of the outputs.
- ``memory.temp_bytes``: the peak of live local bytes during the step
  beyond the arguments, as the eager program holds them; there is no
  buffer assignment, so this is not XLA's figure.
- ``memory.generated_code_bytes``: null, there is no compiler.
- ``lower_s`` and ``compile_s`` are replaced by ``trace_s``, the wall
  time of the step's eager run on fake tensors.
- ``run_calibrated`` keeps the reference's two-point form, but the port
  runs every layer, so there is no scan undercount: the extrapolation
  equals the direct count.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
      [--out DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict

from repro_torch.configs import (ASSIGNED, SHAPES, ModelConfig, ShapeConfig,
                                 get_config, long_context_arch)
from repro_torch.launch.cost_analysis import (StepRecorder, total_wire_bytes,
                                              tree_bytes)
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.steps import build_step

ARTIFACT_DIR = os.path.join("build", "dryrun")


def _place(out: Any, sharding: Any) -> Any:
    """Outputs moved to their shardings, as ``jit(out_shardings=)``
    does; None leaves a subtree as the step left it."""
    if sharding is None:
        return out
    if isinstance(out, dict):
        return {k: _place(v, sharding[k]) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_place(o, s) for o, s in zip(out, sharding))
    from torch.distributed.tensor import DTensor

    if isinstance(out, DTensor):
        return out.redistribute(sharding.mesh, sharding.placements)
    return out


def measure(fn, args: tuple, out_sh: Any) -> Dict[str, Any]:
    """``fn(*args)`` on DTensor arguments (fake local shards, inside a
    ``FakeTensorMode`` and the mesh's process group), its outputs placed
    by ``out_sh`` -> {"flops", "bytes", "collectives", "argument_bytes",
    "output_bytes", "temp_bytes", "trace_s"}."""
    from torch.distributed.tensor.experimental import implicit_replication

    t0 = time.perf_counter()
    # the layers' own plain tensors (positions, masks) join the DTensors
    # as replicated values
    with StepRecorder(args) as rec, implicit_replication():
        out = _place(fn(*args), out_sh)
    trace_s = time.perf_counter() - t0
    return {"flops": rec.flops, "bytes": rec.bytes_accessed,
            "collectives": rec.collectives(),
            "argument_bytes": tree_bytes(args),
            "output_bytes": tree_bytes(out),
            "temp_bytes": rec.peak_bytes, "trace_s": trace_s}


def measure_step(cfg: ModelConfig, shape: ShapeConfig, mesh
                 ) -> Dict[str, Any]:
    """One step of ``cfg`` at ``shape`` laid out on ``mesh`` (inside a
    process group of its size), measured by :func:`measure`."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fn, args, _, out_sh = build_step(cfg, shape, mesh)
        return measure(fn, args, out_sh)


def _mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def _save(rec: Dict[str, Any], save_dir: str, suffix: str = "") -> None:
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fname = (f"{rec['arch'].replace('+', '_')}_{rec['shape']}_"
                 f"{rec['mesh']}{suffix}.json")
        with open(os.path.join(save_dir, fname), "w") as f:
            json.dump(rec, f, indent=1)


def run_dryrun(arch: str, shape_name: str, *, multi_pod: bool = False,
               save_dir: str = ARTIFACT_DIR, verbose: bool = True
               ) -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = _mesh_name(multi_pod)
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        m = measure_step(cfg, shape, mesh)
        num_devices = mesh.size()
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "num_devices": num_devices,
        "kind": shape.kind,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "flops_per_device": float(m["flops"]),
        "bytes_per_device": float(m["bytes"]),
        "collectives": m["collectives"],
        "collective_wire_bytes_per_device":
            total_wire_bytes(m["collectives"]),
        "memory": {
            "argument_bytes": int(m["argument_bytes"]),
            "output_bytes": int(m["output_bytes"]),
            "temp_bytes": int(m["temp_bytes"]),
            "generated_code_bytes": None,
        },
        "trace_s": round(m["trace_s"], 2),
    }
    _save(rec, save_dir)
    if verbose:
        print(f"[dryrun] {arch} × {shape_name} × {mesh_name}: "
              f"flops/dev={rec['flops_per_device']:.3e} "
              f"bytes/dev={rec['bytes_per_device']:.3e} "
              f"coll={rec['collective_wire_bytes_per_device']:.3e}B "
              f"temp={rec['memory']['temp_bytes'] / 2**30:.2f}GiB "
              f"(trace {m['trace_s']:.1f}s)", flush=True)
    return rec


def arch_for_shape(arch: str, shape_name: str) -> str:
    """long_500k swaps pure full-attention archs to their +swa variant."""
    if shape_name == "long_500k":
        return long_context_arch(arch)
    return arch


def calibrate(cfg: ModelConfig, shape: ShapeConfig, mesh
              ) -> Dict[str, Any]:
    """The reference's two-point layer extrapolation on ``mesh``:
    m(L) ≈ m(1) + (L − 1)·[m(2) − m(1)] for FLOPs, bytes and wire bytes,
    from steps traced at L = 1 and 2."""
    metrics = {}
    for n in (1, 2):
        m = measure_step(dataclasses.replace(
            cfg, num_layers=n, name=cfg.name + f"@L{n}"), shape, mesh)
        metrics[n] = {"flops": float(m["flops"]),
                      "bytes": float(m["bytes"]),
                      "wire": total_wire_bytes(m["collectives"])}
    L = cfg.num_layers
    corr = {k: metrics[1][k] + (L - 1) * (metrics[2][k] - metrics[1][k])
            for k in metrics[1]}
    return {"l1": metrics[1], "l2": metrics[2], "corrected": corr}


def run_calibrated(arch: str, shape_name: str, *, multi_pod: bool = False,
                   save_dir: str = ARTIFACT_DIR) -> Dict[str, Any]:
    """Layer-extrapolated metrics, the reference's record. The reference
    needs them because XLA counts a scanned layer body once; the port
    runs every layer, so they equal the direct count (a check on the
    per-layer accounting)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = _mesh_name(multi_pod)
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        cal = calibrate(cfg, shape, mesh)
        num_devices = mesh.size()
    corr = cal["corrected"]
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "num_devices": num_devices, "kind": shape.kind,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "num_layers": cfg.num_layers,
        "l1": cal["l1"], "l2": cal["l2"],
        "flops_per_device_corrected": corr["flops"],
        "bytes_per_device_corrected": corr["bytes"],
        "collective_wire_bytes_corrected": corr["wire"],
    }
    _save(rec, save_dir, "_cal")
    print(f"[dryrun-cal] {arch} × {shape_name}: "
          f"flops/dev={corr['flops']:.3e} bytes/dev={corr['bytes']:.3e} "
          f"wire={corr['wire']:.3e}B", flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--calibrate", action="store_true",
                    help="layer-extrapolated metrics from L=1 and L=2")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else sorted(ASSIGNED)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for arch in archs:
        for shape_name in shapes:
            eff = arch_for_shape(arch, shape_name)
            for mp in meshes:
                try:
                    if args.calibrate:
                        run_calibrated(eff, shape_name, multi_pod=mp,
                                       save_dir=args.out)
                    else:
                        run_dryrun(eff, shape_name, multi_pod=mp,
                                   save_dir=args.out)
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    failures.append((eff, shape_name, mp, repr(e)[:200]))
                    print(f"[dryrun] FAIL {eff} × {shape_name} "
                          f"(multi_pod={mp}): {e!r}", flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")
    print("[dryrun] all combinations laid out and traced OK")


if __name__ == "__main__":
    main()
