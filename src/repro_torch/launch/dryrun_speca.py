"""SpeCa-step dry run (the reference's ``repro.launch.dryrun_speca``): the
two step kinds of the forecast-then-verify loop of an image DiT
(FLUX-like by default) laid out on the production mesh.

  * ``full_step``  — anchor: a full forward that collects every layer's
                     two branch increments, then the difference-table
                     refresh
  * ``spec_step``  — draft: the Taylor forecast, a forward that computes
                     only the verify layer, and the relative-L2 error

As in ``launch.dryrun``, no array is allocated: the arguments are
DTensors over a ``fake`` process group whose local shards are fake
tensors, and the port's own steps run eagerly on them under
``cost_analysis.StepRecorder``. A record has the reference's fields, with
``trace_s`` (the wall time of the eager run on fake tensors) in place of
``compile_s``; FLOPs, bytes and temp bytes mean what ``launch.dryrun``'s
docstring says.

Config axes:
  --table-dtype float32|bfloat16   difference-table storage (the names
                                   the reference's ``jnp.dtype`` takes;
                                   its docstring's f32|bf16 are not)
  --order m                        Taylor order (the table holds m+1
                                   planes)
  --latent/--batch                 serving shape (latent 128 = 4,096
                                   tokens, a 1024² image; batch 16)

Image DiTs only (4-D latents): ``flux-like`` (``cond``) and ``dit-xl2``
(``labels``), both on rectified flow here. The default batch 16 does not
divide the 32 data shards of ``--multi-pod``: that layout raises, as the
reference's does, and the multi-pod records run at batch 32.

Usage:
  python -m repro_torch.launch.dryrun_speca --table-dtype float32
  python -m repro_torch.launch.dryrun_speca --batch 32 --multi-pod \\
      --tag pod2x16x16
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict

import torch

from repro_torch.configs import DiffusionConfig, SpeCaConfig, get_config
from repro_torch.core import taylor
from repro_torch.core.verify import relative_error
from repro_torch.diffusion.pipeline import make_stepper, model_inputs
from repro_torch.launch.cost_analysis import total_wire_bytes
from repro_torch.launch.dryrun import ARTIFACT_DIR, measure
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.steps import (TensorSpec, params_shapes, shard_like,
                                      shard_tree)
from repro_torch.layers import model as M
from repro_torch.sharding import specs as S

TABLE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def table_dtype_of(name: str) -> torch.dtype:
    if name not in TABLE_DTYPES:
        raise ValueError(f"table dtype {name!r} not understood; one of "
                         f"{sorted(TABLE_DTYPES)}")
    return TABLE_DTYPES[name]


def make_steps(cfg, dcfg, scfg, device):
    """(full_step, spec_step), the reference's closures on the port's
    pieces, each ``(params, x, tstate, s, labels_or_cond)``; the schedule's
    tensors live on ``device``."""
    L = cfg.num_layers
    vl = scfg.verify_layer % L
    stepper = make_stepper(dcfg, device)
    cmask = [layer == vl for layer in range(L)]

    # the schedule is read at a one-entry index [1]: indexing by the 0-d
    # step would read its value on the host
    def full_step(params, x, tstate, s, labels_or_cond):
        idx = s.reshape(1)
        inputs = model_inputs(cfg, x, stepper.t_model[idx], labels_or_cond)
        out, extras = M.dit_forward(cfg, params, inputs,
                                    collect_branches=True)
        tstate = taylor.update(tstate, extras["branches"], s)
        return stepper.advance(x, out, idx), tstate

    def spec_step(params, x, tstate, s, labels_or_cond):
        idx = s.reshape(1)
        preds = taylor.predict(tstate, s)
        inputs = model_inputs(cfg, x, stepper.t_model[idx], labels_or_cond)
        out, extras = M.dit_forward(cfg, params, inputs, branch_preds=preds,
                                    compute_mask=cmask,
                                    collect_branches=True)
        real_vl = extras["branches"][vl][0] + extras["branches"][vl][1]
        pred_vl = preds[vl][0] + preds[vl][1]
        err = relative_error(pred_vl, real_vl, metric=scfg.error_metric)
        return stepper.advance(x, out, idx), err

    return full_step, spec_step


def build(cfg, dcfg, scfg, *, batch: int, table_dtype: torch.dtype, mesh):
    """((full_step, spec_step), args, in_shardings, (out_full, out_spec))
    on ``mesh``, inside a ``FakeTensorMode`` and a process group of the
    mesh's size: ``args`` are DTensors laid out by ``in_shardings``, and
    ``out_*`` is where the dry run puts each step's outputs."""
    fns = make_steps(cfg, dcfg, scfg, torch.device("cpu"))
    n_tok = (dcfg.latent_size // cfg.patch_size) ** 2
    lat = TensorSpec((batch, dcfg.latent_size, dcfg.latent_size,
                      cfg.in_channels), torch.float32)
    feat = taylor.feature_shape_for(cfg.num_layers, batch, n_tok,
                                    cfg.d_model)
    tstate = {
        "diffs": TensorSpec((scfg.taylor_order + 1,) + feat, table_dtype),
        "n_anchors": TensorSpec((), torch.int32),
        "anchor_step": TensorSpec((), torch.int32),
        "gap": TensorSpec((), torch.float32),
    }
    cond = {"cond": TensorSpec((batch, 8, cfg.cond_dim), torch.float32)} \
        if cfg.cond_dim else {"labels": TensorSpec((batch,), torch.int32)}
    specs = (params_shapes(cfg), lat, tstate, TensorSpec((), torch.int32),
             cond)
    params_sh = S.params_shardings(cfg, mesh, specs[0])
    dp = S.data_axes(mesh)
    x_sh = S.NamedSharding(mesh, (dp, None, None, None))
    repl = S.replicated(mesh)
    # difference table [m+1, L, 2, B, T, D]: batch over data, tokens over
    # model (the sequence sharding applied to the cached features)
    table_sh = {
        "diffs": S.NamedSharding(mesh, (None, None, None, dp, "model",
                                        None)),
        "n_anchors": repl, "anchor_step": repl, "gap": repl,
    }
    cond_sh = {k: S.NamedSharding(mesh, (dp,) if len(v.shape) == 1
                                  else (dp, None, None))
               for k, v in cond.items()}
    in_sh = (params_sh, x_sh, table_sh, repl, cond_sh)
    args = tuple(shard_like(a, sh) if isinstance(a, TensorSpec)
                 else shard_tree(a, sh) for a, sh in zip(specs, in_sh))
    out_full = (x_sh, table_sh)
    out_spec = (x_sh, S.NamedSharding(mesh, (dp,)))
    return fns, args, in_sh, (out_full, out_spec)


def run(arch: str = "flux-like", *, batch: int = 16, latent: int = 128,
        table_dtype: str = "bfloat16", order: int = 2, tag: str = "",
        multi_pod: bool = False,
        save_dir: str = ARTIFACT_DIR) -> Dict[str, Any]:
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_config(arch)
    dcfg = DiffusionConfig(num_inference_steps=50, latent_size=latent,
                           schedule="rectified_flow")
    scfg = SpeCaConfig(taylor_order=order)
    dtype = table_dtype_of(table_dtype)
    rec: Dict[str, Any] = {
        "arch": arch, "batch": batch, "latent": latent,
        "tokens": (latent // cfg.patch_size) ** 2,
        "table_dtype": table_dtype, "order": order, "tag": tag,
        "mesh": "pod2x16x16" if multi_pod else "pod16x16",
    }
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        with FakeTensorMode():
            fns, args, _, out_shs = build(cfg, dcfg, scfg, batch=batch,
                                          table_dtype=dtype, mesh=mesh)
            ms = [measure(fn, args, out_sh)
                  for fn, out_sh in zip(fns, out_shs)]
        for m, name in zip(ms, ("full_step", "spec_step")):
            rec[name] = {
                "flops_per_device": float(m["flops"]),
                "bytes_per_device": float(m["bytes"]),
                "wire_bytes": total_wire_bytes(m["collectives"]),
                "temp_GiB": round(m["temp_bytes"] / 2**30, 3),
                "arg_GiB": round(m["argument_bytes"] / 2**30, 3),
                "trace_s": round(m["trace_s"], 1),
            }
            print(f"[speca-dryrun:{tag or 'base'}] {name}: "
                  + " ".join(f"{k}={v}" for k, v in rec[name].items()),
                  flush=True)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fname = f"speca_step_{arch}_{table_dtype}_m{order}" \
            + (f"_{tag}" if tag else "") + ".json"
        with open(os.path.join(save_dir, fname), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="flux-like")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--latent", type=int, default=128)
    ap.add_argument("--table-dtype", default="bfloat16")
    ap.add_argument("--order", type=int, default=2)
    ap.add_argument("--tag", default="")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    try:
        run(args.arch, batch=args.batch, latent=args.latent,
            table_dtype=args.table_dtype, order=args.order, tag=args.tag,
            multi_pod=args.multi_pod)
    except ValueError as e:
        raise SystemExit(f"[speca-dryrun] {args.arch} batch {args.batch} "
                         f"on {'pod2x16x16' if args.multi_pod else 'pod16x16'}"
                         f" cannot be laid out: {e}")


if __name__ == "__main__":
    main()
