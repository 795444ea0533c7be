"""Serving launcher: SpeCa diffusion serving or LM decode at a reduced
scale (the reference's ``repro.launch.serve``).

Usage:
  python -m repro_torch.launch.serve --mode diffusion --requests 6 --lanes 4
  python -m repro_torch.launch.serve --mode diffusion --requests 6 \
      --lanes 4 --mesh 2
  python -m repro_torch.launch.serve --mode diffusion --requests 6 \
      --lanes 4 --guidance-scale 4.0
  python -m repro_torch.launch.serve --mode diffusion --requests 8 \
      --lanes 4 --mixed --scheduler sjf
  python -m repro_torch.launch.serve --mode lm --arch qwen1.5-0.5b

The diffusion mode trains the tiny DiT with the port's trainer, then
serves it through ``SpeCaEngine``: ``--lanes N`` packs N lanes (``1`` is
the sequential batch=1 loop), ``--guidance-scale S`` (S > 0) serves each
request as a cond/uncond lane pair, ``--mixed`` alternates guided and
unguided requests with distinct τ on one engine, ``--scheduler`` picks
the admission order, ``--mesh D`` lane-shards the engine over D devices
(``make_lane_mesh(D, device=--device)``: D cards, or D CPU shards with
``--device cpu``; asking for more cards than are visible exits with an
error before anything runs). It prints each request's ``full=/spec=``
counters and the ``allocation_report``. The LM mode runs a prefill and
then decodes ``--gen`` tokens on one device. ``--device`` defaults to
``cuda``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import torch

from repro_torch.configs import (DiffusionConfig, SpeCaConfig, TrainConfig,
                                 get_config, reduced)
from repro_torch.core.complexity import forward_flops
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_lane_mesh
from repro_torch.layers import model as M
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serving import (Request, RequestPolicy, SpeCaEngine,
                                 allocation_report)
from repro_torch.training import lm as T
from repro_torch.training.diffusion_trainer import train_diffusion


def serve_diffusion(args, mesh=None) -> None:
    dev = resolve_device(args.device) if mesh is None else mesh.devices[0]
    cfg = dataclasses.replace(reduced(get_config("dit-xl2")), num_layers=2,
                              d_model=128, d_ff=256, num_heads=4,
                              num_kv_heads=4, num_classes=8)
    dcfg = DiffusionConfig(num_inference_steps=args.steps, latent_size=8,
                           schedule="cosine")
    out = train_diffusion(cfg, dcfg,
                          TrainConfig(global_batch=16, steps=120, lr=2e-3),
                          device=dev, verbose=False)
    scfg = SpeCaConfig(taylor_order=2, max_draft=8, tau0=args.tau0, beta=0.9)
    guided = args.guidance_scale > 0
    engine = SpeCaEngine(cfg, out["state"]["params"], dcfg, scfg,
                         accept_mode=args.accept_mode,
                         guidance=guided and not args.mixed,
                         scheduler=args.scheduler, mesh=mesh, device=dev)
    gs = args.guidance_scale if guided else None

    def labels(i):
        return {"labels": torch.tensor([i % cfg.num_classes])}

    if args.mixed:
        # heterogeneous traffic on ONE engine: alternating guided pairs
        # (distinct scales) and unguided lanes (distinct τ)
        mgs = gs if guided else 4.0
        reqs = [Request(request_id=i, cond=labels(i), seed=i,
                        policy=RequestPolicy(guidance_scale=mgs + i % 3)
                        if i % 2 == 0 else
                        RequestPolicy(tau0=args.tau0 * (0.5 + i % 3)))
                for i in range(args.requests)]
        streams = 2
    else:
        reqs = [Request(request_id=i, cond=labels(i), seed=i,
                        guidance_scale=gs)
                for i in range(args.requests)]
        streams = 2 if guided else 1
    # warm at the served lane width and program, outside the timed run
    engine.warmup({"labels": torch.tensor([0])},
                  lanes=min(args.lanes, streams * args.requests),
                  mixed=args.mixed)
    t0 = time.time()
    results = engine.serve(reqs, lanes=args.lanes)
    wall = time.time() - t0
    for r in results:
        print(f"req {r.request_id}: full={r.num_full} spec={r.num_spec} "
              f"alpha={r.alpha:.2f} done@tick {r.finish_tick}")
    mode = f"{args.lanes} lanes" if args.lanes > 1 else "batch=1"
    if args.mixed:
        mode += ", mixed guided+unguided slots"
    elif guided:
        mode += f", cfg pairs s={args.guidance_scale}"
    if args.scheduler != "fifo":
        mode += f", {args.scheduler}"
    if mesh is not None:
        mode += f" x {mesh.size} shards"
    print(f"served {len(reqs)} requests in {wall:.1f}s "
          f"({len(reqs) / wall:.2f} req/s, {mode}, {dev})")
    fwd = forward_flops(cfg, (dcfg.latent_size // cfg.patch_size) ** 2)
    if args.mixed:
        # a guided step is two denoiser rows: report the populations apart
        gsub = [r for r, q in zip(results, reqs)
                if engine.resolve_policy(q).guided]
        usub = [r for r, q in zip(results, reqs)
                if not engine.resolve_policy(q).guided]
        print("guided:", allocation_report(gsub, 2 * fwd))
        print("unguided:", allocation_report(usub, fwd))
    else:
        print(allocation_report(results, streams * fwd))


@torch.no_grad()
def serve_lm(args) -> None:
    dev = resolve_device(args.device)
    cfg = reduced(get_config(args.arch))
    state = T.make_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                               AdamWConfig(), device=dev)
    params = state["params"]
    gen = torch.Generator(device=dev).manual_seed(1)
    B, P = args.batch, 16
    shape = (B, cfg.num_codebooks, P) if cfg.arch_type == "audio" else (B, P)
    prompt = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                           device=dev, dtype=torch.int32)
    logits, cache = T.prefill_step(cfg, params, {"tokens": prompt})
    max_len = P + args.gen
    dec = M.init_cache(cfg, B, max_len, device=dev)
    if "k" in dec:
        dec["k"][:, :, :P] = cache["k"]
        dec["v"][:, :, :P] = cache["v"]
    if "ssm_state" in dec:
        dec["ssm_state"], dec["conv_state"] = (cache["ssm_state"],
                                               cache["conv_state"])

    def next_tok(logits):
        tok = torch.argmax(logits[..., :cfg.vocab_size], dim=-1)
        if cfg.arch_type == "audio":
            tok = tok.reshape(B, cfg.num_codebooks, 1)
        return tok.to(torch.int32)

    tok = next_tok(logits)
    t0 = time.time()
    for pos in range(P, max_len):
        logits, dec = T.serve_step(cfg, params, tok, dec, pos)
        tok = next_tok(logits)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(f"{args.arch}: decoded {args.gen} tokens × {B} seqs "
          f"in {dt:.2f}s ({args.gen * B / dt:.1f} tok/s on {dev})")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["diffusion", "lm"],
                    default="diffusion")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--lanes", type=int, default=4,
                    help="serving lane width; 1 = sequential batch=1 loop")
    ap.add_argument("--mesh", type=int, default=1,
                    help="lane-shard the diffusion engine over this many "
                         "devices (('data',) mesh): cards on cuda, CPU "
                         "shards on cpu")
    ap.add_argument("--accept-mode", default="per_sample",
                    choices=["per_sample", "batch"])
    ap.add_argument("--guidance-scale", type=float, default=0.0,
                    help="classifier-free guidance scale; >0 serves each "
                         "request as a cond/uncond lane pair with one "
                         "verify decision per pair")
    ap.add_argument("--mixed", action="store_true",
                    help="serve a heterogeneous per-request-policy "
                         "workload (alternating guided pairs and "
                         "unguided lanes with distinct τ) on one engine")
    ap.add_argument("--scheduler", default="fifo",
                    choices=["fifo", "sjf", "edf"],
                    help="admission-queue policy")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--tau0", type=float, default=0.4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.mode == "diffusion":
        mesh = None
        if args.mesh > 1:
            # before the model trains: too few cards fails at once
            mesh = make_lane_mesh(args.mesh, device=args.device)
        serve_diffusion(args, mesh)
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()
