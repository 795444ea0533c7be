#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit:  python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):

1. Build the three CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, started together) and print the card's name and
   power limit.
2. Hold each kernel against its plain PyTorch version on the card at the
   serving path's shapes (W=4 lanes, table [3, 224, 294912] bf16), in f32
   too, and at shapes whose C is not a multiple of the block: the refresh
   bitwise, the predict within one bf16 ulp (rtol 2^-8; f32: 1e-6) of the
   plain f32 sum, the verify error to rtol 1e-5 with equal accept bits
   wherever |e − τ| > 1e-5. Time each kernel (CUDA events) beside its
   plain version, one PyTorch library call where one computes the same
   function, and its bound (bytes over 3.35 TB/s, f32 operations over
   67 TFLOP/s — the H100 SXM data sheet at 700 W).
3. Serve DiT-XL/2 at full width (28 layers, d 1152, bf16, 32×32×4
   latents, 50 DDIM steps) through ``SpeCaEngine.serve_batched``: 8
   requests at lanes=4, taylor_order=2, per-sample accept, fused verify.
   Weights are random from a seed; the AdaLN-Zero leaves, which the
   reference initialises to zero (every increment 0 ⇒ every draft
   accepted ⇒ a vacuous run), are drawn from small seeded noise here.
   Launch counts are reset just before this run and read just after:
   every kernel must have launched. The first 4 requests are served again
   at lanes=1 and must keep identical per-request counters and accept
   trajectories.
4. ``speca_sample`` at batch 2 on the same model.

The last two lines of standard output are one JSON object of per-kernel
numbers and ``{"ok": true, "device": {...}}``; the line before them is
the card's name and power limit. Everything measured also goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "chiprun_out"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, data sheet
F32_FLOPS = 67e12                # H100 SXM, f32 outside the tensor cores
LANES = 4
N_REQUESTS = 8


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float):
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


class Smoke:
    """The phases; ``cfg``/``dcfg`` are the served model and schedule
    (DiT-XL/2 and the DiffusionConfig defaults in a chip run)."""

    def __init__(self, torch, device, cfg, dcfg):
        self.torch = torch
        self.dev = torch.device(device)
        self.cfg, self.dcfg = cfg, dcfg
        self.failures = []
        self.record = {}
        self.kernels = {}

    def phase(self, name, fn):
        t0 = time.perf_counter()
        try:
            fn()
            status = "ok"
        except Exception:                      # report, go on, fail at end
            traceback.print_exc()
            self.failures.append(name)
            status = "FAILED"
        dt = time.perf_counter() - t0
        self.record.setdefault("phase_s", {})[name] = dt
        print(f"[{name}] {status} in {dt:.1f} s", flush=True)

    # --- phase 1 -------------------------------------------------------------
    def build(self):
        from repro_torch.kernels import build
        t0 = time.perf_counter()
        paths = build.build_all()
        self.record["build_s"] = time.perf_counter() - t0
        self.record["ptxas"] = dict(build.build_logs)
        for name, path in paths.items():
            print(f"built {name}: {path.relative_to(ROOT)}")
            for line in build.build_logs.get(name, "").splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {line.strip()}")
        for name in build.SOURCES:
            build.library(name)

    # --- phase 2 -------------------------------------------------------------
    def _inputs(self, shape, dtype, seed):
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(seed)
        m1, W = shape[0], shape[3]
        diffs = torch.randn(shape, generator=g, device=self.dev).to(dtype)
        feats = torch.randn(shape[1:], generator=g,
                            device=self.dev).to(dtype)
        # Taylor weights of lanes at different anchor counts: lane 1 cold
        # (order 0 only), lane 3 at n_anchors=2 — invalid orders are 0.0
        d = torch.tensor([1.0, 2.0, 3.0, 1.0][:W] + [2.0] * max(W - 4, 0),
                         device=self.dev)
        gap = torch.tensor([1.0, 1.0, 2.0, 3.0][:W] + [1.0] * max(W - 4, 0),
                           device=self.dev)
        n = torch.tensor([3, 1, 4, 2][:W] + [3] * max(W - 4, 0),
                         device=self.dev)
        from repro_torch.core.taylor import prediction_weights
        w = prediction_weights(m1 - 1, d, gap, n).contiguous()
        mask = torch.arange(W, device=self.dev) % 2 == 0     # mixed
        return diffs, feats, w, mask

    def check_kernels(self):
        torch = self.torch
        from repro_torch.kernels import ops, ref
        main = (3, 28, 2, LANES, 256, 1152)    # the DiT-XL/2 serving table
        shapes = [(main, torch.bfloat16), (main, torch.float32),
                  ((3, 2, 2, LANES, 17, 33), torch.bfloat16),   # C = 561
                  ((3, 2, 2, LANES, 10, 80), torch.bfloat16),   # C = 800
                  ((3, 2, 2, LANES, 17, 33), torch.float32)]
        checks = []
        for shape, dtype in shapes:
            diffs, feats, w, mask = self._inputs(shape, dtype, 1)
            pk = ops.taylor_predict_lanes(diffs, w)
            p32 = ref.taylor_predict_lanes_ref(diffs.float(), w)
            pp = ref.taylor_predict_lanes_ref(diffs, w)
            tol = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-6
            torch.testing.assert_close(pk.float(), p32, rtol=tol, atol=1e-6)
            uk = ops.taylor_update_lanes(diffs, feats, mask)
            up = ref.taylor_update_lanes_ref(diffs, feats, mask)
            assert torch.equal(uk, up), f"refresh not bitwise at {shape}"
            vl_pred, vl_real = self._verify_planes(shape, dtype)
            err_p, _ = ref.verify_accept_ref(vl_pred, vl_real,
                                             torch.ones(LANES,
                                                        device=self.dev))
            tau = (err_p * torch.tensor([2.0, 0.5, 1.0, 0.9],
                                        device=self.dev)).contiguous()
            ek, ak = ops.verify_accept(vl_pred, vl_real, tau)
            ep, ap = ref.verify_accept_ref(vl_pred, vl_real, tau)
            torch.testing.assert_close(ek, ep, rtol=1e-5, atol=0.0)
            far = (ep - tau).abs() > 1e-5
            assert torch.equal(ak[far], ap[far]), "accept bits differ"
            torch.cuda.synchronize()
            row = {"shape": list(shape), "dtype": str(dtype),
                   "predict_max_abs_err": (pk.float() - pp.float()).abs()
                   .max().item(),
                   "update_max_abs_err": (uk.float() - up.float()).abs()
                   .max().item(),
                   "verify_max_abs_err": (ek - ep).abs().max().item()}
            checks.append(row)
            print(f"kernels == plain at {shape} {dtype}: {row}")
        self.record["kernel_checks"] = checks
        self._time_main(main, torch.bfloat16)

    def _verify_planes(self, shape, dtype):
        """pred/real verify planes [W, T·D] as the lane step forms them."""
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(7)
        W, N = shape[3], shape[4] * shape[5]
        real = torch.randn((W, N), generator=g, device=self.dev)
        scale = torch.tensor([0.05, 0.2, 0.5, 1.0], device=self.dev)[:, None]
        pred = real + scale * torch.randn((W, N), generator=g,
                                          device=self.dev)
        return pred.to(dtype).contiguous(), real.to(dtype).contiguous()

    def _time_main(self, shape, dtype):
        torch = self.torch
        from repro_torch.kernels import ops, ref
        diffs, feats, w, mask = self._inputs(shape, dtype, 2)
        m1, W = shape[0], shape[3]
        R = shape[1] * shape[2] * W
        C = shape[4] * shape[5]
        es = diffs.element_size()
        d4 = diffs.view(m1, shape[1] * shape[2], W, C)
        wb = w.to(dtype)
        p_k = time_ms(torch, lambda: ops.taylor_predict_lanes(diffs, w))
        p_p = time_ms(torch, lambda: ref.taylor_predict_lanes_ref(diffs, w))
        p_l = time_ms(torch, lambda: torch.einsum("zw,zgwc->gwc", wb, d4))
        pk = ops.taylor_predict_lanes(diffs, w)
        pp = ref.taylor_predict_lanes_ref(diffs, w)
        pb, pf = bound_ms((m1 * R * C + R * C) * es + m1 * W * 4,
                          2.0 * m1 * R * C)
        self.kernels["taylor_predict_lanes"] = dict(
            ms=p_k, plain_ms=p_p, library_ms=p_l, bound_ms=pb, bound_by=pf,
            max_abs_err=(pk.float() - pp.float()).abs().max().item())

        u_k = time_ms(torch, lambda: ops.taylor_update_lanes(diffs, feats,
                                                             mask))
        u_p = time_ms(torch, lambda: ref.taylor_update_lanes_ref(
            diffs, feats, mask))
        uk = ops.taylor_update_lanes(diffs, feats, mask)
        up = ref.taylor_update_lanes_ref(diffs, feats, mask)
        fresh = int(mask.sum().item()) * R // W      # refreshed rows
        kept = R - fresh
        # what this mask needs: kept rows read all m+1 old planes, fresh
        # rows read m old planes and their features; all planes written
        ub, uf = bound_ms((kept * m1 * C + fresh * (m1 - 1) * C
                           + fresh * C + m1 * R * C) * es + W,
                          float((m1 - 1) * fresh * C))
        self.kernels["taylor_update_lanes"] = dict(
            ms=u_k, plain_ms=u_p, library_ms=None, bound_ms=ub, bound_by=uf,
            max_abs_err=(uk.float() - up.float()).abs().max().item())

        pred, real = self._verify_planes(shape, dtype)
        tau = torch.full((W,), 0.3, device=self.dev)
        N = pred.shape[1]
        v_k = time_ms(torch, lambda: ops.verify_accept(pred, real, tau),
                      iters=100)
        v_p = time_ms(torch, lambda: ref.verify_accept_ref(pred, real, tau),
                      iters=100)
        ek, _ = ops.verify_accept(pred, real, tau)
        ep, _ = ref.verify_accept_ref(pred, real, tau)
        vb, vf = bound_ms(2 * W * N * es + W * (4 + 4 + 1), 5.0 * W * N)
        self.kernels["verify_accept"] = dict(
            ms=v_k, plain_ms=v_p, library_ms=None, bound_ms=vb, bound_by=vf,
            max_abs_err=(ek - ep).abs().max().item())
        for name, k in self.kernels.items():
            print(f"{name}: {k}")

    # --- phase 3 -------------------------------------------------------------
    def _model(self):
        torch = self.torch
        from repro_torch.layers.model import init_params
        gen = torch.Generator(device=self.dev).manual_seed(0)
        params = init_params(self.cfg, gen, device=self.dev)
        d = self.cfg.d_model
        noise = torch.Generator(device=self.dev).manual_seed(1)

        def fill(t, scale):
            t.copy_(torch.randn(t.shape, generator=noise, device=self.dev)
                    * scale)
        # AdaLN-Zero leaves from small seeded noise (see the docstring)
        fill(params["blocks"]["mod_w"], 0.4 / math.sqrt(d))
        fill(params["blocks"]["mod_b"], 0.02)
        fill(params["head"]["mod_w"], 0.4 / math.sqrt(d))
        fill(params["head"]["mod_b"], 0.02)
        fill(params["head"]["w"], 1.0 / math.sqrt(d))
        fill(params["head"]["b"], 0.02)
        # Random weights on the fast sinusoids of the timestep embedding
        # make t_emb — and every AdaLN modulation — jump at random from one
        # sampler step to the next, which no trained DiT does and which
        # rejects every draft. Keep only the sinusoids that turn at most
        # 0.2 rad per sampler step.
        half = d // 2
        freq = torch.exp(-math.log(10_000.0)
                         * torch.arange(half, device=self.dev) / half)
        dt = self.dcfg.num_train_timesteps / self.dcfg.num_inference_steps
        keep = (dt * freq <= 0.2).to(torch.float32)
        params["embed"]["time"]["w1"] *= torch.cat([keep, keep])[:, None]
        return params

    def serve(self):
        torch = self.torch
        from repro_torch.configs import SpeCaConfig
        from repro_torch.diffusion.pipeline import latent_shape
        from repro_torch.kernels import ops
        from repro_torch.serving import Request, SpeCaEngine
        cfg, dcfg = self.cfg, self.dcfg
        self.params = params = self._model()
        scfg = SpeCaConfig(taylor_order=2)
        S = dcfg.num_inference_steps
        engine = SpeCaEngine(cfg, params, dcfg, scfg,
                             accept_mode="per_sample",
                             verify_backend="fused", device=self.dev)
        reqs = [Request(request_id=i,
                        cond={"labels": torch.tensor([(37 * i)
                                                      % cfg.num_classes])},
                        seed=100 + i) for i in range(N_REQUESTS)]
        # warm the allocator, cuBLAS and the kernels outside the timed run
        engine.serve_batched(reqs[:LANES], lanes=LANES, max_ticks=5)
        torch.cuda.synchronize()
        syncs0 = engine.host_syncs
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()                       # the main path:
        t0 = time.perf_counter()
        res = engine.serve_batched(reqs, lanes=LANES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()                  # read just after
        syncs = engine.host_syncs - syncs0
        ticks = sum(r.num_full + r.num_spec for r in res) // LANES
        for name, n in launches.items():
            self.kernels.setdefault(name, {})["launches"] = n
        samples = torch.cat([r.sample for r in res])
        print(f"main path launches: {launches}")
        per_req = [{"request_id": r.request_id, "num_full": r.num_full,
                    "num_spec": r.num_spec, "alpha": r.alpha,
                    "accepts": "".join("1" if a else "0"
                                       for a in r.accepts)}
                   for r in res]
        for row in per_req:
            print(f"  request {row}")
        print(f"served {N_REQUESTS} requests at lanes={LANES} in "
              f"{wall:.3f} s: {N_REQUESTS / wall:.3f} req/s, "
              f"{syncs} host syncs over {ticks} ticks, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        assert all(n > 0 for n in launches.values()), launches
        assert tuple(samples.shape) == latent_shape(cfg, dcfg, N_REQUESTS)
        assert torch.isfinite(samples).all(), "non-finite samples"
        assert all(r.completed and r.num_full + r.num_spec == S
                   for r in res)
        solo = engine.serve_batched(reqs[:LANES], lanes=1)
        for a, b in zip(res[:LANES], solo):
            assert (a.num_full, a.num_spec, a.accepts) == \
                (b.num_full, b.num_spec, b.accepts), \
                f"request {a.request_id}: lanes={LANES} and lanes=1 differ"
        print(f"lanes={LANES} and lanes=1 counters identical for the first "
              f"{LANES} requests")
        self.record["serve"] = dict(
            requests=per_req, wall_s=wall, req_per_s=N_REQUESTS / wall,
            host_syncs=syncs, ticks=ticks, launches=launches,
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            sample_abs_max=samples.abs().max().item())

    # --- phase 4 -------------------------------------------------------------
    def sample(self):
        torch = self.torch
        from repro_torch.configs import SpeCaConfig
        from repro_torch.core.speca import speca_sample
        gen = torch.Generator(device=self.dev).manual_seed(3)
        x, st = speca_sample(self.cfg, self.params, self.dcfg,
                             SpeCaConfig(taylor_order=2),
                             {"labels": torch.tensor([1, 2],
                                                     device=self.dev)}, 2,
                             generator=gen, device=self.dev)
        torch.cuda.synchronize()
        alpha = st["alpha"].item()
        err = st["err"].float().cpu()
        err = err[torch.isfinite(err)]
        pct = torch.quantile(err, torch.tensor([0.1, 0.5, 0.9])).tolist() \
            if err.numel() else []
        tau = st["tau"].cpu()
        print(f"speca_sample batch 2: alpha={alpha:.3f} "
              f"num_spec={int(st['num_spec'])} err p10/p50/p90={pct} "
              f"tau {tau[0].item():.3f}..{tau[-1].item():.3f} finite="
              f"{bool(torch.isfinite(x).all())}")
        assert torch.isfinite(x).all()
        self.record["speca_sample"] = dict(
            alpha=alpha, num_spec=int(st["num_spec"]), err_p10_p50_p90=pct,
            tau_first_last=[tau[0].item(), tau[-1].item()])


KERNEL_META = {
    "taylor_predict_lanes": ("src/repro_torch/kernels/csrc/"
                             "taylor_predict_lanes.cu",
                             "src/repro/kernels/taylor_predict.py:70"),
    "taylor_update_lanes": ("src/repro_torch/kernels/csrc/"
                            "taylor_update_lanes.cu",
                            "src/repro/kernels/taylor_predict.py:215"),
    "verify_accept": ("src/repro_torch/kernels/csrc/verify_accept.cu",
                      "src/repro/kernels/verify_error.py:72"),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found — run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    # exact f32 products and f32 split-K reductions: the lane width must
    # not change a request's trajectory
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    from repro_torch.configs import DIT_XL2, DiffusionConfig
    smoke = Smoke(torch, "cuda", DIT_XL2, DiffusionConfig())
    smoke.phase("build", smoke.build)
    if smoke.failures:
        return 1
    smoke.phase("kernels", smoke.check_kernels)
    smoke.phase("serve", smoke.serve)
    if "serve" not in smoke.failures:
        smoke.phase("speca_sample", smoke.sample)
    card = smi_line()
    rows = []
    for name, (source, replaces) in KERNEL_META.items():
        k = smoke.kernels.get(name, {})
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": k.get("launches"),
                     "max_abs_err": k.get("max_abs_err"),
                     "ms": k.get("ms"), "plain_ms": k.get("plain_ms"),
                     "bound_ms": k.get("bound_ms"),
                     "bound_by": k.get("bound_by"),
                     "library_ms": k.get("library_ms")})
    OUT.mkdir(exist_ok=True)
    smoke.record.update(card=card, kernels=rows, failures=smoke.failures,
                        torch=torch.__version__, cuda=torch.version.cuda)
    (OUT / "chip_smoke.json").write_text(json.dumps(smoke.record, indent=1))
    if smoke.failures:
        print(f"chip_smoke: FAILED phases {smoke.failures}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
