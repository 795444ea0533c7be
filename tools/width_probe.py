#!/usr/bin/env python3
"""Which op makes a forward depend on the lane width, on one GPU.

A forward runs once on W lanes and once on each lane alone, on the same
inputs. Every torch op the Python code calls is recorded in order (a
``TorchFunctionMode``; ops inside an op are not), and each op's output on
W lanes is held against the lone runs' outputs joined along its lane
axis. The first op that differs is run again on the W-lane run's own
inputs, all lanes at once against one lane at a time: a difference there
is the op's own, not its inputs'. Its row count M at both widths, max
|Δ| and times are reported.

Forwards probed (``--model``, repeatable):

* ``dit-xl2``: DiT-XL/2's forward of 4 seeded latents (t = 500, labels
  0..3), random weights from seed 0 with the chip check's noisy AdaLN
  leaves. ``--time-rows 1`` sets ``layers.embeddings.TIME_ROWS`` to 1,
  the time MLP as it was before its rows were padded, to show the probe
  finds that op.
* a decode model by name (``mamba2-130m``, ``hymba-1.5b``,
  ``granite-moe-1b-a400m``, ``llama3-8b``): one full decode forward
  (``decode_branches_step``, branches collected, as a decode lane tick
  runs it) at 4 lanes, bf16 random weights from seed 0 at full width and
  depth, after 8 seeded tokens decoded into zero caches so that the
  caches and SSD states are not zero.

``--repeat N`` also runs the card tests' MoE, SSD chunk scan and Mamba2
decode cases (``tests/test_torch_cuda.py``) N times in this process and
holds each result bitwise against the first, and each against the CPU
result at the tests' rtol = atol = 1e-5, keeping the first traceback.

Run from the repository root on the card:
    python3 tools/width_probe.py --model mamba2-130m --model hymba-1.5b \
        [--repeat 200]
Writes ``chiprun_out/width_probe.json`` and prints it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

import torch
from torch.overrides import TorchFunctionMode

ROOT = Path(__file__).resolve().parent.parent
LANES = 4
WARM_TOKENS = 8


# ops whose output is uninitialised memory until something writes it
UNINITIALISED = ("empty", "empty_like", "new_empty", "empty_strided")


class OpTrace(TorchFunctionMode):
    """Records (name, func, args, kwargs, output) for every tensor a torch
    op returns (a tuple's items one record each); an output that owns its
    memory is copied when recorded, since a later in-place op may change
    it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        items = out if isinstance(out, (tuple, list)) else (out,)
        name = getattr(func, "__name__", str(func))
        for i, t in enumerate(items):
            if isinstance(t, torch.Tensor) and t.dim() > 0 \
                    and name not in UNINITIALISED:
                # a view (a weight's layer slice, say) is kept as it is
                self.ops.append((name, func, args, kwargs, i, t.detach()
                                 if t._base is not None
                                 else t.detach().clone()))
        return out


def lane_axis(whole: torch.Tensor, one: torch.Tensor, lanes: int):
    """The axis along which ``whole`` joins ``lanes`` tensors shaped like
    ``one``, or None (an op of the weights alone, or no lane axis)."""
    if whole.dim() != one.dim():
        return None
    for ax in range(whole.dim()):
        if whole.shape[ax] == lanes * one.shape[ax] and all(
                whole.shape[a] == one.shape[a]
                for a in range(whole.dim()) if a != ax):
            return ax
    return None


def max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.is_floating_point():
        return (a.float() - b.float()).abs().max().item()
    return float(not torch.equal(a, b))


def rows(t: torch.Tensor) -> int:
    return int(t.numel() // t.shape[-1])


def time_ms(fn, iters: int = 20) -> float:
    fn()
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _sliced(whole_args, lone_args, lane, lanes):
    """``whole_args`` with every tensor that carries lanes cut to
    ``lane`` (its shape read from the lone run's same argument)."""
    out = []
    for w, o in zip(whole_args, lone_args):
        if isinstance(w, torch.Tensor) and isinstance(o, torch.Tensor) \
                and w.shape != o.shape:
            ax = lane_axis(w, o, lanes)
            n = o.shape[ax]
            out.append(w.narrow(ax, lane * n, n))
        elif isinstance(w, (tuple, list)) and isinstance(o, (tuple, list)):
            out.append(type(w)(_sliced(w, o, lane, lanes)))
        else:
            out.append(w)
    return out


def probe(forward, lanes: int = LANES) -> dict:
    """``forward(sel)`` runs the forward on the lanes ``sel`` (a slice)
    and returns its output tensor (or a tuple led by it). Returns the op
    count, whether the lone runs called the same ops, the first
    differing op (with its own difference and times), the differing ops
    (at most 12) and the outputs' max |Δ|."""
    with torch.no_grad():
        with OpTrace() as whole:
            out = forward(slice(None))
        alone, outs = [], []
        for lane in range(lanes):
            with OpTrace() as one:
                outs.append(forward(slice(lane, lane + 1)))
            alone.append(one)
        n = len(whole.ops)
        aligned = all(len(a.ops) == n and all(
            x[0] == y[0] for x, y in zip(whole.ops, a.ops)) for a in alone)
        first, differing = None, []
        for pos in range(n if aligned else 0):
            name, func, args, kwargs, idx, t = whole.ops[pos]
            lone = [a.ops[pos][5] for a in alone]
            ax = lane_axis(t, lone[0], lanes)
            # integer ops do not round (lane indices, MoE slot ranks)
            if ax is None or not t.is_floating_point():
                continue
            d = max_diff(t, torch.cat(lone, dim=ax))
            if d == 0:
                continue
            row = dict(position=pos, op=name, m=rows(t),
                       m_alone=rows(lone[0]), shape=list(t.shape),
                       dtype=str(t.dtype), max_abs_diff=d,
                       abs_max=t.float().abs().max().item())
            if len(differing) < 12:
                differing.append(row)
            if first is None:
                first = dict(row)
                try:
                    first.update(_own(func, args, kwargs, idx,
                                      alone[0].ops[pos][2], ax, lanes))
                except Exception as e:      # the op would not re-run
                    first["own_error"] = repr(e)
        out, outs = _lead(out), [_lead(o) for o in outs]
        ax = lane_axis(out, outs[0], lanes)
        return dict(ops=n, aligned=aligned, first=first,
                    differing=differing,
                    output_max_abs_diff=max_diff(out, torch.cat(outs,
                                                                dim=ax)))


def _lead(out):
    return out[0] if isinstance(out, tuple) else out


def _own(func, args, kwargs, idx, lone_args, ax, lanes) -> dict:
    """The op run again on the W-lane run's inputs: all lanes at once
    against one lane at a time (its own max |Δ|), and both timed."""
    def pick(r):
        return r[idx] if isinstance(r, (tuple, list)) else r

    def whole():
        return pick(func(*args, **kwargs))

    def lane(i):
        return pick(func(*_sliced(args, lone_args, i, lanes), **kwargs))
    split = torch.cat([lane(i) for i in range(lanes)], dim=ax)
    return dict(own_max_abs_diff=max_diff(whole(), split),
                whole_ms=time_ms(whole), alone_ms=time_ms(lambda: lane(0)))


def dit_case(dev, params=None):
    """DiT-XL/2's forward of LANES seeded latents at t = 500, with
    ``params`` or the chip check's tamed random weights."""
    from repro_torch.configs import DIT_XL2, DiffusionConfig
    from repro_torch.diffusion.pipeline import latent_shape
    from repro_torch.layers.model import dit_forward
    cfg, dcfg = DIT_XL2, DiffusionConfig()
    if params is None:
        sys.path.insert(0, str(ROOT))
        from chip_smoke import Smoke
        params = Smoke(torch, dev, cfg, dcfg)._tamed_params(cfg, dcfg)
    g = torch.Generator(device=dev).manual_seed(5)
    inp = {"latents": torch.randn(latent_shape(cfg, dcfg, LANES),
                                  generator=g, device=dev),
           "t": torch.full((LANES,), 500.0, device=dev),
           "labels": torch.arange(LANES, device=dev)}
    return lambda sel: dit_forward(cfg, params,
                                   {k: v[sel] for k, v in inp.items()})


def lm_config(name):
    from repro_torch import configs as C
    return next(c for c in vars(C).values()
                if isinstance(c, C.ModelConfig) and c.name == name)


def decode_case(cfg, dev):
    """One full decode forward of ``cfg`` at LANES lanes (branches
    collected), after WARM_TOKENS seeded tokens decoded into zero
    caches; a lone lane takes its slice of the same caches (lane axis
    1) and tokens."""
    from repro_torch.layers import model as M
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    g = torch.Generator(device=dev).manual_seed(9)
    toks = torch.randint(0, cfg.vocab_size, (WARM_TOKENS + 1, LANES, 1),
                         generator=g, device=dev, dtype=torch.int32)
    cache = M.init_cache(cfg, LANES, 64, dev)
    with torch.no_grad():
        for p in range(WARM_TOKENS):
            pos = torch.full((LANES,), p, dtype=torch.int32, device=dev)
            _, cache, _ = M.decode_branches_step(cfg, params, toks[p], cache,
                                                 pos)
    pos = torch.full((LANES,), WARM_TOKENS, dtype=torch.int32, device=dev)

    def forward(sel):
        logits, _, branches = M.decode_branches_step(
            cfg, params, toks[WARM_TOKENS][sel],
            {k: v[:, sel] for k, v in cache.items()}, pos[sel],
            collect_branches=True)
        return logits
    return forward


def repeat_card_cases(n: int, dev) -> dict:
    """The card tests' MoE, SSD and Mamba2 decode cases ``n`` times:
    runs not bitwise the first, runs off the CPU result beyond rtol =
    atol = 1e-5, the largest |card − CPU| / (1e-5 + 1e-5·|CPU|), and the
    first traceback."""
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_cuda as T
    from repro_torch.layers import moe, ssm

    def to(x):
        if isinstance(x, dict):
            return {k: to(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(to(v) for v in x)
        return x.to(dev) if isinstance(x, torch.Tensor) else x

    def ssd(case):
        *t, chunk, init = case
        return ssm.ssd_chunked(*t, chunk, initial_state=init)

    def mamba(case):
        prm, args, kw = case
        return ssm.mamba2_decode(prm, *args, **kw)

    def moe_call(case):
        prm, x, kw = case
        return moe.moe_forward(prm, x, **kw)     # (output, aux loss)
    cases = {"ssd_chunked": (ssd, T.ssd_case()),
             "mamba2_decode": (mamba, T.mamba2_decode_case()),
             "moe_forward_cf4": (moe_call, T.moe_case(4.0)),
             "moe_forward_cf0.1": (moe_call, T.moe_case(0.1))}
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for name, (fn, case) in cases.items():
            want = fn(case)
            card = to(case)
            first = [t.clone() for t in fn(card)]
            rec = dict(runs=n, not_bitwise=0, off_cpu=0, worst_ratio=0.0,
                       traceback=None)
            for _ in range(n):
                got = fn(card)
                if not all(torch.equal(a, b) for a, b in zip(got, first)):
                    rec["not_bitwise"] += 1
                for a, b in zip(got, want):
                    ratio = ((a.cpu() - b).abs()
                             / (1e-5 + 1e-5 * b.abs())).max().item()
                    rec["worst_ratio"] = max(rec["worst_ratio"], ratio)
                    try:
                        torch.testing.assert_close(a.cpu(), b, rtol=1e-5,
                                                   atol=1e-5)
                    except AssertionError:
                        rec["off_cpu"] += 1
                        rec["traceback"] = rec["traceback"] or \
                            traceback.format_exc()
            out[name] = rec
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", action="append", default=[])
    ap.add_argument("--time-rows", type=int, default=None)
    ap.add_argument("--repeat", type=int, default=0)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("width_probe: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    # as chip_smoke.py runs: exact f32 products, f32 split-K reductions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    import subprocess
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rec = dict(card=card, torch=torch.__version__, models={})
    for name in a.model:
        t0 = time.perf_counter()
        if name == "dit-xl2":
            from repro_torch.layers import embeddings
            if a.time_rows is not None:
                embeddings.TIME_ROWS = a.time_rows
            fwd = dit_case(dev)
        else:
            fwd = decode_case(lm_config(name), dev)
        try:
            res = probe(fwd)
        except Exception:
            res = dict(error=traceback.format_exc())
        res["seconds"] = time.perf_counter() - t0
        rec["models"][name] = res
        print(f"{name}: {json.dumps(res)}", flush=True)
        del fwd
        torch.cuda.empty_cache()
    if a.repeat:
        rec["repeat"] = repeat_card_cases(a.repeat, dev)
        print(f"repeat: {json.dumps(rec['repeat'])}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "width_probe.json").write_text(json.dumps(rec, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
