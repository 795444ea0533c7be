"""Readings that set a configuration's limits (``limits`` in
``bench/configs/<name>.json``), on the card, in one process.

* The program: ``--seeds`` runs of the cell (the same run as
  ``bench/run.py``'s, with a window of ``--seconds``), each printing the
  numbers its judge compared. The largest over a dozen seeds or more is
  a limit's lower reading.
* The control: ``--control-seeds`` runs of the reference itself, put in
  the program's place and computed one precision below the
  configuration's bfloat16: every product of the denoiser on float8
  (e4m3) operands with per-tensor scales (:func:`fp8_matmul`), deciding
  its own accepts. It serves the requests a run compares (the first
  request of each of the first ``check_requests`` clients), and the same
  judge holds its samples and decisions against the float32 reference.
  The smallest reading over three seeds or more is a limit's upper
  reading.
* The over-accepting fault: ``--fault-seeds`` runs of the float32
  reference in the program's place, accepting every draft a request may
  make (a verify or a τ schedule that lets everything through, which
  would also serve faster). Its samples agree with the reference along
  its own decisions, so only a decision number can catch it.

    python3 bench/control.py --workload dit-xl2-256px.aligned \\
        --seeds 11,12,... --control-seeds 21,22,23 --seconds 6

Each run prints one JSON line; ``--out`` appends them to a file too.
Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FP8_MAX = 448.0          # largest finite float8 e4m3fn


def fp8_matmul(x, w):
    """x @ w with both operands rounded to float8 e4m3 under a per-tensor
    scale (amax / 448), the product itself in float32."""
    import torch

    def q(t):
        t = t.to(torch.float32)
        s = t.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return q(x) @ q(w)


def accept_all(err: float, tau: float) -> bool:
    return True


def control_reading(cfg, mix, seed: int, device, *, mm=fp8_matmul,
                    decide=None, side: str = "control") -> dict:
    """The control's numbers at one seed (see the module docstring); with
    ``mm=f32_matmul`` and ``decide=accept_all``, the over-accepting
    fault's."""
    import torch

    from bench.harness import judge as JD
    from bench.harness import serve as SV
    from bench.harness import traffic as TR
    from bench.reference import speca

    loop = TR.Clients(mix, int(cfg["lanes"]),
                      int(cfg["num_inference_steps"]), seed)
    n = min(int(cfg["check_requests"]), len(loop.clients))
    rseeds = [loop.next_seed(c) for c in loop.clients[:n]]
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        params = SV.make_weights(cfg, seed, device)
        reqs = JD.reference_requests(cfg, rseeds, device)
        low = speca.sample(cfg, params, reqs, mm=mm, decide=decide)
        accepts = [o.accepts for o in low]
        outs = speca.replay(cfg, params, reqs, accepts)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags
    v = JD.compare(cfg, [o.sample for o in low], accepts, outs)
    alpha = sum(map(sum, accepts)) / max(sum(map(len, accepts)), 1)
    return {"side": side, "seed": seed, "numbers": v.numbers,
            "correct": v.correct, "alpha": alpha}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from bench import run as R
    from bench.harness import registry as RG
    from bench.reference.dit import f32_matmul
    spec = RG.benchmark()
    cell = RG.cell(spec, args.workload)
    cfg, mix = RG.config(cell["config"]), RG.mix(cell["traffic"])
    dev = torch.device("cuda:0")

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for s in [int(x) for x in args.seeds.split(",") if x]:
        t0 = time.perf_counter()
        out = R.run_cell(args.workload, s, args.seconds, False, dev,
                         spec=spec, cfg=cfg, mix=mix)
        emit({"side": "program", "seed": s, "correct": out["correct"],
              "numbers": {k: c["value"] for k, c in out["checks"].items()},
              "attempted": out["attempted"], "metrics": out["metrics"],
              "setup": out["_window"]["setup"],
              "seconds": time.perf_counter() - t0})
    for seeds, kw in ((args.control_seeds, {}),
                      (args.fault_seeds, dict(mm=f32_matmul,
                                              decide=accept_all,
                                              side="over_accept"))):
        for s in [int(x) for x in seeds.split(",") if x]:
            t0 = time.perf_counter()
            rec = control_reading(cfg, mix, s, dev, **kw)
            rec["seconds"] = time.perf_counter() - t0
            emit(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
