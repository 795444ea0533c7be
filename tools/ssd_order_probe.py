#!/usr/bin/env python3
"""Localise the intermittent card failure of
``tests/test_torch_cuda.py::test_ssd_chunked_and_mamba2_decode_on_card_match_cpu``.

Two steps, on a machine with a CUDA card:

1. ``--runs N``: the whole card test file, up to N times, stopping at the
   first run in which the SSD test fails; that run's full assertion
   (which output, which index, |Δ| against the tolerance) is kept.
2. One more session of the whole file with this module as a pytest
   plugin: after each test the SSD test's cases (``ssd_case``,
   ``mamba2_decode_case``) run again on the card and on the CPU, and the
   plugin records max |Δ| of each output against the tolerance, whether
   the card's and the CPU's outputs are bitwise those of the first check,
   and the global state the calls could depend on (TF32 and reduced
   precision flags, the CPU thread count, deterministic mode). The first
   test after which a check fails, or after which an output or a flag
   changes, is the one that leaves state behind.

    PYTHONPATH=src python3 tools/ssd_order_probe.py --runs 4

Writes ``chiprun_out/ssd_order_probe.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out"
TEST_FILE = "tests/test_torch_cuda.py"
SSD_TEST = "test_ssd_chunked_and_mamba2_decode_on_card_match_cpu"
TOL = dict(rtol=1e-5, atol=1e-5)

_checks = []
_first = {}


def _state(torch):
    m = torch.backends.cuda.matmul
    return {"matmul.allow_tf32": m.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "bf16_reduced": m.allow_bf16_reduced_precision_reduction,
            "fp16_reduced": m.allow_fp16_reduced_precision_reduction,
            "float32_matmul_precision":
                torch.get_float32_matmul_precision(),
            "num_threads": torch.get_num_threads(),
            "deterministic": torch.are_deterministic_algorithms_enabled(),
            "default_dtype": str(torch.get_default_dtype())}


def _check(after: str) -> dict:
    """The SSD test's two cases once more, TF32 off for the calls (as its
    fixture), against the CPU: max |Δ|, the tolerance's verdict, and
    whether each side is bitwise its first check."""
    import torch

    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_cuda as T
    from repro_torch.layers import ssm

    state = _state(torch)
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cuda = torch.device("cuda")
        *tensors, chunk, init = T.ssd_case()
        want = ssm.ssd_chunked(*tensors, chunk, initial_state=init)
        got = ssm.ssd_chunked(*(t.to(cuda) for t in tensors), chunk,
                              initial_state=init.to(cuda))
        prm, args, kw = T.mamba2_decode_case()
        want += ssm.mamba2_decode(prm, *args, **kw)
        got += ssm.mamba2_decode({k: v.to(cuda) for k, v in prm.items()},
                                 *(a.to(cuda) for a in args), **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    names = ("ssd_y", "ssd_state", "decode_out", "decode_ssm_state",
             "decode_conv_state")
    rec = {"after": after, "state": state, "outputs": {}}
    for name, g, w in zip(names, got, want):
        g = g.cpu()
        d = (g - w).abs()
        bad = d > TOL["atol"] + TOL["rtol"] * w.abs()
        first = _first.setdefault(name, (g.clone(), w.clone()))
        rec["outputs"][name] = {
            "max_abs": float(d.max()),
            "at": [int(i) for i in torch.nonzero(d == d.max())[0]],
            "mismatched": int(bad.sum()),
            "card_bitwise_first": bool(torch.equal(g, first[0])),
            "cpu_bitwise_first": bool(torch.equal(w, first[1]))}
    rec["ok"] = all(o["mismatched"] == 0 for o in rec["outputs"].values())
    _checks.append(rec)
    return rec


# --- pytest plugin hooks (step 2) ------------------------------------------

def pytest_runtest_teardown(item, nextitem):
    import torch
    if torch.cuda.is_available():
        _check(item.nodeid)


def pytest_sessionfinish(session, exitstatus):
    if _checks:
        path = OUT / "ssd_order_checks.json"
        OUT.mkdir(exist_ok=True)
        path.write_text(json.dumps(_checks, indent=1))


# --- the two steps --------------------------------------------------------

def _pytest(extra, log):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tools")]))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "pytest", "-q",
                        "--noconftest", "-m", "cuda", "-p",
                        "no:cacheprovider", "-rf", *extra, TEST_FILE],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=1800)
    log.write_text(p.stdout + p.stderr)
    tail = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
    return p, time.perf_counter() - t0, tail


def _ssd_failure(text: str):
    """The SSD test's assertion block from a pytest log, or None."""
    if f"FAILED {TEST_FILE}::{SSD_TEST}" not in text:
        return None
    m = re.search(rf"_+ {SSD_TEST} _+\n(.*?)(?=\n_{{5,}} |\n=+ )", text,
                  re.S)
    return m.group(1)[-6000:] if m else text[-6000:]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=4,
                    help="whole-file runs at most, until the SSD test fails")
    args = ap.parse_args()
    OUT.mkdir(exist_ok=True)
    import torch
    if not torch.cuda.is_available():
        print("ssd_order_probe: no CUDA device", file=sys.stderr)
        return 1
    runs = []
    for i in range(args.runs):
        p, wall, tail = _pytest([], OUT / f"ssd_probe_run{i}.log")
        fail = _ssd_failure(p.stdout)
        runs.append({"run": i, "rc": p.returncode, "wall_s": wall,
                     "summary": tail, "ssd_failed": fail is not None,
                     "ssd_assertion": fail})
        print(f"whole file run {i}: rc {p.returncode} in {wall:.0f} s; "
              f"{tail}; SSD {'FAILED' if fail else 'passed'}", flush=True)
        if fail:
            print(fail, flush=True)
            break
    p, wall, tail = _pytest(["-p", "ssd_order_probe"],
                            OUT / "ssd_probe_plugin.log")
    checks = json.loads((OUT / "ssd_order_checks.json").read_text()) \
        if (OUT / "ssd_order_checks.json").exists() else []
    first_bad = next((c["after"] for c in checks if not c["ok"]), None)
    first_state = checks[0]["state"] if checks else {}
    changed = next((c["after"] for c in checks
                    if c["state"] != first_state), None)
    drift = next((c["after"] for c in checks if not all(
        o["card_bitwise_first"] and o["cpu_bitwise_first"]
        for o in c["outputs"].values())), None)
    worst = max((o["max_abs"] for c in checks
                 for o in c["outputs"].values()), default=None)
    summary = {"runs": runs, "plugin_session": {
        "rc": p.returncode, "wall_s": wall, "summary": tail,
        "checks": len(checks), "first_check_failing_after": first_bad,
        "first_state_change_after": changed,
        "first_output_drift_after": drift, "worst_max_abs": worst,
        "first_state": first_state}}
    (OUT / "ssd_order_probe.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary["plugin_session"], indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
