"""The harness's host-side pieces on the CPU: the closed-loop generator,
the registry, ``BENCHMARK.json`` against the benchmark contract, the
rebuilt per-tick decisions, the metric readers on a made-up run, and the
command's refusals (no card, JAX loaded)."""
import json
import pathlib
import re
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from bench import run as R
from bench.harness import registry as RG
from bench.harness import serve as SV
from bench.harness import traffic as TR
from bench.harness.trace import Slice, _union

BENCH = pathlib.Path(__file__).resolve().parent
REPO = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_aligned_clients_start_together():
    loop = TR.Clients(RG.mix("aligned"), lanes=32, steps=50, seed=7)
    assert len(loop.clients) == 32
    assert loop.setup_ticks == 0
    assert len(loop.due(0)) == 32


def test_staggered_clients_spread_over_the_schedule():
    loop = TR.Clients(RG.mix("staggered"), lanes=32, steps=50, seed=7)
    first = [c.first_tick for c in loop.clients]
    assert first == [50 * i // 32 for i in range(32)]
    assert loop.setup_ticks == 48
    assert sum(len(loop.due(t)) for t in range(50)) == 32
    flux = TR.Clients(RG.mix("staggered"), lanes=4, steps=50, seed=7)
    assert [c.first_tick for c in flux.clients] == [0, 12, 25, 37]


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 2 ** 40 + 17])
def test_request_seeds_are_deterministic_per_seed(seed):
    def seeds(s):
        loop = TR.Clients(RG.mix("aligned"), 4, 50, s)
        return [loop.next_seed(c) for _ in range(3) for c in loop.clients]
    a, b, c = seeds(seed), seeds(seed), seeds(seed + 1)
    assert a == b and a != c
    assert len(set(a)) == len(a)
    assert all(0 <= x < 2 ** 63 for x in a)


@pytest.mark.parametrize("mix", [
    {"loop": "poisson", "rate_per_s": 5},
    {"loop": "closed", "clients_per_lane": 1, "stagger": 1.5},
    {"loop": "closed", "clients_per_lane": 0, "stagger": 0},
    {"loop": "open", "rate_per_s": 0},
    {"loop": "open", "rate_per_s": 5, "burst": 0}])
def test_mix_files_are_checked(tmp_path, mix):
    bad = tmp_path / "x.json"
    bad.write_text(json.dumps(mix))
    with pytest.raises(ValueError):
        TR.load(bad)


def _open(seed, burst=1, rate=8.0, until=100.0):
    loop = TR.Clients({"loop": "open", "rate_per_s": rate, "burst": burst},
                      lanes=4, steps=50, seed=seed)
    assert loop.setup_ticks == 0 and loop.due(0) == []
    assert loop.arrivals(1e9) == []          # nothing before the window
    loop.start(10.0)
    return loop, loop.arrivals(10.0 + until)


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 9])
def test_open_loop_offers_its_rate_in_a_seeded_order(seed):
    loop, got = _open(seed)
    times = [t for _, t in got]
    assert times == sorted(times) and times[0] > 10.0
    assert [c.index for c, _ in got] == list(range(len(got)))
    # 100 s at 8 a second, the first 256 gaps their mean exactly
    assert 760 <= len(got) <= 840
    gaps = np.diff([10.0] + times)
    again = [t for _, t in _open(seed)[1]]
    other = [t for _, t in _open(seed + 1)[1]]
    assert again == times and other[:20] != times[:20]
    # every seed offers the same gaps, in another order
    gaps_o = np.diff([10.0] + other)
    assert np.allclose(sorted(gaps[:256]), sorted(gaps_o[:256]))
    assert np.mean(gaps[:256]) == pytest.approx(1 / 8.0, rel=0.02)
    assert loop.next_arrival() > times[-1]


def test_open_loop_bursts_arrive_together():
    _, got = _open(5, burst=3)
    times = [t for _, t in got]
    assert len(got) % 3 == 0
    assert all(times[i] == times[i + 1] == times[i + 2]
               for i in range(0, len(times), 3))
    assert len(set(times)) == len(times) // 3


def test_closed_loop_has_no_arrivals():
    loop = TR.Clients(RG.mix("aligned"), lanes=4, steps=50, seed=1)
    loop.start(0.0)
    assert loop.closed and loop.arrivals(1e9) == []
    assert loop.next_arrival() == float("inf")


def test_registry_finds_files_a_later_change_adds(tmp_path):
    copy = tmp_path / "bench"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns(
        "__pycache__", "test_*.py"))
    cfg = RG.config("dit-xl2-256px", bench=copy)
    cfg["lanes"] = 8
    (copy / "configs" / "dit-xl2-256px.lanes8.json").write_text(
        json.dumps(cfg))
    (copy / "traffic" / "half-stagger.json").write_text(json.dumps(
        {"loop": "closed", "clients_per_lane": 2, "stagger": 0.5}))
    (copy / "traffic" / "poisson.json").write_text(json.dumps(
        {"loop": "open", "rate_per_s": 20.0, "burst": 2}))
    (copy / "metrics" / "ticks_seen.py").write_text(
        "def read(run):\n    return run.window.ticks\n")
    assert RG.config("dit-xl2-256px.lanes8", bench=copy)["lanes"] == 8
    mix = RG.mix("half-stagger", bench=copy)
    loop = TR.Clients(mix, lanes=8, steps=50, seed=1)
    assert len(loop.clients) == 16 and loop.setup_ticks == 23
    assert not TR.Clients(RG.mix("poisson", bench=copy), 8, 50, 1).closed
    read = RG.reader("ticks_seen", bench=copy)
    assert read(RG.Run(cfg=cfg, window=SV.Window(ticks=9))) == 9


def test_benchmark_json_keeps_the_contract():
    spec = RG.benchmark()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "bench/run.py"]
    assert spec["paths"] == ["bench"]
    assert 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]]
    for c in spec["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("bench/")
        assert (REPO / c["file"]).exists()
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        for k in c["reduced"]:
            assert NAME.match(k)
            assert not k.endswith(("_dim", "_rank")) and k not in (
                "d_model", "d_ff", "num_heads")
    cells = spec["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({c["name"] for c in cells}) == len(cells)
    assert len({(c["config"], c["traffic"]) for c in cells}) == len(cells)
    for c in cells:
        assert NAME.match(c["name"]) and c["chips"] == 1
        assert c["config"] in names
        assert (BENCH / "traffic" / f"{c['traffic']}.json").exists()
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
    assert {c["config"] for c in cells} == set(names)
    metrics = spec["end_to_end"] + spec["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in cells}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in e2e
        assert "bound" not in m
    layers = {m["layer"] for m in spec["per_layer"]}
    perf = (REPO / "PERF.md").read_text()
    for layer in layers:
        assert f"| {layer} |" in perf, layer


def test_tick_table_rebuilds_the_decisions():
    cfg = {"taylor_order": 2, "max_draft": 3}
    acc = [False, False, False, True, True, True, False, True]
    served = [SV.Served(client=0, rseed=1, submit_s=0, done_s=1,
                        sample=None, accepts=acc, num_full=4, num_spec=4,
                        admit_tick=10)]
    t = SV.tick_table(cfg, served, first=12, ticks=10)
    # ticks 12.. hold steps 2..: step 2 full (2 anchors: no draft), steps
    # 3-5 drafted and accepted, step 6 could not draft (3 in a row), step 7
    # drafted after the refresh
    assert t[:6, 0].tolist() == [0, 1, 1, 1, 0, 1]
    assert t[:6, 1].tolist() == [0, 1, 1, 1, 0, 1]
    assert t[:6, 2].tolist() == [1, 0, 0, 0, 1, 0]
    assert t[6:].sum() == 0


def _run(**kw):
    cfg = RG.config("dit-xl2-256px")
    win = SV.Window(seconds=2.0, ticks=100, lane_steps=3000,
                    host_syncs=205, served=[
                        SV.Served(0, 1, 0, 1, None, [True] * 30 + [False]
                                  * 20, 20, 30, 0)])
    tracer = types.SimpleNamespace(
        calls={"full": [0] * 40, "spec": [0] * 90}, profiled={1},
        tick_seconds=lambda: [0.02] * 100,
        forward_ms=lambda k: {"full": 31.5, "spec": 4.0}[k],
        slice=Slice(first=0, ticks=2, seconds=0.1, busy_s=0.08,
                    kernel_s={"predict": 0.002, "refresh": 0.004,
                              "verify": 0.0001},
                    device_ops=[], idle_gaps=[]))
    ticks = np.zeros((100, 3), dtype=np.int64)
    ticks[0] = (32, 30, 2)
    ticks[1] = (0, 0, 32)
    return RG.Run(cfg=cfg, window=win, tracer=tracer, ticks=ticks, **kw)


def test_metric_readers_on_a_made_up_run():
    from bench.harness import flops, roofline as RL
    run = _run()
    read = {m["name"]: RG.reader(m["name"])
            for m in RG.benchmark()["per_layer"]}
    assert read["host_syncs_per_tick"](run) == 2.05
    assert read["lane_occupancy"](run) == pytest.approx(100 * 3000 / 3200)
    assert read["full_forwards_per_tick"](run) == 0.4
    assert read["accept_rate"](run) == 60.0
    assert read["full_forward_ms"](run) == 31.5
    assert read["spec_forward_ms"](run) == 4.0
    assert read["device_idle_share"](run) == pytest.approx(20.0)
    cfg, n = run.cfg, 256
    bound = sum(RL.bound_s(RL.call_bytes(k, cfg, n, lanes, 2), 0) for
                k, lanes in (("predict", 32), ("verify", 32),
                             ("refresh", 2), ("refresh", 32)))
    assert read["forecast_roofline"](run) == pytest.approx(
        100 * bound / 0.0061)
    # tick 1 ran under the profiler: its 32 full forwards and its 0.02 s
    # are left out
    useful = 30 * flops.verify_flops(cfg) + 2 * flops.forward_flops(cfg)
    assert read["step_mfu"](run) == pytest.approx(
        100 * useful / (99 * 0.02 * RL.BF16_TC_FLOPS))
    bare = RG.Run(cfg=cfg, window=run.window)
    for name in ("forecast_roofline", "device_idle_share", "step_mfu",
                 "full_forward_ms", "full_forwards_per_tick"):
        assert read[name](bare) is None


def test_union_of_device_intervals():
    assert _union([(3, 4), (0, 1), (0.5, 2), (4, 5)]) == [(0, 2), (3, 5)]


def test_forbidden_modules_compare_whole_names(monkeypatch):
    # another test file in this process may have loaded JAX already
    before = set(R.forbidden_modules())
    for name in ("repro_torch_like", "jaxy"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(R.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    monkeypatch.setitem(sys.modules, "repro.core",
                        types.ModuleType("repro.core"))
    assert set(R.forbidden_modules()) == before | {"jax", "repro"}


def test_command_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "dit-xl2-256px.aligned", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=REPO,
        timeout=300, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
