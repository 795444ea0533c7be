"""The port's observability layer against the reference's, model-free
(analogues of the unit half of ``tests/test_obs.py``).

The same call sequence goes to ``repro.obs`` and ``repro_torch.obs``:
registry snapshots (counters, gauges, histogram quantiles, series
windows) equal; ``prometheus_text``, ``to_jsonl`` and ``chrome_trace``
byte/JSON-equal on equal inputs; ``build_trace`` span names, ticks and
times equal; ``FlightRecorder`` bounds and LRU equal. The
``LaneAccumulator`` folds seeded numpy flags — [W] ``err`` and [K, W]
``chain_err``, NaN and ±Inf, values exactly on an edge — over several
updates: counts and tick totals exact, ``err_sum`` within rtol 1e-6.
"""
import io
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as J
import repro_torch.obs as P
from repro.obs.lane_metrics import LaneAccumulator as JAcc
from repro.obs.trace import _tick_span_name as j_span_name
from repro_torch.obs.lane_metrics import LaneAccumulator as PAcc
from repro_torch.obs.trace import _tick_span_name as p_span_name

PACKAGES = (J, P)


def test_public_surface_matches_reference():
    assert P.__all__ == J.__all__
    assert P.DEFAULT_ERR_EDGES == J.DEFAULT_ERR_EDGES
    from repro.serving import engine as JE
    from repro_torch.serving import engine as PE
    assert PE._RATE_EDGES == JE._RATE_EDGES
    assert PE._SECONDS_EDGES == JE._SECONDS_EDGES


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def _script(pkg):
    """One call sequence over every instrument kind; returns the registry."""
    reg = pkg.MetricsRegistry()
    c = reg.counter("speca_done_total", workload="diffusion", tenant="a")
    c.inc()
    c.inc(2.5)
    reg.counter("speca_done_total", workload="diffusion", tenant="b").inc(4)
    reg.counter("speca:odd-name.total", **{"1bad": "x"}).inc(0.0)
    g = reg.gauge("speca_depth")
    g.set(4.0)
    g.inc(-1.5)
    h = reg.histogram("speca_lat", edges=(1e-3, 1e-2, 0.1, 1.0, 10.0),
                      workload="diffusion")
    for v in np.random.default_rng(0).lognormal(-3.0, 2.0, 200):
        h.observe(float(v))
    h.observe(1e-2)                    # exactly on an edge: that bucket
    h.observe(1e9)                     # the +Inf bucket
    e = reg.histogram("speca_err", edges=(1.0, 2.0))
    e.add_counts([2.0, 1.0, 3.0], total_sum=12.5, total_count=6.0)
    reg.histogram("speca_empty", edges=(0.5,))
    s = reg.series("speca_qd", capacity=5)
    for i in range(9):
        s.append(i, float((i * 7) % 4))
    reg.series("speca_unused")
    return reg


def test_registry_snapshot_matches_reference():
    jreg, preg = _script(J), _script(P)
    assert preg.snapshot() == jreg.snapshot()
    for name in ("speca_lat", "speca_err"):
        jh = jreg.histogram(name, **({"workload": "diffusion"}
                                     if name == "speca_lat" else {}))
        ph = preg.histogram(name, **({"workload": "diffusion"}
                                     if name == "speca_lat" else {}))
        for q in (0.0, 0.1, 0.25, 0.5, 0.9, 0.99, 1.0):
            assert ph.quantile(q) == jh.quantile(q), (name, q)
        assert ph.mean == jh.mean
    js, ps = jreg.series("speca_qd"), preg.series("speca_qd")
    assert (ps.points(), ps.values(), ps.peak(), ps.last(), ps.dropped,
            len(ps)) == (js.points(), js.values(), js.peak(), js.last(),
                         js.dropped, len(js))
    assert math.isnan(preg.histogram("speca_empty").quantile(0.5))
    assert math.isnan(preg.series("speca_unused").peak())


@pytest.mark.parametrize("case", [
    "counter_negative", "kind_clash", "edges_mismatch", "edges_missing",
    "edges_unsorted", "add_counts_length", "quantile_range",
    "series_capacity"])
def test_registry_errors_match_reference(case):
    def run(pkg):
        reg = pkg.MetricsRegistry()
        reg.counter("c").inc()
        reg.histogram("h", edges=(1.0, 2.0))
        try:
            {"counter_negative": lambda: reg.counter("c").inc(-1.0),
             "kind_clash": lambda: reg.gauge("c"),
             "edges_mismatch": lambda: reg.histogram("h", edges=(1.0,)),
             "edges_missing": lambda: reg.histogram("new"),
             "edges_unsorted": lambda: reg.histogram("u", edges=(2.0, 1.0)),
             "add_counts_length": lambda: reg.histogram("h").add_counts(
                 [1.0], 1.0, 1.0),
             "quantile_range": lambda: reg.histogram("h").quantile(1.5),
             "series_capacity": lambda: reg.series("s", capacity=0)}[case]()
        except Exception as exc:           # noqa: BLE001 — compared below
            return type(exc).__name__, str(exc)
        return None
    got, want = run(P), run(J)
    assert want is not None
    assert got == want


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------

def test_prometheus_text_matches_reference():
    def text(pkg):
        reg = _script(pkg)
        reg.counter("speca_esc_total", tenant='we"ird\nna\\me').inc(2.0)
        reg.gauge("speca_nan").set(float("nan"))
        reg.gauge("speca_inf").set(float("-inf"))
        return pkg.prometheus_text(reg.snapshot())
    got, want = text(P), text(J)
    assert got == want
    assert 'tenant="we\\"ird\\nna\\\\me"' in got
    assert "speca_nan NaN" in got and "speca_inf -Inf" in got
    assert P.prometheus_text([]) == J.prometheus_text([]) == ""


def test_to_jsonl_matches_reference(tmp_path):
    rows = [{"kind": "submit", "ticket": 1, "s": 0.25},
            {"kind": "finish", "lanes": [0, 1], "obj": object.__name__},
            {"b": 2, "a": {"z": 1, "y": [1.5, None]}}]
    buf_j, buf_p = io.StringIO(), io.StringIO()
    assert P.to_jsonl(rows, buf_p) == J.to_jsonl(rows, buf_j)
    assert buf_p.getvalue() == buf_j.getvalue()
    path = tmp_path / "events.jsonl"
    P.to_jsonl(rows, str(path))
    assert path.read_text() == J.to_jsonl(rows)
    assert [json.loads(line) for line in path.read_text().splitlines()] \
        == rows


def _traces(pkg):
    out = []
    for tid, (deep, completed) in enumerate([(False, True), (True, True),
                                             (True, False)]):
        t = pkg.Timings(submit_s=1.0 + tid, admit_s=2.0 + tid,
                        finish_s=6.5 + tid, first_tick_s=2.5 + tid,
                        submit_tick=0, admit_tick=3, finish_tick=7)
        rows = [{"n_spec": 1, "n_drafted": 1, "full": 0, "advanced": 1},
                {"n_spec": 0, "n_drafted": 0, "full": 1, "advanced": 1},
                {"n_spec": 1, "n_drafted": 3, "full": 1, "advanced": 2},
                {"n_spec": 0, "n_drafted": 0, "full": 0, "advanced": 0}]
        out.append(pkg.build_trace(
            ticket_id=10 + tid, request_id=tid,
            workload="diffusion" if tid < 2 else "other",
            tenant=f"t{tid}", completed=completed, timings=t, per_tick=rows,
            tick_times=[None, None, None, 2.5 + tid, 3.5 + tid, None,
                        5.0 + tid], deep=deep))
    return out


def _trace_tuple(tr):
    return (tr.ticket_id, tr.request_id, tr.workload, tr.tenant,
            tr.completed, tuple((s.name, s.t0, s.t1, s.tick0, s.tick1,
                                 s.attrs, s.dur_s) for s in tr.spans),
            [s.name for s in tr.tick_spans()])


def test_build_trace_matches_reference():
    for a, b in zip(_traces(J), _traces(P)):
        assert _trace_tuple(b) == _trace_tuple(a)
    names = [s.name for s in _traces(P)[1].tick_spans()]
    assert names == ["draft+verify", "refresh",
                     "draft+verify+rollback+refresh", "stall"]


@pytest.mark.parametrize("deep", [False, True])
def test_tick_span_names_match_reference(deep):
    for ns in range(3):
        for nd in range(3):
            for full in range(2):
                assert p_span_name(ns, nd, full, deep) == \
                    j_span_name(ns, nd, full, deep), (ns, nd, full)


def test_chrome_trace_matches_reference(tmp_path):
    jdoc, pdoc = J.chrome_trace(_traces(J)), P.chrome_trace(_traces(P))
    assert pdoc == jdoc
    assert json.dumps(pdoc, sort_keys=True) == \
        json.dumps(jdoc, sort_keys=True)
    path = tmp_path / "trace.json"
    P.chrome_trace(_traces(P), str(path))
    assert json.loads(path.read_text()) == json.loads(json.dumps(jdoc))


def test_flight_recorder_bounds_and_lru_match_reference():
    def run(pkg):
        rec = pkg.FlightRecorder(capacity=3, trace_capacity=2)
        for i in range(5):
            rec.record("submit", float(i), ticket=i, lanes=[i])
        t = pkg.Timings(submit_s=0.0, admit_s=0.0, finish_s=1.0)
        for tid in (0, 1, 0, 2):       # re-putting 0 refreshes it
            rec.put_trace(pkg.build_trace(
                ticket_id=tid, request_id=tid, workload="diffusion",
                tenant="default", completed=True, timings=t, per_tick=[],
                tick_times=[], deep=False))
        return (rec.events(), rec.dropped,
                [tr.ticket_id for tr in rec.traces()],
                rec.trace(1), rec.trace(0).ticket_id)
    got, want = run(P), run(J)
    assert got == want
    assert got[1] == 2 and got[2] == [0, 2] and got[3] is None
    for pkg in PACKAGES:
        with pytest.raises(ValueError):
            pkg.FlightRecorder(capacity=0)


def test_observability_bundle_matches_reference():
    def run(pkg):
        obs = pkg.Observability(clock=pkg.FakeClock(5.0, auto_tick=0.5),
                                event_capacity=8, trace_capacity=2,
                                err_edges=(0.1, 1.0))
        for i in range(3):
            obs.recorder.record("submit", obs.clock.now(), ticket=i)
        for tr in _traces(pkg):
            obs.recorder.put_trace(tr)
        obs.metrics.counter("speca_x_total").inc(3)
        acc = obs.lane_accumulator()
        return obs, acc.err_edges
    (jo, je), (po, pe) = run(J), run(P)
    assert pe == je
    assert po.snapshot() == jo.snapshot()
    assert po.prometheus() == jo.prometheus()
    assert po.events_jsonl() == jo.events_jsonl()
    assert po.chrome_trace() == jo.chrome_trace()
    assert isinstance(P.Observability().clock, P.MonotonicClock)


def test_phase_recorder_nests_bounds_and_counts():
    """Phase spans nest (parent ids, inherited workload and ticket), the
    ring keeps the newest ``capacity`` and counts the dropped, a wait adds
    its count and seconds by reason, keeps its count in its ``attrs`` and
    leaves its parent's ``self_s``,
    ``spans(since=)`` keeps the spans ending at or after it, and an
    exception still closes the span."""
    clock = P.FakeClock(0.0, auto_tick=1.0)
    reg = P.MetricsRegistry()
    ph = P.trace.PhaseRecorder(clock, reg, capacity=4)
    ph.tick = 7

    def body():
        ph.wait("flags", lambda: None, n=6)
        return ph.call("inner", lambda x: x + 1, 1)
    assert ph.call("outer", body, workload="diffusion", ticket=3) == 2
    assert ph.self_s == 5.0 - 1.0        # outer: t 0..5, its wait 1 s
    spans = ph.spans()
    assert [(s.name, s.t0, s.t1) for s in spans] == [
        ("wait.flags", 1.0, 2.0), ("inner", 3.0, 4.0), ("outer", 0.0, 5.0)]
    assert [s.attrs for s in spans] == [(("n", 6),), (), ()]
    outer = spans[-1]
    assert outer.parent is None and (outer.tick0, outer.tick1) == (7, 8)
    assert all(s.parent == outer.span_id and s.workload == "diffusion"
               and s.ticket == 3 for s in spans[:2])
    snap = {(r["name"], r["labels"].get("reason")): r["value"]
            for r in reg.snapshot()}
    assert snap == {("speca_device_waits_total", "flags"): 6.0,
                    ("speca_wait_seconds_total", "flags"): 1.0}
    with pytest.raises(KeyError):
        ph.call("bad", lambda: {}["x"])
    assert ph._open == [] and ph.spans()[-1].name == "bad"
    for i in range(3):
        ph.call(f"s{i}", lambda: None)
    assert [s.name for s in ph.spans()] == ["bad", "s0", "s1", "s2"]
    assert ph.dropped == 3
    assert [s.name for s in ph.spans(since=ph.spans()[2].t1)] == \
        ["s1", "s2"]
    with pytest.raises(ValueError):
        P.trace.PhaseRecorder(clock, reg, capacity=0)
    obs = P.Observability()
    assert obs.phases.capacity == 16384 and obs.phases.clock is obs.clock
    assert obs.phases.metrics is obs.metrics and obs.snapshot() == []


# ---------------------------------------------------------------------------
# The lane accumulator
# ---------------------------------------------------------------------------

EDGES = (1e-3, 1e-2, 0.1, 0.5, 1.0, 10.0)


def _flags(rng, W, K, edges):
    """One tick's seeded flags: counters, and errors with NaN, ±Inf and
    values exactly on an edge (as f32)."""
    err = rng.lognormal(-2.5, 2.0, (K, W)).astype(np.float32)
    pick = rng.random((K, W))
    on_edge = np.asarray(edges, np.float32)[
        rng.integers(0, len(edges), (K, W))]
    err = np.where(pick < 0.2, on_edge, err)
    err = np.where((pick >= 0.2) & (pick < 0.3), np.nan, err)
    err = np.where((pick >= 0.3) & (pick < 0.35), np.inf, err)
    err = np.where((pick >= 0.35) & (pick < 0.38), -np.inf, err)
    attempted = rng.random(W) < 0.7
    n_drafted = (attempted * rng.integers(1, K + 1, W)).astype(np.int32)
    n_spec = np.minimum(n_drafted, rng.integers(0, K + 1, W)).astype(
        np.int32)
    full = attempted & (n_spec < n_drafted) | ~attempted
    advanced = (n_spec + full).astype(np.int32)
    return {"attempted": attempted, "accepted": n_spec > 0,
            "n_spec": n_spec, "n_drafted": n_drafted, "full": full,
            "advanced": advanced, "err": err[0], "chain_err": err}


def _feed(flags_list, key, edges):
    """Both accumulators over ``flags_list`` with the errors under
    ``key`` ("err" [W] or "chain_err" [K, W]); their registries."""
    jacc = JAcc(err_edges=edges) if edges else JAcc()
    pacc = PAcc(err_edges=edges) if edges else PAcc()
    regs = (J.MetricsRegistry(), P.MetricsRegistry())
    for f in flags_list:
        sel = {k: v for k, v in f.items() if k in
               ("attempted", "accepted", "n_spec", "n_drafted", "full",
                "advanced", key)}
        jacc.update({k: jnp.asarray(v) for k, v in sel.items()})
        pacc.update({k: torch.from_numpy(np.asarray(v))
                     for k, v in sel.items()})
    jacc.flush_into(regs[0], workload="diffusion")
    pacc.flush_into(regs[1], workload="diffusion")
    return regs, jacc, pacc


def _assert_snapshots_close(jsnap, psnap):
    assert len(jsnap) == len(psnap)
    for a, b in zip(jsnap, psnap):
        if a["kind"] == "histogram":
            # err_sum (and the mean from it) is an f32 sum whose order
            # differs between the packages
            inexact = ("sum", "mean")
            assert {k: v for k, v in b.items() if k not in inexact} == \
                {k: v for k, v in a.items() if k not in inexact}
            for k in inexact:
                if k in a:
                    assert b[k] == pytest.approx(a[k], rel=1e-6)
        else:
            assert b == a


@pytest.mark.parametrize("key, K, edges", [
    ("err", 1, EDGES), ("chain_err", 3, EDGES), ("chain_err", 4, None),
    ("err", 1, None)])
def test_lane_accumulator_matches_reference(key, K, edges):
    rng = np.random.default_rng(7 + K)
    flags = [_flags(rng, 6, K, edges or J.DEFAULT_ERR_EDGES)
             for _ in range(5)]
    (jreg, preg), _, _ = _feed(flags, key, edges)
    jsnap, psnap = jreg.snapshot(), preg.snapshot()
    _assert_snapshots_close(jsnap, psnap)
    h = {r["name"]: r for r in psnap}["speca_chain_err"]
    finite = sum(int(np.isfinite(f[key]).sum()) for f in flags)
    assert h["count"] == sum(h["counts"]) == finite
    assert {r["name"]: r for r in psnap}["speca_obs_ticks_total"][
        "value"] == 5.0
    assert {r["name"]: r for r in psnap}["speca_n_spec_total"]["value"] \
        == sum(int(f["n_spec"].sum()) for f in flags)


def test_lane_accumulator_edge_values_bin_left():
    """An error exactly on an edge lands in that edge's bucket (``le``),
    in both packages."""
    edges = (0.5, 1.0, 2.0)
    flags = {"attempted": np.ones(5, bool), "accepted": np.ones(5, bool),
             "n_spec": np.ones(5, np.int32),
             "n_drafted": np.ones(5, np.int32), "full": np.zeros(5, bool),
             "advanced": np.ones(5, np.int32),
             "err": np.asarray([0.5, 1.0, 2.0, 2.5, 0.25], np.float32)}
    (jreg, preg), _, _ = _feed([flags], "err", edges)
    assert preg.snapshot() == jreg.snapshot()
    assert preg.histogram("speca_chain_err", workload="diffusion").counts \
        == [2.0, 1.0, 1.0, 1.0]


def test_lane_accumulator_depth1_err_equals_chain_err_row():
    """The port's depth-1 step emits ``err`` [W] and no ``chain_*``; the
    reference's emits ``chain_err = err[None]``: both give the same
    histogram."""
    rng = np.random.default_rng(3)
    flags = [_flags(rng, 4, 1, EDGES) for _ in range(4)]
    jacc, pacc = JAcc(err_edges=EDGES), PAcc(err_edges=EDGES)
    for f in flags:
        base = {k: f[k] for k in ("attempted", "accepted", "n_spec",
                                  "n_drafted", "full", "advanced")}
        jacc.update({**{k: jnp.asarray(v) for k, v in base.items()},
                     "err": jnp.asarray(f["err"]),
                     "chain_err": jnp.asarray(f["err"][None])})
        pacc.update({**{k: torch.from_numpy(v) for k, v in base.items()},
                     "err": torch.from_numpy(f["err"])})
    jreg, preg = J.MetricsRegistry(), P.MetricsRegistry()
    jacc.flush_into(jreg)
    pacc.flush_into(preg)
    _assert_snapshots_close(jreg.snapshot(), preg.snapshot())


def test_lane_accumulator_counts_both_lanes_of_a_guided_pair():
    """A guided pair reports pair-equal flags on both lanes; the
    reference counts both, and so does the port."""
    pair = {"attempted": np.asarray([1, 1, 1], bool),
            "accepted": np.asarray([1, 1, 0], bool),
            "n_spec": np.asarray([1, 1, 0], np.int32),
            "n_drafted": np.asarray([1, 1, 1], np.int32),
            "full": np.asarray([0, 0, 1], bool),
            "advanced": np.ones(3, np.int32),
            "err": np.asarray([0.05, 0.05, 2.0], np.float32)}
    (jreg, preg), _, _ = _feed([pair], "err", EDGES)
    assert preg.snapshot() == jreg.snapshot()
    lab = {"workload": "diffusion"}
    assert preg.counter("speca_n_spec_total", **lab).value == 2.0
    assert preg.histogram("speca_chain_err", **lab).count == 3.0


def test_lane_accumulator_flush_resets_and_empty_flush_matches():
    rng = np.random.default_rng(11)
    flags = [_flags(rng, 4, 2, EDGES) for _ in range(2)]
    (jreg, preg), jacc, pacc = _feed(flags, "chain_err", EDGES)
    # flushing again adds zeros, never the same ticks twice
    jacc.flush_into(jreg, workload="diffusion")
    pacc.flush_into(preg, workload="diffusion")
    _assert_snapshots_close(jreg.snapshot(), preg.snapshot())
    assert preg.counter("speca_obs_ticks_total",
                        workload="diffusion").value == 2.0
    # a never-updated accumulator flushes the reference's zero rows
    jr, pr = J.MetricsRegistry(), P.MetricsRegistry()
    JAcc().flush_into(jr, workload="w")
    PAcc().flush_into(pr, workload="w")
    assert pr.snapshot() == jr.snapshot()
    # after a reset the buffer keeps accumulating from zero
    pacc.update({k: torch.from_numpy(np.asarray(v))
                 for k, v in flags[0].items() if k != "err"})
    reg = P.MetricsRegistry()
    pacc.flush_into(reg)
    assert reg.counter("speca_obs_ticks_total").value == 1.0
    assert reg.counter("speca_n_drafted_total").value == \
        float(flags[0]["n_drafted"].sum())
