"""The phase readers and the clock anchors (``harness/phases.py``) on the
CPU, on a hand-built slice: the engine's spans recorded on a scripted
clock, mapped onto a profiler base with another offset and a drift,
every share exact; None wherever there is nothing to read. On the card
(marked ``cuda``): twenty ticks of a small engine under the profiler,
every ``cudaStreamSynchronize`` inside a mapped ``wait.*`` span, and the
waits counted by reason equal to the syncs their spans hold.

    PYTHONPATH=src python -m pytest -q -m cuda bench/test_bench_phases.py
"""
import dataclasses
import types

import pytest
import torch

from bench.harness import registry as RG
from bench.harness import serve as SV
from bench.harness.phases import (ANCHOR, SYNC, Anchor, ClockMap,
                                  MappedSpan, PhaseSlice, PhaseTracer,
                                  match_anchors, slice_phases, take_anchors)
from bench.harness.trace import Slice
from repro_torch.obs import FakeClock, MetricsRegistry
from repro_torch.obs.trace import PhaseRecorder

NEW = ("device_waits_per_tick", "step_host_ms", "idle_in_step_share",
       "idle_in_lifecycle_share")
DRIFT = 1e-4                     # 100 µs a second: far more than a card's


def prof(t: float) -> float:
    """The made-up profiler base: µs, 5 ms ahead, running fast."""
    return 5000.0 + (t - 100.0) * 1e6 * (1.0 + DRIFT)


def _recorded():
    """One engine tick's spans on a scripted clock (engine seconds):
    tick [100.0, 100.010] > admit [100.0, 100.001] > wait.fill
    [100.0005, 100.001]; step [100.001, 100.006] > wait.draft [100.0018,
    100.0028]; harvest [100.007, 100.009] > wait.sample [100.0078,
    100.009]."""
    clock = FakeClock(100.0)
    ph = PhaseRecorder(clock, MetricsRegistry())

    def to(t):
        clock._t = t

    def admit():
        to(100.0005)
        ph.wait("fill", to, 100.001)

    def step():
        to(100.0018)
        ph.wait("draft", to, 100.0028)
        to(100.006)

    def harvest():
        to(100.0078)
        ph.wait("sample", to, 100.009)

    def tick():
        ph.call("admit", admit, ticket=1)
        ph.call("step", step)
        to(100.007)
        ph.call("harvest", harvest, ticket=1)
        to(100.010)
    ph.call("tick", tick)
    return types.SimpleNamespace(phases=ph)


def _anchor(t, pad=0.5e-4):
    """A sync bracketed by clock reads ``2 pad`` + 100 µs apart, its
    runtime event the middle 100 µs."""
    a = Anchor(t, t + 2 * pad + 1e-4)
    return a, (ANCHOR, prof(t + pad), prof(t + pad + 1e-4))


def _anchors(t):
    """An anchor's draining sync and three brackets at uneven pauses
    (0.4 and 1.1 ms), the second the narrowest (its event 10 µs from
    either end)."""
    out = [_anchor(t + start, pad) for start, pad in
           ((1e-3, 0.5e-4), (1.6e-3, 1e-5), (2.9e-3, 0.8e-4))]
    drain = (ANCHOR, prof(t), prof(t + 0.9e-3))
    return [a for a, _ in out], [drain] + [e for _, e in out]


def _slice(observed=True, stray=False):
    """Busy 100.0–.0015, .0025–.0064, .0074–.0100, .0110–.0120: three
    idle ms, the first under ``step``, the second 0.4 ms under
    ``harvest``, the third outside the tick."""
    busy = [(100.0, 100.0015), (100.0025, 100.0064), (100.0074, 100.0100),
            (100.0110, 100.0120)]
    dev = [(prof(a), prof(b)) for a, b in busy]
    a0, e0 = _anchors(99.9940)
    a1, e1 = _anchors(100.0130)
    if stray:       # syncs the profiler makes as it starts and stops
        e0 = [(ANCHOR, prof(99.9939), prof(99.99392))] + e0
        e1 = e1 + [(ANCHOR, prof(100.0170), prof(100.01701))]
    host = e0 + e1 + [(name, prof(a), prof(b)) for name, a, b in (
        (SYNC, 100.0019, 100.0027),         # in wait.draft
        (SYNC, 100.0080, 100.0088),         # in wait.sample
        (SYNC, 100.000495, 100.00101),      # wait.fill, within 20 µs
        (SYNC, 100.0104, 100.0107),         # outside any wait
        ("cudaLaunchKernel", 100.0063, 100.0064))]
    base = Slice(first=0, ticks=1, seconds=0.012, busy_s=0.009,
                 kernel_s={}, device_ops=[], idle_gaps=[])
    return slice_phases(base, dev, host, (a0, a1),
                        _recorded() if observed else None)


def test_anchors_take_the_narrowest_bracket_that_holds_its_event():
    a0, e0 = _anchors(99.994)
    a1, e1 = _anchors(100.013)
    marks = [e[1:] for e in e0 + e1]
    a, b = match_anchors(a0, a1, marks)
    assert (a.c0, b.c0) == (a0[1].c0, a1[1].c0)
    assert (a.p0, b.p0) == (marks[2][0], marks[6][0])
    # a run whose offsets disagree by more than 50 µs is no anchor; a
    # bracket shorter than its event holds none of it; too few events
    # map nothing
    off = list(marks)
    off[2] = (marks[2][0] + 300.0, marks[2][1] + 300.0)
    assert match_anchors(a0, a1, off) is None
    a0[1].c1 = a0[1].c0 + 1e-5
    assert match_anchors(a0, a1, marks) is None
    assert match_anchors(a0, a1, marks[:7]) is None


def test_clock_map_recovers_offset_and_drift():
    a0, e0 = _anchor(99.999)
    a1, e1 = _anchor(100.013)
    a0.p0, a0.p1 = e0[1:]
    a1.p0, a1.p1 = e1[1:]
    cmap = ClockMap(a0, a1)
    for t in (99.9, 100.0, 100.0075, 100.5):
        assert cmap(t) == pytest.approx(prof(t), abs=1e-6)
    # the offset at each anchor's middle, its error bound half of the 200
    # µs bracket beyond the 100 µs event
    assert a0.offset_us == pytest.approx(prof(99.9991) - 99.9991e6,
                                         abs=1e-6)
    assert a0.width_us == pytest.approx(50.0 - 50 * DRIFT, abs=1e-6)
    assert cmap.drift_us == pytest.approx(0.014 * 1e6 * DRIFT, abs=1e-6)


@pytest.mark.parametrize("stray", [False, True])
def test_idle_shares_gap_names_and_syncs_on_a_hand_built_slice(stray):
    sl = _slice(stray=stray)
    assert sl.anchor_events == 8 + 2 * stray
    assert isinstance(sl, PhaseSlice) and sl.drift_us == pytest.approx(
        1.9, abs=1e-6)
    # each anchor's narrowest bracket: its event 10 µs from either end
    assert [a.width_us for a in sl.anchors] == pytest.approx(
        [10.0 - 50 * DRIFT] * 2, abs=1e-6)
    assert len(sl.gaps) == 3
    assert sl.idle_share_under(("step",)) == pytest.approx(100 / 3)
    assert sl.idle_share_under(("admit", "harvest")) == \
        pytest.approx(100 * 0.4 / 3)
    assert sl.idle_share_under(("admit",)) == 0.0
    names = sorted(n for n, _ in sl.idle_gaps)
    assert names == ["outside|cudaStreamSynchronize",
                     "step>wait.draft|cudaStreamSynchronize", "tick|host"]
    assert all(s == pytest.approx(1e-3 * (1 + DRIFT))
               for _, s in sl.idle_gaps)
    assert len(sl.syncs) == 4
    # the sync 5 µs before wait.fill counts inside, by the 20 µs margin
    assert sl.unspanned_syncs() == [(prof(100.0104), "outside")]
    paths = {s.path for s in sl.spans}
    assert {"admit>wait.fill", "harvest>wait.sample", "tick"} <= paths
    assert sl.sync_counts() == {"fill": [1, 1], "draft": [1, 1],
                                "sample": [1, 1]}


def test_sync_counts_give_each_sync_to_one_of_back_to_back_waits():
    """Two ``wait.flags`` spans 5 µs apart, counting 2 and 1, holding
    syncs that each also lie within 20 µs of the other span: each sync
    goes to the span under its middle, so the counts agree; a sync under
    no span but within 20 µs of one goes to it, one farther to none."""
    base = {f.name: None for f in dataclasses.fields(Slice)}
    spans = [MappedSpan("wait.flags", 0.0, 100.0, "harvest>wait.flags", 2),
             MappedSpan("wait.flags", 105.0, 200.0, "harvest>wait.flags", 1),
             MappedSpan("wait.sample", 300.0, 310.0, "harvest>wait.sample",
                        1),
             MappedSpan("harvest", -5.0, 320.0, "harvest")]
    syncs = [(10.0, 20.0), (85.0, 99.0), (110.0, 120.0), (311.0, 325.0),
             (400.0, 410.0)]
    sl = PhaseSlice(**base, spans=spans, syncs=syncs,
                    syncs_bounds=(-10.0, 500.0))
    assert sl.sync_counts() == {"flags": [3, 3], "sample": [1, 1]}


def test_phase_readers_on_a_made_up_run():
    sl = _slice()
    opened = {("speca_device_waits_total", (("reason", "draft"),)): 10.0,
              ("speca_device_waits_total", (("reason", "flags"),)): 60.0,
              ("speca_step_host_seconds_total",
               (("workload", "diffusion"),)): 1.0,
              ("speca_obs_ticks_total", (("workload", "diffusion"),)): 5.0}
    closed = dict(opened)
    closed.update({
        ("speca_device_waits_total", (("reason", "draft"),)): 210.0,
        ("speca_device_waits_total", (("reason", "flags"),)): 660.0,
        ("speca_device_waits_total", (("reason", "sample"),)): 32.0,
        ("speca_step_host_seconds_total", (("workload", "diffusion"),)):
            2.5,
        ("speca_obs_ticks_total", (("workload", "diffusion"),)): 105.0})
    tracer = types.SimpleNamespace(opened=opened, closed=closed, slice=sl)
    tracer.growth = lambda name, **lab: PhaseTracer.growth(
        tracer, name, **lab)
    assert tracer.growth("speca_device_waits_total", reason="flags") == 600
    run = RG.Run(cfg={}, window=SV.Window(ticks=100), tracer=tracer)
    read = {n: RG.reader(n) for n in NEW}
    assert read["device_waits_per_tick"](run) == pytest.approx(8.32)
    assert read["step_host_ms"](run) == pytest.approx(15.0)
    assert read["idle_in_step_share"](run) == pytest.approx(100 / 3)
    assert read["idle_in_lifecycle_share"](run) == \
        pytest.approx(100 * 0.4 / 3)
    shares = [read[n](run) for n in NEW[2:]]
    assert all(0.0 <= v <= 100.0 for v in shares) and sum(shares) <= 100.0


def test_phase_readers_find_nothing_without_obs_or_slice():
    read = {n: RG.reader(n) for n in NEW}
    plain = Slice(first=0, ticks=1, seconds=0.1, busy_s=0.08, kernel_s={},
                  device_ops=[], idle_gaps=[])
    unobserved = _slice(observed=False)
    runs = [RG.Run(cfg={}, window=SV.Window(ticks=10)),
            RG.Run(cfg={}, window=SV.Window(ticks=10),
                   tracer=types.SimpleNamespace(slice=None, calls={})),
            RG.Run(cfg={}, window=SV.Window(ticks=10),
                   tracer=types.SimpleNamespace(slice=plain)),
            RG.Run(cfg={}, window=SV.Window(ticks=10),
                   tracer=types.SimpleNamespace(
                       slice=unobserved, opened=None, closed=None,
                       growth=lambda *a, **k: None))]
    for run in runs:
        for name in NEW:
            assert read[name](run) is None, name


def test_slice_without_observability_keeps_the_benchmarks_names():
    sl = _slice(observed=False)
    assert sl.spans == [] and sl.drift_us is None
    assert sorted(n for n, _ in sl.idle_gaps) == [
        "cudaStreamSynchronize", "cudaStreamSynchronize", "host"]


def _dit(device):
    """A random two-layer DiT's (config, parameters, diffusion config,
    SpeCa config) on ``device``."""
    from repro_torch import configs as PC
    from repro_torch.layers.model import init_params
    cfg = PC.ModelConfig(name="t", num_layers=2, d_model=64, num_heads=4,
                         d_ff=128, num_classes=10, dtype="float32")
    gen = torch.Generator(device=device).manual_seed(0)
    return (cfg, init_params(cfg, gen, device=device),
            PC.DiffusionConfig(num_inference_steps=20, latent_size=8),
            PC.SpeCaConfig(tau0=1.0))


def _engine(kind, device):
    """A small engine of ``kind`` with observability on, warmed, started
    at four lanes with twelve requests queued, and a first three ticks
    served: a random two-layer DiT (labels and noise on the host), or a
    reduced Llama-3-8B decoding eight tokens from prompts of 4–7."""
    import numpy as np

    from repro_torch import configs as PC
    from repro_torch.core.workload import DecodeWorkload
    from repro_torch.layers.model import init_params
    from repro_torch.serving import Request, RequestPolicy, SpeCaEngine
    if kind == "decode":
        cfg = PC.reduced(PC.get_config("llama3-8b"))
        gen = torch.Generator(device=device).manual_seed(0)
        wl = DecodeWorkload(cfg, init_params(cfg, gen, device=device),
                            PC.SpeCaConfig(tau0=5.0), max_new_tokens=8,
                            max_seq_len=16, device=device)
        eng = SpeCaEngine(workloads={"decode": wl}, lanes=4, obs=True,
                          device=device)
        rng = np.random.default_rng(0)
        conds = [{"tokens": rng.integers(0, cfg.vocab_size, (1, 4 + i % 4),
                                         dtype=np.int32)}
                 for i in range(12)]
        pol = RequestPolicy(workload="decode")
        eng.warmup(conds[0], lanes=4, workload="decode")
        eng.start(lanes=4, workload="decode")
    else:
        eng = SpeCaEngine(*_dit(device), lanes=4, obs=True, device=device)
        conds = [{"labels": torch.tensor([i % 10])} for i in range(12)]
        pol = None
        eng.warmup(conds[0], lanes=4, mixed=True)
        eng.start(lanes=4)
    for i, cond in enumerate(conds):
        eng.submit(Request(request_id=i, cond=cond, seed=i,
                           **({} if pol is None else {"policy": pol})))
    eng.tick(3)
    return eng


def test_anchors_on_the_spans_clock_when_the_engine_has_its_own():
    """An engine given an ``Observability`` on one clock and a clock of
    its own stamps its phase spans on the bundle's: anchors taken on that
    clock (``span_clock``) map every wait span onto the syncs made inside
    it, and anchors taken on the engine's clock would miss them all. The
    profiler's base here follows the bundle's clock (``prof``); each
    ``torch.cuda.synchronize()`` is a made-up runtime event in the middle
    of its bracket, and each wait a made-up sync inside its span."""
    from bench.harness.phases import span_clock
    from repro_torch.obs import Observability
    from repro_torch.serving import Request, SpeCaEngine
    spans_clock, engine_clock = FakeClock(100.0, 1e-5), FakeClock(7.0, 1e-5)
    eng = SpeCaEngine(*_dit("cpu"), lanes=4,
                      obs=Observability(clock=spans_clock),
                      clock=engine_clock, device="cpu")
    assert span_clock(eng) is spans_clock and eng.clock is engine_clock
    eng.start(lanes=4)
    for i in range(6):
        eng.submit(Request(request_id=i, cond={"labels": torch.tensor([i])},
                           seed=i))
    marks = []

    def sync():
        t = spans_clock._t
        marks.append((ANCHOR, prof(t), prof(t + 4e-5)))
        spans_clock.advance(5e-5)

    def run(clock_of_anchors, monkeypatch):
        marks.clear()
        monkeypatch.setattr(torch.cuda, "synchronize", sync)
        a0 = take_anchors(clock_of_anchors)
        start = spans_clock._t
        eng.tick(25)
        a1 = take_anchors(clock_of_anchors)
        waits = [x for x in eng.obs.phases.spans(since=start)
                 if x.name.startswith("wait.")]
        host = marks + [(SYNC, prof(x.t0 + 2e-6), prof(x.t1 - 2e-6))
                        for x in waits]
        dev = [(prof(start), prof(spans_clock._t))]
        base = Slice(first=0, ticks=25, seconds=0.0, busy_s=0.0,
                     kernel_s={}, device_ops=[], idle_gaps=[])
        return slice_phases(base, dev, host, (a0, a1), eng.obs), waits

    with pytest.MonkeyPatch.context() as mp:
        sl, waits = run(span_clock(eng), mp)
    assert len(waits) >= 25 and len(sl.syncs) == len(waits)
    assert sl.unspanned_syncs() == []
    mapped = [x for x in sl.spans if x.name.startswith("wait.")]
    assert [x.name for x in mapped] == [w.name for w in waits]
    assert [x.a for x in mapped] == pytest.approx(
        [prof(w.t0) for w in waits], abs=1e-3)
    with pytest.MonkeyPatch.context() as mp:
        sl, waits = run(eng.clock, mp)
    assert len(sl.unspanned_syncs()) == len(sl.syncs) == len(waits)
    eng.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["diffusion", "decode"])
def test_every_stream_sync_lies_in_a_wait_span_on_card(kind):
    """Twenty ticks of a small engine (``_engine``) under the profiler,
    bracketed by two anchors on the spans' clock: every
    ``cudaStreamSynchronize`` lies inside a mapped ``wait.*`` span within
    20 µs, and by reason the waits the program counted equal the syncs
    their spans hold."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from bench.harness.phases import span_clock
    eng = _engine(kind, torch.device("cuda:0"))
    clock = span_clock(eng)
    cuda_t = torch.autograd.DeviceType.CUDA

    for _ in range(3):               # the profiler now and then loses events
        p = profile(activities=[ProfilerActivity.CUDA])
        p.start()
        a0 = take_anchors(clock)
        eng.tick(20)
        a1 = take_anchors(clock)
        p.stop()
        evs = p.events()
        dev = [(e.time_range.start, e.time_range.end) for e in evs
               if e.device_type == cuda_t]
        host = [(e.name, e.time_range.start, e.time_range.end)
                for e in evs if e.device_type != cuda_t]
        if dev and sum(n == SYNC for n, _, _ in host) >= 40:
            break
    base = Slice(first=0, ticks=20, seconds=0.0, busy_s=0.0, kernel_s={},
                 device_ops=[], idle_gaps=[])
    sl = slice_phases(base, dev, host, (a0, a1), eng.obs)
    assert sl.spans and len(sl.syncs) >= 40
    waits = [(x.a, x.b, x.path) for x in sl.spans
             if x.name.startswith("wait.")]
    outside = [(p, min((max(a - t, t - b), n) for a, b, n in waits))
               for t, p in sl.unspanned_syncs()]
    near = [([(x.name, round(x.a - t), round(x.b - t)) for x in sl.spans
              if abs(x.a - t) < 300 or abs(x.b - t) < 300],
             [(n, round(a - t), round(b - t)) for n, a, b in host
              if abs(a - t) < 150])
            for t, _ in sl.unspanned_syncs()]
    assert outside == [], (outside, [a.width_us for a in sl.anchors], near)
    counts = sl.sync_counts()
    assert "fill" in counts and "sample" in counts, counts
    assert all(n == held for n, held in counts.values()), counts
    for a in sl.anchors:
        assert a.width_us < 100.0
    assert abs(sl.drift_us) < 50.0
    eng.shutdown()
