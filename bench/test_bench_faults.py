"""A run of the harness with the timed path broken underneath comes out
not correct. On the CPU at a reduced size, ``run.run_cell`` drives the
rest of a run (no look for a card): set-up, the window of the lifecycle
engine with the mix's clients, the judge against the plain reference.
Unbroken, it is correct; each fault a served diffusion cell can have
makes it false:

* a step that leaves its state unchanged (the sampler never advances);
* half of the lane batch left out (its outputs zero);
* an answer altered where it is produced (the emitted latent);
* a verify that accepts every draft a lane may make (it serves faster,
  and its samples agree with the reference along its own decisions, so
  a decision number has to catch it).

The exchange between chips is no fault of these one-card cells."""
import pytest
import torch

from bench import run as R
from bench.harness import registry

DEV = torch.device("cpu")
SPEC = {"workloads": [{"name": "t", "config": "t", "traffic": "aligned",
                       "chips": 1}],
        "end_to_end": [{"name": "samples_per_s", "unit": "samples/s"},
                       {"name": "latency_p95_s", "unit": "s"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": []}


def _cfg(name):
    cfg = registry.config(name)
    cfg.update(num_layers=2, d_model=64, num_heads=4, d_ff=128,
               latent_size=8, dtype="float32", lanes=4, check_requests=8,
               num_inference_steps=10)
    if cfg["num_classes"]:
        cfg["num_classes"] = 10
    if cfg["cond_dim"]:
        cfg.update(cond_dim=32, text_tokens=4)
    return cfg


def _run(name, mix="aligned"):
    # 4 s: enough ticks for 8 completions on a loaded CPU
    mix = registry.mix(mix) if isinstance(mix, str) else mix
    return R.run_cell("t", 2 ** 31 + 12345, 4.0, False, DEV, spec=SPEC,
                      cfg=_cfg(name), mix=mix)


def _half(fn):
    def broken(self, *a, **kw):
        out, extra = fn(self, *a, **kw)
        out = out.clone()
        out[out.shape[0] // 2:] = 0
        return out, extra
    return broken


@pytest.mark.parametrize("mix", ["aligned", "staggered"])
@pytest.mark.parametrize("name", ["dit-xl2-256px", "flux-like-512px"])
def test_unbroken_run_is_correct(name, mix):
    out = _run(name, mix)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out["checks"]) == list(_cfg(name)["limits"])
    assert set(out["metrics"]) == {"samples_per_s", "latency_p95_s",
                                   "setup_s"}


def test_open_loop_run_is_correct():
    """An open-loop mix (a data file a later cell may add) drives the
    same window: requests arrive by the clock, none is resent."""
    out = _run("dit-xl2-256px", {"loop": "open", "rate_per_s": 6.0,
                                 "burst": 2})
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 4 and out["failed"] == 0


@pytest.mark.parametrize("name", ["dit-xl2-256px", "flux-like-512px"])
def test_over_accepting_verify_is_not_correct(name, monkeypatch):
    from repro_torch.kernels import ops
    verify = ops.verify_accept_mixed

    def accept_all(*a, **kw):
        err, ok = verify(*a, **kw)
        return err, torch.ones_like(ok)
    monkeypatch.setattr(ops, "verify_accept_mixed", accept_all)
    out = _run(name)
    assert not out["correct"], out["checks"]
    gap = "accept_gap" if "accept_gap" in out["checks"] else "decision_gap"
    assert out["checks"][gap]["value"] > out["checks"][gap]["limit"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_broken_run_is_not_correct(fault, monkeypatch):
    from repro_torch.core.workload import DiffusionWorkload as DW
    if fault == "unchanged":
        monkeypatch.setattr(DW, "advance",
                            lambda self, dyn, out, ctx, s: dict(dyn))
    elif fault == "half_batch":
        monkeypatch.setattr(DW, "full_forward", _half(DW.full_forward))
        monkeypatch.setattr(DW, "spec_forward", _half(DW.spec_forward))
    else:
        emit = DW.emit

        def altered(self, state, lane, done):
            x = emit(self, state, lane, done).clone()
            x[..., 0] = 0
            return x
        monkeypatch.setattr(DW, "emit", altered)
    out = _run("dit-xl2-256px")
    assert not out["correct"], out["checks"]
