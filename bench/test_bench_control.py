"""The control comes out not correct. At a size a test run holds, on the
CPU, the reference put in the program's place at one precision below the
configuration's bfloat16 (``bench/control.py``: every product on float8
e4m3 operands with per-tensor scales) fails the configuration's own
limits on every seed tried, while the program served at that size in
its stated precision passes them. The readings at the cells' own sizes,
on the card, are in PERF.md."""
import pytest
import torch

from bench import control
from bench import run as R
from bench.harness import registry
from bench.reference import dit

DEV = torch.device("cpu")
SEEDS = (2 ** 31 + 7, 2 ** 33 + 1, 12)


def _cfg(name):
    cfg = registry.config(name)
    cfg.update(num_layers=4, d_model=128, num_heads=4, d_ff=512,
               latent_size=8, lanes=8, check_requests=8)
    if cfg["num_classes"]:
        cfg["num_classes"] = 10
    if cfg["cond_dim"]:
        cfg.update(cond_dim=64, text_tokens=4)
    return cfg


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["dit-xl2-256px", "flux-like-512px"])
def test_float8_control_fails_the_limits(name, seed):
    cfg = _cfg(name)
    rec = control.control_reading(cfg, registry.mix("aligned"), seed, DEV)
    assert not rec["correct"], rec
    assert rec["numbers"]["sample_err"] > cfg["limits"]["sample_err"]


@pytest.mark.parametrize("name", ["dit-xl2-256px", "flux-like-512px"])
def test_program_at_the_same_size_passes(name):
    cfg = _cfg(name)
    spec = {"workloads": [{"name": "t", "config": "t", "traffic": "aligned",
                           "chips": 1}], "end_to_end": [], "per_layer": []}
    out = R.run_cell("t", SEEDS[0], 8.0, False, DEV, spec=spec, cfg=cfg,
                     mix=registry.mix("aligned"))
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("name", ["dit-xl2-256px", "flux-like-512px"])
def test_over_accepting_fault_fails_a_decision_number(name):
    """The float32 reference in the program's place, accepting every
    draft it may make: its samples agree with the reference along those
    decisions, and a decision number fails."""
    cfg = _cfg(name)
    rec = control.control_reading(cfg, registry.mix("aligned"), SEEDS[0],
                                  DEV, mm=dit.f32_matmul,
                                  decide=control.accept_all)
    assert not rec["correct"], rec
    assert rec["numbers"]["sample_err"] < cfg["limits"]["sample_err"]
    gap = "accept_gap" if "accept_gap" in cfg["limits"] else "decision_gap"
    assert rec["numbers"][gap] > cfg["limits"][gap]
