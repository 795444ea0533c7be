"""``tools/width_probe.py`` on the CPU: it names the first op whose output
depends on the lane width (and that op's own difference on the batched
run's inputs), finds nothing in a forward whose lanes are independent,
and ignores integer and uninitialised outputs."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import width_probe as W  # noqa: E402

X = torch.randn((4, 3, 16), generator=torch.Generator().manual_seed(0))
WEIGHT = torch.randn((16, 8), generator=torch.Generator().manual_seed(1))


def test_probe_names_an_op_whose_own_output_depends_on_the_width():
    """A sum across the lanes: re-run on the batched run's inputs, all
    lanes at once against one at a time, the op itself differs."""
    def forward(sel):
        h = X[sel] @ WEIGHT
        return torch.tanh(torch.cumsum(h, dim=0)).sum(-1)
    rec = W.probe(forward)
    first = rec["first"]
    assert rec["aligned"] and first is not None
    assert first["op"] == "cumsum", first
    assert (first["m"], first["m_alone"]) == (12, 3)
    assert first["shape"] == [4, 3, 8]
    assert first["own_max_abs_diff"] == first["max_abs_diff"] > 0.0
    assert rec["differing"][0]["position"] == first["position"]
    assert rec["output_max_abs_diff"] > 0.0


def test_probe_separates_an_ops_own_difference_from_its_inputs():
    """The width reaches an add through a Python scalar: the add's output
    differs, but re-run on the batched run's inputs the add does not."""
    def forward(sel):
        h = X[sel] @ WEIGHT
        return torch.tanh(h + 1e-3 * h.shape[0]).sum(-1)
    first = W.probe(forward)["first"]
    assert first["op"] in ("add", "__add__"), first
    assert first["max_abs_diff"] == pytest.approx(3e-3, rel=1e-3)
    assert first["own_max_abs_diff"] == 0.0


def test_probe_finds_nothing_when_lanes_are_independent():
    rec = W.probe(lambda sel: torch.tanh(X[sel] * 2.0 + 1.0).sum(-1))
    assert rec["aligned"] and rec["first"] is None
    assert rec["differing"] == [] and rec["output_max_abs_diff"] == 0.0


def test_probe_ignores_integer_and_uninitialised_outputs():
    def forward(sel):
        x = X[sel]
        lane = torch.arange(x.shape[0])             # differs by width
        scratch = torch.empty_like(x)               # never compared
        scratch.copy_(x)
        return (scratch * 2.0 + lane[:, None, None] * 0.0).sum(-1)
    rec = W.probe(forward)
    assert rec["first"] is None and rec["output_max_abs_diff"] == 0.0


@pytest.mark.parametrize("whole,one,axis", [
    ((4, 3, 8), (1, 3, 8), 0), ((2, 4, 5), (2, 1, 5), 1),
    ((16, 8), (16, 8), None), ((4, 8), (3, 8), None),
    ((4, 8), (1, 1, 8), None)])
def test_lane_axis(whole, one, axis):
    assert W.lane_axis(torch.zeros(whole), torch.zeros(one), 4) == axis


def test_a_tuple_output_is_led_by_its_first_tensor():
    rec = W.probe(lambda sel: (torch.tanh(X[sel]), None))
    assert rec["first"] is None and rec["output_max_abs_diff"] == 0.0
