"""The Python side of the predict kernels' launch, on the CPU.

The lane and chain predicts walk a 1-D tile index on the card
(``csrc/predict_tiles.cuh``), so their wrappers take any row count. Here
the launch path runs with its C library replaced by a recorder: every
argument the wrappers pass (dtype code, m+1, K, the folded R, C and lane
count, the vector flag, the output) is held against a plain enumeration
of the table's shape, for row counts past the 65,535 that rows on
``gridDim.y`` allowed, chains past the 12,288 weights the shared-memory
staging allowed, and ragged or unaligned rows. The checks that raise are
the kernels' own limits.
"""
import itertools

import pytest
import torch

from repro_torch.kernels import build, ops


class _Recorder:
    """Stands in for a predict library: each entry records its arguments
    and returns 0 (launched)."""

    def __init__(self, name):
        self.name, self.calls = name, []
        for entry in (name, name + "_floor"):
            setattr(self, entry,
                    lambda *a, _e=entry: self.calls.append((_e, a)) or 0)


@pytest.fixture
def recorder(monkeypatch):
    libs = {n: _Recorder(n) for n in ("taylor_predict_lanes",
                                      "taylor_predict_chain")}
    monkeypatch.setattr(build, "library", lambda name: libs[name])
    monkeypatch.setattr(ops, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(ops, "_stream", lambda t: (7, 0))
    ops.reset_launch_counts()
    return libs


def _fold(shape, lane_axis):
    """(R, C, lanes) by enumeration: rows are every index of the dims up
    to and through the lane axis, columns every index after it."""
    feat = shape[1:]
    rows = sum(1 for _ in itertools.product(
        *map(range, feat[:lane_axis + 1])))
    cols = sum(1 for _ in itertools.product(*map(range, feat[lane_axis + 1:])))
    return rows, cols, feat[lane_axis]


# (table shape, lane axis): R past 65,535 (70,000 and 65,536), one lane,
# ragged C (35, and 3 with lane axis 3), the serving layouts
CASES = [((3, 8750, 2, 4, 1, 8), 2), ((2, 4096, 2, 8, 1, 8), 2),
         ((3, 2, 2, 3, 5, 7), 2), ((1, 2, 2, 4, 8, 16), 2),
         ((3, 4, 2, 4, 2, 3), 3), ((8, 3, 5, 1, 2, 8), 2),
         ((3, 2, 4, 4, 3), 0)]


@pytest.mark.parametrize(
    "shape,lane_axis,K",
    [(s, a, K) for s, a in CASES for K in (None, 1, 4)]
    + [(s, a, 4100) for s, a in CASES[2:4]])     # K past the old cap
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_predict_launch_arguments_match_the_fold(recorder, shape, lane_axis,
                                                 K, dtype):
    m1, (R, C, lanes) = shape[0], _fold(shape, lane_axis)
    d = torch.zeros(shape, dtype=dtype)
    if K is None:
        w = torch.ones((m1, lanes))
        out = ops.taylor_predict_lanes(d, w, lane_axis=lane_axis)
        lib, want_shape, kk = "taylor_predict_lanes", shape[1:], ()
        key = "taylor_predict_lanes"
    else:
        w = torch.ones((m1, K, lanes))
        out = ops.taylor_predict_chain_lanes(d, w, lane_axis=lane_axis)
        lib, want_shape, kk = "taylor_predict_chain", (K,) + shape[1:], (K,)
        key = "taylor_predict_chain_lanes"
    (entry, args), = recorder[lib].calls
    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    vec = int(C * d.element_size() % 16 == 0 and d.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    assert entry == lib
    assert args == (d.data_ptr(), w.data_ptr(), out.data_ptr(), code, m1,
                    *kk, R, C, lanes, vec, 7, 0)
    assert tuple(out.shape) == want_shape and out.dtype == dtype
    assert ops.launch_counts()[key] == 1
    assert sum(ops.launch_counts().values()) == 1


@pytest.mark.parametrize("K", [None, 4])
def test_predict_floor_passes_the_launch_arguments(recorder, K):
    """The floor entry gets the predict's own arguments (the table stands
    in for the output) and counts no launch."""
    shape = (3, 9000, 2, 4, 1, 16)
    d = torch.zeros(shape, dtype=torch.bfloat16)
    w = torch.ones((3, 4)) if K is None else torch.ones((3, K, 4))
    ops.predict_launch_floor(d, w)
    lib = "taylor_predict_lanes" if K is None else "taylor_predict_chain"
    (entry, args), = recorder[lib].calls
    kk = () if K is None else (K,)
    assert entry == lib + "_floor"
    assert args == (d.data_ptr(), w.data_ptr(), d.data_ptr(), 1, 3, *kk,
                    9000 * 2 * 4, 16, 4, 1, 7, 0)
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("K", [None, 4])
def test_predict_empty_table_launches_nothing(recorder, K):
    """A table with no element: the predicts return an empty output and
    the floor returns, neither reaching a C entry or a count."""
    d = torch.zeros((3, 0, 2, 4, 1, 16), dtype=torch.bfloat16)
    w = torch.ones((3, 4)) if K is None else torch.ones((3, K, 4))
    out = ops.taylor_predict_lanes(d, w) if K is None \
        else ops.taylor_predict_chain_lanes(d, w)
    ops.predict_launch_floor(d, w)
    assert out.numel() == 0
    assert not any(r.calls for r in recorder.values())
    assert not any(ops.launch_counts().values())


def test_predict_unaligned_table_clears_the_vector_flag(recorder):
    buf = torch.zeros(3 * 2 * 2 * 4 * 8 * 16 + 1)
    d = buf[1:].view(3, 2, 2, 4, 8, 16)
    ops.taylor_predict_lanes(d, torch.ones((3, 4)))
    (_, args), = recorder["taylor_predict_lanes"].calls
    assert args[-3] == 0


@pytest.mark.parametrize("case", ["orders", "dtype", "layout", "weights"])
def test_predict_launch_rejects_what_the_kernels_do_not_take(recorder, case):
    d = torch.zeros((3, 2, 2, 4, 8, 16))
    with pytest.raises((ValueError, TypeError)):
        if case == "orders":
            ops.taylor_predict_chain_lanes(torch.zeros((9, 2, 2, 4, 1, 8)),
                                           torch.ones((9, 2, 4)))
        elif case == "dtype":
            ops.taylor_predict_lanes(d.half(), torch.ones((3, 4)))
        elif case == "layout":
            ops.taylor_predict_lanes(d.transpose(1, 2), torch.ones((3, 4)))
        else:
            ops.taylor_predict_chain_lanes(d, torch.ones((3, 4, 2)))
    assert not any(r.calls for r in recorder.values())
    assert not any(ops.launch_counts().values())


def test_predict_launch_floor_needs_the_card():
    with pytest.raises(ValueError):
        ops.predict_launch_floor(torch.zeros((3, 2, 2, 4, 1, 8)),
                                 torch.ones((3, 4)))
