"""The benchmark's frozen copies against their origins, and its counters
against hand counts: FLOPs (``harness/flops.py`` vs
``repro_torch.core.complexity``), the roofline (``harness/roofline.py``
vs ``chip_smoke.py``) and the tamed weights (``harness/weights.py`` vs
``chip_smoke.py``'s ``_tamed_params`` over the port's ``init_params``),
at a reduced configuration and at the two served shapes."""
import importlib.util
import math
import pathlib

import pytest
import torch

from bench.harness import flops, roofline, registry, serve, weights

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = ("dit-xl2-256px", "flux-like-512px")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_origin", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _small(name):
    cfg = registry.config(name)
    cfg.update(num_layers=2, d_model=64, num_heads=4, d_ff=128,
               latent_size=8, dtype="float32")
    if cfg["num_classes"]:
        cfg["num_classes"] = 10
    if cfg["cond_dim"]:
        cfg["cond_dim"] = 32
    return cfg


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("small", [False, True], ids=["served", "reduced"])
def test_flops_copy_equals_origin(name, small):
    from repro_torch.core import complexity as CX
    cfg = _small(name) if small else registry.config(name)
    mc, dc, _ = serve.port_configs(cfg)
    n = flops.tokens(cfg)
    assert n == (dc.latent_size // mc.patch_size) ** 2
    assert flops.forward_flops(cfg) == CX.forward_flops(mc, n)
    assert flops.verify_flops(cfg) == CX.verify_flops(mc, n)


def test_flops_hand_count_dit_xl2():
    cfg = registry.config("dit-xl2-256px")
    n, d, L = 256, 1152, 28
    # Q, K, V, O: 4 products of [n, d] x [d, d]; scores and values:
    # 2 products of [H, n, hd] x [H, hd, n]; the MLP: 2 of [n, d] x [d, 4d]
    block = 2 * n * d * d * 4 + 2 * 2 * n * n * d + 2 * 2 * n * d * 4 * d
    glue = 2 * n * d + 2 * 2 * n * 16 * d + L * 2 * d * 6 * d
    assert flops.forward_flops(cfg) == L * block + glue
    assert flops.forward_flops(cfg) == pytest.approx(2.3723e11, rel=1e-3)
    taylor = 4 * L * 2 * n * d
    assert flops.verify_flops(cfg) == block + glue + taylor


def test_flops_hand_count_flux_like():
    cfg = registry.config("flux-like-512px")
    n, d, L, f = 1024, 3072, 38, 12288
    block = 8 * n * d * d + 4 * n * n * d + 4 * n * d * f
    glue = 2 * n * d + 4 * n * 64 * d + L * 12 * d * d
    assert flops.forward_flops(cfg) == L * block + glue


def test_roofline_copy_equals_origin():
    cs = _chip_smoke()
    assert roofline.HBM_BYTES_PER_S == cs.HBM_BYTES_PER_S
    assert roofline.BF16_TC_FLOPS == cs.BF16_TC_FLOPS
    assert roofline.F32_FLOPS == cs.F32_FLOPS
    for nbytes, fl, peak in ((3.2e9, 1e9, roofline.F32_FLOPS),
                             (1e6, 5e12, roofline.BF16_TC_FLOPS),
                             (0.0, 7e10, roofline.F32_FLOPS)):
        ms, _ = cs.bound_ms(nbytes, fl, peak)
        assert roofline.bound_s(nbytes, fl, peak) * 1e3 == \
            pytest.approx(ms, rel=1e-12)


@pytest.mark.parametrize("name,plane", [
    ("dit-xl2-256px", 28 * 2 * 256 * 1152),
    ("flux-like-512px", 38 * 2 * 1024 * 3072)])
def test_forecast_bytes_hand_counts(name, plane):
    cfg = registry.config(name)
    n = flops.tokens(cfg)
    # m = 2: a forecast reads 3 planes and writes 1; a refresh reads the
    # increments and 2 old planes and writes 3; a verify reads 2 [n, d]
    for lanes in (1, 3, 32):
        assert roofline.call_bytes("predict", cfg, n, lanes, 2) == \
            4 * lanes * plane * 2
        assert roofline.call_bytes("refresh", cfg, n, lanes, 2) == \
            6 * lanes * plane * 2
        assert roofline.call_bytes("verify", cfg, n, lanes, 2) == \
            2 * lanes * n * cfg["d_model"] * 2
    # DiT-XL/2, 32 lanes drafting: 4 x 32 x 16.5 M bf16 elements = 4.23 GB,
    # 1.26 ms at 3.35 TB/s
    if name == "dit-xl2-256px":
        b = roofline.call_bytes("predict", cfg, n, 32, 2)
        assert roofline.bound_s(b, 0.0) == pytest.approx(1.2624e-3,
                                                         rel=1e-3)


class _Smoke:
    """What ``Smoke._tamed_params`` reads of its instance."""
    torch = torch
    dev = torch.device("cpu")


@pytest.mark.parametrize("name", CONFIGS)
def test_tamed_weights_copy_equals_origin(name):
    cs = _chip_smoke()
    cfg = _small(name)
    cfg["dtype"] = "bfloat16"
    mc, dc, _ = serve.port_configs(cfg)
    want = cs.Smoke._tamed_params(_Smoke(), mc, dc)
    got = weights.make(cfg, 0, 1, torch.device("cpu"))

    def leaves(t, pre=""):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k], f"{pre}/{k}")
        else:
            yield pre, t
    a, b = dict(leaves(want)), dict(leaves(got))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


def test_weights_follow_the_seed():
    cfg = _small("dit-xl2-256px")
    dev = torch.device("cpu")
    a = serve.make_weights(cfg, 2 ** 40 + 3, dev)
    b = serve.make_weights(cfg, 2 ** 40 + 3, dev)
    c = serve.make_weights(cfg, 2 ** 40 + 4, dev)
    assert torch.equal(a["blocks"]["wq"], b["blocks"]["wq"])
    assert not torch.equal(a["blocks"]["wq"], c["blocks"]["wq"])
    assert math.isfinite(float(a["head"]["w"].sum()))
