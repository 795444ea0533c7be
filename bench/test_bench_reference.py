"""The plain reference (``bench/reference``) against the port, on the
CPU at a reduced size in float32, where the port runs its plain kernel
versions: the DiT forward, collecting increments and masked to the
verify layer, with class labels and with a text stub; the two sampler
schedules; and whole SpeCa samples, deciding for themselves and replayed
along the port's decisions. The test imports both; the reference
imports nothing of the port."""
import pytest
import torch

from bench.harness import registry, serve
from bench.reference import dit, speca

CONFIGS = ("dit-xl2-256px", "flux-like-512px")
DEV = torch.device("cpu")


def _small(name, **kw):
    cfg = registry.config(name)
    cfg.update(num_layers=3, d_model=64, num_heads=4, d_ff=128,
               latent_size=8, dtype="float32", lanes=4, check_requests=4,
               num_inference_steps=20)
    if cfg["num_classes"]:
        cfg["num_classes"] = 10
    if cfg["cond_dim"]:
        cfg.update(cond_dim=32, text_tokens=4)
    cfg.update(kw)
    return cfg


def _inputs(cfg, B, seed):
    g = torch.Generator().manual_seed(seed)
    s, C = cfg["latent_size"], cfg["in_channels"]
    x = torch.randn((B, s, s, C), generator=g)
    t = torch.tensor([937.0, 12.5, 500.0][:B])
    labels = torch.randint(0, cfg["num_classes"], (B,), generator=g) \
        if cfg["num_classes"] else None
    text = 0.1 * torch.randn((B, cfg["text_tokens"], cfg["cond_dim"]),
                             generator=g) if cfg["cond_dim"] else None
    return x, t, labels, text


def _port_inputs(x, t, labels, text):
    inp = {"latents": x, "t": t}
    if labels is not None:
        inp["labels"] = labels
    if text is not None:
        inp["cond"] = text
    return inp


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_collecting_increments_matches_port(name):
    from repro_torch.layers import model as M
    cfg = _small(name)
    mc, _, _ = serve.port_configs(cfg)
    P = serve.make_weights(cfg, 11, DEV)
    x, t, labels, text = _inputs(cfg, 3, 1)
    want, ex = M.dit_forward(mc, P, _port_inputs(x, t, labels, text),
                             collect_branches=True)
    got, incs = dit.forward(cfg, P, x, t, labels=labels, text=text,
                            collect=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(incs, ex["branches"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_masked_to_the_verify_layer_matches_port(name):
    from repro_torch.layers import model as M
    cfg = _small(name)
    mc, _, _ = serve.port_configs(cfg)
    P = serve.make_weights(cfg, 12, DEV)
    x, t, labels, text = _inputs(cfg, 2, 2)
    L, T, d = cfg["num_layers"], 16, cfg["d_model"]
    preds = 0.05 * torch.randn((L, 2, 2, T, d),
                               generator=torch.Generator().manual_seed(3))
    vl = cfg["verify_layer"] % L
    want, ex = M.dit_forward(mc, P, _port_inputs(x, t, labels, text),
                             branch_preds=preds,
                             compute_mask=[i == vl for i in range(L)],
                             collect_branches=True)
    got, incs = dit.forward(cfg, P, x, t, labels=labels, text=text,
                            preds=preds, computed=[vl])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(incs[0], ex["branches"][vl], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", CONFIGS)
def test_schedule_matches_port(name):
    from repro_torch.diffusion.pipeline import make_stepper
    cfg = _small(name, num_inference_steps=50)
    _, dc, _ = serve.port_configs(cfg)
    st = make_stepper(dc, DEV)
    sch = speca.schedule(cfg, DEV)
    torch.testing.assert_close(sch.t_model, st.t_model, rtol=1e-6,
                               atol=1e-4)
    torch.testing.assert_close(sch.t_frac, st.t_frac, rtol=1e-6, atol=1e-7)
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, 8, 8, 4), generator=g)
    out = torch.randn((2, 8, 8, 4), generator=g)
    for s in (0, 17, 49):
        torch.testing.assert_close(
            sch.step(x, out, s),
            st.advance(x, out, torch.tensor([s, s])), rtol=1e-5, atol=1e-6)


def _port_serve(cfg, reqs, seed):
    from repro_torch.serving import Request, SpeCaEngine
    mc, dc, sc = serve.port_configs(cfg)
    P = serve.make_weights(cfg, seed, DEV)
    noises = [r.noise[None] for r in reqs]
    eng = SpeCaEngine(mc, P, dc, sc, noise_fn=lambda i: noises[i],
                      device=DEV)
    port = []
    for i, r in enumerate(reqs):
        cond = {}
        if r.label is not None:
            cond["labels"] = torch.tensor([r.label])
        if r.text is not None:
            cond["cond"] = r.text[None]
        port.append(Request(request_id=i, cond=cond, seed=i))
    return P, eng.serve_batched(port, lanes=len(reqs))


@pytest.mark.parametrize("name", CONFIGS)
def test_speca_samples_and_replay_match_port(name):
    cfg = _small(name)
    reqs = [speca.Request(noise=inp["noise"][0], label=inp["label"],
                          text=None if inp["text"] is None
                          else inp["text"][0])
            for inp in (serve.request_inputs(cfg, 1000 + i, DEV)
                        for i in range(3))]
    P, res = _port_serve(cfg, reqs, 21)
    free = speca.sample(cfg, P, reqs)
    for r, o in zip(res, free):
        assert r.accepts == o.accepts
        assert 0 < sum(o.accepts) < len(o.accepts)
        torch.testing.assert_close(o.sample, r.sample[0], rtol=1e-5,
                                   atol=1e-5)
    again = speca.replay(cfg, P, reqs, [r.accepts for r in res])
    for r, o in zip(res, again):
        assert o.bad_steps == 0
        assert o.decision_gap == 0.0
        torch.testing.assert_close(o.sample, r.sample[0], rtol=1e-5,
                                   atol=1e-5)


def test_replay_flags_decisions_no_sampler_makes():
    cfg = _small("dit-xl2-256px")
    P = serve.make_weights(cfg, 5, DEV)
    inp = serve.request_inputs(cfg, 77, DEV)
    req = speca.Request(noise=inp["noise"][0], label=inp["label"])
    good = speca.sample(cfg, P, [req])[0]
    early = [True] + good.accepts[1:]       # a draft before any anchor
    short = good.accepts[:-1]               # a step missing
    flipped = [not a if i > 3 else a for i, a in enumerate(good.accepts)]
    o_early, o_short, o_flip = speca.replay(
        cfg, P, [req] * 3, [early, short, flipped])
    assert o_early.bad_steps == 1
    assert o_short.bad_steps == 1
    assert o_flip.decision_gap > 0.0


@pytest.mark.parametrize("name", CONFIGS)
def test_a_seed_lays_out_one_model(name):
    """Every run seed serves the configuration's model: the permuted
    weights differ, the function does not."""
    from bench.harness import weights
    cfg = _small(name)
    base = weights.make(cfg, cfg["weights_seed"], cfg["taming_seed"], DEV)
    a = serve.make_weights(cfg, 2 ** 31 + 1, DEV)
    b = serve.make_weights(cfg, 2 ** 31 + 2, DEV)
    assert not torch.equal(a["blocks"]["mlp"]["w_up"],
                           b["blocks"]["mlp"]["w_up"])
    x, t, labels, text = _inputs(cfg, 3, 9)
    want, wi = dit.forward(cfg, base, x, t, labels=labels, text=text,
                           collect=True)
    for P in (a, b):
        got, gi = dit.forward(cfg, P, x, t, labels=labels, text=text,
                              collect=True)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(gi, wi, rtol=1e-5, atol=1e-5)
