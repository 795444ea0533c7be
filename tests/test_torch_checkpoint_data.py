"""The port's checkpoints and synthetic data against the JAX package, on
the CPU.

Checkpoints: a reference save read by the port and a port save read by
the reference, bitwise for f32, bf16 and int32 leaves; a whole train
state (parameters, AdamW moments, count, step); a shape mismatch and a
missing leaf raise, as ``tests/test_checkpoint_data_optim.py`` holds for
the reference; ``params_from_checkpoint`` with no ``like`` tree.

Data: jax.random's bits cannot be reproduced, so the deterministic parts
are held given the reference's own draws — the class pattern at rtol
1e-6 and the token stream's Markov mix bitwise — and the port's own
draws are held by the properties the reference's tests ask:
index-addressability, disjoint hosts, class structure.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.configs import get_config, reduced
from repro.data import synthetic as jsyn
from repro.layers import model as JM
from repro.optim import adamw as JA
from repro_torch.checkpoint import (checkpoint_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.convert import params_from_checkpoint, params_from_jax
from repro_torch.data import synthetic as syn
from repro_torch.optim import adamw as PA
from repro_torch.tree import tree_flatten_with_paths

torch.set_num_threads(2)


def _tree_np():
    rng = np.random.default_rng(0)
    return {"a": rng.normal(size=(2, 3)).astype(np.float32),
            "b": {"c": rng.normal(size=(4,)).astype(ml_dtypes.bfloat16),
                  "d": np.array(7, np.int32),
                  "e": rng.integers(-5, 5, (3, 2)).astype(np.int32)},
            "z": {"y": rng.normal(size=(1, 2, 2)).astype(np.float32)}}


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        bits = torch.from_numpy(a.view(np.uint16).astype(np.int16))
        return bits.view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x):
    """The raw bytes of a leaf (bf16 as its 16-bit pattern)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().tobytes(), "bfloat16"
        return x.numpy().tobytes(), str(x.dtype).replace("torch.", "")
    a = np.asarray(x)
    if a.dtype == ml_dtypes.bfloat16:
        return a.view(np.int16).tobytes(), "bfloat16"
    return a.tobytes(), str(a.dtype)


def _assert_same(a_tree, b_tree):
    fa, fb = tree_flatten_with_paths(a_tree), tree_flatten_with_paths(
        b_tree)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, a), (_, b) in zip(fa, fb):
        assert _bits(a) == _bits(b), k


def test_reference_save_is_read_by_the_port(tmp_path):
    tree = _tree_np()
    jsave(str(tmp_path / "ck"), jax.tree_util.tree_map(jnp.asarray, tree),
          step=11, extra={"note": "x"})
    like = jax.tree_util.tree_map(lambda a: _to_torch(np.zeros_like(a)),
                                  tree)
    back = restore_checkpoint(str(tmp_path / "ck"), like, device="cpu")
    _assert_same(back, tree)
    assert back["b"]["c"].dtype == torch.bfloat16
    assert back["b"]["d"].dtype == torch.int32
    assert checkpoint_step(str(tmp_path / "ck")) == 11


def test_port_save_is_read_by_the_reference(tmp_path):
    tree = _tree_np()
    ttree = jax.tree_util.tree_map(_to_torch, tree)
    save_checkpoint(str(tmp_path / "ck"), ttree, step=5)
    like = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype),
                                  tree)
    back = jrestore(str(tmp_path / "ck"), like)
    _assert_same(jax.tree_util.tree_map(np.asarray, back), tree)
    # and the port reads its own save back bitwise
    _assert_same(restore_checkpoint(str(tmp_path / "ck"), ttree,
                                    device="cpu"), ttree)
    from repro.checkpoint import checkpoint_step as jstep
    assert jstep(str(tmp_path / "ck")) == 5


def test_train_state_round_trips_with_the_reference(tmp_path):
    """A whole AdamW train state (bf16 parameters, f32 moments, the int32
    count and step) saved by the port restores bitwise in the reference,
    and the manifests of both packages' saves are equal."""
    cfg = dataclasses.replace(reduced(get_config("qwen1.5-0.5b")),
                              dtype="bfloat16")
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    jstate = {"params": jp, "opt": JA.init_opt_state(jp),
              "step": jnp.asarray(3, jnp.int32)}
    jstate["opt"]["count"] = jnp.asarray(3, jnp.int32)
    jsave(str(tmp_path / "j"), jstate, step=3)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    tstate = {"params": tp, "opt": PA.init_opt_state(tp),
              "step": torch.tensor(3, dtype=torch.int32)}
    tstate["opt"]["count"] = torch.tensor(3, dtype=torch.int32)
    save_checkpoint(str(tmp_path / "p"), tstate, step=3)
    import json
    mj = json.loads((tmp_path / "j" / "manifest.json").read_text())
    mp = json.loads((tmp_path / "p" / "manifest.json").read_text())
    assert mj == mp
    back = jrestore(str(tmp_path / "p"), jstate)
    _assert_same(jax.tree_util.tree_map(np.asarray, back),
                 jax.tree_util.tree_map(np.asarray, jstate))
    _assert_same(restore_checkpoint(str(tmp_path / "j"), tstate,
                                    device="cpu"), tstate)


def test_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path / "ck"), {"a": torch.ones(2, 3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path / "ck"), {"a": torch.ones(3, 2)},
                           device="cpu")


def test_missing_leaf_raises(tmp_path):
    save_checkpoint(str(tmp_path / "ck"), {"a": torch.ones(2)})
    with pytest.raises(KeyError, match="missing leaf 'b/c'"):
        restore_checkpoint(str(tmp_path / "ck"),
                           {"a": torch.ones(2), "b": {"c": torch.ones(1)}},
                           device="cpu")


@pytest.mark.parametrize("arch,dtype", [("dit-xl2", "float32"),
                                        ("qwen1.5-0.5b", "bfloat16"),
                                        ("mamba2-130m", "float32")])
def test_params_from_checkpoint(tmp_path, arch, dtype):
    """The reference's saved parameters (and a saved train state, read from
    its ``params`` group) become the port's tree with no ``like``:
    bitwise ``params_from_jax`` of the same tree, in the manifest dtype."""
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype=dtype)
    if cfg.is_diffusion:
        cfg = dataclasses.replace(cfg, num_classes=8)
    jp = JM.init_params(cfg, jax.random.PRNGKey(1))
    jsave(str(tmp_path / "params"), jp)
    jsave(str(tmp_path / "state"), {"params": jp,
                                    "opt": JA.init_opt_state(jp)})
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    for d in ("params", "state"):
        got = params_from_checkpoint(str(tmp_path / d), device="cpu")
        _assert_same(got, want)


# ---------------------------------------------------------------------------
# Synthetic data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", [0, 3, 5, 14, 999])
def test_class_pattern_matches_reference(label):
    for cfg in (jsyn.GMLatentConfig(num_classes=1000, latent_size=8,
                                    channels=4),
                jsyn.GMLatentConfig(num_classes=16, latent_size=5,
                                    channels=3)):
        pcfg = syn.GMLatentConfig(**dataclasses.asdict(cfg))
        want = np.asarray(jsyn._class_pattern(cfg, jnp.asarray(label)))
        got = syn._class_pattern(pcfg, label).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_gm_latents_match_reference_given_its_draws():
    """The reference's labels and noise (its fold-in keys) through the
    port's deterministic part give the reference's batch."""
    cfg = jsyn.GMLatentConfig(num_classes=8, latent_size=8, channels=4)
    pcfg = syn.GMLatentConfig(**dataclasses.asdict(cfg))
    idx = np.arange(5, 11)
    labels, noise = [], []
    for i in idx:
        key = jax.random.fold_in(jax.random.PRNGKey(1), int(i))
        labels.append(int(jax.random.randint(key, (), 0, cfg.num_classes)))
        noise.append(np.asarray(jax.random.normal(
            jax.random.fold_in(key, 2), (8, 8, 4))))
    want = jsyn.gm_latent_batch(cfg, jnp.asarray(idx))
    got = syn.gm_latents_from_draws(pcfg, labels, np.stack(noise))
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    np.testing.assert_allclose(got["latents"].numpy(),
                               np.asarray(want["latents"]), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("codebooks", [0, 4])
def test_markov_mix_matches_reference_given_its_draws(codebooks):
    cfg = jsyn.LMStreamConfig(vocab_size=101, seq_len=16,
                              num_codebooks=codebooks)
    idx = np.arange(3, 7)
    base, mix = [], []
    shape = (codebooks, 17) if codebooks else (17,)
    for i in idx:
        key = jax.random.fold_in(jax.random.PRNGKey(0), int(i))
        base.append(np.asarray(jax.random.categorical(
            key, jnp.zeros((101,)), shape=shape)))
        mix.append(np.asarray(jax.random.bernoulli(
            jax.random.fold_in(key, 1), 0.5, shape)))
    want = np.asarray(jsyn.lm_batch(cfg, jnp.asarray(idx))["tokens"])
    got = syn.markov_mix(torch.from_numpy(np.stack(base)),
                         torch.from_numpy(np.stack(mix)), 101)
    np.testing.assert_array_equal(got[..., :-1].numpy().astype(np.int32),
                                  want)


def test_samples_are_functions_of_their_index():
    """A sample's draws depend on its index only: any batch holding it
    gives it the same tokens, latents, label and conditioning."""
    lm = syn.LMStreamConfig(vocab_size=97, seq_len=12, num_codebooks=2)
    a = syn.lm_batch(lm, [4, 9, 2])
    b = syn.lm_batch(lm, [9])
    assert torch.equal(a["tokens"][1], b["tokens"][0])
    assert a["tokens"].shape == (3, 2, 12) and a["tokens"].dtype == \
        torch.int32
    assert torch.equal(a["tokens"][..., 1:], a["labels"][..., :-1])
    gm = syn.GMLatentConfig(num_classes=6, latent_size=4)
    x, y = syn.gm_latent_batch(gm, [0, 7]), syn.gm_latent_batch(gm, [7])
    assert torch.equal(x["latents"][1], y["latents"][0])
    assert int(x["labels"][1]) == int(y["labels"][0])
    c1 = syn.cond_stub_batch(2, 3, 5, [1, 8])
    c2 = syn.cond_stub_batch(1, 3, 5, [8])
    assert torch.equal(c1[1], c2[0]) and c1.shape == (2, 3, 5)
    assert not torch.equal(c1[0], c1[1])


def test_sharded_iterator_hosts_are_disjoint():
    """The reference's host-sharding test, on the port's stream: two hosts
    read disjoint halves of the global batch, and their union is the
    single-host batch."""
    cfg = syn.LMStreamConfig(vocab_size=101, seq_len=16)
    one = next(syn.ShardedIterator(lambda i: syn.lm_batch(cfg, i), 8))
    halves = [next(syn.ShardedIterator(lambda i: syn.lm_batch(cfg, i), 8,
                                       host_id=h, num_hosts=2))
              for h in range(2)]
    assert halves[0]["tokens"].shape == (4, 16)
    assert not torch.equal(halves[0]["tokens"], halves[1]["tokens"])
    assert torch.equal(torch.cat([h["tokens"] for h in halves]),
                       one["tokens"])
    it = syn.ShardedIterator(lambda i: syn.lm_batch(cfg, i), 8, start_step=1)
    two = syn.ShardedIterator(lambda i: syn.lm_batch(cfg, i), 8)
    next(two)
    assert torch.equal(next(it)["tokens"], next(two)["tokens"])
    with pytest.raises(ValueError):
        syn.ShardedIterator(lambda i: i, 7, num_hosts=2)


def test_gm_latents_class_structure():
    """Same class ⇒ similar latents; different class ⇒ dissimilar (the
    reference's test, on the port's draws)."""
    cfg = syn.GMLatentConfig(num_classes=4, latent_size=8, channels=2,
                             noise_scale=0.05)
    batch = syn.gm_latent_batch(cfg, np.arange(0, 256))
    lat = batch["latents"].numpy().reshape(256, -1)
    lab = batch["labels"].numpy()
    assert set(lab.tolist()) == {0, 1, 2, 3}
    sims_same, sims_diff = [], []
    for i in range(0, 40):
        for j in range(i + 1, 40):
            cos = float(np.dot(lat[i], lat[j])
                        / (np.linalg.norm(lat[i]) * np.linalg.norm(lat[j])))
            (sims_same if lab[i] == lab[j] else sims_diff).append(cos)
    assert np.mean(sims_same) > np.mean(sims_diff) + 0.3


def test_lm_stream_has_markov_structure():
    """About a quarter of the positions follow ``(prev·7 + 13) mod V`` (a
    position takes the map of its predecessor's draw half the time, and
    the predecessor kept its draw half the time), far above chance
    (1/V), and the tokens cover the vocabulary."""
    cfg = syn.LMStreamConfig(vocab_size=50, seq_len=256)
    toks = syn.lm_batch(cfg, np.arange(8))["tokens"].numpy()
    follow = (toks[:, :-1] * 7 + 13) % 50 == toks[:, 1:]
    assert 0.2 < follow.mean() < 0.35
    assert len(np.unique(toks)) == 50
