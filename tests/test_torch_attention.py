"""The port's attention entry point against the JAX package's
(``repro.layers.attention``), on the same numpy inputs.

``full_attention`` with ``use_flash`` True (an ``int`` window: the flash
kernel, whose plain version runs here) and False (the mask bias and
``attention_core``), with grouped-query heads, windows and a query
offset, to rtol=atol=1e-5 in f32 (online against materialised softmax,
and sums in another order); one S = 4096 case, where the reference scans
over query chunks and the port does not. ``repeat_kv`` and
``_mask_bias`` bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import attention as jattn
from repro_torch.kernels import ops
from repro_torch.layers import attention as pattn

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(b, s, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, hd)).astype(np.float32),
            rng.normal(size=(b, s, kv, hd)).astype(np.float32),
            rng.normal(size=(b, s, kv, hd)).astype(np.float32))


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("q_offset", [0, 5])
def test_full_attention_matches_reference(use_flash, window, q_offset):
    """GQA (4 query heads on 2 KV heads). With ``use_flash`` both packages
    take the flash kernel, which ignores ``q_offset`` in both."""
    q, k, v = _qkv(2, 40, 4, 2, 16, 1 + window + q_offset)
    got = pattn.full_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), window,
                               q_offset=q_offset, use_flash=use_flash)
    want = jattn.full_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), window, q_offset=q_offset,
                                use_flash=use_flash)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_full_attention_tensor_window_takes_the_mask_path():
    """A window that is a tensor (the reference's traced per-layer window)
    goes through ``attention_core`` even with ``use_flash``, as in the
    reference, and launches nothing."""
    q, k, v = _qkv(1, 24, 2, 2, 16, 7)
    ops.reset_launch_counts()
    got = pattn.full_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.tensor(6),
                               use_flash=True)
    want = jattn.full_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(6, jnp.int32),
                                use_flash=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    flash_got = pattn.full_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), 6, use_flash=True)
    np.testing.assert_allclose(flash_got.numpy(), got.numpy(), **TOL)
    assert ops.launch_counts()["flash_attention"] == 0    # CPU: plain path


@pytest.mark.parametrize("use_flash", [False, True])
def test_full_attention_long_sequence_matches_chunked_reference(use_flash):
    """S = 4096 with 1 head of dim 16 and a 1024 window: the reference
    scans over query chunks of 1024 (off the flash path); the port runs
    one masked attention, or the flash kernel's plain version."""
    q, k, v = _qkv(1, 4096, 1, 1, 16, 11)
    got = pattn.full_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), 1024,
                               use_flash=use_flash)
    want = jattn.full_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), 1024)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n_rep", [1, 3])
def test_repeat_kv_bitwise(n_rep):
    x = np.random.default_rng(3).normal(size=(2, 5, 2, 8)).astype(np.float32)
    got = pattn.repeat_kv(torch.from_numpy(x), n_rep)
    want = jattn.repeat_kv(jnp.asarray(x), n_rep)
    assert tuple(got.shape) == (2, 5, 2 * n_rep, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("window", [0, 1, 4, -3])
@pytest.mark.parametrize("q_offset", [0, 3])
def test_mask_bias_bitwise(window, q_offset):
    q_pos = np.arange(7, dtype=np.int32) + q_offset
    k_pos = np.arange(10, dtype=np.int32)
    got = pattn._mask_bias(torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                           window)
    want = jattn._mask_bias(jnp.asarray(q_pos), jnp.asarray(k_pos), window)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert pattn.NEG_INF == jattn.NEG_INF


def test_attention_core_with_bias_matches_reference():
    q, k, v = _qkv(2, 12, 3, 3, 8, 5)
    bias = np.random.default_rng(6).normal(size=(1, 3, 12, 12)).astype(
        np.float32)
    got = pattn.attention_core(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(bias))
    want = jattn.attention_core(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
