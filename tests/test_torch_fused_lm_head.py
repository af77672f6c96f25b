"""The port's fused LM head top-r + logsumexp (``ops/fused_lm_head.py``, K6's
plain version) against the JAX package's Pallas kernel in interpret mode,
on the CPU, from the same numpy inputs."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vilmedic_torch.ops import fused_lm_head as tf
from vilmedic_tpu.ops import fused_lm_head as jf

# f32: the same products summed in another order (one matmul against the
# TPU kernel's vocab tiles); lse: a sum of exp in another order, relative
TOL, TOL_LSE = 1e-5, 1e-5


def _inputs(n, h, v, seed, dtype):
    rng = np.random.default_rng(seed)
    hid = (rng.normal(size=(n, h)) * 0.2).astype(np.float32)
    w = (rng.normal(size=(h, v)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(v,)) * 0.2).astype(np.float32)
    if dtype == "bfloat16":  # values exact in bf16 on both sides
        hid = hid.astype(ml_dtypes.bfloat16)
        w = w.astype(ml_dtypes.bfloat16)
    return hid, w, b


def _torch(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_jax_kernel(dtype):
    """The JAX test's case: n 16, H 64, V 5000, r 8, tile_v 1024."""
    n, h, v, r, tile_v = 16, 64, 5000, 8, 1024
    hid, w0, b0 = _inputs(n, h, v, 0, dtype)
    jw, jb = jf.pad_lm_head_weights(jnp.asarray(w0), jnp.asarray(b0), tile_v=tile_v)
    want = jf.lm_head_topk_lse(jnp.asarray(hid), jw, jb, r=r, tile_v=tile_v, interpret=True)
    w, b = tf.pad_lm_head_weights(_torch(w0), _torch(b0), tile_v)
    got = tf.lm_head_topk_lse(_torch(hid), w, b, r, tile_v)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].dtype == torch.int32 and got[2].shape == (n,)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=TOL_LSE)


def test_exact_ties_match_jax_bitwise():
    """Small integers in h and w: every f32 sum is exact, so logits tie in
    bulk and the order among equal values (lower column first, across the
    TPU kernel's vocab tiles) is compared bitwise."""
    rng = np.random.default_rng(1)
    hid = rng.integers(-2, 3, (24, 32)).astype(np.float32)
    w0 = rng.integers(-1, 2, (32, 3000)).astype(np.float32)
    b0 = np.zeros(3000, np.float32)
    jw, jb = jf.pad_lm_head_weights(jnp.asarray(w0), jnp.asarray(b0), tile_v=1024)
    want = jf.lm_head_topk_lse(jnp.asarray(hid), jw, jb, r=16, tile_v=1024, interpret=True)
    w, b = tf.pad_lm_head_weights(torch.from_numpy(w0), torch.from_numpy(b0), 1024)
    got = tf.lm_head_topk_lse(torch.from_numpy(hid), w, b, 16, 1024)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # the top 16 of 3000 columns hold repeated values: the ties are real
    assert (np.diff(np.asarray(want[0]), axis=1) == 0).any()
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=TOL_LSE)


@pytest.mark.parametrize("v,tile_v", [(5000, 1024), (4096, 2048), (50265, 2048)])
def test_pad_lm_head_weights_matches_jax(v, tile_v):
    rng = np.random.default_rng(v)
    w0 = rng.normal(size=(8, v)).astype(np.float32)
    b0 = rng.normal(size=(v,)).astype(np.float32)
    jw, jb = jf.pad_lm_head_weights(jnp.asarray(w0), jnp.asarray(b0), tile_v=tile_v)
    w, b = tf.pad_lm_head_weights(torch.from_numpy(w0), torch.from_numpy(b0), tile_v)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    assert w.is_contiguous() and b.dtype == torch.float32 and tf.NEG == jf.NEG


def test_refuses_an_unpadded_vocab():
    h, w, b = torch.zeros(2, 8), torch.zeros(8, 3000), torch.zeros(3000)
    with pytest.raises(ValueError):
        tf.lm_head_topk_lse(h, w, b, 4, 1024)
    with pytest.raises(ValueError):  # h and w disagree on H
        tf.lm_head_topk_lse(torch.zeros(2, 4), *tf.pad_lm_head_weights(w, b, 1024), 4, 1024)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [1, 127, 128, 1024])
@pytest.mark.parametrize("vp", [2048, 51200])
@pytest.mark.parametrize("sms", [132, 7])
def test_work_split_covers_every_tile_once(dtype, n, vp, sms):
    """The split's chunks (chunk c holds vocab tiles [c * sub, (c + 1) *
    sub)) cover every vocab tile exactly once and none is empty, so every
    (row tile, chunk) unit writes the partial list the merge reads; bf16
    aims at one unit per SM: no more chunks than the SMs a row tile gets."""
    sub, chunks = tf.work_split(n, vp, sms, dtype)
    tiles, mtiles = vp // tf.BLK, -(-n // tf.BLK)
    covered = [t for c in range(chunks) for t in range(c * sub, min(tiles, (c + 1) * sub))]
    assert sub >= 1 and covered == list(range(tiles))
    assert (chunks - 1) * sub < tiles  # the last chunk holds a tile
    if dtype == torch.bfloat16:
        assert chunks <= max(1, -(-sms // mtiles))
