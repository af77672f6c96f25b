"""The PyTorch port's ops against the JAX package's, on the CPU.

Each kernel's plain PyTorch version (what a CUDA kernel of the port is held
against on the card) is fed the same numpy inputs as the JAX function, run as
the JAX package's own tests run it: the Pallas kernels in interpret mode, the
crop+normalize on its XLA path. All in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vilmedic_tpu.ops import attention as jattn
from vilmedic_tpu.ops.beam_cache_attention import (
    fused_beam_cache_attention as jax_beam_attention,
    make_ancestry_mask,
)
from vilmedic_tpu.ops.blocked_lm_head import lm_head_blocked_stats as jax_lm_head
from vilmedic_tpu.ops.blocked_lm_head import unpack_stats
from vilmedic_tpu.ops.image_preproc import crop_normalize as jax_crop_normalize
from vilmedic_torch.ops import attention as tattn
from vilmedic_torch.ops.beam_cache_attention import fused_beam_cache_attention
from vilmedic_torch.ops.blocked_lm_head import NEG, lm_head_blocked_stats
from vilmedic_torch.ops.flash_attention import flash_attention_reference
from vilmedic_torch.ops.image_preproc import crop_normalize, crop_normalize_reference

# float32 sums of the same products in another order (online softmax in
# chunks vs one softmax; a K-blocked product vs one matmul)
TOL_KERNEL = 1e-5
# the crop+normalize is the same elementwise IEEE ops in the same order
TOL_PREPROC = 1e-6


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("idx", [0, 6, 9])
def test_beam_cache_attention_matches_jax(g, idx):
    B, K, T, H, D = 4, 4, 10, 4, 32
    N = B * K
    rng = np.random.default_rng(idx + 10 * g)
    kc = rng.normal(size=(T, N, H * D)).astype(np.float32)
    vc = rng.normal(size=(T, N, H * D)).astype(np.float32)
    q, k_new, v_new = (rng.normal(size=(N, H, D)).astype(np.float32) for _ in range(3))
    anc_idx = rng.integers(0, K, (B, K, T))
    anc = np.zeros((B, K, K, T), np.float32)  # (b, kj, kq, t): one ancestor per t < idx
    for b in range(B):
        for qq in range(K):
            for t in range(idx):
                anc[b, anc_idx[b, qq, t], qq, t] = 1.0
    mask = np.asarray(make_ancestry_mask(jnp.asarray(anc), g=g)).astype(np.float32)

    out_j, kc_j, vc_j = jax_beam_attention(
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(q), jnp.asarray(k_new),
        jnp.asarray(v_new), jnp.asarray(mask, jnp.bfloat16),
        jnp.asarray(idx, jnp.int32), interpret=True,
    )
    kc_t, vc_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    out_t = fused_beam_cache_attention(
        kc_t, vc_t, torch.from_numpy(q), torch.from_numpy(k_new),
        torch.from_numpy(v_new), torch.from_numpy(mask) != 0, idx,
    )
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=TOL_KERNEL,
                               atol=TOL_KERNEL)
    # the in-place cache write: row idx replaced, every other row untouched
    np.testing.assert_array_equal(kc_t.numpy(), np.asarray(kc_j))
    np.testing.assert_array_equal(vc_t.numpy(), np.asarray(vc_j))


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("idx", [0, 5, 7])
def test_beam_cache_attention_stats_match_jax(g, idx):
    """Stage (b): ``return_stats=True`` gives ``(out, m, l)``, the softmax max
    and denominator over the ancestor lanes plus the current-step lane, in
    the scaled-score domain (the case of the JAX package's own stats test)."""
    B, K, T, H, D = 2, 4, 8, 4, 32
    N = B * K
    rng = np.random.default_rng(1 + idx + 10 * g)
    kc = rng.normal(size=(T, N, H * D)).astype(np.float32)
    vc = rng.normal(size=(T, N, H * D)).astype(np.float32)
    q, k_new, v_new = (rng.normal(size=(N, H, D)).astype(np.float32) for _ in range(3))
    anc_idx = rng.integers(0, K, (B, K, T))
    anc = np.zeros((B, K, K, T), np.float32)
    for b in range(B):
        for qq in range(K):
            for t in range(idx):
                anc[b, anc_idx[b, qq, t], qq, t] = 1.0
    mask = np.asarray(make_ancestry_mask(jnp.asarray(anc), g=g)).astype(np.float32)

    out_j, kc_j, vc_j, m_j, l_j = jax_beam_attention(
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(q), jnp.asarray(k_new),
        jnp.asarray(v_new), jnp.asarray(mask), jnp.asarray(idx, jnp.int32),
        interpret=True, return_stats=True,
    )
    kc_t, vc_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    out_t, m_t, l_t = fused_beam_cache_attention(
        kc_t, vc_t, torch.from_numpy(q), torch.from_numpy(k_new),
        torch.from_numpy(v_new), torch.from_numpy(mask) != 0, idx, return_stats=True,
    )
    assert m_t.shape == (N, H) and l_t.shape == (N, H)
    for got, want in ((out_t, out_j), (m_t, m_j), (l_t, l_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_KERNEL,
                                   atol=TOL_KERNEL)
    np.testing.assert_array_equal(kc_t.numpy(), np.asarray(kc_j))
    np.testing.assert_array_equal(vc_t.numpy(), np.asarray(vc_j))


def test_beam_cache_attention_never_reads_past_index():
    """Mask lanes at t >= index are ignored: no live lane reads a row the
    step has not yet written (the kernel's race freedom by construction)."""
    T, N, H, D, idx = 6, 4, 2, 32, 3
    rng = np.random.default_rng(0)
    kc = torch.from_numpy(rng.normal(size=(T, N, H * D)).astype(np.float32))
    vc = torch.from_numpy(rng.normal(size=(T, N, H * D)).astype(np.float32))
    q, kn, vn = (torch.from_numpy(rng.normal(size=(N, H, D)).astype(np.float32))
                 for _ in range(3))
    mask = torch.zeros(1, N, T * N, dtype=torch.bool)
    mask[0, :, :idx * N] = torch.eye(N, dtype=torch.bool).repeat(1, idx)
    out = fused_beam_cache_attention(kc.clone(), vc.clone(), q, kn, vn, mask, idx)
    mask[0, :, idx * N:] = True  # lanes past the index are dead whatever they say
    kc2, vc2 = kc.clone(), vc.clone()
    kc2[idx:] = float("nan")
    vc2[idx:] = float("nan")
    kc2[idx + 1:] = 1e9
    out2 = fused_beam_cache_attention(kc2, vc2, q, kn, vn, mask, idx)
    assert torch.isfinite(out2).all()
    torch.testing.assert_close(out2, out, rtol=0, atol=0)


@pytest.mark.parametrize("rows", [3, 8])
def test_blocked_lm_head_matches_jax(rows):
    vocab, hidden = 4500, 64  # 4500 = 35 full blocks + a partial pad block
    nb = -(-vocab // 128)
    rng = np.random.default_rng(rows)
    h = rng.normal(size=(rows, hidden)).astype(np.float32)
    w = (rng.normal(size=(vocab, hidden)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(vocab,)) * 0.05).astype(np.float32)
    wp = np.zeros((nb * 128, hidden), np.float32)
    wp[:vocab] = w
    bp = np.full((nb * 128,), NEG, np.float32)
    bp[:vocab] = b

    tile_v = 1024
    lg_j, mx_j, sm_j = jax_lm_head(jnp.asarray(h), jnp.asarray(wp.T), jnp.asarray(bp),
                                   tile_v=tile_v, interpret=True, force_pallas=True)
    lg_j = np.asarray(lg_j).transpose(1, 0, 2)[:, :nb]  # block-major -> row-major
    mx_j = np.asarray(unpack_stats(mx_j, tile_v))[:, :nb]
    sm_j = np.asarray(unpack_stats(sm_j, tile_v))[:, :nb]

    lg_t, mx_t, sm_t = lm_head_blocked_stats(torch.from_numpy(h), torch.from_numpy(wp),
                                             torch.from_numpy(bp))
    assert lg_t.shape == (rows, nb, 128) and mx_t.shape == (rows, nb)
    for got, want in ((lg_t, lg_j), (mx_t, mx_j), (sm_t, sm_j)):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL_KERNEL, atol=TOL_KERNEL)


@pytest.mark.parametrize("tops,lefts", [
    ([0, 3, 8, 5], [2, 0, 8, 7]),
    ([8, 0, 20, -3], [0, 30, 1, 4]),  # out-of-range offsets: dynamic_slice's wrap and clamp
])
def test_crop_normalize_matches_jax(tops, lefts):
    rng = np.random.default_rng(0)
    b, r, c = 4, 40, 32
    images = rng.integers(0, 256, (b, r, r, 3), dtype=np.uint8)
    tops, lefts = np.asarray(tops, np.int32), np.asarray(lefts, np.int32)
    want = np.asarray(jax_crop_normalize(jnp.asarray(images), jnp.asarray(tops),
                                         jnp.asarray(lefts), c, use_pallas=False))
    got = crop_normalize(torch.from_numpy(images), torch.from_numpy(tops),
                         torch.from_numpy(lefts), c)
    assert got.shape == (b, 3, c, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=TOL_PREPROC,
                               atol=TOL_PREPROC)


@pytest.mark.parametrize("mean,std", [(None, None), ((0.5, 0.25, 0.75), (0.2, 0.3, 0.4))])
def test_crop_normalize_table_is_the_plain_arithmetic(mean, std):
    """The plain version's output depends only on (channel, byte), the
    premise of the kernel's (3, 256) table: the table read off one column of
    every byte of every channel gives, one lookup per value, the whole
    output, to the bit; and the plain version equals JAX's XLA path there."""
    kw = {} if mean is None else dict(mean=mean, std=std)
    img = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    img = img[None, :, None, None].expand(1, 256, 256, 3).contiguous()
    zero = torch.zeros(1, dtype=torch.int32)
    want = crop_normalize_reference(img, zero, zero, 256, **kw)
    table = want[0, :, :, 0]  # (3, 256): channel c, byte v
    other = torch.randint(0, 256, (2, 40, 40, 3), generator=torch.Generator().manual_seed(0),
                          dtype=torch.uint8)
    zeros = torch.zeros(2, dtype=torch.int32)
    assert torch.equal(table[torch.arange(3)[None, :, None, None], other.long().permute(0, 3, 1, 2)],
                       crop_normalize_reference(other, zeros, zeros, 40, **kw))
    jax_kw = {} if mean is None else dict(mean=np.asarray(mean), std=np.asarray(std))
    jax_out = np.asarray(jax_crop_normalize(jnp.asarray(img.numpy()), jnp.asarray(zero.numpy()),
                                            jnp.asarray(zero.numpy()), 256, use_pallas=False,
                                            **jax_kw))
    np.testing.assert_allclose(table.numpy().T, jax_out[0, :, 0, :], rtol=TOL_PREPROC,
                               atol=TOL_PREPROC)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq", [1, 5])
def test_dot_product_attention_matches_jax(causal, tq):
    rng = np.random.default_rng(tq)
    B, Tk, H, D = 2, 7, 2, 16
    q = rng.normal(size=(B, tq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Tk, H, D)).astype(np.float32)
    v = rng.normal(size=(B, Tk, H, D)).astype(np.float32)
    key_mask = np.ones((B, Tk), np.int32)
    key_mask[1, -2:] = 0
    bias_j = jattn.make_attention_bias(key_mask=jnp.asarray(key_mask))
    bias_t = tattn.make_attention_bias(key_mask=torch.from_numpy(key_mask))
    want = jattn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       bias=bias_j, causal=causal)
    got = tattn.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), bias=bias_t, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("form", ["key_mask", "causal", "both", "decode"])
def test_make_attention_bias_matches_jax(form):
    key_mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.int32)
    kw_j, kw_t = {}, {}
    if form in ("key_mask", "both"):
        kw_j["key_mask"], kw_t["key_mask"] = jnp.asarray(key_mask), torch.from_numpy(key_mask)
    if form in ("causal", "both"):
        kw_j.update(causal=True, query_len=5, key_len=5)
        kw_t.update(causal=True, query_len=5, key_len=5)
    if form == "decode":
        kw_j.update(causal=True, key_len=5, decode_index=jnp.asarray(2))
        kw_t.update(causal=True, key_len=5, decode_index=2)
    want = np.asarray(jattn.make_attention_bias(**kw_j))
    got = tattn.make_attention_bias(**kw_t)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_mask_to_bias_matches_jax():
    mask = np.array([[0, 1, 2], [1, 0, 0]], np.int32)
    np.testing.assert_array_equal(tattn.mask_to_bias(torch.from_numpy(mask)).numpy(),
                                  np.asarray(jattn.mask_to_bias(jnp.asarray(mask))))


def test_flash_length_attention_runs_dense_on_cpu():
    """Where the JAX package takes its flash kernel, so does the port: on CPU
    tensors that is the kernel's plain version (dense math with the kernel's
    rounding points); on CUDA tensors the kernel."""
    n = tattn.FLASH_MIN_LEN
    q = torch.from_numpy(np.random.default_rng(0).normal(size=(1, n, 1, 8)).astype(np.float32))
    out = tattn.dot_product_attention(q, q, q)
    assert out.shape == (1, n, 1, 8)
    torch.testing.assert_close(out, flash_attention_reference(q, q, q), rtol=0, atol=0)
