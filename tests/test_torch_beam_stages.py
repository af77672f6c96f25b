"""Stages (c) and (d) of the port's beam-cache attention against the JAX
package's kernel, on the CPU.

The plain PyTorch version (what the CUDA kernel is held against on the card)
and the JAX kernel in interpret mode get the same numpy inputs: (c) int8
caches with per-lane scales (``kv_scales``), (d) a beam-shared prefix
streamed through the kernel's online softmax (``prefix=``), each in f32 and
bf16, with and without the softmax stats.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vilmedic_tpu.ops.beam_cache_attention import fused_beam_cache_attention as jax_beam_attention
from vilmedic_tpu.ops.beam_cache_attention import make_ancestry_mask
from vilmedic_tpu.ops.beam_cache_attention import pack_kernel_prefix as jax_pack_prefix
from vilmedic_torch.ops.beam_cache_attention import (
    KernelPrefix, fused_beam_cache_attention, pack_kernel_prefix, prefix_fusable,
    quantize_cache_rows,
)

# out: f32 sums in another order (online softmax in chunks vs one softmax);
# bf16: p rounded to bf16 against the running max in the JAX kernel and
# against the final max in the plain version. m: f32 maxima of the same
# scores; l: f32 sums of exp terms in another order
TOL_OUT = {np.float32: 1e-5, jnp.bfloat16: 2e-2}
TOL_STATS = 1e-5

B, K, H, D = 4, 4, 4, 32  # H * D = 128: one lane block in the JAX kernel
N = B * K


def _ancestry_mask(rng, t, idx, g):
    """One random ancestor per (row, t < idx), as beam search leaves it, as
    the kernels' dense (groups, g*K, T*g*K) mask."""
    src = rng.integers(0, K, (B, K, t))
    anc = np.zeros((B, K, K, t), np.float32)  # (b, kj, kq, t)
    for b in range(B):
        for qq in range(K):
            for tt in range(idx):
                anc[b, src[b, qq, tt], qq, tt] = 1.0
    return np.asarray(make_ancestry_mask(jnp.asarray(anc), g=g)).astype(np.float32)


def _as_torch(x, dtype):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(torch.bfloat16) if dtype == jnp.bfloat16 else t


def _round(x, dtype):
    """numpy values as they arrive in ``dtype``, in f32."""
    return np.array(jnp.asarray(x, dtype).astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("return_stats", [False, True])
@pytest.mark.parametrize("idx", [0, 5, 9])
def test_int8_cache_stage_matches_jax(dtype, return_stats, idx):
    """Stage (c): out (and m, l) within tolerance, the int8 write bitwise,
    with k_new and v_new past 127 * scale on about a third of the lanes (the
    saturating write) and random ancestry at 2 items per group."""
    T, g = 10, 2
    rng = np.random.default_rng(idx + 3 * return_stats)
    ks = (rng.uniform(0.5, 2.0, H * D) * 0.1 / 127.0).astype(np.float32)
    vs = (rng.uniform(0.5, 2.0, H * D) * 0.1 / 127.0).astype(np.float32)
    kc = rng.integers(-127, 128, (T, N, H * D)).astype(np.int8)
    vc = rng.integers(-127, 128, (T, N, H * D)).astype(np.int8)
    q, k_new, v_new = (_round(rng.normal(size=(N, H, D)) * 0.15, dtype) for _ in range(3))
    mask = _ancestry_mask(rng, T, idx, g)
    scales = np.stack([ks, vs])

    res_j = jax_beam_attention(
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(q, dtype), jnp.asarray(k_new, dtype),
        jnp.asarray(v_new, dtype), jnp.asarray(mask, jnp.bfloat16), jnp.asarray(idx, jnp.int32),
        interpret=True, return_stats=return_stats, kv_scales=jnp.asarray(scales))
    kc_t, vc_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    res_t = fused_beam_cache_attention(
        kc_t, vc_t, _as_torch(q, dtype), _as_torch(k_new, dtype), _as_torch(v_new, dtype),
        torch.from_numpy(mask) != 0, idx, return_stats=return_stats,
        kv_scales=torch.from_numpy(scales))
    out_t, *stats_t = res_t if return_stats else (res_t,)
    out_j, kc_j, vc_j, *stats_j = res_j
    _close(out_t, out_j, TOL_OUT[dtype])
    for got, want in zip(stats_t, stats_j):
        _close(got, want, TOL_STATS)
    assert kc_t.dtype == torch.int8
    np.testing.assert_array_equal(kc_t.numpy(), np.asarray(kc_j))
    np.testing.assert_array_equal(vc_t.numpy(), np.asarray(vc_j))
    saturated = np.abs(k_new.reshape(N, H * D) / ks) > 127.5
    assert saturated.mean() > 0.1 and (np.abs(kc_t[idx].numpy()[saturated]) == 127).all()


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("return_stats", [False, True])
@pytest.mark.parametrize("idx", [0, 5, 9])
def test_prefix_stage_matches_jax(dtype, return_stats, idx):
    """Stage (d): a 37-position prefix (not a multiple of 128: the JAX
    layout pads it, the port's does not), 2 items per group, one joint
    softmax over prefix, ancestor lanes and the current step."""
    T, g, P = 10, 2, 37
    rng = np.random.default_rng(20 + idx + 3 * return_stats)
    kc, vc = (_round(rng.normal(size=(T, N, H * D)), dtype) for _ in range(2))
    q, k_new, v_new = (_round(rng.normal(size=(N, H, D)), dtype) for _ in range(3))
    pk, pv = (_round(rng.normal(size=(B, P, H, D)), dtype) for _ in range(2))
    mask = _ancestry_mask(rng, T, idx, g)

    pk_j, pv_j, p_real = jax_pack_prefix(jnp.asarray(pk, dtype), jnp.asarray(pv, dtype), g)
    assert pk_j.shape[0] > P and p_real == P  # the JAX layout is padded
    res_j = jax_beam_attention(
        jnp.asarray(kc, dtype), jnp.asarray(vc, dtype), jnp.asarray(q, dtype),
        jnp.asarray(k_new, dtype), jnp.asarray(v_new, dtype), jnp.asarray(mask, jnp.bfloat16),
        jnp.asarray(idx, jnp.int32), interpret=True, return_stats=return_stats,
        prefix=(pk_j, pv_j, p_real, K))
    kc_t, vc_t = _as_torch(kc, dtype).clone(), _as_torch(vc, dtype).clone()
    prefix = pack_kernel_prefix(_as_torch(pk, dtype), _as_torch(pv, dtype), K)
    assert prefix.pk.shape == (B, P, H * D) and prefix.p_real == P
    res_t = fused_beam_cache_attention(
        kc_t, vc_t, _as_torch(q, dtype), _as_torch(k_new, dtype), _as_torch(v_new, dtype),
        torch.from_numpy(mask) != 0, idx, return_stats=return_stats, prefix=prefix)
    out_t, *stats_t = res_t if return_stats else (res_t,)
    out_j, kc_j, vc_j, *stats_j = res_j
    _close(out_t, out_j, TOL_OUT[dtype])
    for got, want in zip(stats_t, stats_j):
        _close(got, want, TOL_STATS)
    np.testing.assert_array_equal(kc_t.float().numpy(), np.asarray(kc_j, np.float32))
    np.testing.assert_array_equal(vc_t.float().numpy(), np.asarray(vc_j, np.float32))


def test_prefix_stage_reads_only_p_real_keys():
    """Positions at and past ``p_real`` are never keys, whatever they hold:
    the kernel masks its own ragged tail."""
    T, P, p_real, idx = 6, 9, 5, 3
    rng = np.random.default_rng(4)
    kc, vc = (torch.from_numpy(rng.normal(size=(T, N, H * D)).astype(np.float32))
              for _ in range(2))
    q, kn, vn = (torch.from_numpy(rng.normal(size=(N, H, D)).astype(np.float32))
                 for _ in range(3))
    pk, pv = (torch.from_numpy(rng.normal(size=(B, P, H * D)).astype(np.float32))
              for _ in range(2))
    mask = torch.from_numpy(_ancestry_mask(rng, T, idx, 1)) != 0
    want = fused_beam_cache_attention(kc.clone(), vc.clone(), q, kn, vn, mask, idx,
                                      prefix=KernelPrefix(pk[:, :p_real].contiguous(),
                                                          pv[:, :p_real].contiguous(), p_real, K))
    pk[:, p_real:], pv[:, p_real:] = 1e9, float("nan")
    got = fused_beam_cache_attention(kc.clone(), vc.clone(), q, kn, vn, mask, idx,
                                     prefix=KernelPrefix(pk, pv, p_real, K))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_quantized_write_rounds_half_to_even_and_saturates():
    """The int8 write: x / s rounded half to even (jnp.round), clipped to
    ±127, never -128."""
    s = torch.full((8,), 0.5)
    x = torch.tensor([1.25, 1.75, -1.25, 0.25, 0.75, 100.0, -100.0, -63.75])
    got = quantize_cache_rows(x, s)
    assert got.tolist() == [2, 4, -2, 0, 2, 127, -127, -127]
    np.testing.assert_array_equal(
        got.numpy(), np.clip(np.round(x.numpy() / s.numpy()), -127, 127).astype(np.int8))


def test_stage_guards():
    """An int8 cache needs scales, scales need int8 caches, and scales and a
    prefix exclude each other (the JAX package asserts the same)."""
    T, idx = 4, 1
    mask = torch.zeros(B, K, T * K, dtype=torch.bool)
    x = torch.zeros(N, H, D)
    c8 = torch.zeros(T, N, H * D, dtype=torch.int8)
    c32 = torch.zeros(T, N, H * D)
    scales = torch.ones(2, H * D)
    prefix = pack_kernel_prefix(torch.zeros(B, 3, H, D), torch.zeros(B, 3, H, D), K)
    with pytest.raises(ValueError, match="requires kv_scales"):
        fused_beam_cache_attention(c8, c8.clone(), x, x, x, mask, idx)
    with pytest.raises(ValueError, match="requires int8 caches"):
        fused_beam_cache_attention(c32, c32.clone(), x, x, x, mask, idx, kv_scales=scales)
    with pytest.raises(ValueError, match="exclude each other"):
        fused_beam_cache_attention(c8, c8.clone(), x, x, x, mask, idx, kv_scales=scales,
                                   prefix=prefix)
    with pytest.raises(ValueError, match="cache dtype"):
        fused_beam_cache_attention(c32.bfloat16(), c32.bfloat16(), x.bfloat16(), x.bfloat16(),
                                   x.bfloat16(), mask, idx, prefix=prefix)
    # the port fuses at any group size; the JAX package needs group_items % 8
    assert prefix_fusable(8, 1, 1370) and prefix_fusable(4, 2, 17)
    assert not prefix_fusable(8, 2, 0)
