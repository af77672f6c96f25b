"""The port's fp8 probes (``ops/fp8_probe.py``, K7's plain versions) against
the operations of the JAX spike's kernel bodies (``experiments/
spike_fp8_cache.py``: its kernels are closures inside ``main``, so the same
``jnp`` operations run here), on the CPU. fp8 data crosses between the
libraries as uint8 bit patterns."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vilmedic_torch.ops import fp8_probe as tp

F8 = ml_dtypes.float8_e4m3fn


def _codes_np(x_np):
    return x_np.astype(F8).view(np.uint8)


def _to_torch(codes):
    return torch.from_numpy(np.ascontiguousarray(codes)).view(tp.E4M3)


def _same_codes(got: torch.Tensor, want: np.ndarray):
    """e4m3 codes equal bit for bit, except that a NaN's sign bit may differ
    (0x7F against 0xFF)."""
    got = got.view(torch.uint8).numpy()
    nan_g, nan_w = (got & 0x7F) == 0x7F, (want & 0x7F) == 0x7F
    np.testing.assert_array_equal(nan_g, nan_w)
    np.testing.assert_array_equal(got[~nan_g], want[~nan_w])


def test_e4m3_rounding_matches_ml_dtypes_bitwise():
    """Round to nearest even; 448 up to 464 (the tie, which rounds to even
    448) stay finite; beyond, and the infinities, become NaN with the sign;
    subnormals and the tie below the smallest one."""
    edges = np.array([447, 448, 449, 456, 463.99, 464, 464.01, 465, 480, 500, 1e4, np.inf,
                      -np.inf, np.nan, -np.nan, -448, -464, -465, -500, 2.0 ** -10, 2.0 ** -9,
                      1.5 * 2.0 ** -9, 0.0, -0.0, 3.0e-3, 240, 232, 17.5], np.float32)
    rng = np.random.default_rng(0)
    spread = (rng.normal(size=4096) * np.exp2(rng.integers(-12, 10, 4096))).astype(np.float32)
    for x in (edges, spread):
        got = tp.e4m3_from_f32(torch.from_numpy(x)).view(torch.uint8).numpy()
        np.testing.assert_array_equal(got, _codes_np(x))
    # PyTorch's own cast saturates: the reason for the correction
    assert torch.tensor([500.0]).to(tp.E4M3).float().item() == 448.0


@pytest.mark.parametrize("scale", [2.0, 58.0, 1e38])
def test_scale2_matches_the_spike_body(scale):
    """Every e4m3 code through ``x.astype(f32) * s`` then ``.astype(f8)``
    (the spike's ``kernel`` at s = 2): the codes whose product overflows
    become NaN in both."""
    codes = np.arange(256, dtype=np.uint8)
    want = np.asarray((jnp.asarray(codes.view(F8)).astype(jnp.float32)
                       * jnp.float32(scale)).astype(jnp.float8_e4m3fn)).view(np.uint8)
    got = tp.fp8_scale2(_to_torch(codes), scale)
    _same_codes(got, want)
    assert got.dtype == tp.E4M3
    if scale == 2.0:  # 240 * 2 = 480 overflows; 224 * 2 = 448 does not
        assert got.view(torch.uint8)[0x77].item() == 0x7F
        assert got.view(torch.uint8)[0x76].item() == 0x7E
    if scale == 58.0:  # 8 * 58 = 464, the tie, rounds to 448
        assert got.view(torch.uint8)[0x50].item() == 0x7E


def test_matmul_matches_the_spike_body():
    """The spike's ``mm_kernel``: operands widened to bf16 (exact for e4m3),
    f32 accumulation; the port's plain version widens to f32. Within f32
    rounding of sums of 128 exact products."""
    x, a, b = tp.spike_inputs()
    ja = jnp.asarray(a.view(torch.uint8).numpy().view(F8))
    jb = jnp.asarray(b.view(torch.uint8).numpy().view(F8))
    want = np.asarray(jax.lax.dot_general(
        ja.astype(jnp.bfloat16), jb.astype(jnp.bfloat16), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32))
    got = tp.fp8_matmul(a, b)
    scale = (a.float().abs() @ b.float().abs()).numpy()
    assert got.shape == (128, 128) and got.dtype == torch.float32
    assert (np.abs(got.numpy() - want) <= 1e-6 * scale).all()


def test_slab_copy_matches_the_spike_body():
    """The spike's ``dma_kernel``: rows 0:8 of a (16, 256) slab as f32, every
    code (NaN included) among the inputs; bitwise, NaN compared as NaN."""
    codes = (np.arange(16 * 256) % 256).astype(np.uint8).reshape(16, 256)
    want = np.asarray(jnp.asarray(codes.view(F8))[0:8].astype(jnp.float32))
    got = tp.fp8_slab_copy(_to_torch(codes), 8).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got.view(np.uint32)[~np.isnan(want)],
                                  want.view(np.uint32)[~np.isnan(want)])


def test_spike_inputs_and_probe():
    """The spike's inputs (normal draws rounded to bf16, then to e4m3) equal
    JAX's, and its three checks pass with no error on the CPU."""
    x, a, b = tp.spike_inputs()
    for t, seed, shape in ((x, 0, (128, 256)), (a, 1, (128, 128)), (b, 2, (128, 128))):
        want = jnp.asarray(np.random.default_rng(seed).normal(size=shape),
                           jnp.bfloat16).astype(jnp.float8_e4m3fn)
        np.testing.assert_array_equal(t.view(torch.uint8).numpy(),
                                      np.asarray(want).view(np.uint8))
    res = tp.probe("cpu")
    assert {k: v[1] for k, v in res.items()} == {"scale2": 0.0, "matmul": 0.0, "slab": 0.0}


def test_wrappers_check_their_inputs():
    x = torch.zeros(16, 32).to(tp.E4M3)
    with pytest.raises(ValueError):
        tp.fp8_scale2(torch.zeros(4))
    with pytest.raises(ValueError):
        tp.fp8_matmul(x, x)
    with pytest.raises(ValueError):
        tp.fp8_slab_copy(x, 17)
