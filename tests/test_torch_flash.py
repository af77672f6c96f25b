"""The port's flash attention (its plain PyTorch version, what the CUDA kernel
is held against on the card) against the JAX package's Pallas flash kernels
in interpret mode, on the CPU, float32.

Both JAX entries are reached: ``_flash_bthd`` (v2, H*D a multiple of 128)
and ``_flash_bhtd`` (v1: H*D = 96 with D = 48, or ``VILMEDIC_FLASH_IMPL=v1``).
The cases are those of ``tests/test_flash_attention.py``: ragged 100/130
axes that the JAX wrapper pads to its 64-wide blocks, random key masks, and
suffix key masks under the causal mask.
"""

import ctypes
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vilmedic_torch.ops import attention as tattn
from vilmedic_torch.ops import cuda_lib
from vilmedic_torch.ops import flash_attention as fa
from vilmedic_torch.ops.flash_attention import (
    flash_attention, flash_attention_backward_reference, flash_attention_reference,
    kernel_route, pad_head_dim, padded_head_dim,
)
from vilmedic_tpu.ops import attention as jattn
from vilmedic_tpu.ops.flash_attention import flash_attention as jax_flash

# f32 sums in another order (the JAX kernel's online softmax over 64-key
# blocks vs one softmax), the tolerance of the JAX package's own flash tests
TOL = 2e-4
# (heads, head dim, VILMEDIC_FLASH_IMPL): v2, v1 by layout, v1 by the switch
LAYOUTS = [(4, 32, "v2"), (2, 48, "v2"), (4, 32, "v1")]


def _inputs(seed, b, tq, tk, h, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, t, h, d)).astype(np.float32) for t in (tq, tk, tk)], rng


def _run_jax(q, k, v, key_mask, causal):
    out = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    key_mask=None if key_mask is None else jnp.asarray(key_mask),
                    block_q=64, block_k=64, interpret=True, causal=causal)
    return np.asarray(out)


def _run_port(q, k, v, key_mask, causal):
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          key_mask=None if key_mask is None else torch.from_numpy(key_mask),
                          causal=causal)
    return out.numpy()


@pytest.mark.parametrize("h,d,impl", LAYOUTS)
@pytest.mark.parametrize("tq,tk,mask", [(128, 256, False), (100, 130, True)])
def test_flash_matches_jax(monkeypatch, h, d, impl, tq, tk, mask):
    monkeypatch.setenv("VILMEDIC_FLASH_IMPL", impl)
    (q, k, v), rng = _inputs(0, 2, tq, tk, h, d)
    key_mask = (rng.random((2, tk)) > 0.3).astype(np.int32) if mask else None
    np.testing.assert_allclose(_run_port(q, k, v, key_mask, False),
                               _run_jax(q, k, v, key_mask, False), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("h,d,impl", LAYOUTS)
@pytest.mark.parametrize("tq,tk,mask", [(128, 128, False), (100, 130, True), (130, 130, True)])
def test_causal_flash_matches_jax(monkeypatch, h, d, impl, tq, tk, mask):
    """causal: query r sees key c iff c <= r + Tk - Tq. Suffix key masks;
    every row sees at least one unmasked key."""
    monkeypatch.setenv("VILMEDIC_FLASH_IMPL", impl)
    (q, k, v), _ = _inputs(1, 2, tq, tk, h, d)
    key_mask = None
    if mask:
        key_mask = (np.arange(tk) < tk - 17)[None].repeat(2, 0).astype(np.int32)
    np.testing.assert_allclose(_run_port(q, k, v, key_mask, True),
                               _run_jax(q, k, v, key_mask, True), rtol=TOL, atol=TOL)


def test_fully_masked_row_averages_values():
    """The mask value is the finite -1e9: a row whose keys are all masked
    averages V over the real keys, instead of giving 0 or NaN."""
    (q, k, v), _ = _inputs(2, 1, 5, 9, 2, 32)
    out = flash_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), key_mask=torch.zeros(1, 9))
    want = torch.from_numpy(v).mean(dim=1, keepdim=True).expand(1, 5, 2, 32)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)


def test_dot_product_attention_takes_the_flash_route(monkeypatch):
    """Both axes at or above FLASH_MIN_LEN with a key-padding bias: the port
    and the JAX package both route to flash (the threshold is a module
    global read at call time) and agree."""
    monkeypatch.setattr(tattn, "FLASH_MIN_LEN", 64)
    monkeypatch.setattr(jattn, "FLASH_MIN_LEN", 64)
    (q, k, v), _ = _inputs(3, 2, 100, 100, 4, 32)
    key_mask = np.ones((2, 100), np.int32)
    key_mask[1, -30:] = 0
    want = jattn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       bias=jattn.make_attention_bias(jnp.asarray(key_mask)),
                                       causal=True)
    bias = tattn.make_attention_bias(key_mask=torch.from_numpy(key_mask))
    got = tattn.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), bias=bias, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    # on CPU tensors the route runs the kernel's plain version
    torch.testing.assert_close(got, flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        key_mask=torch.from_numpy(key_mask), causal=True), rtol=0, atol=0)


def test_bf16_rounds_p_before_the_value_product():
    """bf16 operands: the plain version rounds p to bf16 before P V and
    returns bf16, as the kernel does."""
    (q, k, v), _ = _inputs(4, 1, 7, 11, 2, 32)
    qb, kb, vb = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    out = flash_attention_reference(qb, kb, vb)
    assert out.dtype == torch.bfloat16
    s = torch.einsum("bqhd,bkhd->bhqk", qb.float(), kb.float()) * 32 ** -0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    want = torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(), vb.float())
    want = (want / p.sum(-1).transpose(1, 2)[..., None]).bfloat16()
    torch.testing.assert_close(out, want, rtol=0, atol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_padded_head_dim_matches_jax_v1(causal):
    """Head dim 48 as the card runs it: q, k, v zero-padded to the built head
    dim 64, the plain version at that width with the true scale 48 ** -0.5,
    the output sliced back. It equals the unpadded plain version (zero
    columns change no score) and JAX's v1 kernel, which takes D 48 itself;
    the padded backward equals the unpadded one."""
    (q, k, v), rng = _inputs(5, 2, 100, 130 if not causal else 100, 2, 48)
    key_mask = (rng.random((2, k.shape[1])) > 0.2).astype(np.int32)
    key_mask[:, 0] = 1
    width = padded_head_dim(48)
    assert width == 64 and padded_head_dim(8) == 16 and padded_head_dim(96) == 128
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tm = torch.from_numpy(key_mask)
    padded = [pad_head_dim(x, width) for x in (tq, tk, tv)]
    out_p, lse_p = flash_attention_reference(*padded, tm, causal, return_lse=True,
                                             scale=48 ** -0.5)
    assert torch.equal(out_p[..., 48:], torch.zeros_like(out_p[..., 48:]))
    out, lse = flash_attention_reference(tq, tk, tv, tm, causal, return_lse=True)
    torch.testing.assert_close(out_p[..., :48], out, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse_p, lse, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out_p[..., :48].numpy(), _run_jax(q, k, v, key_mask, causal),
                               rtol=TOL, atol=TOL)
    dout = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))
    got = flash_attention_backward_reference(*padded, tm, out_p, lse_p, pad_head_dim(dout, width),
                                             causal, scale=48 ** -0.5)
    want = flash_attention_backward_reference(tq, tk, tv, tm, out, lse, dout, causal)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g[..., 48:], torch.zeros_like(g[..., 48:]))
        torch.testing.assert_close(g[..., :48], w, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=1e-5)
    assert padded_head_dim(129) == 256 and padded_head_dim(200) == 256


# padded width in f32 -> in bf16, where they differ: bf16 above 320 pads to a
# width a cluster splits (split_of)
BF16_WIDTHS = {448: 512, 576: 640, 704: 768, 2624: 2880}


@pytest.mark.parametrize("d,width", [(129, 256), (200, 256), (256, 256), (257, 320),
                                     (320, 320), (321, 384), (1000, 1024), (448, 448),
                                     (512, 512), (576, 576), (700, 704), (2560, 2560),
                                     (2600, 2624), (5120, 5120)])
def test_padded_head_dim_above_128(d, width):
    """Above 128 the card runs 256 (the wgmma kernels' largest), above 256
    the next multiple of 64 (the wide kernels' chunk); in f32 every head
    above 128 the next multiple of 64 (n shares of 64 columns of a cluster),
    and in bf16 above 320 the next width a cluster of CTAs splits into equal
    shares of 192, 256 or 320 columns; and names the C entry that takes it:
    f32 the three-pass TF32 split kernels up to 1024 (16 shares) and the
    matrix products of ``flash_attention_gemm.cu`` above, bf16 the wgmma
    ones of ``flash_attention_wide_tc.cu`` at every width here."""
    bf16_width = BF16_WIDTHS.get(width, width)
    f32_width = -(-d // 64) * 64
    assert padded_head_dim(d) == width
    assert padded_head_dim(d, torch.float32) == f32_width
    assert padded_head_dim(d, torch.bfloat16) == bf16_width
    assert kernel_route(torch.float32, f32_width) == ("f32_split" if f32_width <= 1024 else "wide")
    assert kernel_route(torch.bfloat16, bf16_width) == "wide_tc"


@pytest.mark.parametrize("width", range(320 + 64, 5120 + 1, 64))
def test_split_of_takes_every_bf16_width(width):
    """Every multiple of 64 above 320 up to 5120 pads to ``n * w``: n =
    ceil(width / 320) CTAs (at most 16, Hopper's largest cluster) of w
    columns, w one of the widths the split kernels are built for, the least
    such multiple at or above the width; a padded width pads to itself, and
    the C entries are given that n."""
    n, w = fa.split_of(width)
    assert n == -(-width // 320) <= fa.SPLIT_MAX and w in fa.SPLIT_WIDTHS
    assert width <= n * w < width + 64 * n
    assert fa.split_of(n * w) == (n, w)
    assert fa._head_args(torch.bfloat16, n * w) == (n * w, n)


@pytest.mark.parametrize("d,width,route", [
    (129, 192, "f32_split"), (192, 192, "f32_split"), (256, 256, "f32_split"),
    (300, 320, "f32_split"), (320, 320, "f32_split"), (1000, 1024, "f32_split"),
    (1024, 1024, "f32_split"), (1025, 1088, "wide"), (1088, 1088, "wide"),
])
def test_f32_split_of_takes_every_f32_width_to_1024(d, width, route):
    """An f32 head above 128 pads to the next multiple of 64 and runs, up
    to 1024 (16 shares, the largest split), as a cluster of width / 64 CTAs
    of 64 columns on the ``f32_split`` entries, which take the cluster size
    after the head dim; a width above runs on the GEMM entries, which take
    the head dim alone and, after the scale, a workspace (pointer, bytes)
    and the rows a chunk."""
    assert padded_head_dim(d, torch.float32) == width
    assert kernel_route(torch.float32, width) == route
    n, w = fa.f32_split_of(width)
    assert (n, w) == (width // 64, fa.F32_SHARE) == (width // 64, 64)
    split = route == "f32_split"
    assert fa._head_args(torch.float32, width) == ((width, n) if split else (width,))
    for part in ("", "_bwd_dq", "_bwd_dkv"):
        assert len(cuda_lib.SIGNATURES[f"vt_flash_attention{part}_{route}"]) \
            == len(cuda_lib.SIGNATURES[f"vt_flash_attention{part}_f32"]) + (1 if split else 3)


@pytest.mark.parametrize("dtype,width,args", [
    (torch.bfloat16, 128, (128,)), (torch.bfloat16, 256, (256, 1)),
    (torch.bfloat16, 320, (320, 1)), (torch.bfloat16, 384, (384, 2)),
    (torch.bfloat16, 1024, (1024, 4)), (torch.bfloat16, 2880, (2880, 9)),
    (torch.bfloat16, 5120, (5120, 16)), (torch.float32, 384, (384, 6)),
    (torch.float32, 128, (128,)), (torch.float32, 1088, (1088,)),
])
def test_head_args_give_the_wide_tc_entries_their_cluster(dtype, width, args):
    """The ``wide_tc`` and ``f32_split`` entries take the CTAs a head (bf16:
    1 at 256 and 320, a cluster above; f32: one CTA a 64-column share) after
    the head dim, one int more than the other entries; the caller, which
    pads to :func:`split_of` or :func:`f32_split_of`, is the one place that
    chooses it. The GEMM entries (f32 above 1024) take the head dim alone,
    and three more arguments after the scale: the workspace, its bytes and
    the rows a chunk."""
    assert fa._head_args(dtype, width) == args
    route = fa.kernel_route(dtype, width)
    entry = f"vt_flash_attention_{route}"
    assert len(cuda_lib.SIGNATURES[entry]) == len(cuda_lib.SIGNATURES["vt_flash_attention_f32"]) \
        + len(args) - 1 + (3 if route in fa.GEMM_ROUTES else 0)


def test_cuda_core_route_is_f32_only():
    """No flash route runs on the CUDA cores any more. Up to the widest head
    a cluster of CTAs splits in bf16 (5120), the GEMM route of
    ``csrc/flash_attention_gemm.cu`` is an f32 route alone, and only above
    the widest f32 head a cluster splits (16 shares of 64, 1024): f32 from
    192 to 1024 routes to the three-pass TF32 split entries, f32 from 1088
    to 5120 to the GEMM f32 entries, and no bf16 width from 129 to 5120 to
    the GEMM entries (those run on the wgmma kernels of ``wide_tc``)."""
    for part in ("", "_bwd_dq", "_bwd_dkv"):
        assert cuda_lib.SIGNATURES[f"vt_flash_attention{part}_wide"][0] is ctypes.c_void_p
    for width in (192, 256, 320, 384, 1024):
        assert kernel_route(torch.float32, width) == "f32_split"
        assert kernel_route(torch.bfloat16, width) == "wide_tc"
    for width in (1088, 2048, 4096, 5120):
        assert kernel_route(torch.float32, width) == "wide"
        assert kernel_route(torch.bfloat16, width) == "wide_tc"


def test_cuda_core_routes_take_f32_above_128_and_bf16_above_5120():
    """The GEMM file, which took over from the CUDA-core
    ``flash_attention_wide.cu`` (gone), takes the heads wider than a cluster
    of 16 CTAs splits, in each dtype through entries of its own (``_wide``
    and ``_wide_bf16``, the same arguments, no dtype flag, no cluster size):
    f32 above 1024 and bf16 above 5120; f32 from 129 to 1024 never routes
    there."""
    assert not (cuda_lib.CSRC_DIR / "flash_attention_wide.cu").exists()
    source = (cuda_lib.CSRC_DIR / "flash_attention_gemm.cu").read_text()
    for part in ("", "_bwd_dq", "_bwd_dkv"):
        for suffix in fa.GEMM_ROUTES:
            assert f'extern "C" int vt_flash_attention{part}_{suffix}(' in source
    for part in ("", "_bwd_dq", "_bwd_dkv"):
        assert cuda_lib.SIGNATURES[f"vt_flash_attention{part}_wide_bf16"] \
            == cuda_lib.SIGNATURES[f"vt_flash_attention{part}_wide"]
    for width in (5184, 5248, 8192):
        assert kernel_route(torch.float32, width) == "wide"
        assert kernel_route(torch.bfloat16, width) == "wide_bf16"
    for d in (1025, 1088, 2000):
        assert kernel_route(torch.float32, padded_head_dim(d, torch.float32)) == "wide"
    for d in (129, 500, 1024):
        assert kernel_route(torch.float32, padded_head_dim(d, torch.float32)) == "f32_split"


class _StandInLibrary:
    """Records which C entry is called with which arguments; every call
    returns ``status``."""

    def __init__(self, status=0):
        self.calls, self.status = [], status

    def __getattr__(self, name):
        if not name.startswith("vt_"):
            raise AttributeError(name)
        if name == "vt_error_string":
            return lambda status: b"stand-in error"
        return lambda *args: self.calls.append((name, args)) or self.status


@pytest.mark.parametrize("name", ["vt_flash_attention", "vt_flash_attention_bwd_dq",
                                  "vt_flash_attention_bwd_dkv"])
@pytest.mark.parametrize("dtype,width,suffix", [
    (torch.bfloat16, 64, "bf16"), (torch.bfloat16, 128, "bf16"),
    (torch.bfloat16, 256, "wide_tc"), (torch.bfloat16, 320, "wide_tc"),
    (torch.bfloat16, 384, "wide_tc"), (torch.bfloat16, 512, "wide_tc"),
    (torch.bfloat16, 1024, "wide_tc"), (torch.float32, 128, "f32"),
    (torch.float32, 256, "f32_split"), (torch.float32, 320, "f32_split"),
    (torch.float32, 1024, "f32_split"), (torch.float32, 1088, "wide"),
    (torch.float32, 16, "f32"), (torch.float32, 32, "f32"), (torch.float32, 64, "f32"),
    (torch.bfloat16, 5184, "wide_bf16"), (torch.bfloat16, 5248, "wide_bf16"),
])
def test_entry_calls_the_routed_c_entry(monkeypatch, name, dtype, width, suffix):
    """``_entry`` (through ``_launch``) calls the entry ``kernel_route``
    names: f32 up to 128 the three-pass TF32 kernels of
    ``flash_attention_f32.cu``; bf16 above 128 the wgmma kernels of
    ``flash_attention_wide_tc.cu`` (one CTA a row block at 256 and 320, a
    cluster above) up to 5120, the GEMM kernels' bf16 entries above; f32
    above 128 the three-pass TF32 kernels of ``flash_attention_f32_split.cu``
    up to 1024, the GEMM kernels above; no entry takes a dtype flag. It counts the
    launch under that entry; a non-zero status raises and counts nothing.
    The function is looked up once per library."""
    stand_in = _StandInLibrary()
    monkeypatch.setattr(cuda_lib, "lib", lambda: stand_in)
    monkeypatch.setattr(fa, "ENTRY_LAUNCHES", {})
    entry = f"{name}_{suffix}"
    fa._launch(name, "flash", dtype, width, 11, 22)
    assert stand_in.calls == [(entry, (11, 22))]
    assert fa.ENTRY_LAUNCHES == {entry: 1}
    assert fa._ENTRIES[(entry, stand_in)] is fa._entry(name, dtype, width)[1]
    stand_in.status = 1
    with pytest.raises(RuntimeError, match="stand-in error"):
        fa._launch(name, "flash", dtype, width, 11, 22)
    assert fa.ENTRY_LAUNCHES == {entry: 1}


@functools.lru_cache(maxsize=None)
def _wide_case(d: int, causal: bool):
    """The inputs of a wide-head case and JAX's v1 output on them (one
    interpret-mode run, whichever dtype's padding a case checks)."""
    (q, k, v), rng = _inputs(6 + d, 2, 100, 130 if not causal else 100, 2, d)
    key_mask = (rng.random((2, k.shape[1])) > 0.2).astype(np.int32)
    key_mask[:, 0] = 1
    return q, k, v, key_mask, _run_jax(q, k, v, key_mask, causal)


@pytest.mark.parametrize("d", [160, 256, 320, 384, 448, 512])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wide_head_dims_match_jax_v1(d, causal, dtype):
    """Head dims above 128 (JAX's v1 kernel, which takes any D): the plain
    forward equals JAX's in interpret mode, with a key mask; run as the card
    runs it in the case's dtype (zero-padded to ``padded_head_dim(d,
    dtype)``: in bf16 448 to 512, the split kernels' widths; in f32 160 to
    192, three 64-column shares; true scale) it equals the unpadded plain
    version."""
    q, k, v, key_mask, want = _wide_case(d, causal)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tm = torch.from_numpy(key_mask)
    out, lse = flash_attention_reference(tq, tk, tv, tm, causal, return_lse=True)
    np.testing.assert_allclose(out.numpy(), want, rtol=TOL, atol=TOL)
    width = padded_head_dim(d, dtype)
    padded = [pad_head_dim(x, width) for x in (tq, tk, tv)]
    out_p, lse_p = flash_attention_reference(*padded, tm, causal, return_lse=True,
                                             scale=d ** -0.5)
    assert torch.equal(out_p[..., d:], torch.zeros_like(out_p[..., d:]))
    torch.testing.assert_close(out_p[..., :d], out, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse_p, lse, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d,width", [(5121, 5184), (5184, 5184), (5200, 5248), (5248, 5248)])
def test_bf16_heads_above_5120_run_on_the_cuda_cores(d, width):
    """A bf16 head wider than 16 CTAs split (5120) is no longer refused: it
    pads to the next multiple of 64, as f32 does, and routes to the bf16
    entries of ``flash_attention_gemm.cu`` (on the tensor cores now), which
    take the head dim alone (no cluster size) and the workspace, its bytes
    and the rows a chunk."""
    assert padded_head_dim(d, torch.bfloat16) == width == padded_head_dim(d, torch.float32)
    assert kernel_route(torch.bfloat16, width) == "wide_bf16"
    assert kernel_route(torch.float32, width) == "wide"
    assert fa._head_args(torch.bfloat16, width) == (width,)
    assert len(cuda_lib.SIGNATURES["vt_flash_attention_wide_bf16"]) \
        == len(cuda_lib.SIGNATURES["vt_flash_attention_f32"]) + 3


# ------------------------------------------------------------ the GEMM routes


def _round64(x: int) -> int:
    return -(-x // 64) * 64


@pytest.mark.parametrize("rows,b,h,cols,kind,dtype", [
    (1370, 2, 3, 1370, "fwd", torch.bfloat16), (1370, 16, 3, 1370, "fwd", torch.float32),
    (1370, 16, 3, 1370, "dkv", torch.float32), (1370, 64, 12, 1370, "dq", torch.bfloat16),
    (24, 1, 2, 16, "fwd", torch.float32), (100000, 64, 16, 8192, "dkv", torch.float32),
    (4096, 32, 16, 4096, "fwd", torch.bfloat16),
])
def test_gemm_chunk_is_a_multiple_of_64_under_the_cap(rows, b, h, cols, kind, dtype):
    """The rows a GEMM route's launch takes (queries for the forward and dq,
    keys for dk/dv): a multiple of 64, at least 64, no more than the axis
    rounded up to 64 (so its chunks cover the axis), and the most whose
    scores for every (b, h) over the other axis (rounded up to 64) fit in
    the workspace cap; 64 when not even that fits."""
    score = fa.gemm_score_bytes(kind, dtype)
    chunk = fa.gemm_chunk(rows, b, h, cols, score)
    assert chunk % 64 == 0 and 64 <= chunk <= _round64(rows)
    per_row = b * h * _round64(cols) * score
    assert chunk * per_row <= fa.WORKSPACE_CAP or chunk == 64
    if chunk < _round64(rows):
        assert (chunk + 64) * per_row > fa.WORKSPACE_CAP
    assert -(-rows // chunk) * chunk >= rows


@pytest.mark.parametrize("kind", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gemm_chunk_takes_the_whole_axis_at_the_training_shapes(kind, dtype):
    """At B 2 to 16, T 1370, 3 heads the whole axis is one chunk in every
    entry and dtype, under a cap that forces 3 or more chunks of each axis
    at B 2, Tq 300, Tk 260 (what the card's forced-chunk parity uses), and
    the score bytes are the entries' (S f32 and P, dS, P^T and dS^T in the
    operands' dtype; f32 as TF32 hi and lo)."""
    score = fa.gemm_score_bytes(kind, dtype)
    assert score == {("fwd", torch.bfloat16): 6, ("fwd", torch.float32): 12,
                     ("dq", torch.bfloat16): 2, ("dq", torch.float32): 8,
                     ("dkv", torch.bfloat16): 4, ("dkv", torch.float32): 16}[(kind, dtype)]
    for b in (2, 16):
        assert fa.gemm_chunk(1370, b, 3, 1370, score) == 1408
    rows, cols = (260, 300) if kind == "dkv" else (300, 260)
    assert -(-rows // fa.gemm_chunk(rows, 2, 3, cols, score, cap=1 << 18)) >= 3


def test_gemm_workspace_is_allocated_for_the_gemm_routes_only():
    """The wrapper allocates a GEMM route's workspace itself (the kernels
    allocate nothing) and passes (pointer, bytes, chunk) after the scale;
    its size is the entry's layout: regions on 1024-byte boundaries, in f32
    the TF32 halves of the operands first (transposes padded to 64 rows),
    then the score block. Other routes get no workspace."""
    ws, args = fa._workspace("fwd", torch.float32, 1, 24, 16, 2, 1088, "cpu")
    assert args == (ws.data_ptr(), ws.numel(), 64) and ws.dtype == torch.uint8
    assert fa._workspace("fwd", torch.float32, 1, 24, 16, 2, 1024, "cpu") == (None, ())
    assert fa._workspace("dkv", torch.bfloat16, 1, 24, 16, 2, 5120, "cpu") == (None, ())

    def regions(*sizes):
        used = 0
        for size in sizes:
            used = -(-used // 1024) * 1024 + size
        return used

    b, tq, tk, h, d, c = 1, 24, 16, 2, 1088, 64
    assert ws.numel() == regions(*[b * tq * h * d * 4] * 2, *[b * tk * h * d * 4] * 2,
                                 *[b * d * h * 64 * 4] * 2, b * c * h * 64 * 4,
                                 2 * b * c * h * 64 * 4, b * h * c * 4)
    assert fa.gemm_workspace_bytes("dq", torch.bfloat16, b, tq, tk, h, 5184, c) \
        == b * c * h * 64 * 2
    assert fa.gemm_workspace_bytes("dkv", torch.bfloat16, b, tq, tk, h, 5184, c) \
        == regions(*[b * c * h * 64 * 2] * 2, b * h * c * 1 * 4)


@functools.lru_cache(maxsize=None)
def _gemm_case(d: int):
    """B 1, Tq 24 > Tk 16, 2 heads, the last 4 keys masked, and JAX's v1
    output on them, causal (one interpret-mode run)."""
    (q, k, v), _ = _inputs(40 + d, 1, 24, 16, 2, d)
    key_mask = np.ones((1, 16), np.int32)
    key_mask[0, 12:] = 0
    return q, k, v, key_mask, _run_jax(q, k, v, key_mask, True)


@pytest.mark.parametrize("d,dtype", [(5184, torch.bfloat16), (1088, torch.float32)])
def test_gemm_head_dims_match_jax_v1(d, dtype):
    """The GEMM routes' widths (bf16 above 5120, f32 above 1024): the plain
    forward equals JAX's v1 kernel in interpret mode, causal with Tq > Tk
    (rows 0 to 7 see no key and average every V) and masked keys; run at
    ``padded_head_dim(d, dtype)`` with the true scale, as the card runs it,
    it equals the unpadded plain version."""
    q, k, v, key_mask, want = _gemm_case(d)
    width = padded_head_dim(d, dtype)
    assert kernel_route(dtype, width) in fa.GEMM_ROUTES
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tm = torch.from_numpy(key_mask)
    out, lse = flash_attention_reference(tq, tk, tv, tm, True, return_lse=True)
    np.testing.assert_allclose(out.numpy(), want, rtol=TOL, atol=TOL)
    padded = [pad_head_dim(x, width) for x in (tq, tk, tv)]
    out_p, lse_p = flash_attention_reference(*padded, tm, True, return_lse=True, scale=d ** -0.5)
    torch.testing.assert_close(out_p[..., :d], out, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse_p, lse, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tq,tk", [(24, 16), (16, 24), (130, 130)])
def test_gemm_skips_only_zero_probabilities(tq, tk):
    """What the GEMM kernels leave out under the causal mask is exactly zero
    in the plain version: a row that sees keys weighs the keys past its
    causal limit by exp(-1e9 - m) = 0 (P V's depth stops at the limit, the
    softmax writes P = 0 past it, dS is 0 there), and a row that sees no key
    (Tq > Tk) weighs every key alike, so a tile holding one takes every key.
    On the backward's side, dS^T of a key for the queries before the first
    that sees it is 0 (dk/dv's depth starts there)."""
    (q, k, v), rng = _inputs(7, 1, tq, tk, 2, 16)
    tq_, tk_, tv_ = (torch.from_numpy(x) for x in (q, k, v))
    key_mask = torch.ones(1, tk)
    key_mask[0, tk - 3:] = 0
    s = fa._scores(tq_, tk_, key_mask, True)
    m = s.amax(dim=-1, keepdim=True).clamp_min(fa.NEG_INF)
    p = torch.exp(s - m)
    row = torch.arange(tq)[:, None]
    col = torch.arange(tk)[None, :]
    sees_none = (row + tk - tq < 0).expand(tq, tk)
    past = (col > row + tk - tq) & ~sees_none
    assert torch.equal(p[..., past], torch.zeros_like(p[..., past]))
    if tq > tk:
        torch.testing.assert_close(p[..., sees_none], torch.ones_like(p[..., sees_none]))
    _, lse = flash_attention_reference(tq_, tk_, tv_, key_mask, True, return_lse=True)
    dout = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))
    pb = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout, tv_)
    ds = pb * (dp - fa._delta(flash_attention_reference(tq_, tk_, tv_, key_mask, True), dout)[..., None])
    assert torch.equal(ds[..., past], torch.zeros_like(ds[..., past]))


# ------------------------------------------------ three-pass TF32 arithmetic


def _tf32_read(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) as a tensor core reads it in a TF32 product: the low
    13 mantissa bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _tf32_product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """``a @ b`` as the f32 kernels take it: one TF32 pass (each operand read
    as TF32) or three (``lo_a hi_b + hi_a lo_b + hi_a hi_b`` of
    :func:`split_tf32`'s halves, each read as TF32); the products and sums
    in float64, rounded to float32 once (the tensor core's own rounding of
    its sums is left out)."""
    if passes == 1:
        return (_tf32_read(a).double() @ _tf32_read(b).double()).float()
    (ah, al), (bh, bl) = fa.split_tf32(a), fa.split_tf32(b)
    ah, al, bh, bl = (_tf32_read(x).double() for x in (ah, al, bh, bl))
    return (al @ bh + ah @ bl + ah @ bh).float()


def _flash_tf32(q, k, v, passes: int, share=None) -> torch.Tensor:
    """One head's attention (T, D) with S = Q K^T and P V in ``passes``
    TF32 passes, the softmax in f32 as the kernels run it. With ``share``, S
    is summed as the split kernels sum it: each CTA's ``share`` columns a
    product of their own, rounded to f32, the partials added in rank order
    in f32 (P V needs no such sum: each CTA writes its own columns)."""
    share = share or q.shape[-1]
    s = None
    for c in range(0, q.shape[-1], share):
        part = _tf32_product(q[:, c:c + share].contiguous(), k[:, c:c + share].t().contiguous(),
                             passes)
        s = part if s is None else s + part
    s = s * q.shape[-1] ** -0.5
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return _tf32_product(p, v, passes) / p.sum(dim=-1, keepdim=True)


def test_split_tf32_halves_each_f32_word():
    """``split_tf32`` on the f32 bit patterns, as the kernels split each
    operand: hi is x rounded to TF32 (10 mantissa bits, nearest, ties away
    from zero: low 13 bits zero), lo = x - hi exactly, |lo| at most half a
    TF32 step of |x|; ties and signs by hand."""
    rng = np.random.default_rng(22)
    x = torch.from_numpy(np.concatenate([
        rng.normal(size=4096) * 10.0 ** rng.integers(-30, 30, size=4096),
        [0.0, -0.0, 1.0, -1.5, 3e38]]).astype(np.float32))
    hi, lo = fa.split_tf32(x)
    assert torch.equal(hi + lo, x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert (lo.abs() <= hi.abs() * 2.0 ** -11).all()
    one = np.float32(1.0)
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12, 1 + 3 * 2.0 ** -11],
                       dtype=torch.float32)
    assert fa.split_tf32(tie)[0].tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), one,
                                              1 + 2.0 ** -9]


@pytest.mark.parametrize("d", [64, 128, 320, 512])
def test_three_tf32_passes_hold_the_f32_tolerance(d):
    """At the tower's reduction lengths (1370 keys; head dim 64, and 128),
    attention with both products in three TF32 passes stays within the f32
    tolerance the card's checks hold the kernels to (1e-5, max abs, of the
    f32 plain version) and keeps f32's order of error against float64; one
    pass misses it by orders of magnitude. At the split heads' widths (320
    and 512: 5 and 8 CTAs) with S summed as those kernels sum it, in
    64-column shares added in rank order."""
    rng = np.random.default_rng(1370 + d)
    q, k, v = (torch.from_numpy(rng.normal(size=(t, d)).astype(np.float32))
               for t in (64, 1370, 1370))
    want = flash_attention_reference(q[None, :, None], k[None, :, None], v[None, :, None])[0, :, 0]
    exact = torch.softmax(q.double() @ k.double().t() * d ** -0.5, dim=-1) @ v.double()
    share = fa.f32_split_of(d)[1] if d > 128 else None
    three, one = _flash_tf32(q, k, v, 3, share), _flash_tf32(q, k, v, 1, share)
    tol = 1e-5  # chip_smoke.FLASH_TOL["float32"], tests/test_torch_cuda.TOL
    assert (three - want).abs().max().item() <= tol
    assert (three.double() - exact).abs().max().item() <= 2 * (want.double() - exact).abs().max()
    assert (one - want).abs().max().item() > 10 * tol
