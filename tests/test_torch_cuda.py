"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU and the CUDA toolkit, and skip elsewhere. They cover
shapes off the slices' main paths (odd row counts, groups wider than a warp,
every head dim the kernels take, pad-heavy vocabularies, out-of-range crop
offsets, ragged and fully masked flash tiles, Tq != Tk, the flash backward's
ragged tails and all-padding items, the beam kernel's int8 cache and prefix
stages at ragged prefix lengths and saturating writes, the fused LM head's
top-r at ragged vocab tails, r 1 to 32 and exact ties, the fp8 probes on
every e4m3 code at the rounding edge and at infinity), tiny VisionLanguage
serving routes, the tiny RRG's ensembling, greedy, small-vocab and
cache-permute routes, and a tiny training step card vs CPU. Run them on the card
from the repository root, without the JAX conftest (the card's machine has no
JAX):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import pytest
import torch

import vilmedic_torch.blocks.vision.densenet as tdensenet
from vilmedic_torch.data.image import finalize_device_preproc
from vilmedic_torch.models.evaluation_nlg import make_generate_fn
from vilmedic_torch.models.rrg import RRG
from vilmedic_torch.ops.beam_cache_attention import (
    KernelPrefix, fused_beam_cache_attention, fused_beam_cache_attention_reference,
    pack_kernel_prefix,
)
from vilmedic_torch.models.vision_language import VisionLanguage, make_vl_generate_fn
from vilmedic_torch.ops.blocked_lm_head import (
    NEG, lm_head_blocked_stats, lm_head_blocked_stats_reference,
)
from vilmedic_torch.ops.flash_attention import (
    flash_attention, flash_attention_backward, flash_attention_backward_reference,
    flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_reference,
    flash_attention_with_lse,
)
from vilmedic_torch.ops.fp8_probe import (
    E4M3, MAX_SLAB_BYTES, e4m3_from_f32, fp8_matmul, fp8_matmul_reference, fp8_scale2,
    fp8_scale2_reference, fp8_slab_copy, fp8_slab_copy_reference, probe,
)
from vilmedic_torch.ops.fused_lm_head import (
    lm_head_topk_lse, lm_head_topk_lse_reference, pad_lm_head_weights,
)
from vilmedic_torch.ops.image_preproc import crop_normalize, crop_normalize_reference
from vilmedic_torch.ops.topk import top_k

pytestmark = pytest.mark.cuda

# f32: sums in another order; bf16: p is rounded against the running max in
# the kernel and against the final max in the plain version
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("rows", [4, 40])
@pytest.mark.parametrize("index", [0, 5, 11])
def test_beam_cache_attention_kernel(cuda, dtype, d, rows, index):
    t, heads, groups = 12, 2, 3
    n = groups * rows
    gen = torch.Generator().manual_seed(d + rows + index)
    kc = torch.randn(t, n, heads * d, generator=gen).to(cuda, dtype)
    vc = torch.randn(t, n, heads * d, generator=gen).to(cuda, dtype)
    q, kn, vn = (torch.randn(n, heads, d, generator=gen).to(cuda, dtype) for _ in range(3))
    # several live slots per position, and lanes past the index set too
    mask = (torch.rand(groups, rows, t * rows, generator=gen) < 0.3).to(cuda)
    kc1, vc1, kc2, vc2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    out = fused_beam_cache_attention(kc1, vc1, q, kn, vn, mask, index)
    ref = fused_beam_cache_attention_reference(kc2, vc2, q, kn, vn, mask, index)
    torch.testing.assert_close(out, ref, rtol=TOL[dtype], atol=TOL[dtype])
    assert torch.equal(kc1, kc2) and torch.equal(vc1, vc2)  # bitwise, row index only


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("index", [0, 11])
def test_beam_cache_attention_stats_kernel(cuda, dtype, index):
    """Stage (b) at the first and the last index: out, m, l and the write."""
    t, heads, d, rows, groups = 12, 3, 64, 8, 2
    n = groups * rows
    gen = torch.Generator().manual_seed(7 + index)
    kc = torch.randn(t, n, heads * d, generator=gen).to(cuda, dtype)
    vc = torch.randn(t, n, heads * d, generator=gen).to(cuda, dtype)
    q, kn, vn = (torch.randn(n, heads, d, generator=gen).to(cuda, dtype) for _ in range(3))
    mask = (torch.rand(groups, rows, t * rows, generator=gen) < 0.3).to(cuda)
    kc1, vc1, kc2, vc2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    out, m, l = fused_beam_cache_attention(kc1, vc1, q, kn, vn, mask, index, return_stats=True)
    ref, rm, rl = fused_beam_cache_attention_reference(kc2, vc2, q, kn, vn, mask, index,
                                                       return_stats=True)
    torch.testing.assert_close(out, ref, rtol=TOL[dtype], atol=TOL[dtype])
    torch.testing.assert_close(m, rm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, rl, rtol=1e-4, atol=1e-5)
    assert torch.equal(kc1, kc2) and torch.equal(vc1, vc2)


def _stage_inputs(cuda, dtype, d, rows, int8: bool, seed: int):
    """Caches, q/k_new/v_new and an ancestry mask with several live slots per
    position (lanes past the index set too); with ``int8``, int8 caches,
    per-lane scales and k_new/v_new past 127 * scale on about a third of the
    lanes (the saturating write)."""
    t, heads, groups = 12, 2, 3
    n = groups * rows
    gen = torch.Generator().manual_seed(seed)
    q, kn, vn = (torch.randn(n, heads, d, generator=gen).to(cuda, dtype) for _ in range(3))
    mask = (torch.rand(groups, rows, t * rows, generator=gen) < 0.3).to(cuda)
    if not int8:
        kc, vc = (torch.randn(t, n, heads * d, generator=gen).to(cuda, dtype) for _ in range(2))
        return kc, vc, q, kn, vn, mask, None
    kc, vc = (torch.randint(-127, 128, (t, n, heads * d), generator=gen, dtype=torch.int8)
              .to(cuda) for _ in range(2))
    scales = (torch.rand(2, heads * d, generator=gen) * 1.5 + 0.5) / 127.0
    return kc, vc, q, kn, vn, mask, scales.to(cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("rows", [4, 40])
@pytest.mark.parametrize("index", [0, 11])
@pytest.mark.parametrize("return_stats", [False, True])
def test_beam_cache_attention_int8_kernel(cuda, dtype, d, rows, index, return_stats):
    """Stage (c): out (and m, l) against the plain version, the int8 write
    bitwise (round half to even, saturated at ±127), a launch counted."""
    kc, vc, q, kn, vn, mask, scales = _stage_inputs(cuda, dtype, d, rows, True,
                                                    d + rows + index)
    kc1, vc1, kc2, vc2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    before = (fused_beam_cache_attention.launches, fused_beam_cache_attention.launches_int8)
    got = fused_beam_cache_attention(kc1, vc1, q, kn, vn, mask, index, return_stats,
                                     kv_scales=scales)
    want = fused_beam_cache_attention_reference(kc2, vc2, q, kn, vn, mask, index, return_stats,
                                                kv_scales=scales)
    assert (fused_beam_cache_attention.launches - before[0],
            fused_beam_cache_attention.launches_int8 - before[1]) == (1, 1)
    got, want = (x if return_stats else (x,) for x in (got, want))
    torch.testing.assert_close(got[0], want[0], rtol=TOL[dtype], atol=TOL[dtype])
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    assert kc1.dtype == torch.int8 and torch.equal(kc1, kc2) and torch.equal(vc1, vc2)
    assert (kc1[index].abs() == 127).float().mean() > 0.15
    assert not (kc1[index] == -128).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("rows", [4, 40])
@pytest.mark.parametrize("index", [0, 11])
@pytest.mark.parametrize("p,p_real", [(37, 37), (64, 50), (1, 1)])
def test_beam_cache_attention_prefix_kernel(cuda, dtype, d, rows, index, p, p_real):
    """Stage (d), with and without stats: ragged prefix lengths (not a
    multiple of the 16 keys a block walks per step), a buffer longer than
    ``p_real`` whose tail is garbage, 1 and 10 items per row group."""
    beams = 4
    kc, vc, q, kn, vn, mask, _ = _stage_inputs(cuda, dtype, d, rows, False, d + p + index)
    n, heads = q.shape[:2]
    gen = torch.Generator().manual_seed(p + index)
    pk, pv = (torch.randn(n // beams, p, heads * d, generator=gen).to(cuda, dtype)
              for _ in range(2))
    pk[:, p_real:], pv[:, p_real:] = float("nan"), 1e9
    prefix = KernelPrefix(pk, pv, p_real, beams)
    for return_stats in (False, True):
        kc1, vc1, kc2, vc2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        before = fused_beam_cache_attention.launches_prefix
        got = fused_beam_cache_attention(kc1, vc1, q, kn, vn, mask, index, return_stats,
                                         prefix=prefix)
        want = fused_beam_cache_attention_reference(kc2, vc2, q, kn, vn, mask, index,
                                                    return_stats, prefix=prefix)
        assert fused_beam_cache_attention.launches_prefix - before == 1
        got, want = (x if return_stats else (x,) for x in (got, want))
        torch.testing.assert_close(got[0], want[0], rtol=TOL[dtype], atol=TOL[dtype])
        for g, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
        assert torch.equal(kc1, kc2) and torch.equal(vc1, vc2)


def test_beam_cache_attention_stages_refuse(cuda):
    """CUDA tensors the stages do not take raise; nothing falls back."""
    kc, vc, q, kn, vn, mask, scales = _stage_inputs(cuda, torch.bfloat16, 64, 4, True, 1)
    with pytest.raises(ValueError):  # int8 caches without scales
        fused_beam_cache_attention(kc, vc, q, kn, vn, mask, 3)
    with pytest.raises(ValueError):  # float16 q
        fused_beam_cache_attention(kc, vc, q.half(), kn.half(), vn.half(), mask, 3,
                                   kv_scales=scales)
    with pytest.raises(ValueError):  # bf16 scales
        fused_beam_cache_attention(kc, vc, q, kn, vn, mask, 3, kv_scales=scales.bfloat16())
    with pytest.raises(ValueError):  # scales on the CPU
        fused_beam_cache_attention(kc, vc, q, kn, vn, mask, 3, kv_scales=scales.cpu())
    kc, vc, q, kn, vn, mask, _ = _stage_inputs(cuda, torch.bfloat16, 64, 4, False, 2)
    pk = torch.zeros(3, 5, 2, 64, device=cuda)
    with pytest.raises(ValueError):  # an f32 prefix beside bf16 caches
        fused_beam_cache_attention(kc, vc, q, kn, vn, mask, 3, prefix=pack_kernel_prefix(
            pk, pk, 4))
    with pytest.raises(ValueError):  # scales and a prefix together
        fused_beam_cache_attention(kc.to(torch.int8), vc.to(torch.int8), q, kn, vn, mask, 3,
                                   kv_scales=scales, prefix=pack_kernel_prefix(
                                       pk.bfloat16(), pk.bfloat16(), 4))
    with pytest.raises(ValueError):  # a prefix that is not contiguous
        x = torch.zeros(3, 5, 256, device=cuda, dtype=torch.bfloat16)[:, :, :128]
        fused_beam_cache_attention(kc, vc, q, kn, vn, mask, 3, prefix=KernelPrefix(x, x, 5, 4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("tq,tk,causal", [
    (50, 50, False), (64, 64, False), (130, 130, False),  # below, at, above a tile
    (64, 64, True), (130, 130, True), (70, 200, True),   # causal, Tq < Tk
    (33, 129, False),
    # the bf16 kernel's 128-row CTAs and 128- (64- at D 128) key tiles: ragged
    # on both axes, Tq < Tk causal, and rows that see no key (Tq > Tk causal:
    # the first CTAs visit every key tile, as the finite mask averages V)
    (127, 129, False), (255, 191, True), (129, 257, True), (100, 300, True), (300, 100, True),
])
def test_flash_attention_kernel(cuda, dtype, d, tq, tk, causal):
    b, heads = 2, 3
    gen = torch.Generator().manual_seed(d + tq + tk)
    q = torch.randn(b, tq, heads, d, generator=gen).to(cuda, dtype)
    k, v = (torch.randn(b, tk, heads, d, generator=gen).to(cuda, dtype) for _ in range(2))
    key_mask = torch.ones(b, tk, dtype=torch.bool)
    key_mask[1, tk - tk // 3:] = False  # a masked key tail
    key_mask = key_mask.to(cuda)
    for km in (None, key_mask):
        out = flash_attention(q, k, v, km, causal)
        ref = flash_attention_reference(q, k, v, km, causal)
        assert out.dtype == dtype and out.shape == q.shape
        torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_fully_masked_item(cuda, dtype):
    """Every key of item 0 masked: its rows average V (the finite -1e9)."""
    b, t, heads, d = 2, 100, 2, 64
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(b, t, heads, d, generator=gen).to(cuda, dtype) for _ in range(3))
    key_mask = torch.ones(b, t, dtype=torch.bool, device=cuda)
    key_mask[0] = False
    out = flash_attention(q, k, v, key_mask)
    torch.testing.assert_close(out.float(), flash_attention_reference(q, k, v, key_mask).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    mean_v = v[0].float().mean(dim=0, keepdim=True).expand(t, heads, d)
    torch.testing.assert_close(out[0].float(), mean_v, rtol=TOL[dtype], atol=TOL[dtype])


# backward: relative to each gradient's largest entry; f32 sums in another
# order, bf16 p and dS rounded from f32 values that differ in the last bits;
# dbias sums unrounded f32 dS; lse f32 (absolute)
TOL_GRAD = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
TOL_DBIAS, TOL_LSE = 1e-4, 1e-5


def _flash_grads_match(q, k, v, key_mask, causal):
    """K4 with LSE and K5 against the plain versions, on the same inputs."""
    dtype = q.dtype
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(9)).to(q.device, dtype)
    out, lse = flash_attention_with_lse(q, k, v, key_mask, causal)
    rout, rlse = flash_attention_reference(q, k, v, key_mask, causal, return_lse=True)
    torch.testing.assert_close(out.float(), rout.float(), rtol=TOL[dtype], atol=TOL[dtype])
    torch.testing.assert_close(lse, rlse, rtol=0, atol=TOL_LSE)
    got = flash_attention_backward(q, k, v, key_mask, out, lse, dout, causal)
    want = flash_attention_backward_reference(q, k, v, key_mask, out, lse, dout, causal)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        tol = TOL_DBIAS if name == "dbias" else TOL_GRAD[dtype]
        scale = w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol * scale, f"{name}: {err:.3e} vs {tol * scale:.3e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("tq,tk,causal", [
    (50, 50, False), (130, 130, True), (70, 200, True), (200, 70, False), (129, 129, False),
    # ragged 128-row CTAs and 64-row tiles, Tq < Tk causal, rows that see no key
    (127, 129, True), (257, 191, False), (100, 300, True), (300, 100, True),
])
def test_flash_backward_kernel(cuda, dtype, d, tq, tk, causal):
    b, heads = 2, 3
    gen = torch.Generator().manual_seed(d + tq + tk)
    q = torch.randn(b, tq, heads, d, generator=gen).to(cuda, dtype)
    k, v = (torch.randn(b, tk, heads, d, generator=gen).to(cuda, dtype) for _ in range(2))
    key_mask = torch.ones(b, tk, dtype=torch.bool)
    key_mask[1, tk - tk // 3:] = False
    for km in (None, key_mask.to(cuda)):
        _flash_grads_match(q, k, v, km, causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_single_item_and_head(cuda, dtype, d, causal):
    """B 1, H 1: the tensor maps' outer dims at their smallest; forward, LSE
    and backward against the plain versions."""
    gen = torch.Generator().manual_seed(d + causal)
    q, k, v = (torch.randn(1, 150, 1, d, generator=gen).to(cuda, dtype) for _ in range(3))
    key_mask = torch.ones(1, 150, dtype=torch.bool, device=cuda)
    key_mask[0, 140:] = False
    out = flash_attention(q, k, v, None, causal)
    ref = flash_attention_reference(q, k, v, None, causal)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])
    _flash_grads_match(q, k, v, key_mask, causal)


def test_flash_backward_is_deterministic(cuda):
    """K5 writes every output element from one block in a fixed order (no
    atomics): two runs agree bit for bit."""
    gen = torch.Generator().manual_seed(11)
    q, k, v, dout = (torch.randn(2, 300, 3, 64, generator=gen).to(cuda, torch.bfloat16)
                     for _ in range(4))
    key_mask = torch.ones(2, 300, dtype=torch.bool, device=cuda)
    key_mask[1, 250:] = False
    out, lse = flash_attention_with_lse(q, k, v, key_mask, True)
    first = flash_attention_backward(q, k, v, key_mask, out, lse, dout, True)
    second = flash_attention_backward(q, k, v, key_mask, out, lse, dout, True)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_ragged_training_length(cuda, dtype):
    """T 1470 = 22 x 64 + 62, causal, the last 20 keys padding on item 1."""
    b, t, heads, d = 2, 1470, 2, 64
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(b, t, heads, d, generator=gen).to(cuda, dtype) for _ in range(3))
    key_mask = torch.ones(b, t, dtype=torch.bool, device=cuda)
    key_mask[1, t - 20:] = False
    _flash_grads_match(q, k, v, key_mask, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kept", [0, 10])
def test_flash_backward_padding_heavy_item(cuda, dtype, kept):
    """Item 0 keeps only its first ``kept`` keys. kept 0, non-causal: every
    key is padding, its rows average V over the real keys (the finite -1e9)
    and the gradients follow the plain version's. kept 10, causal: every row
    sees the kept keys (as every VisionLanguage row sees the image prefix)
    and none of the padding. (A causal row whose visible keys are all
    padding is undefined: the kernels walk only the tiles up to the causal
    limit, the plain version weighs every key alike, and the JAX kernels'
    answer depends on their block size.)"""
    b, t, heads, d = 2, 100, 2, 64
    gen = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(b, t, heads, d, generator=gen).to(cuda, dtype) for _ in range(3))
    key_mask = torch.ones(b, t, dtype=torch.bool, device=cuda)
    key_mask[0, kept:] = False
    _flash_grads_match(q, k, v, key_mask, kept > 0)


def test_flash_autograd_runs_the_kernels(cuda):
    """With grad, ``flash_attention`` is the autograd Function: one K4 launch
    with LSE forward, one launch of each K5 kernel backward, and the
    gradients of the plain backward."""
    gen = torch.Generator().manual_seed(7)
    q, k, v, dout = (torch.randn(2, 80, 2, 64, generator=gen).to(cuda, torch.bfloat16)
                     for _ in range(4))
    key_mask = torch.ones(2, 80, dtype=torch.bool, device=cuda)
    key_mask[1, 60:] = False
    counters = (flash_attention, flash_attention_with_lse, flash_attention_bwd_dq,
                flash_attention_bwd_dkv)
    start = [fn.launches for fn in counters]
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves, key_mask=key_mask, causal=True)
    out.backward(dout)
    torch.cuda.synchronize()
    assert [fn.launches - s for fn, s in zip(counters, start)] == [0, 1, 1, 1]
    o, lse = flash_attention_reference(q, k, v, key_mask, True, return_lse=True)
    want = flash_attention_backward_reference(q, k, v, key_mask, out.detach(), lse, dout, True)
    for leaf, w in zip(leaves, want):
        scale = w.float().abs().max().item()
        assert (leaf.grad.float() - w.float()).abs().max().item() <= TOL_GRAD[torch.bfloat16] * scale


def test_flash_backward_wrappers_refuse(cuda):
    q = torch.zeros(1, 8, 2, 64, device=cuda)
    stats = torch.zeros(1, 2, 8, device=cuda)
    with pytest.raises(ValueError):  # float16
        x = q.half()
        flash_attention_bwd_dq(x, x, x, None, x, stats, stats)
    with pytest.raises(ValueError):  # head dim 48
        x = torch.zeros(1, 8, 2, 48, device=cuda)
        flash_attention_bwd_dkv(x, x, x, None, x, stats, stats)
    with pytest.raises(ValueError):  # contiguous, 4 bytes off
        x = torch.zeros(8 * 2 * 64 + 1, device=cuda)[1:].view(1, 8, 2, 64)
        flash_attention_bwd_dq(x, x, x, None, x, stats, stats)
    with pytest.raises(ValueError):  # lse of the wrong shape
        flash_attention_bwd_dkv(q, q, q, None, q, torch.zeros(1, 8, 2, device=cuda), stats)
    with pytest.raises(ValueError):  # lse not f32
        flash_attention_bwd_dq(q, q, q, None, q, stats.bfloat16(), stats)
    with pytest.raises(ValueError):  # dO of another shape
        flash_attention_bwd_dq(q, q, q, None, q[:, :4].contiguous(), stats, stats)
    with pytest.raises(ValueError):  # out of another dtype than q
        flash_attention_backward(q, q, q, None, q.bfloat16(), stats, q)


def test_tiny_vl_train_step_card_equals_cpu(cuda):
    """f32, dropout off: one microbatch's gradients and one AdamW update of a
    small VisionLanguage (LM attention at a flash training length) on the
    card equal those of the CPU plain versions."""
    from vilmedic_torch.executors.train_state import create_optimizer, gated_update

    tower = dict(model_type="dinov2", hidden_size=128, num_hidden_layers=2,
                 num_attention_heads=2, patch_size=4, image_size=96)
    decoder = dict(proto=None, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                   intermediate_size=192, max_position_embeddings=1024, layer_norm_eps=1e-5,
                   hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    gen = torch.Generator().manual_seed(3)
    ids = torch.randint(3, 4500, (2, 20), generator=gen)
    ids[:, 0] = 0
    mask = torch.ones(2, 20, dtype=torch.long)
    mask[1, 15:] = 0
    batch = {"images": torch.randn(2, 3, 96, 96, generator=gen), "input_ids": ids,
             "attention_mask": mask}
    results, state = {}, None
    for device in ("cpu", cuda):
        model = VisionLanguage(decoder=dict(decoder), vision={"vision_model_name": "tiny",
                                                              "image_size": 96},
                               vision_hf_config=tower, vocab_size=4500, bos_token_id=0,
                               eos_token_id=2, pad_token_id=1, device=device, seed=5)
        assert model.module.num_image_tokens + 20 >= 512  # FLASH_MIN_LEN_TRAIN: flash
        if state is None:
            state = {k: x.clone() for k, x in model.module.state_dict().items()}
        else:
            model.module.load_state_dict(state)
        start = flash_attention_bwd_dq.launches
        loss = model.apply_train({k: x.to(device) for k, x in batch.items()})["loss"]
        loss.backward()
        tx = create_optimizer("adamw", {"lr": 5e-5}, None, model.frozen_prefixes,
                              named_parameters=model.module.named_parameters())
        grads = {n: p.grad.cpu().clone() for n, p in zip(tx.names, tx.params)}
        assert gated_update(tx, 5e-5, loss.detach())
        params = {n: p.detach().cpu().clone() for n, p in zip(tx.names, tx.params)}
        results[str(device)] = (loss.item(), grads, params, flash_attention_bwd_dq.launches - start)
    (l_cpu, g_cpu, p_cpu, _), (l_gpu, g_gpu, p_gpu, n_dq) = results["cpu"], results["cuda"]
    assert n_dq == 2  # one K5 dq launch per LM layer on the card
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    for name, want in g_cpu.items():
        ref = name[:-len("bias")] + "weight" if name.endswith("self_attn.k.bias") else name
        scale = g_cpu[ref].abs().max().item()
        assert (g_gpu[name] - want).abs().max().item() <= 1e-4 * scale, name
        assert (p_gpu[name] - p_cpu[name]).abs().max().item() <= 2 * 5e-5, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 5, 130])
@pytest.mark.parametrize("k", [64, 768])
def test_blocked_lm_head_kernel(cuda, dtype, n, k):
    vocab, vp = 4500, 4608
    gen = torch.Generator().manual_seed(n + k)
    w = torch.randn(vp, k, generator=gen) * 0.05
    w[vocab:] = 0.0
    b = torch.randn(vp, generator=gen) * 0.05
    b[vocab:] = NEG
    h = torch.randn(n, k, generator=gen).to(cuda, dtype)
    w, b = w.to(cuda, dtype), b.to(cuda)
    got = lm_head_blocked_stats(h, w, b)
    want = lm_head_blocked_stats_reference(h, w, b)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)


def test_crop_normalize_kernel(cuda):
    gen = torch.Generator().manual_seed(0)
    img = torch.randint(0, 256, (5, 40, 40, 3), generator=gen, dtype=torch.uint8).to(cuda)
    tops = torch.tensor([0, 8, 20, -3, 5], dtype=torch.int32, device=cuda)
    lefts = torch.tensor([8, 0, -1, 30, 2], dtype=torch.int32, device=cuda)
    torch.testing.assert_close(crop_normalize(img, tops, lefts, 32),
                               crop_normalize_reference(img, tops, lefts, 32),
                               rtol=1e-6, atol=1e-6)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(4, 2, 64, device=cuda, dtype=torch.float16)
    cache = torch.zeros(3, 4, 128, device=cuda, dtype=torch.float16)
    mask = torch.zeros(1, 4, 12, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        fused_beam_cache_attention(cache, cache.clone(), x, x, x, mask, 1)
    h = torch.zeros(2, 48, device=cuda)
    with pytest.raises(ValueError):  # hidden not a multiple of 32
        lm_head_blocked_stats(h, torch.zeros(128, 48, device=cuda), torch.zeros(128, device=cuda))
    h = torch.zeros(2 * 64 + 1, device=cuda)[1:].view(2, 64)  # contiguous, 4 bytes off
    with pytest.raises(ValueError):
        lm_head_blocked_stats(h, torch.zeros(128, 64, device=cuda), torch.zeros(128, device=cuda))
    img = torch.zeros(1, 8, 8, 3, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):  # int64 offsets
        crop_normalize(img, torch.zeros(1, dtype=torch.long, device=cuda),
                       torch.zeros(1, dtype=torch.long, device=cuda), 4)
    q = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError):  # float16
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):  # head dim 48
        x = torch.zeros(1, 8, 2, 48, device=cuda)
        flash_attention(x, x, x)
    with pytest.raises(ValueError):  # mixed dtypes
        flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError):  # not contiguous
        flash_attention(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))
    with pytest.raises(ValueError):  # key mask of the wrong shape
        flash_attention(q, q, q, key_mask=torch.ones(1, 7, device=cuda))
    with pytest.raises(ValueError):  # contiguous, 4 bytes off
        x = torch.zeros(8 * 2 * 64 + 1, device=cuda)[1:].view(1, 8, 2, 64)
        flash_attention(x, x, x)


@pytest.mark.parametrize("g", [1, 2])
def test_tiny_slice_card_equals_cpu(cuda, monkeypatch, g):
    """f32 beam sequences of a small RRG: kernels on the card == plain
    versions on the CPU."""
    monkeypatch.setitem(tdensenet.CONFIGS, "densenet_tiny", (8, (2, 2), 16))
    decoder = dict(proto=None, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                   intermediate_size=256, max_position_embeddings=64, layer_norm_eps=1e-5,
                   vocab_size=4500, bos_token_id=0, eos_token_id=2, pad_token_id=1)
    cnn = dict(backbone="densenet_tiny", visual_projection={"out_features": 128})
    gen = torch.Generator().manual_seed(1)
    batch = {"images_u8": torch.randint(0, 256, (4, 40, 40, 3), generator=gen,
                                        dtype=torch.uint8),
             "preproc_tops": torch.tensor([0, 3, 8, 5], dtype=torch.int32),
             "preproc_lefts": torch.tensor([2, 0, 8, 7], dtype=torch.int32)}
    results = {}
    for device in ("cpu", cuda):
        model = RRG(decoder=dict(decoder), cnn=dict(cnn), device=device, seed=5)
        generate = make_generate_fn([model], 4, 12, 0, 2, 1, ancestry_group_items=g)
        on = finalize_device_preproc({k: v.to(device) for k, v in batch.items()}, 32)
        res = generate(model.encoder_inputs(on))
        results[str(device)] = (res.sequences.cpu(), res.scores.cpu())
    (s_cpu, sc_cpu), (s_gpu, sc_gpu) = results["cpu"], results["cuda"]
    assert torch.equal(s_cpu, s_gpu)
    torch.testing.assert_close(sc_gpu, sc_cpu, rtol=1e-4, atol=1e-4)


def test_tiny_vl_slice_card_equals_cpu(cuda):
    """f32 beam sequences of a small VisionLanguage (DINOv2 tower and prefix
    LM at flash lengths): kernels on the card == plain versions on the CPU."""
    tower = dict(model_type="dinov2", hidden_size=128, num_hidden_layers=2,
                 num_attention_heads=2, patch_size=4, image_size=128)
    decoder = dict(proto=None, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                   intermediate_size=192, max_position_embeddings=1100, layer_norm_eps=1e-5)
    images = torch.randn(2, 3, 128, 128, generator=torch.Generator().manual_seed(2))
    results = {}
    for device in ("cpu", cuda):
        model = VisionLanguage(decoder=dict(decoder), vision={"vision_model_name": "tiny",
                                                              "image_size": 128},
                               vision_hf_config=tower, vocab_size=4500, bos_token_id=0,
                               eos_token_id=2, pad_token_id=1, device=device, seed=5)
        assert model.module.num_image_tokens == 1025  # >= FLASH_MIN_LEN: flash
        res = make_vl_generate_fn(model, 4, 12, 0, 2, 1)(images.to(device))
        results[str(device)] = (res.sequences.cpu(), res.scores.cpu())
    (s_cpu, sc_cpu), (s_gpu, sc_gpu) = results["cpu"], results["cuda"]
    assert torch.equal(s_cpu, s_gpu)
    torch.testing.assert_close(sc_gpu, sc_cpu, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("prefix_kv_dtype", [None, "int8"])
def test_tiny_vl_permute_route_card_equals_cpu(cuda, prefix_kv_dtype):
    """A small VisionLanguage whose decoder has heads of 16 (which the
    beam-cache kernel is not built for) at a flash-length prefix: the
    permute route, with no beam-cache launch, its prefill through K4 at head
    dim 16 (one launch per tower and LM layer); f32 beam sequences on the
    card equal the CPU's."""
    tower = dict(model_type="dinov2", hidden_size=128, num_hidden_layers=2,
                 num_attention_heads=2, patch_size=4, image_size=128)
    decoder = dict(proto=None, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                   intermediate_size=128, max_position_embeddings=1100, layer_norm_eps=1e-5)
    images = torch.randn(2, 3, 128, 128, generator=torch.Generator().manual_seed(8))
    results = {}
    for device in ("cpu", cuda):
        model = VisionLanguage(decoder=dict(decoder), vision={"vision_model_name": "tiny",
                                                              "image_size": 128},
                               vision_hf_config=tower, vocab_size=4500, bos_token_id=0,
                               eos_token_id=2, pad_token_id=1, device=device, seed=7)
        assert model.dec_config.head_dim == 16 and model.module.num_image_tokens == 1025
        start = fused_beam_cache_attention.launches, flash_attention.launches
        res = make_vl_generate_fn(model, 4, 12, 0, 2, 1,
                                  prefix_kv_dtype=prefix_kv_dtype)(images.to(device))
        results[str(device)] = (res.sequences.cpu(), res.scores.cpu())
        flash = 4 if device == cuda else 0  # 2 tower + 2 LM layers
        assert (fused_beam_cache_attention.launches, flash_attention.launches) == (
            start[0], start[1] + flash)
    (s_cpu, sc_cpu), (s_gpu, sc_gpu) = results["cpu"], results["cuda"]
    assert torch.equal(s_cpu, s_gpu)
    torch.testing.assert_close(sc_gpu, sc_cpu, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("prefix_kv_dtype,gen_kv_dtype,fused_prefix", [
    ("int8", "int8", False), (None, "int8", False), ("int8", None, False), (None, None, True),
])
def test_tiny_vl_routes_card_equals_cpu(cuda, prefix_kv_dtype, gen_kv_dtype, fused_prefix):
    """The int8-cache and fused-prefix serving routes of a small
    VisionLanguage, f32: beam sequences on the card (stages c and d) equal
    those of the CPU plain versions."""
    tower = dict(model_type="dinov2", hidden_size=128, num_hidden_layers=2,
                 num_attention_heads=2, patch_size=8, image_size=64)
    decoder = dict(proto=None, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                   intermediate_size=192, max_position_embeddings=128, layer_norm_eps=1e-5)
    images = torch.randn(4, 3, 64, 64, generator=torch.Generator().manual_seed(4))
    results = {}
    for device in ("cpu", cuda):
        model = VisionLanguage(decoder=dict(decoder), vision={"vision_model_name": "tiny",
                                                              "image_size": 64},
                               vision_hf_config=tower, vocab_size=4500, bos_token_id=0,
                               eos_token_id=2, pad_token_id=1, device=device, seed=6)
        start = (fused_beam_cache_attention.launches_int8,
                 fused_beam_cache_attention.launches_prefix)
        res = make_vl_generate_fn(model, 4, 12, 0, 2, 1, ancestry_group_items=2,
                                  prefix_kv_dtype=prefix_kv_dtype, gen_kv_dtype=gen_kv_dtype,
                                  fused_prefix=fused_prefix)(images.to(device))
        launched = (fused_beam_cache_attention.launches_int8 - start[0],
                    fused_beam_cache_attention.launches_prefix - start[1])
        results[str(device)] = (res.sequences.cpu(), res.scores.cpu(), launched, res.steps)
    (s_cpu, sc_cpu, _, _), (s_gpu, sc_gpu, launched, steps) = results["cpu"], results["cuda"]
    assert launched == ((2 * steps if gen_kv_dtype else 0), (2 * steps if fused_prefix else 0))
    assert torch.equal(s_cpu, s_gpu)
    torch.testing.assert_close(sc_gpu, sc_cpu, rtol=1e-4, atol=1e-4)


# K6: f32 sums of up to 768 products in another order (the plain version's
# one matmul against the kernel's k-tiles); lse: f32 sums of exp in another
# order (128-column partials merged across blocks), relative
TOL_TOPK, TOL_LSE = 1e-4, 1e-5


def topk_agrees(vals, idx, logits, tol: float) -> bool:
    """The kernel's (vals, idx) against the f32 logits: values within
    ``tol`` of the stable top-r; distinct columns each as good as the
    reference's entry at that rank; equal columns wherever the reference's
    value is more than ``tol`` from its neighbours (near-ties compare as
    sets)."""
    r = vals.shape[1]
    ref_v, ref_i = top_k(logits, min(r + 1, logits.shape[1]))
    picked = logits.gather(1, idx.long())
    gaps = ref_v[:, :-1] - ref_v[:, 1:]
    lone = torch.ones_like(ref_v[:, :r], dtype=torch.bool)
    lone[:, 1:] &= gaps[:, :r - 1] > tol
    if ref_v.shape[1] > r:
        lone &= gaps[:, :r] > tol
    distinct = (idx.sort(dim=1).values.diff(dim=1) != 0).all()
    return bool((vals - ref_v[:, :r]).abs().max() <= tol
                and (picked - ref_v[:, :r]).abs().max() <= tol and distinct
                and (idx.long() == ref_i[:, :r])[lone].all())


def _head(cuda, n, k, vocab, tile_v, seed, dtype):
    gen = torch.Generator().manual_seed(seed)
    h = torch.randn(n, k, generator=gen)
    w, b = pad_lm_head_weights(torch.randn(k, vocab, generator=gen) * 0.05,
                               torch.randn(vocab, generator=gen) * 0.05, tile_v)
    return h.to(cuda, dtype), w.to(cuda, dtype), b.to(cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 130])
@pytest.mark.parametrize("r", [1, 16, 32])
@pytest.mark.parametrize("k,vocab,tile_v", [(64, 4500, 1024), (768, 5000, 2048)])
def test_fused_lm_head_kernel(cuda, dtype, n, r, k, vocab, tile_v):
    """Ragged vocab tails (pad columns at -1e30), rows not a multiple of the
    128-row tile."""
    h, w, b = _head(cuda, n, k, vocab, tile_v, n + r + k, dtype)
    vals, idx, lse = lm_head_topk_lse(h, w, b, r, tile_v)
    logits = h.float() @ w.float() + b
    assert vals.shape == (n, r) and idx.dtype == torch.int32 and lse.shape == (n,)
    assert int(idx.max()) < vocab
    assert topk_agrees(vals, idx, logits, TOL_TOPK)
    _, _, want = lm_head_topk_lse_reference(h, w, b, r, tile_v)
    assert ((lse - want).abs() / want.abs()).max().item() <= TOL_LSE


def test_fused_lm_head_exact_ties(cuda):
    """Integer-valued h and w: the f32 sums are exact, so many logits tie and
    the kernel's columns equal the stable top-r's bitwise."""
    gen = torch.Generator().manual_seed(3)
    h = torch.randint(-2, 3, (70, 64), generator=gen).float()
    w, b = pad_lm_head_weights(torch.randint(-1, 2, (64, 3000), generator=gen).float(),
                               torch.zeros(3000), 1024)
    for dtype in (torch.float32, torch.bfloat16):
        got = lm_head_topk_lse(h.to(cuda, dtype), w.to(cuda, dtype), b.to(cuda), 32, 1024)
        want = lm_head_topk_lse_reference(h, w, b, 32, 1024)
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


def test_fused_lm_head_refuses(cuda):
    h, w, b = _head(cuda, 4, 64, 1000, 1024, 0, torch.float32)
    with pytest.raises(ValueError):  # h on the CPU, w and b on the card
        lm_head_topk_lse(h.cpu(), w, b, 8, 1024)
    with pytest.raises(ValueError):
        lm_head_topk_lse(h, w.cpu(), b, 8, 1024)
    with pytest.raises(ValueError):  # not contiguous
        lm_head_topk_lse(h.t().contiguous().t(), w, b, 8, 1024)
    with pytest.raises(ValueError):  # Vp % tile_v != 0
        lm_head_topk_lse(h, w, b, 8, 2048)
    with pytest.raises(ValueError):  # r beyond a warp
        lm_head_topk_lse(h, w, b, 33, 1024)
    with pytest.raises(ValueError):  # mixed dtypes
        lm_head_topk_lse(h, w.bfloat16(), b, 8, 1024)


def _all_e4m3_codes(cuda):
    return torch.arange(256, dtype=torch.int32).to(torch.uint8).view(E4M3).to(cuda)


@pytest.mark.parametrize("scale", [2.0, 58.0, 1e38, -0.5])
def test_fp8_scale2_kernel(cuda, scale):
    """Every e4m3 code (NaN, and the values whose doubling overflows), times
    2, times 58 (8 * 58 = 464 rounds to 448, 16 * 58 to NaN), times 1e38
    (infinities): bitwise equal to the plain version on the card and on the
    CPU."""
    x = _all_e4m3_codes(cuda)
    got = fp8_scale2(x, scale).view(torch.uint8)
    assert torch.equal(got, fp8_scale2_reference(x, scale).view(torch.uint8))
    assert torch.equal(got.cpu(), fp8_scale2_reference(x.cpu(), scale).view(torch.uint8))
    if scale == 58.0:
        assert got[0x50].item() == 0x7E  # 8 -> 464 -> 448
        assert got[0x58].item() == 0x7F  # 16 -> 928 -> NaN


@pytest.mark.parametrize("m,n,k", [(16, 8, 32), (128, 128, 128), (48, 40, 96)])
def test_fp8_matmul_kernel(cuda, m, n, k):
    """Within 2^-10 of sum |a||b| per output (the tensor cores may add fp8
    products with fewer bits than f32's 24)."""
    gen = torch.Generator().manual_seed(m + n + k)
    a = e4m3_from_f32(torch.randn(m, k, generator=gen) * 4).to(cuda)
    b = e4m3_from_f32(torch.randn(k, n, generator=gen)).to(cuda)
    got = fp8_matmul(a, b)
    scale = a.float().abs() @ b.float().abs()
    assert ((got - fp8_matmul_reference(a, b)).abs() <= 2.0 ** -10 * scale).all()


@pytest.mark.parametrize("rows,width", [(8, 256), (1, 16), (3, 4096),
                                        (16, MAX_SLAB_BYTES // 16)])
def test_fp8_slab_copy_kernel(cuda, rows, width):
    """Every code, NaN included, bitwise equal to the plain version's f32;
    the last case copies the largest slab the wrapper takes."""
    codes = torch.arange(16 * width, dtype=torch.int32).remainder(256).to(torch.uint8)
    x = codes.view(16, width).view(E4M3).to(cuda)
    got = fp8_slab_copy(x, rows)
    assert torch.equal(got.view(torch.int32), fp8_slab_copy_reference(x, rows).view(torch.int32))
    assert torch.equal(got.cpu().view(torch.int32),
                       fp8_slab_copy_reference(x.cpu(), rows).view(torch.int32))


def test_fp8_probe_runs_the_kernels(cuda):
    """The spike's main on the card: one launch of each kernel, no error."""
    start = (fp8_scale2.launches, fp8_matmul.launches, fp8_slab_copy.launches)
    res = probe(cuda)
    assert (fp8_scale2.launches, fp8_matmul.launches, fp8_slab_copy.launches) == tuple(
        s + 1 for s in start)
    assert res["scale2"][1] == 0.0 and res["slab"][1] == 0.0 and res["matmul"][1] <= 1e-2


def test_fp8_wrappers_refuse(cuda):
    x = _all_e4m3_codes(cuda).view(16, 16)
    with pytest.raises(ValueError):  # not e4m3
        fp8_scale2(x.float())
    with pytest.raises(ValueError):  # not contiguous
        fp8_scale2(x.t())
    with pytest.raises(ValueError):  # K not a multiple of 32
        fp8_matmul(x, x)
    with pytest.raises(ValueError):  # a on the card, b on the CPU
        a = x.view(8, 32)
        fp8_matmul(a, a.t().contiguous().cpu())
    with pytest.raises(ValueError):  # 3 * 5 bytes: not a multiple of 16
        fp8_slab_copy(x.view(torch.uint8)[:, :5].contiguous().view(E4M3), 3)
    with pytest.raises(ValueError):  # more rows than the slab has
        fp8_slab_copy(x, 17)
    with pytest.raises(ValueError):  # 16 bytes past the cap
        big = torch.zeros((16, MAX_SLAB_BYTES // 16 + 1), dtype=torch.uint8, device=cuda)
        fp8_slab_copy(big.view(E4M3), 16)


@pytest.mark.parametrize("route,vocab,members,beam", [
    ("greedy", 4500, 1, 1), ("greedy", 4500, 2, 1), ("ensemble", 4500, 2, 4),
    ("permute", 4500, 1, 4), ("permute", 300, 2, 4), ("small vocab", 300, 1, 4),
])
def test_tiny_rrg_routes_card_equals_cpu(cuda, monkeypatch, route, vocab, members, beam):
    """The RRG decode routes of a small model, f32: sequences (and beam
    scores) on the card equal the CPU plain versions'; K1 runs once per
    member, layer and step on the reorder-free routes and never on greedy or
    permute (8 heads of 16, a head dim K1 is not built for); K2 only for one
    member over a large vocabulary."""
    monkeypatch.setitem(tdensenet.CONFIGS, "densenet_tiny", (8, (2, 2), 16))
    heads = 8 if route == "permute" else 2
    decoder = dict(proto=None, hidden_size=128, num_hidden_layers=2, num_attention_heads=heads,
                   intermediate_size=256, max_position_embeddings=64, layer_norm_eps=1e-5,
                   vocab_size=vocab, bos_token_id=0, eos_token_id=2, pad_token_id=1)
    cnn = dict(backbone="densenet_tiny", visual_projection={"out_features": 128})
    gen = torch.Generator().manual_seed(2)
    batch = {"images_u8": torch.randint(0, 256, (4, 40, 40, 3), generator=gen,
                                        dtype=torch.uint8),
             "preproc_tops": torch.tensor([0, 3, 8, 5], dtype=torch.int32),
             "preproc_lefts": torch.tensor([2, 0, 8, 7], dtype=torch.int32)}
    results = {}
    for device in ("cpu", cuda):
        models = [RRG(decoder=dict(decoder), cnn=dict(cnn), device=device, seed=7 + i)
                  for i in range(members)]
        generate = make_generate_fn(models, beam, 12, 0, 2, 1)
        on = finalize_device_preproc({k: v.to(device) for k, v in batch.items()}, 32)
        start = (fused_beam_cache_attention.launches, lm_head_blocked_stats.launches)
        res = generate(models[0].encoder_inputs(on))
        launched = (fused_beam_cache_attention.launches - start[0],
                    lm_head_blocked_stats.launches - start[1])
        results[str(device)] = (res, launched)
    (cpu, _), (gpu, launched) = results["cpu"], results["cuda"]
    assert torch.equal(cpu.sequences, gpu.sequences.cpu())
    if beam > 1:
        torch.testing.assert_close(gpu.scores.cpu(), cpu.scores, rtol=1e-4, atol=1e-4)
    k1 = 2 * members * gpu.steps if route != "permute" and beam > 1 else 0
    k2 = gpu.steps if beam > 1 and members == 1 and vocab >= 4096 else 0
    assert launched == (k1, k2)
