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
cache-permute routes, a tiny training step card vs CPU, the sampler, K1 (a)
and K2 at RRS's shapes (K1 also at beam 2), small SCST, RRS and RRG_FORCE generation paths
card vs CPU, a tiny RoBERTa-type RRG (the LM-head transform before K2, the
ensemble's blocked head and the plain head), the GLoRIA loss, an unfrozen
DINOv2 tower's gradient (K5 non-causal; also alone at T 1370), gradient
checkpointing's replayed dropout, BERTScore's encoder, the ModernBERT
encoder and the GREEN judge's LLaMA (logits, greedy tokens) card vs CPU, the
Trainor's device prefetch (the copy stream's placement and crop+normalize
bitwise the synchronous one; prefetched batches intact while the caching
allocator reuses freed memory) and the pipelined SCST iteration with a
reward on the card (CheXbert on the reward worker's stream, the serial
path's rewards). Run them on the card
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
    pack_kernel_prefix, quantize_cache_rows,
)
from vilmedic_torch.models.vision_language import VisionLanguage, make_vl_generate_fn
from vilmedic_torch.ops import flash_attention as fa
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


def _ancestry_mask(groups: int, rows: int, t: int, gen, dense: bool = False):
    """One ancestor slot per (row, t), as beam search leaves it; or every
    slot live (``dense``: 8 positions at 8 rows fill one 64-key tile)."""
    if dense:
        return torch.ones(groups, rows, t * rows, dtype=torch.bool)
    j = torch.randint(0, rows, (groups, rows, t), generator=gen)
    mask = torch.zeros(groups, rows, t, rows, dtype=torch.bool)
    mask.scatter_(3, j[..., None], True)
    return mask.view(groups, rows, t * rows)


def _stage_matches(stage: str, kc, vc, q, kn, vn, mask, index: int, prefix=None, scales=None):
    """One bf16 call of stage (a), (b) (stats), (c) (int8 with stats) or (d)
    (prefix with stats) against the plain version on the same inputs: out
    within 2e-2, m within 1e-5, l within 1e-4 relative, the caches bitwise,
    this step's write bitwise (int8: also against the CPU's quantization)."""
    n, heads, d = q.shape
    stats = stage != "a"
    kc1, vc1, kc2, vc2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    before = fused_beam_cache_attention.launches
    got = fused_beam_cache_attention(kc1, vc1, q, kn, vn, mask, index, stats, kv_scales=scales,
                                     prefix=prefix)
    want = fused_beam_cache_attention_reference(kc2, vc2, q, kn, vn, mask, index, stats,
                                                kv_scales=scales, prefix=prefix)
    assert fused_beam_cache_attention.launches - before == 1
    got, want = (x if stats else (x,) for x in (got, want))
    torch.testing.assert_close(got[0], want[0], rtol=2e-2, atol=2e-2)
    if stats:
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)
        assert ((got[2] - want[2]).abs() / want[2]).max().item() <= 1e-4
    assert torch.equal(kc1, kc2) and torch.equal(vc1, vc2)
    if scales is None:
        assert torch.equal(kc1[index], kn.reshape(n, -1))
        assert torch.equal(vc1[index], vn.reshape(n, -1))
    else:
        cpu = quantize_cache_rows(kn.float().cpu(), scales[0].cpu().view(heads, d))
        assert torch.equal(kc1[index].cpu(), cpu.view(n, -1))


def _stage_tensors(cuda, stage, t, n, heads, d, beams, gen, p=0, p_real=0):
    """bf16 q/k_new/v_new and caches for a stage: int8 caches and scales
    for (c), a (n / beams, p, H*D) prefix with ``p_real`` keys (a NaN tail)
    for (d)."""
    q, kn, vn = (torch.randn(n, heads, d, generator=gen).to(cuda, torch.bfloat16)
                 for _ in range(3))
    scales = prefix = None
    if stage == "c":
        kc, vc = (torch.randint(-127, 128, (t, n, heads * d), generator=gen, dtype=torch.int8)
                  .to(cuda) for _ in range(2))
        scales = ((torch.rand(2, heads * d, generator=gen) * 1.5 + 0.5) / 127.0).to(cuda)
    else:
        kc, vc = (torch.randn(t, n, heads * d, generator=gen).to(cuda, torch.bfloat16)
                  for _ in range(2))
    if stage == "d":
        pk, pv = (torch.randn(n // beams, p, heads * d, generator=gen).to(cuda, torch.bfloat16)
                  for _ in range(2))
        pk[:, p_real:], pv[:, p_real:] = float("nan"), 1e9
        prefix = KernelPrefix(pk, pv, p_real, beams)
    return kc, vc, q, kn, vn, scales, prefix


@pytest.mark.parametrize("stage", ["a", "b", "c", "d"])
@pytest.mark.parametrize("n", [128, 1024])
@pytest.mark.parametrize("index,dense", [(0, False), (1, False), (8, True), (9, True),
                                         (57, False), (99, False)])
def test_beam_cache_attention_decode_shapes(cuda, stage, n, index, dense):
    """The bf16 kernel at the decode shapes: T 100, 12 heads of 64, beam 8,
    N 128 (the VisionLanguage batch, split across CTAs of a cluster) and
    1024 (the RRG batch); index 0 (the current lane alone), 1, 8 and 9 with
    every slot live (64 lanes fill one tile exactly, 72 need a second), 57
    and 99 under beam-search ancestry. Stage (d): a 1370-position prefix
    whose last 33 keys are not real (N 128), or 200 with 150 real (N 1024)."""
    gen = torch.Generator().manual_seed(n + index + ord(stage))
    p, p_real = (1370, 1337) if n == 128 else (200, 150)
    kc, vc, q, kn, vn, scales, prefix = _stage_tensors(cuda, stage, 100, n, 12, 64, 8, gen,
                                                       p, p_real)
    mask = _ancestry_mask(n // 8, 8, 100, gen, dense).to(cuda)
    _stage_matches(stage, kc, vc, q, kn, vn, mask, index, prefix, scales)


@pytest.mark.parametrize("stage", ["a", "b", "c", "d"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("beams,items", [(8, 1), (4, 1), (4, 2), (8, 2), (3, 7), (2, 1), (2, 8)])
def test_beam_cache_attention_groups(cuda, stage, d, beams, items):
    """The bf16 kernel at every head dim it is built for, beam 4 and 8, one
    or two items per row group (``ancestry_group_items`` 2: two items' rows
    in one 16-row block, each seeing its own prefix), 21-row groups of
    beam 3 (a block of 16 rows and one of 5, items across the block edge, a
    mask read byte by byte), and beam 2 (the RRS_HF Validator's) with one
    item per 2-row group and eight per 16-row group (16 items, so that the
    rows fill whole groups)."""
    gen = torch.Generator().manual_seed(d + beams + items + ord(stage))
    rows, t, index = beams * items, 20, 17
    n_items = 14 if (14 * beams) % rows == 0 else 16
    n = n_items * beams
    kc, vc, q, kn, vn, scales, prefix = _stage_tensors(cuda, stage, t, n, 3, d, beams, gen,
                                                       100, 77)
    mask = _ancestry_mask(n // rows, rows, t, gen).to(cuda)
    _stage_matches(stage, kc, vc, q, kn, vn, mask, index, prefix, scales)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 48, 96])
@pytest.mark.parametrize("tq,tk,causal", [(70, 200, True), (130, 130, False)])
def test_flash_padded_head_dims(cuda, dtype, d, tq, tk, causal):
    """Head dims the kernels are not built for run at the next built one
    (zero columns, the true scale): K4, K4 with LSE and K5 launch, and match
    the plain versions at the head dim itself."""
    b, heads = 2, 3
    gen = torch.Generator().manual_seed(d + tq)
    q = torch.randn(b, tq, heads, d, generator=gen).to(cuda, dtype)
    k, v = (torch.randn(b, tk, heads, d, generator=gen).to(cuda, dtype) for _ in range(2))
    key_mask = torch.ones(b, tk, dtype=torch.bool)
    key_mask[1, tk - tk // 3:] = False
    key_mask = key_mask.to(cuda)
    counters = (flash_attention, flash_attention_with_lse, flash_attention_bwd_dq,
                flash_attention_bwd_dkv)
    start = [fn.launches for fn in counters]
    out = flash_attention(q, k, v, key_mask, causal)
    assert out.shape == q.shape and out.is_contiguous()
    torch.testing.assert_close(out.float(), flash_attention_reference(q, k, v, key_mask, causal)
                               .float(), rtol=TOL[dtype], atol=TOL[dtype])
    _flash_grads_match(q, k, v, key_mask, causal)
    assert [fn.launches - s for fn, s in zip(counters, start)] == [1, 1, 1, 1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [160, 192, 256, 320, 384, 448, 512, 1000])
@pytest.mark.parametrize("tq,tk,causal", [(70, 200, True), (130, 130, False), (300, 100, True)])
def test_flash_wide_head_dims(cuda, dtype, d, tq, tk, causal):
    """Head dims above 128, which JAX's v1 kernel takes: D 160 and 192 run
    padded to 256; bf16 on the wgmma kernels of ``flash_attention_wide_tc.cu``
    at every width (256 and 320 one CTA a row block; 384, 448 padded to 512,
    and 512 a pair of CTAs that split the head dim; 1000 padded to 1024,
    four), f32 at all of them on the three-pass TF32 kernels of
    ``flash_attention_f32_split.cu`` (160 padded to 192 and 192 as three
    64-column shares of a cluster, 1000 padded to 1024 as sixteen).
    K4, K4 with LSE and K5 launch, only on those entries, and match the
    plain versions at the head dim itself, ragged on both axes, with rows
    that see no key."""
    b, heads = 2, 3
    entries = dict(fa.ENTRY_LAUNCHES)
    gen = torch.Generator().manual_seed(d + tq + causal)
    q = torch.randn(b, tq, heads, d, generator=gen).to(cuda, dtype)
    k, v = (torch.randn(b, tk, heads, d, generator=gen).to(cuda, dtype) for _ in range(2))
    key_mask = torch.ones(b, tk, dtype=torch.bool)
    key_mask[1, tk - tk // 3:] = False
    key_mask = key_mask.to(cuda)
    counters = (flash_attention, flash_attention_with_lse, flash_attention_bwd_dq,
                flash_attention_bwd_dkv)
    start = [fn.launches for fn in counters]
    for km in (None, key_mask):
        out = flash_attention(q, k, v, km, causal)
        assert out.shape == q.shape and out.dtype == dtype and out.is_contiguous()
        torch.testing.assert_close(out.float(), flash_attention_reference(q, k, v, km, causal)
                                   .float(), rtol=TOL[dtype], atol=TOL[dtype])
        _flash_grads_match(q, k, v, km, causal)
    assert [fn.launches - s for fn, s in zip(counters, start)] == [2, 2, 2, 2]
    route = "wide_tc" if dtype == torch.bfloat16 else "f32_split"
    launched = {e: n - entries.get(e, 0) for e, n in fa.ENTRY_LAUNCHES.items()
                if n != entries.get(e, 0)}
    assert launched == {f"vt_flash_attention_{route}": 4, f"vt_flash_attention_bwd_dq_{route}": 2,
                        f"vt_flash_attention_bwd_dkv_{route}": 2}


@pytest.mark.parametrize("d,tq,tk", [(704, 300, 100), (1600, 130, 130), (2560, 70, 200),
                                     (2600, 130, 70), (5120, 70, 130)])
def test_flash_wide_clusters_of_three_to_sixteen(cuda, d, tq, tk):
    """bf16 heads that 3 (704 padded to 768), 5 (1600), 8 (2560), 9 (2600
    padded to 2880) and 16 (5120) CTAs split, above 8 as non-portable
    clusters, whose partial scores are read through distributed shared
    memory and summed in rank order: K4, K4 with LSE and K5 match the plain
    versions, causal with a key mask, on the wgmma entries only."""
    gen = torch.Generator().manual_seed(d + tq)
    q = torch.randn(2, tq, 3, d, generator=gen).to(cuda, torch.bfloat16)
    k, v = (torch.randn(2, tk, 3, d, generator=gen).to(cuda, torch.bfloat16) for _ in range(2))
    key_mask = torch.ones(2, tk, dtype=torch.bool)
    key_mask[1, tk - tk // 3:] = False
    entries = dict(fa.ENTRY_LAUNCHES)
    _flash_grads_match(q, k, v, key_mask.to(cuda), True)
    launched = {e for e, n in fa.ENTRY_LAUNCHES.items() if n != entries.get(e, 0)}
    assert launched == {"vt_flash_attention_wide_tc", "vt_flash_attention_bwd_dq_wide_tc",
                        "vt_flash_attention_bwd_dkv_wide_tc"}


@pytest.mark.parametrize("d,tq,tk", [(128, 300, 100), (192, 70, 200), (320, 300, 100),
                                     (512, 130, 200), (576, 200, 70), (1024, 70, 130)])
def test_flash_f32_split_clusters_of_two_to_sixteen(cuda, monkeypatch, d, tq, tk):
    """f32 heads split across clusters of 2 (D 128 routed to the split
    kernels here: the public route gives it one CTA of
    ``flash_attention_f32.cu``, and splits f32 only from 192), 3, 5, 8, 9
    (a non-portable cluster) and 16 CTAs of 64 columns, three TF32 passes,
    partial scores summed over the cluster each tile: K4 with LSE and K5
    (out, lse, dq, dk, dv, dbias) match the plain versions within the f32
    bounds, causal with a key mask, Tq != Tk, on the split entries only;
    two runs agree bit for bit (no atomics, fixed sum order)."""
    if d == 128:
        route = fa.kernel_route
        monkeypatch.setattr(fa, "kernel_route", lambda dtype, width: "f32_split"
                            if dtype == torch.float32 and width == 128 else route(dtype, width))
    gen = torch.Generator().manual_seed(d + tq + 23)
    q, dout = (torch.randn(2, tq, 3, d, generator=gen).to(cuda) for _ in range(2))
    k, v = (torch.randn(2, tk, 3, d, generator=gen).to(cuda) for _ in range(2))
    key_mask = torch.ones(2, tk, dtype=torch.bool)
    key_mask[1, tk - tk // 3:] = False
    key_mask = key_mask.to(cuda)
    entries = dict(fa.ENTRY_LAUNCHES)
    _flash_grads_match(q, k, v, key_mask, True)
    runs = []
    for _ in range(2):
        out, lse = flash_attention_with_lse(q, k, v, key_mask, True)
        runs.append((out, lse) + tuple(flash_attention_backward(q, k, v, key_mask, out, lse,
                                                                dout, True)))
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv", "dbias"), *runs):
        assert torch.equal(a, b), name
    launched = {e: n - entries.get(e, 0) for e, n in fa.ENTRY_LAUNCHES.items()
                if n != entries.get(e, 0)}
    assert launched == {"vt_flash_attention_f32_split": 3,
                        "vt_flash_attention_bwd_dq_f32_split": 3,
                        "vt_flash_attention_bwd_dkv_f32_split": 3}


def test_flash_f32_above_1024_runs_on_the_cuda_cores(cuda):
    """An f32 head wider than 16 shares of 64 columns (1088) runs on
    ``flash_attention_gemm.cu``'s f32 entries (three TF32 passes on the
    tensor cores, no longer the CUDA cores): K4, K4 with LSE and K5 against
    the plain versions, causal with padded keys."""
    gen = torch.Generator().manual_seed(1088)
    q, k, v = (torch.randn(1, 96, 2, 1088, generator=gen).to(cuda) for _ in range(3))
    key_mask = torch.ones(1, 96, dtype=torch.bool, device=cuda)
    key_mask[0, 80:] = False
    entries = dict(fa.ENTRY_LAUNCHES)
    out = flash_attention(q, k, v, key_mask, True)
    torch.testing.assert_close(out, flash_attention_reference(q, k, v, key_mask, True),
                               rtol=TOL[torch.float32], atol=TOL[torch.float32])
    _flash_grads_match(q, k, v, key_mask, True)
    launched = {e: n - entries.get(e, 0) for e, n in fa.ENTRY_LAUNCHES.items()
                if n != entries.get(e, 0)}
    assert launched == {"vt_flash_attention_wide": 2, "vt_flash_attention_bwd_dq_wide": 1,
                        "vt_flash_attention_bwd_dkv_wide": 1}


def test_flash_refuses_bf16_heads_above_5120(cuda):
    """No head dim is refused. A bf16 head above 5120, wider than the 16
    CTAs of Hopper's largest cluster split, runs on the tensor cores
    (``flash_attention_gemm.cu``'s bf16 entries, bf16's rounding points):
    D 5184 at B 1, T 96, one head, causal with padded keys, K4, K4 with LSE
    and K5 against the plain versions; f32 takes such a head as before."""
    gen = torch.Generator().manual_seed(5184)
    q, k, v = (torch.randn(1, 96, 1, 5184, generator=gen).to(cuda, torch.bfloat16)
               for _ in range(3))
    key_mask = torch.ones(1, 96, dtype=torch.bool, device=cuda)
    key_mask[0, 80:] = False
    entries = dict(fa.ENTRY_LAUNCHES)
    out = flash_attention(q, k, v, key_mask, True)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), flash_attention_reference(q, k, v, key_mask, True)
                               .float(), rtol=TOL[torch.bfloat16], atol=TOL[torch.bfloat16])
    _flash_grads_match(q, k, v, key_mask, True)
    launched = {e: n - entries.get(e, 0) for e, n in fa.ENTRY_LAUNCHES.items()
                if n != entries.get(e, 0)}
    assert launched == {"vt_flash_attention_wide_bf16": 2,
                        "vt_flash_attention_bwd_dq_wide_bf16": 1,
                        "vt_flash_attention_bwd_dkv_wide_bf16": 1}
    q = torch.randn(1, 64, 1, 5200, device=cuda)
    out = flash_attention(q, q, q)
    torch.testing.assert_close(out, flash_attention_reference(q, q, q), rtol=TOL[torch.float32],
                               atol=TOL[torch.float32])


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 5184), (torch.float32, 1088)])
@pytest.mark.parametrize("tq,tk", [(300, 260), (260, 300)])
def test_flash_gemm_routes_in_chunks(cuda, monkeypatch, dtype, d, tq, tk):
    """The GEMM routes with the workspace cap forced so low that every
    entry takes its axis in 64-row chunks (5 of each): K4 with LSE and K5
    match the plain versions, causal with a key mask, with Tq > Tk and Tq <
    Tk, on the route's three entries, and two runs agree bit for bit (no
    atomics, fixed sum order)."""
    monkeypatch.setattr(fa, "WORKSPACE_CAP", 1 << 18)
    gen = torch.Generator().manual_seed(d + tq)
    q, dout = (torch.randn(2, tq, 3, d, generator=gen).to(cuda, dtype) for _ in range(2))
    k, v = (torch.randn(2, tk, 3, d, generator=gen).to(cuda, dtype) for _ in range(2))
    key_mask = torch.ones(2, tk, dtype=torch.bool)
    key_mask[1, tk - tk // 3:] = False
    key_mask = key_mask.to(cuda)
    entries = dict(fa.ENTRY_LAUNCHES)
    _flash_grads_match(q, k, v, key_mask, True)
    runs = []
    for _ in range(2):
        out, lse = flash_attention_with_lse(q, k, v, key_mask, True)
        runs.append((out, lse) + tuple(flash_attention_backward(q, k, v, key_mask, out, lse,
                                                                dout, True)))
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv", "dbias"), *runs):
        assert torch.equal(a, b), name
    route = fa.kernel_route(dtype, d)
    launched = {e: n - entries.get(e, 0) for e, n in fa.ENTRY_LAUNCHES.items()
                if n != entries.get(e, 0)}
    assert launched == {f"vt_flash_attention_{route}": 3, f"vt_flash_attention_bwd_dq_{route}": 3,
                        f"vt_flash_attention_bwd_dkv_{route}": 3}


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_f32_runs_three_tf32_passes_deterministically(cuda, d):
    """f32 up to head dim 128 runs ``flash_attention_f32.cu`` (wgmma, three
    TF32 passes) and nothing else: K4 with LSE and K5, causal with a key
    mask and ragged tiles, match the plain versions, and two runs of each
    agree bit for bit (no atomics, fixed sum order)."""
    gen = torch.Generator().manual_seed(40 + d)
    q, k, v, dout = (torch.randn(2, 300, 3, d, generator=gen).to(cuda) for _ in range(4))
    key_mask = torch.ones(2, 300, dtype=torch.bool, device=cuda)
    key_mask[1, 250:] = False
    entries = dict(fa.ENTRY_LAUNCHES)
    _flash_grads_match(q, k, v, key_mask, True)
    runs = []
    for _ in range(2):
        out, lse = flash_attention_with_lse(q, k, v, key_mask, True)
        runs.append((out, lse) + tuple(flash_attention_backward(q, k, v, key_mask, out, lse,
                                                                dout, True)))
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv", "dbias"), *runs):
        assert torch.equal(a, b), name
    launched = {e: n - entries.get(e, 0) for e, n in fa.ENTRY_LAUNCHES.items()
                if n != entries.get(e, 0)}
    assert launched == {"vt_flash_attention_f32": 3, "vt_flash_attention_bwd_dq_f32": 3,
                        "vt_flash_attention_bwd_dkv_f32": 3}


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


@pytest.mark.parametrize("d", [256, 320, 384, 512, 2600])
def test_flash_wide_backward_is_deterministic(cuda, d):
    """The wide-head backward (``flash_attention_wide_tc.cu``: the dk/dv
    kernel's two warpgroups hand P^T over in shared memory; at 384 and 512
    a pair of CTAs, at 2600 nine, sums its partial scores in rank order)
    writes every output element from one block in a fixed order: two runs of
    the causal backward with a key mask agree bit for bit, and both ran its
    kernels."""
    gen = torch.Generator().manual_seed(12 + d)
    q, k, v, dout = (torch.randn(2, 300, 3, d, generator=gen).to(cuda, torch.bfloat16)
                     for _ in range(4))
    key_mask = torch.ones(2, 300, dtype=torch.bool, device=cuda)
    key_mask[1, 250:] = False
    out, lse = flash_attention_with_lse(q, k, v, key_mask, True)
    start = dict(fa.ENTRY_LAUNCHES)
    first = flash_attention_backward(q, k, v, key_mask, out, lse, dout, True)
    second = flash_attention_backward(q, k, v, key_mask, out, lse, dout, True)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), first, second):
        assert torch.equal(a, b), name
    for entry in ("vt_flash_attention_bwd_dq_wide_tc", "vt_flash_attention_bwd_dkv_wide_tc"):
        assert fa.ENTRY_LAUNCHES.get(entry, 0) - start.get(entry, 0) == 2, entry


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
def test_flash_backward_tower_length(cuda, dtype):
    """The unfrozen DINOv2 tower's attention at 518² / 14: T 1370 = 21 x 64
    + 26 (a ragged last tile), B 2, 12 heads of 64, non-causal, no padding:
    K4 with LSE and K5 against their plain versions."""
    b, t, heads, d = 2, 1370, 12, 64
    gen = torch.Generator().manual_seed(8)
    q, k, v = (torch.randn(b, t, heads, d, generator=gen).to(cuda, dtype) for _ in range(3))
    _flash_grads_match(q, k, v, None, False)


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
    with pytest.raises(ValueError):  # dO in another dtype than q, k, v
        flash_attention_bwd_dkv(q, q, q, None, q.bfloat16(), stats, stats)
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


def test_unfrozen_dinov2_step_card_equals_cpu(cuda):
    """f32, dropout off: an unfrozen DINOv2 tower (``VisualEncoder``, 577
    tokens at 96² / 4, so its attention takes K4 with LSE and K5,
    non-causal) takes one gradient on the card equal to the CPU's."""
    from vilmedic_torch.blocks.vision.visual_encoder import build_visual_encoder

    block = dict(backbone="dinov2", freeze=False, permute="no_permute", hidden_size=128,
                 num_hidden_layers=2, num_attention_heads=2, patch_size=4, image_size=96)
    gen = torch.Generator().manual_seed(4)
    images = torch.randn(2, 3, 96, 96, generator=gen)
    proj = torch.randn(2, 577, 128, generator=gen)
    torch.manual_seed(0)
    enc = build_visual_encoder(dict(block))
    state = {k: x.clone() for k, x in enc.state_dict().items()}
    grads = {}
    for device in ("cpu", cuda):
        enc = build_visual_encoder(dict(block)).to(device)
        enc.load_state_dict(state)
        start = flash_attention_bwd_dkv.launches
        out = enc(images.to(device), train=True, generator=torch.Generator(device).manual_seed(0))
        (out * proj.to(device)).sum().backward()
        grads[str(device)] = {n: p.grad.cpu() for n, p in enc.named_parameters()}
        launched = flash_attention_bwd_dkv.launches - start
    assert launched == 2  # one K5 dk/dv launch per tower layer on the card
    for name, want in grads["cpu"].items():
        ref = name[:-len("bias")] + "weight" if name.endswith("self_attn.k.bias") else name
        scale = grads["cpu"][ref].abs().max().item()
        assert (grads["cuda"][name] - want).abs().max().item() <= 1e-4 * scale, name


@pytest.mark.parametrize("mode", [True, "dots"])
def test_grad_checkpointing_replays_card_dropout(cuda, mode):
    """The decoder stack with dropout on, masks from a CUDA generator: with
    ``gradient_checkpointing`` the gradients and the generator's final state
    equal those without it."""
    import dataclasses

    from vilmedic_torch.blocks.transformer import TransformerConfig, TransformerDecoder

    cfg = TransformerConfig(vocab_size=50, hidden_size=64, num_hidden_layers=2,
                            num_attention_heads=2, intermediate_size=128,
                            max_position_embeddings=32, hidden_dropout_prob=0.2)
    ids = torch.randint(3, 50, (2, 9), generator=torch.Generator().manual_seed(1)).to(cuda)
    mem = torch.randn(2, 5, 64, generator=torch.Generator().manual_seed(2)).to(cuda)
    results = []
    for remat in (False, mode):
        torch.manual_seed(0)
        dec = TransformerDecoder(dataclasses.replace(cfg, gradient_checkpointing=remat)).to(cuda)
        gen = torch.Generator(cuda).manual_seed(7)
        dec(ids, torch.ones_like(ids), mem, torch.ones(2, 5, dtype=torch.long, device=cuda),
            mode="train", train=True, generator=gen).square().mean().backward()
        results.append(({n: p.grad.cpu() for n, p in dec.named_parameters()}, gen.get_state()))
    (want, want_state), (got, got_state) = results
    assert torch.equal(got_state, want_state)
    for name, w in want.items():
        scale = max(w.abs().max().item(), 1e-30)
        assert (got[name] - w).abs().max().item() <= 1e-6 * scale, name


def test_bertscore_card_equals_cpu(cuda, tmp_path):
    """BERTScore P / R / F with the port's encoder on the card equal the
    CPU's within 1e-5, for a BERT and a DistilBERT directory written here
    (random weights, a ``pytorch_model.bin``)."""
    import json

    from vilmedic_torch.scorers.bert_encoder import BertEncoder
    from vilmedic_torch.scorers.bertscore_impl import bert_score_prf

    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "lungs", "are", "clear",
             "no", "effusion", "mild", "edema", ",", "."]
    refs = ["the lungs are clear.", "mild edema, no effusion", "no effusion"]
    hyps = ["lungs clear", "no edema", "the lungs are clear, no effusion."]
    configs = {
        "bert": dict(model_type="bert", vocab_size=len(words), hidden_size=32,
                     num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
                     max_position_embeddings=64),
        "distilbert": dict(model_type="distilbert", vocab_size=len(words), dim=32, n_layers=2,
                           n_heads=2, hidden_dim=64, max_position_embeddings=64),
    }
    for kind, cfg in configs.items():
        folder = tmp_path / kind
        folder.mkdir()
        (folder / "config.json").write_text(json.dumps(cfg))
        (folder / "vocab.txt").write_text("\n".join(words))
        torch.manual_seed(0)
        torch.save(BertEncoder(cfg).state_dict(), folder / "pytorch_model.bin")
        want = bert_score_prf(str(folder), refs, hyps, rescale_with_baseline=False, device="cpu")
        got = bert_score_prf(str(folder), refs, hyps, rescale_with_baseline=False, device=cuda)
        for g, w in zip(got, want):
            assert max(abs(a - b) for a, b in zip(g, w)) <= 1e-5, kind


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 5, 130])
@pytest.mark.parametrize("k", [32, 64, 96, 768])
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


@pytest.mark.parametrize("n", [1, 128, 1000, 1024])
def test_blocked_lm_head_decode_shapes(cuda, n):
    """The bf16 kernel at the flagship head (K 768, vocab 50265 padded to
    50304: 393 blocks of 128, an odd count) for one row, the VisionLanguage
    and RRG beam batches and a ragged 1000; one launch each."""
    vocab, vp, k = 50265, 50304, 768
    gen = torch.Generator().manual_seed(n)
    w = torch.randn(vp, k, generator=gen) * 0.02
    w[vocab:] = 0.0
    b = torch.randn(vp, generator=gen) * 0.02
    b[vocab:] = NEG
    h = torch.randn(n, k, generator=gen).to(cuda, torch.bfloat16)
    w, b = w.to(cuda, torch.bfloat16), b.to(cuda)
    before = lm_head_blocked_stats.launches
    got = lm_head_blocked_stats(h, w, b)
    assert lm_head_blocked_stats.launches - before == 1
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


@pytest.mark.parametrize("b", [1, 16, 128])
@pytest.mark.parametrize("r,crop", [(256, 224), (224, 224), (256, 223), (40, 32)])
def test_crop_normalize_shapes(cuda, b, r, crop):
    """Bitwise the plain version: in-range, negative (from the end) and
    out-of-range (clamped) offsets; a crop that is not a multiple of 4 (the
    scalar tail path); the serving path's uncropped R = crop."""
    gen = torch.Generator().manual_seed(b + r + crop)
    img = torch.randint(0, 256, (b, r, r, 3), generator=gen, dtype=torch.uint8).to(cuda)
    tops = torch.randint(-r, r + 5, (b,), generator=gen, dtype=torch.int32).to(cuda)
    lefts = torch.randint(-r, r + 5, (b,), generator=gen, dtype=torch.int32).to(cuda)
    before = crop_normalize.launches
    got = crop_normalize(img, tops, lefts, crop)
    assert crop_normalize.launches - before == 1
    assert torch.equal(got, crop_normalize_reference(img, tops, lefts, crop))


@pytest.mark.parametrize("mean,std", [(None, None), ((0.5, 0.25, 0.75), (0.2, 0.3, 0.4))])
def test_crop_normalize_table_is_the_plain_arithmetic(cuda, mean, std):
    """Every byte of every channel through the kernel (its table built in
    the kernel) and the plain version on the card: equal to the bit."""
    kw = {} if mean is None else dict(mean=mean, std=std)
    img = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    img = img[None, :, None, None].expand(1, 256, 256, 3).contiguous().to(cuda)
    zero = torch.zeros(1, dtype=torch.int32, device=cuda)
    assert torch.equal(crop_normalize(img, zero, zero, 256, **kw),
                       crop_normalize_reference(img, zero, zero, 256, **kw))


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
    with pytest.raises(ValueError):  # an empty key axis
        x = torch.zeros(1, 0, 2, 64, device=cuda)
        flash_attention(q, x, x)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 127, 1024])
@pytest.mark.parametrize("r", [1, 16, 32])
def test_fused_lm_head_decode_shapes(cuda, dtype, n, r):
    """The flagship head (H 768, vocab 50265 padded to 51200): one row, a
    ragged row tile, and the RRG batch of 128 x beam 8, where a bf16 unit
    walks many vocab tiles behind its threshold."""
    h, w, b = _head(cuda, n, 768, 50265, 2048, n + r, dtype)
    vals, idx, lse = lm_head_topk_lse(h, w, b, r, 2048)
    logits = h.float() @ w.float() + b
    assert topk_agrees(vals, idx, logits, TOL_TOPK)
    _, _, want = lm_head_topk_lse_reference(h, w, b, r, 2048)
    assert ((lse - want).abs() / want.abs()).max().item() <= TOL_LSE


@pytest.mark.parametrize("n,vocab,r", [(1024, 30000, 32), (300, 12000, 16), (1, 5000, 1)])
def test_fused_lm_head_exact_ties_across_units(cuda, n, vocab, r):
    """Exact ties (integer h and w) where a bf16 unit walks several vocab
    tiles and several units share a row: the columns equal the stable
    top-r's bitwise in both dtypes."""
    gen = torch.Generator().manual_seed(n + vocab)
    h = torch.randint(-2, 3, (n, 64), generator=gen).float()
    w, b = pad_lm_head_weights(torch.randint(-1, 2, (64, vocab), generator=gen).float(),
                               torch.zeros(vocab), 2048)
    want = lm_head_topk_lse_reference(h, w, b, r, 2048)
    for dtype in (torch.float32, torch.bfloat16):
        got = lm_head_topk_lse(h.to(cuda, dtype), w.to(cuda, dtype), b.to(cuda), r, 2048)
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
        torch.testing.assert_close(got[2].cpu(), want[2], rtol=TOL_LSE, atol=0)


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


@pytest.mark.parametrize("vocab,members", [(4500, 1), (4500, 2), (300, 1)],
                         ids=["blocked-stats", "ensemble", "plain-head"])
def test_tiny_roberta_rrg_card_equals_cpu(cuda, monkeypatch, vocab, members):
    """A RoBERTa-type decoder (the LM-head transform before every head
    route), f32: beam sequences and scores on the card equal the CPU's; K1
    once per member, layer and step, K2 (behind the transform) only for one
    member over a large vocabulary."""
    monkeypatch.setitem(tdensenet.CONFIGS, "densenet_tiny", (8, (2, 2), 16))
    decoder = dict(proto=None, model_type="roberta", hidden_size=128, num_hidden_layers=2,
                   num_attention_heads=2, intermediate_size=256, max_position_embeddings=64,
                   layer_norm_eps=1e-5, vocab_size=vocab, bos_token_id=0, eos_token_id=2,
                   pad_token_id=1)
    cnn = dict(backbone="densenet_tiny", visual_projection={"out_features": 128})
    gen = torch.Generator().manual_seed(3)
    batch = {"images_u8": torch.randint(0, 256, (3, 40, 40, 3), generator=gen,
                                        dtype=torch.uint8),
             "preproc_tops": torch.tensor([0, 3, 8], dtype=torch.int32),
             "preproc_lefts": torch.tensor([2, 0, 8], dtype=torch.int32)}
    results = {}
    for device in ("cpu", cuda):
        models = [RRG(decoder=dict(decoder), cnn=dict(cnn), device=device, seed=9 + i)
                  for i in range(members)]
        assert models[0].dec_config.lm_head_transform
        generate = make_generate_fn(models, 4, 12, 0, 2, 1)
        on = finalize_device_preproc({k: v.to(device) for k, v in batch.items()}, 32)
        start = (fused_beam_cache_attention.launches, lm_head_blocked_stats.launches)
        res = generate(models[0].encoder_inputs(on))
        results[str(device)] = (res, (fused_beam_cache_attention.launches - start[0],
                                      lm_head_blocked_stats.launches - start[1]))
    (cpu, _), (gpu, launched) = results["cpu"], results["cuda"]
    assert torch.equal(cpu.sequences, gpu.sequences.cpu())
    torch.testing.assert_close(gpu.scores.cpu(), cpu.scores, rtol=1e-4, atol=1e-4)
    k2 = gpu.steps if members == 1 and vocab >= 4096 else 0
    assert launched == (2 * members * gpu.steps, k2)


class _TinyTokenizerDL:
    class dataset:
        class tokenizer:
            vocab_size, cls_token_id, sep_token_id, pad_token_id = 4500, 2, 3, 0


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi-image"])
def test_tiny_rrg_hf_card_equals_cpu(cuda, multi):
    """RRG_HF (a post-LN ViT of 64 projected to a 2-layer decoder of 128),
    f32, on 4-D images and on (B, 2, 3, H, W) batches with one image
    masked: beam sequences and scores on the card equal the CPU's; K1 twice
    and K2 once a step; the masked image's tokens masked."""
    from vilmedic_torch.models.hf_compat import RRG_HF

    vision = {"proto_config_args": {"hidden_size": 64, "num_hidden_layers": 2,
                                    "num_attention_heads": 2, "intermediate_size": 128,
                                    "patch_size": 16, "image_size": 32}}
    decoder = {"proto_config_args": {"hidden_size": 128, "num_hidden_layers": 2,
                                     "num_attention_heads": 2, "intermediate_size": 256,
                                     "max_position_embeddings": 32}}
    gen = torch.Generator().manual_seed(4)
    shape = (3, 2, 3, 32, 32) if multi else (3, 3, 32, 32)
    images = torch.randn(*shape, generator=gen)
    batch = {"images": images}
    if multi:
        images[1, 1] = 0.0
        batch["images_mask"] = torch.tensor([[True, True], [True, False], [True, True]])
    results = {}
    for device in ("cpu", cuda):
        model = RRG_HF(vision=vision, decoder=decoder, dl=_TinyTokenizerDL(), device=device,
                       seed=11)
        on = {k: v.to(device) for k, v in batch.items()}
        _, enc_mask = model.module.encode(**model.encoder_inputs(on))
        start = (fused_beam_cache_attention.launches, lm_head_blocked_stats.launches)
        res = make_generate_fn([model], 4, 12, 2, 3, 0)(model.encoder_inputs(on))
        results[str(device)] = (res, enc_mask.cpu(), (
            fused_beam_cache_attention.launches - start[0],
            lm_head_blocked_stats.launches - start[1]))
    (cpu, cpu_mask, _), (gpu, gpu_mask, launched) = results["cpu"], results["cuda"]
    assert torch.equal(cpu.sequences, gpu.sequences.cpu())
    torch.testing.assert_close(gpu.scores.cpu(), cpu.scores, rtol=1e-4, atol=1e-4)
    assert torch.equal(cpu_mask, gpu_mask)
    assert launched == (2 * gpu.steps, gpu.steps)
    if multi:
        assert gpu_mask.shape == (3, 10) and not gpu_mask[1, 5:].any() and gpu_mask[1, :5].all()


@pytest.mark.parametrize("case", ["3d_densenet121", "slice_encode", "multi_image"])
def test_tower_paths_card_equal_cpu(cuda, case):
    """The volume, slice and multi-image paths of ``VisualEncoder.encode``,
    f32, TF32 off, the same weights: features within 1e-4 of the largest
    (cuDNN's convolution algorithms against the CPU's), equal masks."""
    from vilmedic_torch.blocks.vision.visual_encoder import build_visual_encoder
    from vilmedic_torch.models.base import init_weights_

    gen = torch.Generator().manual_seed(6)
    mask = None
    if case == "3d_densenet121":
        cfg, in_channels = dict(backbone="3d_densenet121", output_layer="avgpool"), 1
        x = torch.randn(2, 1, 32, 32, 32, generator=gen)
    elif case == "slice_encode":
        cfg = dict(backbone="densenet121", output_layer="avgpool", slice_encode=True,
                   slice_dim=1)
        in_channels, x = 1, torch.randn(2, 1, 3, 32, 32, generator=gen)
    else:
        cfg, in_channels = dict(backbone="resnet18", output_layer="layer4"), None
        x = torch.randn(2, 3, 3, 64, 64, generator=gen)
        x[1, 2] = 0.0
        mask = torch.tensor([[True, True, True], [True, True, False]])
    enc = build_visual_encoder(dict(cfg, visual_projection={"out_features": 16}),
                               in_channels=in_channels).eval()
    init_weights_(enc, torch.Generator().manual_seed(7), 0.02, lambda name: False)
    with torch.no_grad():
        want, want_mask = enc.encode(x, mask)
        got, got_mask = enc.to(cuda).encode(x.to(cuda), None if mask is None else mask.to(cuda))
    assert torch.equal(got_mask.cpu(), want_mask)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4 * want.abs().max().item())


def test_gloria_loss_card_equals_cpu(cuda):
    """GLoRIA's loss (the local loss over the (text, image) grid, ragged word
    masks) and its input gradients, f32, TF32 off: within 1e-5 relative of
    the CPU's."""
    from vilmedic_torch.blocks.losses import GLoRIALoss

    gen = torch.Generator().manual_seed(5)
    inputs = [torch.randn(8, 32, generator=gen), torch.randn(8, 16, 32, generator=gen),
              torch.randn(8, 12, 32, generator=gen), torch.randn(8, 32, generator=gen)]
    mask = (torch.arange(12)[None] < torch.tensor([12, 3, 7, 1, 12, 5, 9, 2])[:, None]).float()
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for device in ("cpu", cuda):
            xs = [x.clone().to(device).requires_grad_(True) for x in inputs]
            loss = GLoRIALoss()(*xs, mask.to(device))
            loss.backward()
            out[str(device)] = (loss.detach().cpu(), [x.grad.cpu() for x in xs])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["cuda"]
    torch.testing.assert_close(l_gpu, l_cpu, rtol=1e-5, atol=0)
    for a, b in zip(g_gpu, g_cpu):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("route,vocab,beam", [("greedy", 4500, 1), ("small vocab", 4000, 4)])
def test_tiny_vl_greedy_and_small_vocab_card_equals_cpu(cuda, route, vocab, beam):
    """The VisionLanguage routes that follow from the beam width and the
    vocabulary, f32: sequences on the card equal the CPU plain versions';
    K1 runs once per layer and step under the small-vocabulary beam search
    and never under greedy decoding."""
    tower = dict(model_type="dinov2", hidden_size=128, num_hidden_layers=2,
                 num_attention_heads=2, patch_size=8, image_size=64)
    decoder = dict(proto=None, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                   intermediate_size=192, max_position_embeddings=128, layer_norm_eps=1e-5)
    images = torch.randn(3, 3, 64, 64, generator=torch.Generator().manual_seed(4))
    results = {}
    for device in ("cpu", cuda):
        model = VisionLanguage(decoder=dict(decoder), vision={"vision_model_name": "tiny",
                                                              "image_size": 64},
                               vision_hf_config=tower, vocab_size=vocab, bos_token_id=0,
                               eos_token_id=2, pad_token_id=1, device=device, seed=6)
        generate = make_vl_generate_fn(model, beam, 12, 0, 2, 1)
        start = fused_beam_cache_attention.launches
        res = generate(images.to(device))
        results[str(device)] = (res, fused_beam_cache_attention.launches - start)
    (cpu, _), (gpu, launched) = results["cpu"], results["cuda"]
    assert torch.equal(cpu.sequences, gpu.sequences.cpu())
    assert launched == (2 * gpu.steps if beam > 1 else 0)


def test_tiny_rrg_training_card_equals_cpu(cuda, monkeypatch):
    """Three RAdam steps of a small RRG in training mode (DenseNet with
    batch-statistics BatchNorm, uint8 images through the crop+normalize
    kernel on the card), f32, dropout 0: losses within 1e-5 relative,
    parameters within 1e-6 and running statistics within 1e-5 of the CPU's,
    from the same seed."""
    from vilmedic_torch.config.config import Config
    from vilmedic_torch.executors import Trainor

    monkeypatch.setitem(tdensenet.CONFIGS, "densenet_tiny", (8, (2, 2), 16))
    decoder = dict(proto=None, hidden_size=128, num_hidden_layers=1, num_attention_heads=2,
                   intermediate_size=256, max_position_embeddings=64, layer_norm_eps=1e-5,
                   vocab_size=4500, bos_token_id=0, eos_token_id=2, pad_token_id=1,
                   hidden_dropout_prob=0.0)
    config = Config({"model": {"proto": "RRG", "decoder": decoder, "dtype": "float32",
                               "cnn": {"backbone": "densenet_tiny",
                                       "visual_projection": {"out_features": 128}}},
                     "optimizer": "RAdam", "optim_params": {"lr": 1e-3}, "epochs": 0})
    gen = torch.Generator().manual_seed(8)
    ids = torch.randint(3, 4500, (4, 16), generator=gen)
    ids[:, 0] = 0
    mask = torch.ones(4, 16, dtype=torch.long)
    mask[2, 10:] = 0
    batch = {"images_u8": torch.randint(0, 256, (4, 32, 32, 3), generator=gen,
                                        dtype=torch.uint8),
             "preproc_tops": torch.zeros(4, dtype=torch.int32),
             "preproc_lefts": torch.zeros(4, dtype=torch.int32),
             "input_ids": ids, "attention_mask": mask}
    results = {}
    for device in ("cpu", cuda):
        trainer = Trainor(config, seed=3, loader=[batch], device=device)
        on = finalize_device_preproc({k: v.to(device) for k, v in batch.items()}, 32)
        losses = [trainer.train_step(on, 1e-3).item() for _ in range(3)]
        results[str(device)] = (losses, {k: v.cpu() for k, v in
                                         trainer.model.module.state_dict().items()})
    (l_cpu, s_cpu), (l_gpu, s_gpu) = results["cpu"], results["cuda"]
    for a, b in zip(l_gpu, l_cpu):
        assert abs(a - b) <= 1e-5 * abs(b)
    for name, want in s_cpu.items():
        tol = 1e-5 if "running" in name else 1e-6
        assert (s_gpu[name] - want).abs().max().item() <= tol, name


def test_sampler_on_the_card(cuda):
    """The port's own sampler on the card: 200000 draws of one row under
    top-k 4 and two bad words stay in the 5-token support (a tie at the
    4th value) with frequencies within 5 standard errors (and 0.006) of the
    renormalized softmax; the same noise gives the same tokens as the CPU."""
    from vilmedic_torch.decoding import decode

    logits = torch.tensor([[2.0, -1.0, 1.5, 0.3, 0.3, 1.0, -0.5, 0.3, 3.0, -2.0]])
    n = 200_000
    rows = logits.to(cuda).expand(n, -1)
    draws = decode._categorical(decode._warp(rows, (8, 0), 4),
                                torch.Generator(device=cuda).manual_seed(0)).cpu()
    support = torch.zeros(10, dtype=torch.bool)
    support[[2, 3, 4, 5, 7]] = True
    p = torch.where(support, torch.softmax(torch.where(support, logits[0], -torch.inf), -1), 0.0)
    freq = torch.bincount(draws, minlength=10).double() / n
    assert set(draws.unique().tolist()) == {2, 3, 4, 5, 7}
    se = torch.sqrt(p * (1 - p) / n)
    assert ((freq - p).abs() <= torch.maximum(5 * se, torch.tensor(0.006))).all(), (freq, p)
    wide = torch.randn(6, 5000, generator=torch.Generator().manual_seed(1)) * 3
    noise = decode.gumbel_noise((6, 5000), torch.Generator().manual_seed(2), "cpu")
    picks = [(decode._warp(wide.to(d), (1, 0), 25) + noise.to(d)).argmax(-1).cpu()
             for d in ("cpu", cuda)]
    assert torch.equal(*picks)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("index", [0, 1, 57, 79])
def test_kernels_at_rrs_shapes(cuda, dtype, index):
    """K1 stage (a) at RRS's Validator shape (N 128 = 16 x beam 8, T 80, 12
    heads of 64) and K2 at N 128 over a built vocabulary of 4600 padded to
    4608, against their plain versions."""
    gen = torch.Generator().manual_seed(index)
    t, n, heads, d, rows = 80, 128, 12, 64, 8
    kc = torch.randn(t, n, heads * d, generator=gen).to(cuda, dtype)
    vc = torch.randn(t, n, heads * d, generator=gen).to(cuda, dtype)
    q, kn, vn = (torch.randn(n, heads, d, generator=gen).to(cuda, dtype) for _ in range(3))
    j = torch.randint(0, rows, (n // rows, rows, t), generator=gen)
    mask = torch.zeros(n // rows, rows, t, rows, dtype=torch.bool)
    mask.scatter_(3, j[..., None], True)
    mask = mask.view(n // rows, rows, t * rows).to(cuda)
    kc2, vc2 = kc.clone(), vc.clone()
    out = fused_beam_cache_attention(kc, vc, q, kn, vn, mask, index)
    ref = fused_beam_cache_attention_reference(kc2, vc2, q, kn, vn, mask, index)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
    vocab, vp = 4600, 4608
    w = torch.randn(vp, 768, generator=gen) * 0.02
    w[vocab:] = 0
    b = torch.randn(vp, generator=gen) * 0.02
    b[vocab:] = NEG
    h = torch.randn(n, 768, generator=gen)
    args = (h.to(cuda, dtype), w.to(cuda, dtype), b.to(cuda))
    lg, mx, sm = lm_head_blocked_stats(*args)
    rlg, rmx, rsm = lm_head_blocked_stats_reference(*args)
    assert max((lg - rlg).abs().max().item(), (mx - rmx).abs().max().item()) <= 1e-4
    assert ((sm - rsm).abs() / rsm).max().item() <= 1e-4


def _rrs_corpus(root):
    words = [f"w{i}" for i in range(60)]
    gen = torch.Generator().manual_seed(0)
    for split in ("train", "validate"):
        for kind, lo, hi in (("findings", 8, 20), ("impression", 2, 6)):
            lines = [" ".join(words[int(k)] for k in torch.randint(0, 60, (int(length),),
                                                                   generator=gen)) + " ."
                     for length in torch.randint(lo, hi, (8,), generator=gen)]
            (root / f"{split}.{kind}.tok").write_text("\n".join(lines))


def _tiny_rrs_config(root, ckpt_dir, proto):
    from vilmedic_torch.config.config import Config

    block = dict(proto=None, hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                 intermediate_size=128, max_position_embeddings=32, hidden_dropout_prob=0.0)
    return Config({
        "ckpt_dir": str(ckpt_dir), "seed": 0,
        "dataset": {"proto": "Seq2Seq",
                    "src": {"root": str(root), "file": "findings.tok", "tokenizer_max_len": 24},
                    "tgt": {"root": str(root), "file": "impression.tok", "tokenizer_max_len": 10},
                    "num_workers": 0},
        "model": {"proto": proto, "encoder": dict(block), "decoder": dict(block),
                  "dtype": "float32", "scores": "rougel", "top_k": 5},
        "batch_size": 4, "optimizer": "RAdam", "optim_params": {"lr": 1e-3}, "epochs": 0,
        "beam_width": 4, "splits": ["validate"], "metrics": ["ROUGEL"]})


def test_tiny_rrs_scst_iteration_card_equals_cpu(cuda, tmp_path, monkeypatch):
    """One RRS_SCST iteration of a small model, f32, the same weights and
    Gumbel draws on both devices: equal greedy and sampled ids and rewards,
    the loss within 1e-5 relative, parameters within 1e-6 after RAdam's
    first update, lr x the gradient (Adam's would divide each gradient
    entry by its own size, so an entry near 0 would turn rounding into a
    full step)."""
    from vilmedic_torch.decoding import decode
    from vilmedic_torch.executors import Trainor

    _rrs_corpus(tmp_path)
    real = decode.gumbel_noise
    results = {}
    for device in ("cpu", cuda):
        calls = []

        def noise(shape, generator, dev):
            calls.append(1)
            return real(shape, torch.Generator().manual_seed(len(calls)), "cpu").to(dev)

        monkeypatch.setattr(decode, "gumbel_noise", noise)
        (tmp_path / str(device)).mkdir()
        trainer = Trainor(_tiny_rrs_config(tmp_path, tmp_path / str(device), "RRS_SCST"),
                          seed=3, device=device)
        batch = trainer._model_batch(next(iter(trainer.dl)))
        loss, _ = trainer.model.train_iteration(trainer, batch, 1e-3)
        results[str(device)] = (dict(trainer.model.last), float(loss),
                                {k: v.cpu() for k, v in trainer.model.module.state_dict().items()})
    (cpu, l_cpu, s_cpu), (gpu, l_gpu, s_gpu) = results["cpu"], results["cuda"]
    for key in ("greedy", "sampled"):
        assert (cpu[key] == gpu[key]).all()
    for a, b in zip(cpu["reward_greedy"] + cpu["reward_sampling"],
                    gpu["reward_greedy"] + gpu["reward_sampling"]):
        assert (a == b).all()
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    for name, want in s_cpu.items():
        assert (s_gpu[name] - want).abs().max().item() <= 1e-6, name


def test_tiny_rrs_beam_card_equals_cpu(cuda):
    """A small RRS at beam 4 over a target vocabulary of 4500, f32: equal
    sequences on both devices; on the card K1 once per layer and step, K2
    once per step."""
    from vilmedic_torch.models.rrs import RRS

    block = dict(proto=None, hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                 intermediate_size=128, max_position_embeddings=32)
    gen = torch.Generator().manual_seed(5)
    ids = torch.randint(5, 97, (3, 12), generator=gen)
    mask = torch.ones(3, 12, dtype=torch.long)
    mask[1, 8:] = 0
    results = {}
    for device in ("cpu", cuda):
        model = RRS(encoder=dict(block, vocab_size=97),
                    decoder=dict(block, vocab_size=4500, bos_token_id=0, eos_token_id=2,
                                 pad_token_id=1), device=device, seed=4)
        generate = make_generate_fn([model], 4, 12, 0, 2, 1)
        start = (fused_beam_cache_attention.launches, lm_head_blocked_stats.launches)
        res = generate(model.encoder_inputs({"input_ids": ids.to(device),
                                             "attention_mask": mask.to(device)}))
        results[str(device)] = (res, (fused_beam_cache_attention.launches - start[0],
                                      lm_head_blocked_stats.launches - start[1]))
    (cpu, _), (gpu, launched) = results["cpu"], results["cuda"]
    assert torch.equal(cpu.sequences, gpu.sequences.cpu())
    assert launched == (2 * gpu.steps, gpu.steps)


def test_tiny_rrg_force_card_equals_cpu(cuda, monkeypatch):
    """Constrained greedy decoding of a small RRG_FORCE, f32: equal
    sequences on both devices, every forced token present."""
    from vilmedic_torch.models.rrg_force import RRG_FORCE, make_force_generate_fn

    monkeypatch.setitem(tdensenet.CONFIGS, "densenet_tiny", (8, (2, 2), 16))
    decoder = dict(proto=None, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                   intermediate_size=256, max_position_embeddings=64, layer_norm_eps=1e-5,
                   vocab_size=4500, bos_token_id=0, eos_token_id=2, pad_token_id=1)
    cnn = dict(backbone="densenet_tiny", visual_projection={"out_features": 128})
    gen = torch.Generator().manual_seed(6)
    images = torch.randint(0, 256, (3, 32, 32, 3), generator=gen, dtype=torch.uint8)
    force = torch.tensor([[7, 99, -1], [4000, -1, -1], [12, 13, 14]])
    seqs = {}
    for device in ("cpu", cuda):
        model = RRG_FORCE(decoder=dict(decoder), cnn=dict(cnn), device=device, seed=9)
        on = finalize_device_preproc({"images_u8": images.to(device),
                                      "preproc_tops": torch.zeros(3, dtype=torch.int32).to(device),
                                      "preproc_lefts": torch.zeros(3, dtype=torch.int32).to(device)},
                                     32)
        generate = make_force_generate_fn(model, 16, 0, 2, 1)
        seqs[str(device)] = generate(model.encoder_inputs(on), force.to(device)).sequences.cpu()
    assert torch.equal(seqs["cpu"], seqs["cuda"])
    for row, f in zip(seqs["cuda"], force):
        assert set(f[f >= 0].tolist()) <= set(row.tolist())


def test_modernbert_card_equals_cpu(cuda):
    """The ModernBERT encoder (``radevalbertscore``'s) on the card equals the
    CPU's within 1e-5 on every hidden state: a local layer whose window is
    shorter than the rows, padded rows."""
    from vilmedic_torch.scorers.modernbert import ModernBertEncoder

    cfg = dict(vocab_size=300, hidden_size=64, intermediate_size=96, num_hidden_layers=3,
               num_attention_heads=4, global_attn_every_n_layers=2, local_attention=8)
    torch.manual_seed(0)
    enc = ModernBertEncoder(cfg).eval()
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 300, (3, 40), generator=gen)
    mask = torch.ones(3, 40, dtype=torch.long)
    mask[1, 25:] = 0
    with torch.no_grad():
        want = enc(ids, mask)
        got = enc.to(cuda)(ids.to(cuda), mask.to(cuda))
    keep = mask.bool()
    for a, b in zip(got, want):
        assert (a.cpu()[keep] - b[keep]).abs().max().item() <= 1e-5


@pytest.mark.parametrize("num_kv", [4, 2])
def test_llama_greedy_card_equals_cpu(cuda, num_kv):
    """The GREEN judge's LLaMA: f32 logits card vs CPU within 1e-5 and the
    same greedy tokens over left-padded prompts; bf16 on the card gives
    finite logits."""
    from vilmedic_torch.blocks.llm import LlamaConfig, LlamaForCausalLM, greedy_generate
    from vilmedic_torch.blocks.llm import init_random_

    kw = dict(vocab_size=97, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=num_kv)
    cpu = init_random_(LlamaForCausalLM(LlamaConfig(**kw, dtype=torch.float32), device="cpu"),
                       0, std=0.05)
    card = LlamaForCausalLM(LlamaConfig(**kw, dtype=torch.float32), device=cuda)
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(2)
    ids = torch.randint(3, 97, (3, 9), generator=gen)
    mask = torch.ones_like(ids)
    mask[1, :3] = 0
    mask[2, :5] = 0
    want, got = cpu(ids, mask), card(ids.to(cuda), mask.to(cuda)).cpu()
    assert (got - want)[mask.bool()].abs().max().item() <= 1e-5
    assert torch.equal(greedy_generate(cpu, ids, mask, 10, -1, 1),
                       greedy_generate(card, ids.to(cuda), mask.to(cuda), 10, -1, 1).cpu())
    bf16 = LlamaForCausalLM(LlamaConfig(**kw, dtype=torch.bfloat16), device=cuda)
    bf16.load_state_dict(cpu.state_dict())
    assert torch.isfinite(bf16(ids.to(cuda), mask.to(cuda))).all()


# ---------------------------------------------------------------- the zoo

def _perturbed(state, seed):
    """The seeded init moved by small random steps (biases and norms off
    their init; BatchNorm variances kept positive)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in state.items():
        step = 0.02 * torch.randn(v.shape, generator=gen)
        out[k] = (v + step).abs() + 0.5 if k.endswith("running_var") else v + step
    return out


def _write_zoo_rrg(root):
    """A reference-layout RRG ``.pth`` (DenseNet-121, a 1-layer decoder of 64
    with 2 heads of 32, a 4105-entry vocabulary, ``device_preproc``), its
    ``vocab.tgt`` and two JPEGs; -> (pth, the reference state, JPEG paths)."""
    import numpy as np
    from PIL import Image

    from vilmedic_torch.zoo.convert import reference_rrg_state_dict

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"w{i}" for i in range(4100)]
    (root / "vocab.tgt").write_text("\n".join(vocab))
    rng = np.random.default_rng(0)
    images = []
    for i in range(2):
        images.append(str(root / f"im{i}.jpg"))
        Image.fromarray(rng.integers(0, 255, (72, 72, 3), dtype=np.uint8)).save(images[-1])
    decoder = dict(proto=None, hidden_size=64, num_hidden_layers=1, num_attention_heads=2,
                   intermediate_size=128, max_position_embeddings=32)
    cnn = dict(proto="VisualEncoder", backbone="densenet121", output_layer="features",
               permute="batch_first", visual_projection=dict(in_features=1024, out_features=64))
    config = {"dataset": {"proto": "ImSeq", "num_workers": 2,
                          "image": {"root": str(root), "file": "image.tok", "resize": 64,
                                    "crop": 64, "ext": ".jpg", "device_preproc": True},
                          "seq": {"root": str(root), "file": "report.tok", "source": "tgt",
                                  "tokenizer_max_len": 12}},
              "model": {"proto": "RRG", "decoder": decoder, "cnn": cnn}}
    state = _perturbed(RRG(decoder=decoder, cnn=cnn, vocab_size=len(vocab), device="cpu")
                       .module.state_dict(), 3)
    reference = reference_rrg_state_dict(state)
    torch.save({"model": {f"module.{k}": v for k, v in reference.items()}, "config": config},
               root / "model.pth")
    return str(root / "model.pth"), reference, images


def test_zoo_rrg_card_equals_cpu(cuda, tmp_path):
    """A reference ``.pth`` through ``bin.convert_checkpoint`` and
    ``AutoModel.from_pretrained`` on the card and on the CPU, f32:
    ``dataset.inference`` over two JPEGs (uint8 crops through K3 on the
    card), beam 4: equal sequences; K3 once, K1 and K2 once a decode step;
    every loaded tensor the ``.pth``'s."""
    from vilmedic_torch.bin.convert_checkpoint import main as convert
    from vilmedic_torch.data.image import prepare_batch
    from vilmedic_torch.models.evaluation_nlg import to_device
    from vilmedic_torch.zoo import AutoModel
    from vilmedic_torch.zoo.convert import convert_reference_rrg

    pth, reference, images = _write_zoo_rrg(tmp_path)
    convert([pth, str(tmp_path), "--num-layers", "1", "--backbone", "densenet121"])
    want_state = convert_reference_rrg(reference, 1, "densenet121")
    results = {}
    for device in ("cpu", cuda):
        model, dataset = AutoModel.from_pretrained(str(tmp_path), device=device)
        for k, v in model.module.state_dict().items():
            assert torch.equal(v.cpu(), want_state[k]), k
        batch = dataset.inference(seq=["w1 w2", "w3"], image=images)
        assert batch["images_u8"].dtype == torch.uint8
        start = (crop_normalize.launches, fused_beam_cache_attention.launches,
                 lm_head_blocked_stats.launches)
        on = prepare_batch(to_device(batch, device), dataset)
        tok = dataset.tokenizer
        res = make_generate_fn([model], 4, 12, tok.cls_token_id, tok.sep_token_id,
                               tok.pad_token_id)(model.encoder_inputs(on))
        results[str(device)] = (res, (crop_normalize.launches - start[0],
                                      fused_beam_cache_attention.launches - start[1],
                                      lm_head_blocked_stats.launches - start[2]))
    (cpu, _), (gpu, launched) = results["cpu"], results["cuda"]
    assert torch.equal(cpu.sequences, gpu.sequences.cpu())
    assert launched == (1, gpu.steps, gpu.steps)


def _hf_dinov2_tensors(cfg, grid, gen):
    """A DINOv2 state dict under HF ``Dinov2Model``'s names, random from
    ``gen`` (LayerScale near 1, norms near identity)."""
    d, p, f = cfg["hidden_size"], cfg["patch_size"], cfg["hidden_size"] * cfg["mlp_ratio"]

    def rand(*shape, scale=0.05, base=0.0):
        return base + scale * torch.randn(*shape, generator=gen)

    sd = {"embeddings.cls_token": rand(1, 1, d), "embeddings.mask_token": rand(1, d),
          "embeddings.position_embeddings": rand(1, 1 + grid * grid, d),
          "embeddings.patch_embeddings.projection.weight": rand(d, 3, p, p),
          "embeddings.patch_embeddings.projection.bias": rand(d),
          "layernorm.weight": rand(d, base=1.0), "layernorm.bias": rand(d)}
    for i in range(cfg["num_hidden_layers"]):
        pre = f"encoder.layer.{i}."
        for norm in ("norm1", "norm2"):
            sd[f"{pre}{norm}.weight"], sd[f"{pre}{norm}.bias"] = rand(d, base=1.0), rand(d)
        for name in ("attention.attention.query", "attention.attention.key",
                     "attention.attention.value", "attention.output.dense"):
            sd[f"{pre}{name}.weight"], sd[f"{pre}{name}.bias"] = rand(d, d), rand(d)
        sd[f"{pre}mlp.fc1.weight"], sd[f"{pre}mlp.fc1.bias"] = rand(f, d), rand(f)
        sd[f"{pre}mlp.fc2.weight"], sd[f"{pre}mlp.fc2.bias"] = rand(d, f), rand(d)
        for scale in ("layer_scale1", "layer_scale2"):
            sd[f"{pre}{scale}.lambda1"] = rand(d, base=1.0)
    return sd


def test_zoo_dinov2_tower_card_equals_cpu(cuda, tmp_path):
    """A DINOv2 weight folder whose ``config.json`` has no ``image_size``
    (a 16 x 16 grid) under a VisionLanguage config at 518²: the tower holds
    the file's tensors, its positions re-gridded to 1370 tokens, on both
    devices; its output on two images on the card (K4, once a layer) within
    1e-4 of the largest of the CPU's, f32."""
    import json

    from vilmedic_torch.config.config import Config
    from vilmedic_torch.executors.utils import create_model
    from vilmedic_torch.zoo.convert_vision import convert_hf_dinov2

    cfg = {"model_type": "dinov2", "hidden_size": 64, "num_hidden_layers": 2,
           "num_attention_heads": 2, "patch_size": 14, "mlp_ratio": 4}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    sd = _hf_dinov2_tensors(cfg, 16, torch.Generator().manual_seed(5))
    torch.save(sd, tmp_path / "pytorch_model.bin")
    want = convert_hf_dinov2(sd, target_tokens=1370)
    decoder = dict(proto=None, hidden_size=64, num_hidden_layers=1, num_attention_heads=2,
                   intermediate_size=128, max_position_embeddings=64)
    config = Config({"model": {"proto": "VisionLanguage", "decoder": decoder,
                               "vision": {"vision_model_name": str(tmp_path),
                                          "image_size": 518}}})
    images = torch.randn(2, 3, 518, 518, generator=torch.Generator().manual_seed(6))
    outs = {}
    for device in ("cpu", cuda):
        model = create_model(config, device=device, vocab_size=30, bos_token_id=0,
                             eos_token_id=1, pad_token_id=2)
        tower = model.module.vision
        for k, v in want.items():
            assert torch.equal(tower.model.state_dict()[k].cpu(), v), k
        start = flash_attention.launches
        with torch.no_grad():
            outs[str(device)] = tower(images.to(device)).cpu()
        launched = flash_attention.launches - start
    assert launched == cfg["num_hidden_layers"]
    scale = outs["cpu"].abs().max().item()
    assert (outs["cuda"] - outs["cpu"]).abs().max().item() <= 1e-4 * scale


def _u8_batches(n: int, b: int, r: int, crop: int, seed: int):
    """``device_preproc`` host batches: uint8 (b, r, r, 3) images, crop
    offsets, token ids."""
    gen = torch.Generator().manual_seed(seed)
    return [{"images_u8": torch.randint(0, 256, (b, r, r, 3), generator=gen, dtype=torch.uint8),
             "preproc_tops": torch.randint(0, r - crop + 1, (b,), generator=gen,
                                           dtype=torch.int32),
             "preproc_lefts": torch.randint(0, r - crop + 1, (b,), generator=gen,
                                            dtype=torch.int32),
             "input_ids": torch.randint(0, 100, (b, 12), generator=gen)} for _ in range(n)]


def _placement(device, crop: int, streams=None):
    """The Trainor's placement of a ``device_preproc`` batch: the copy,
    then the crop+normalize kernel (K3); records the stream it ran on."""
    from vilmedic_torch.models.evaluation_nlg import to_device

    def place(batch):
        if streams is not None:
            streams.append(torch.cuda.current_stream(device))
        return finalize_device_preproc(to_device(batch, device), crop)

    return place


def test_device_prefetch_copy_stream_equals_synchronous_placement(cuda):
    """Six batches of 16 at 256² cropped to 224: placed on a copy stream of
    the prefetcher's own (pinned copies, K3 there) they equal the batches
    placed on the training thread's stream, to the bit, with as many K3
    launches."""
    from vilmedic_torch.data.loader import DevicePrefetch

    batches = _u8_batches(6, 16, 256, 224, 0)
    start = crop_normalize.launches
    want = [_placement(cuda, 224)(b) for b in batches]
    launched = crop_normalize.launches - start
    streams = []
    start = crop_normalize.launches
    got = list(DevicePrefetch(batches, _placement(cuda, 224, streams), depth=2, device=cuda))
    assert crop_normalize.launches - start == launched == 6
    assert streams and all(s != torch.cuda.default_stream(cuda) for s in streams)
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and all(torch.equal(g[k], w[k]) for k in w)


def test_prefetched_batches_survive_allocator_reuse(cuda):
    """Each consumed batch is read by the training stream only after a
    ~10 ms sleep kernel, and dropped right away: its memory goes back to the
    caching allocator while the read is still queued, and the producer's
    next batches (same sizes, on the copy stream) would take it but for
    ``record_stream``. Every batch's sum equals that of the synchronous
    placement."""
    from vilmedic_torch.data.loader import DevicePrefetch

    batches = _u8_batches(12, 16, 256, 224, 1)
    place = _placement(cuda, 224)
    want = [place(b)["images"].double().sum().item() for b in batches]
    sums = []
    for batch in DevicePrefetch(batches, place, depth=2, device=cuda):
        torch.cuda._sleep(20_000_000)
        sums.append(batch["images"].double().sum())
        del batch
    assert [s.item() for s in sums] == want


def _chexbert_files(root, words):
    """A small CheXbert (BERT of 1 layer x 64, the 14 heads) and its
    ``vocab.txt``, random from a seed."""
    from vilmedic_torch.scorers.chexbert import CheXbertModule

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *words]
    (root / "vocab.txt").write_text("\n".join(vocab))
    cfg = dict(model_type="bert", vocab_size=len(vocab), hidden_size=64, num_hidden_layers=1,
               num_attention_heads=1, intermediate_size=128, max_position_embeddings=64,
               type_vocab_size=2)
    torch.manual_seed(0)
    module = CheXbertModule(cfg)
    with torch.no_grad():
        for head in module.linear_heads:
            head.weight.mul_(20)  # labels away from ties
    torch.save({"model_state_dict": {f"module.{k}": v for k, v in module.state_dict().items()}},
               root / "chexbert.pth")
    return root / "chexbert.pth", root / "vocab.txt"


def test_overlapped_scst_card_reward_gives_the_serial_rewards(cuda, tmp_path, monkeypatch):
    """The pipelined SCST iteration of a small RRG_SCST (``densenet_tiny``,
    f32) with rewards [rougel, chexbert] over 3 batches of 3 and the flush:
    the rewards of batches 1 and 2 run on the reward worker, CheXbert on the
    card on the worker's own stream; each equals what the serial path's
    reward computation gives on the same rollouts on the training thread;
    3 steps, finite losses, nothing left pending."""
    import threading

    import numpy as np
    from PIL import Image

    from vilmedic_torch.config.config import Config
    from vilmedic_torch.executors import Trainor
    from vilmedic_torch.scorers import chexbert

    monkeypatch.setitem(tdensenet.CONFIGS, "densenet_tiny", (8, (2, 2), 16))
    reports = ["no acute disease .", "heart size is normal .", "small pleural effusion .",
               "lungs are clear .", "mild cardiomegaly .", "no evidence of pneumonia .",
               "stable cardiomegaly .", "small left effusion .", "clear lungs ."]
    rng = np.random.default_rng(0)
    paths = []
    for i in range(len(reports)):
        paths.append(str(tmp_path / f"im{i}.jpg"))
        Image.fromarray(rng.integers(0, 255, (48, 48, 3), dtype=np.uint8)).save(paths[-1])
    (tmp_path / "train.report.tok").write_text("\n".join(reports))
    (tmp_path / "train.image.tok").write_text("\n".join(paths))
    pth, vocab = _chexbert_files(tmp_path, sorted({w for r in reports for w in r.split()}))
    monkeypatch.setenv("CHEXBERT_PTH", str(pth))
    monkeypatch.setenv("CHEXBERT_VOCAB", str(vocab))
    chexbert._load_labeler.cache_clear()
    decoder = dict(proto=None, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
                   intermediate_size=64, max_position_embeddings=64, hidden_dropout_prob=0.0)
    cnn = dict(proto="VisualEncoder", backbone="densenet_tiny", output_layer="features",
               dropout_out=0.0, permute="batch_first",
               visual_projection={"in_features": 32, "out_features": 32}, freeze=False)
    config = Config({
        "ckpt_dir": str(tmp_path), "seed": 0,
        "dataset": {"proto": "ImSeq",
                    "image": {"root": str(tmp_path), "file": "image.tok", "resize": 40,
                              "crop": 32, "ext": ".jpg", "device_preproc": True},
                    "seq": {"root": str(tmp_path), "file": "report.tok", "source": "tgt",
                            "tokenizer_max_len": 12},
                    "num_workers": 0},
        "model": {"proto": "RRG_SCST", "decoder": decoder, "cnn": cnn, "dtype": "float32",
                  "scores": ["rougel", "chexbert"], "scores_weights": [0.5, 0.5], "top_k": 5,
                  "overlap_rollout": True},
        "batch_size": 3, "optimizer": "RAdam", "optim_params": {"lr": 1e-3}, "epochs": 0})
    trainer = Trainor(config, seed=0, device=cuda)
    model = trainer.model
    real, calls, labelled = model.scst.get_reward, [], []
    real_predict = chexbert.CheXbertModule.predict_classes

    def predict(module, ids, mask):
        labelled.append((ids.device.type, torch.cuda.current_stream(cuda)))
        return real_predict(module, ids, mask)

    def get_reward(ids, refs):
        out = real(ids, refs)
        calls.append((ids.copy(), refs.copy(), [r.copy() for r in out[0]],
                      threading.current_thread().name))
        return out

    monkeypatch.setattr(chexbert.CheXbertModule, "predict_classes", predict)
    model.scst.get_reward = get_reward
    losses = trainer.train_epoch(0)
    assert len(calls) == 6 and model.timing["iters"] == 3 and model._pending is None
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert [c[3].startswith("scst-rewards") for c in calls] == [True] * 4 + [False] * 2
    assert {d for d, _ in labelled} == {"cuda"}
    assert all(s != torch.cuda.default_stream(cuda) for _, s in labelled[:4])
    for ids, refs, rewards, _ in calls:
        again = real(ids, refs)[0]
        assert len(rewards) == 2 and all(np.array_equal(a, b) for a, b in zip(rewards, again))
