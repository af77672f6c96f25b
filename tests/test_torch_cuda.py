"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU and the CUDA toolkit, and skip elsewhere. They cover
shapes off the slices' main paths (odd row counts, groups wider than a warp,
every head dim the kernels take, pad-heavy vocabularies, out-of-range crop
offsets, ragged and fully masked flash tiles, Tq != Tk). Run them on the card
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
    fused_beam_cache_attention, fused_beam_cache_attention_reference,
)
from vilmedic_torch.models.vision_language import VisionLanguage, make_vl_generate_fn
from vilmedic_torch.ops.blocked_lm_head import (
    NEG, lm_head_blocked_stats, lm_head_blocked_stats_reference,
)
from vilmedic_torch.ops.flash_attention import flash_attention, flash_attention_reference
from vilmedic_torch.ops.image_preproc import crop_normalize, crop_normalize_reference

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("tq,tk,causal", [
    (50, 50, False), (64, 64, False), (130, 130, False),  # below, at, above a tile
    (64, 64, True), (130, 130, True), (70, 200, True),   # causal, Tq < Tk
    (33, 129, False),
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
