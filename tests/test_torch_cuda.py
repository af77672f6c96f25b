"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU and the CUDA toolkit, and skip elsewhere. They cover
shapes off the slices' main paths (odd row counts, groups wider than a warp,
every head dim the kernels take, pad-heavy vocabularies, out-of-range crop
offsets, ragged and fully masked flash tiles, Tq != Tk, the flash backward's
ragged tails and all-padding items, the beam kernel's int8 cache and prefix
stages at ragged prefix lengths and saturating writes), tiny VisionLanguage
serving routes and a tiny training step card vs CPU. Run them on the card
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
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("tq,tk,causal", [
    (50, 50, False), (130, 130, True), (70, 200, True), (200, 70, False), (129, 129, False),
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
