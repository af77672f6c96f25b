#!/usr/bin/env python3
"""Drive the PyTorch port (``vilmedic_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. requires a CUDA device and prints the card's name and power limit;
2. builds the hand-written CUDA kernels from ``vilmedic_torch/csrc``;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes of the paths below, in float32 (TF32 off) and bfloat16, and times
   both (the flash backward K5 and K4's LSE output at the VisionLanguage
   training shape: B 16, T 1470, H 12, D 64, causal, padded text keys);
4. serves the flagship RRG beam-8 slice (``config/RRG/baseline-mimic.yml``,
   vocab 50265, random weights from a seed, bf16) on 16 uint8 images, checks
   the output and that every kernel ran, and times reports/s at batch 16 and
   128;
5. generates a batch of 2 RRG reports in float32 (TF32 off) on the card and
   on the CPU, where the plain versions run, and requires equal beam
   sequences;
6. serves the VisionLanguage beam-8 slice
   (``config/VL/vl-dinov2-modernbert.yml``: DINOv2-B/14 at 518², 12-layer
   prefix LM, vocab 50368, random weights from a seed, bf16) on 16 float
   images, checks the output and the flash and beam-cache launch counts,
   times reports/s at batch 16 and splits one batch into tower, prefill and
   decode;
7. generates a batch of 2 VisionLanguage reports in float32 on the card and
   on the CPU and requires equal beam sequences;
8. trains the VisionLanguage model in bf16 at full width and depth through
   the port's ``Trainor`` (the config's ``trainor:`` block: batch 16, AdamW
   lr 5e-5, warmup ratio 0.1, grad_accu 4) on 8 synthetic microbatches:
   finite losses, the frozen tower bitwise unchanged, every trainable tensor
   moved by the second update (the first runs at lr 0), 12 launches per
   microbatch each of K4 with LSE, K5's two kernels and the tower's K4; times
   microbatches and updates and splits one by stage with ``torch.profiler``;
9. requires the loss to fall over 10 updates on one repeated batch
   (grad_accu 1, constant lr 1e-4);
10. takes one f32 training microbatch and AdamW update at batch 2 on the card
    and on the CPU from the same weights and requires equal gradients and
    parameters within the stated tolerances.

Any failed check raises and the exit code is non-zero. The second-to-last
line of output is a JSON summary of the kernels, the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or away from the
repository's files, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "config", "RRG", "baseline-mimic.yml")
SEED = 0
VOCAB = 50265
BEAM = 8
T_MAX = 100  # tokenizer_max_len of the flagship config

VL_CONFIG = os.path.join(ROOT, "config", "VL", "vl-dinov2-modernbert.yml")
# ModernBERT-base's vocabulary and CLS/SEP/PAD ids, the VL tokenizer's
VL_VOCAB, VL_BOS, VL_EOS, VL_PAD = 50368, 50281, 50282, 50283
# the config's vision_model_name (a RAD-DINO ViT-B/14), whose architecture
# equals DINOv2's defaults; the HF config lookup is not ported
VL_TOWER = dict(model_type="dinov2", hidden_size=768, num_hidden_layers=12,
                num_attention_heads=12, mlp_ratio=4.0, patch_size=14, image_size=518,
                layer_norm_eps=1e-6, use_swiglu_ffn=False, hidden_act="gelu")
VL_TOKENS = 1370  # 37² patches + CLS in the tower; 37² + marker in the prefill


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int = 9, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` on the current stream, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def set_tf32(enabled: bool):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled


# --------------------------------------------------------------- kernels


def random_ancestry_mask(groups: int, rows: int, t: int, gen, device):
    """One ancestor slot per (row, t), as beam search leaves it."""
    import torch

    j = torch.randint(0, rows, (groups, rows, t), generator=gen)
    mask = torch.zeros(groups, rows, t, rows, dtype=torch.bool)
    mask.scatter_(3, j[..., None], True)
    return mask.view(groups, rows, t * rows).to(device)


def check_beam_cache_attention(results):
    import torch

    from vilmedic_torch.ops.beam_cache_attention import (
        fused_beam_cache_attention, fused_beam_cache_attention_reference,
    )

    t, heads, d, rows = T_MAX, 12, 64, BEAM
    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    worst = 0.0
    timing = {}
    gen = torch.Generator().manual_seed(SEED)
    for dtype in (torch.float32, torch.bfloat16):
        for n in (128, 1024):
            kc = torch.randn(t, n, heads * d, generator=gen).to("cuda", dtype)
            vc = torch.randn(t, n, heads * d, generator=gen).to("cuda", dtype)
            q, kn, vn = (torch.randn(n, heads, d, generator=gen).to("cuda", dtype)
                         for _ in range(3))
            mask = random_ancestry_mask(n // rows, rows, t, gen, "cuda")
            for index in (0, 1, 57, 99):
                kc1, vc1, kc2, vc2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
                out = fused_beam_cache_attention(kc1, vc1, q, kn, vn, mask, index)
                ref = fused_beam_cache_attention_reference(kc2, vc2, q, kn, vn, mask, index)
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                worst = max(worst, err)
                others = torch.ones(t, dtype=torch.bool, device="cuda")
                others[index] = False
                cache_ok = (
                    torch.equal(kc1[others], kc[others]) and torch.equal(vc1[others], vc[others])
                    and torch.equal(kc1[index], kn.reshape(n, -1))
                    and torch.equal(vc1[index], vn.reshape(n, -1))
                )
                ok = err <= tol[dtype] and cache_ok
                print(f"K1 fused_beam_cache_attention {str(dtype)[6:]:8s} N={n:5d} "
                      f"index={index:2d}: max|err|={err:.3e} (tol {tol[dtype]:.0e}), "
                      f"cache write bitwise {'ok' if cache_ok else 'WRONG'}")
                if not ok:
                    fail(f"beam cache attention {dtype} N={n} index={index}")
            if dtype == torch.bfloat16:
                timing[n] = (
                    cuda_ms(lambda: fused_beam_cache_attention(kc, vc, q, kn, vn, mask, 99)),
                    cuda_ms(lambda: fused_beam_cache_attention_reference(kc, vc, q, kn, vn, mask, 99)),
                )
    for n, (ms, plain) in timing.items():
        print(f"K1 bf16 N={n} index=99: kernel {ms:.4f} ms, plain {plain:.4f} ms")
    results["fused_beam_cache_attention"] = dict(
        route="cuda", source="vilmedic_torch/csrc/beam_cache_attention.cu",
        replaces="vilmedic_tpu/ops/beam_cache_attention.py:94",
        max_abs_err=worst, ms=timing[1024][0], plain_ms=timing[1024][1],
        path="rrg", counter="fused_beam_cache_attention",
    )


def check_beam_cache_attention_stats(results):
    """Stage (b), at the VisionLanguage decode shape (16 items x beam 8)."""
    import torch

    from vilmedic_torch.ops.beam_cache_attention import (
        fused_beam_cache_attention, fused_beam_cache_attention_reference,
    )

    t, heads, d, rows, n = T_MAX, 12, 64, BEAM, 128
    # out: as stage (a); m: f32 maxima of the same scores summed in another
    # order; l: f32 sums of up to 100 exp terms in another order (relative)
    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    tol_m, tol_l = 1e-5, 1e-4
    worst = 0.0
    gen = torch.Generator().manual_seed(SEED + 4)
    for dtype in (torch.float32, torch.bfloat16):
        kc = torch.randn(t, n, heads * d, generator=gen).to("cuda", dtype)
        vc = torch.randn(t, n, heads * d, generator=gen).to("cuda", dtype)
        q, kn, vn = (torch.randn(n, heads, d, generator=gen).to("cuda", dtype)
                     for _ in range(3))
        mask = random_ancestry_mask(n // rows, rows, t, gen, "cuda")
        for index in (0, 1, 57, 99):
            kc1, vc1, kc2, vc2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
            out, m, l = fused_beam_cache_attention(kc1, vc1, q, kn, vn, mask, index,
                                                   return_stats=True)
            ref, rm, rl = fused_beam_cache_attention_reference(kc2, vc2, q, kn, vn, mask, index,
                                                               return_stats=True)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            err_m = (m - rm).abs().max().item()
            rel_l = ((l - rl).abs() / rl).max().item()
            worst = max(worst, err, err_m)
            cache_ok = torch.equal(kc1, kc2) and torch.equal(vc1, vc2)
            print(f"K1 stats {str(dtype)[6:]:8s} N={n} index={index:2d}: max|err| out "
                  f"{err:.3e} (tol {tol[dtype]:.0e}), m {err_m:.3e} (tol {tol_m:.0e}), "
                  f"l rel {rel_l:.3e} (tol {tol_l:.0e}), cache write bitwise "
                  f"{'ok' if cache_ok else 'WRONG'}")
            if err > tol[dtype] or err_m > tol_m or rel_l > tol_l or not cache_ok:
                fail(f"beam cache attention stats {dtype} index={index}")
    ms = cuda_ms(lambda: fused_beam_cache_attention(kc, vc, q, kn, vn, mask, 99,
                                                    return_stats=True))
    plain = cuda_ms(lambda: fused_beam_cache_attention_reference(kc, vc, q, kn, vn, mask, 99,
                                                                 return_stats=True))
    print(f"K1 stats bf16 N={n} index=99: kernel {ms:.4f} ms, plain {plain:.4f} ms")
    results["fused_beam_cache_attention_stats"] = dict(
        route="cuda", source="vilmedic_torch/csrc/beam_cache_attention.cu",
        replaces="vilmedic_tpu/ops/beam_cache_attention.py:94",
        max_abs_err=worst, ms=ms, plain_ms=plain,
        path="vl", counter="fused_beam_cache_attention",
    )


def check_flash_attention(results):
    """K4 at the VisionLanguage tower and prefill shapes, plus a padded key
    mask and a Tq < Tk causal case."""
    import torch

    from vilmedic_torch.ops.flash_attention import flash_attention, flash_attention_reference

    b, t, heads, d = 16, VL_TOKENS, 12, 64
    # f32: the same f32 products summed in another order (online softmax over
    # key tiles vs one softmax); bf16: p is rounded to bf16 against the
    # running max in the kernel and against the final max in the plain version
    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    gen = torch.Generator("cuda").manual_seed(SEED + 3)
    cases = [("tower", t, t, False, False), ("prefill", t, t, True, False),
             ("padded keys", t, t, False, True), ("Tq<Tk causal", 1000, t, True, False)]
    worst, timing = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, tq, tk, causal, padded in cases:
            q = torch.randn(b, tq, heads, d, generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn(b, tk, heads, d, generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            key_mask = None
            if padded:  # suffix padding of another length per item, one item fully masked
                lengths = torch.randint(tk // 2, tk + 1, (b,), generator=gen, device="cuda")
                lengths[0] = 0
                key_mask = torch.arange(tk, device="cuda")[None, :] < lengths[:, None]
            out = flash_attention(q, k, v, key_mask, causal)
            ref = flash_attention_reference(q, k, v, key_mask, causal)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            worst = max(worst, err)
            print(f"K4 flash_attention {str(dtype)[6:]:8s} {name:13s} B={b} Tq={tq} Tk={tk} "
                  f"H={heads} D={d}: max|err|={err:.3e} (tol {tol[dtype]:.0e})")
            if not err <= tol[dtype]:
                fail(f"flash attention {dtype} {name}")
            if dtype == torch.bfloat16 and name in ("tower", "prefill"):
                timing[name] = (cuda_ms(lambda: flash_attention(q, k, v, None, causal)),
                                cuda_ms(lambda: flash_attention_reference(q, k, v, None, causal)))
            del q, k, v, out, ref
    for name, (ms, plain) in timing.items():
        flops = 4 * b * heads * t * t * d / (2 if name == "prefill" else 1)
        print(f"K4 bf16 {name} T={t}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
              f"plain {plain:.4f} ms")
    results["flash_attention"] = dict(
        route="cuda", source="vilmedic_torch/csrc/flash_attention.cu",
        replaces="vilmedic_tpu/ops/flash_attention.py:287",
        max_abs_err=worst, ms=timing["tower"][0], plain_ms=timing["tower"][1],
        path="vl", counter="flash_attention",
    )


def train_key_mask(b: int, t: int, device):
    """The VisionLanguage training key mask: the last 20 text keys are
    padding on half of the items."""
    import torch

    mask = torch.ones(b, t, dtype=torch.bool, device=device)
    mask[b // 2:, t - 20:] = False
    return mask


def check_flash_attention_backward(results):
    """K4 with LSE and K5 (dq kernel, dk/dv/dbias kernel) at the VisionLanguage
    training shape: B 16, T 1370 + 100, H 12, D 64, causal, padded text keys."""
    import torch

    from vilmedic_torch.ops.flash_attention import (
        _delta, _key_bias, flash_attention_backward, flash_attention_backward_reference,
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_reference,
        flash_attention_with_lse,
    )

    b, t, heads, d = 16, VL_TOKENS + T_MAX, 12, 64
    # out: as K4; lse: f32 max plus log of a sum in another order; dq/dk/dv
    # relative to each tensor's largest entry: f32 sums in another order, and
    # in bf16 p and dS rounded to bf16 from f32 values that differ in the last
    # bits (one bf16 step, 2^-8, now and then); dbias sums unrounded f32 dS
    tol_out = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    tol_lse = 1e-5
    tol_grad = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    tol_dbias = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
    gen = torch.Generator("cuda").manual_seed(SEED + 5)
    key_mask = train_key_mask(b, t, "cuda")
    worst = {"lse": 0.0, "dq": 0.0, "dkv": 0.0}
    timing = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, dout = (torch.randn(b, t, heads, d, generator=gen, device="cuda").to(dtype)
                         for _ in range(4))
        out, lse = flash_attention_with_lse(q, k, v, key_mask, causal=True)
        rout, rlse = flash_attention_reference(q, k, v, key_mask, causal=True, return_lse=True)
        grads = flash_attention_backward(q, k, v, key_mask, out, lse, dout, causal=True)
        ref = flash_attention_backward_reference(q, k, v, key_mask, out, lse, dout, causal=True)
        torch.cuda.synchronize()
        err_out = (out.float() - rout.float()).abs().max().item()
        err_lse = (lse - rlse).abs().max().item()
        errs = {name: (g.float() - r.float()).abs().max().item()
                for name, g, r in zip(("dq", "dk", "dv", "dbias"), grads, ref)}
        rel = {name: errs[name] / r.float().abs().max().item()
               for name, r in zip(("dq", "dk", "dv", "dbias"), ref)}
        worst["lse"] = max(worst["lse"], err_out, err_lse)
        worst["dq"] = max(worst["dq"], errs["dq"])
        worst["dkv"] = max(worst["dkv"], errs["dk"], errs["dv"], errs["dbias"])
        print(f"K4+LSE / K5 {str(dtype)[6:]:8s} B={b} T={t} H={heads} D={d} causal, padded "
              f"keys: max|err| out {err_out:.3e} (tol {tol_out[dtype]:.0e}), lse {err_lse:.3e} "
              f"(tol {tol_lse:.0e}); relative dq {rel['dq']:.3e} dk {rel['dk']:.3e} dv "
              f"{rel['dv']:.3e} (tol {tol_grad[dtype]:.0e}), dbias {rel['dbias']:.3e} "
              f"(tol {tol_dbias[dtype]:.0e})")
        bad = [n for n in ("dq", "dk", "dv") if not rel[n] <= tol_grad[dtype]]
        if not rel["dbias"] <= tol_dbias[dtype]:
            bad.append("dbias")
        if not err_out <= tol_out[dtype] or not err_lse <= tol_lse:
            bad.append("out/lse")
        if bad:
            fail(f"flash attention backward {dtype}: {bad}")
        del rout, rlse, ref
        torch.cuda.empty_cache()
        bias = _key_bias(key_mask, b, t, "cuda").contiguous()
        delta = _delta(out, dout)
        timing[dtype] = dict(
            lse=cuda_ms(lambda: flash_attention_with_lse(q, k, v, key_mask, causal=True)),
            lse_plain=cuda_ms(lambda: flash_attention_reference(q, k, v, key_mask, causal=True,
                                                                return_lse=True)),
            dq=cuda_ms(lambda: flash_attention_bwd_dq(q, k, v, bias, dout, lse, delta, True)),
            dkv=cuda_ms(lambda: flash_attention_bwd_dkv(q, k, v, bias, dout, lse, delta, True)),
            bwd=cuda_ms(lambda: flash_attention_backward(q, k, v, key_mask, out, lse, dout,
                                                         causal=True)),
            bwd_plain=cuda_ms(lambda: flash_attention_backward_reference(
                q, k, v, key_mask, out, lse, dout, causal=True)),
        )
        del q, k, v, dout, out, lse, grads
        torch.cuda.empty_cache()
    # two T x T x D products forward; seven backward (S and dP recomputed in
    # both kernels), causal: half of each
    fwd_flops = 4 * b * heads * t * t * d / 2
    for dtype, tm in timing.items():
        bwd_k = tm["dq"] + tm["dkv"]
        print(f"K4+LSE {str(dtype)[6:]} T={t} causal: kernel {tm['lse']:.4f} ms "
              f"({fwd_flops / tm['lse'] / 1e9:.1f} TFLOP/s), plain {tm['lse_plain']:.4f} ms; "
              f"K5 dq {tm['dq']:.4f} ms + dk/dv/dbias {tm['dkv']:.4f} ms = {bwd_k:.4f} ms "
              f"({3.5 * fwd_flops / bwd_k / 1e9:.1f} TFLOP/s), whole backward with delta "
              f"{tm['bwd']:.4f} ms, plain backward {tm['bwd_plain']:.4f} ms")
    tm = timing[torch.bfloat16]
    common = dict(route="cuda", path="vl_train")
    results["flash_attention_with_lse"] = dict(
        common, source="vilmedic_torch/csrc/flash_attention.cu",
        replaces="vilmedic_tpu/ops/flash_attention.py:352", max_abs_err=worst["lse"],
        ms=tm["lse"], plain_ms=tm["lse_plain"], counter="flash_attention_with_lse")
    # each K5 kernel against the whole plain backward, which computes both
    results["flash_attention_bwd_dq"] = dict(
        common, source="vilmedic_torch/csrc/flash_attention_bwd.cu",
        replaces="vilmedic_tpu/ops/flash_attention.py:598", max_abs_err=worst["dq"],
        ms=tm["dq"], plain_ms=tm["bwd_plain"], counter="flash_attention_bwd_dq")
    results["flash_attention_bwd_dkv"] = dict(
        common, source="vilmedic_torch/csrc/flash_attention_bwd.cu",
        replaces="vilmedic_tpu/ops/flash_attention.py:665", max_abs_err=worst["dkv"],
        ms=tm["dkv"], plain_ms=tm["bwd_plain"], counter="flash_attention_bwd_dkv")


def check_blocked_lm_head(results):
    import torch

    from vilmedic_torch.ops.blocked_lm_head import (
        NEG, lm_head_blocked_stats, lm_head_blocked_stats_reference,
    )

    hidden, vp = 768, -(-VOCAB // 128) * 128
    # f32 sums of 768 products of |h| ~ 1, |w| ~ 0.02 in another order: ~1e-5
    tol_abs, tol_rel_sum = 1e-4, 1e-4
    worst = 0.0
    timing = {}
    gen = torch.Generator().manual_seed(SEED + 1)
    w32 = torch.randn(vp, hidden, generator=gen) * 0.02
    w32[VOCAB:] = 0.0
    b = torch.randn(vp, generator=gen) * 0.02
    b[VOCAB:] = NEG
    b = b.cuda()
    for dtype in (torch.float32, torch.bfloat16):
        w = w32.to("cuda", dtype)
        for n in (128, 1024):
            h = torch.randn(n, hidden, generator=gen).to("cuda", dtype)
            lg, mx, sm = lm_head_blocked_stats(h, w, b)
            rlg, rmx, rsm = lm_head_blocked_stats_reference(h, w, b)
            torch.cuda.synchronize()
            err = max((lg - rlg).abs().max().item(), (mx - rmx).abs().max().item())
            rel = ((sm - rsm).abs() / rsm).max().item()
            worst = max(worst, err)
            print(f"K2 lm_head_blocked_stats {str(dtype)[6:]:8s} N={n:5d}: "
                  f"max|err| logits/max={err:.3e} (tol {tol_abs:.0e}), "
                  f"sumexp rel={rel:.3e} (tol {tol_rel_sum:.0e})")
            if err > tol_abs or rel > tol_rel_sum:
                fail(f"blocked lm head {dtype} N={n}")
            if dtype == torch.bfloat16:
                timing[n] = (cuda_ms(lambda: lm_head_blocked_stats(h, w, b)),
                             cuda_ms(lambda: lm_head_blocked_stats_reference(h, w, b)))
    for n, (ms, plain) in timing.items():
        flops = 2 * n * hidden * vp
        print(f"K2 bf16 N={n}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
              f"plain {plain:.4f} ms")
    results["lm_head_blocked_stats"] = dict(
        route="cuda", source="vilmedic_torch/csrc/blocked_lm_head.cu",
        replaces="vilmedic_tpu/ops/blocked_lm_head.py:52",
        max_abs_err=worst, ms=timing[1024][0], plain_ms=timing[1024][1],
        path="rrg", counter="lm_head_blocked_stats",
    )


def check_crop_normalize(results):
    import torch

    from vilmedic_torch.ops.image_preproc import crop_normalize, crop_normalize_reference

    b, r, crop = 16, 256, 224
    tol = 1e-6  # the same IEEE f32 ops in the same order: expected exact
    gen = torch.Generator().manual_seed(SEED + 2)
    img = torch.randint(0, 256, (b, r, r, 3), generator=gen, dtype=torch.uint8).cuda()
    tops = torch.randint(0, r - crop + 1, (b,), generator=gen, dtype=torch.int32).cuda()
    lefts = torch.randint(0, r - crop + 1, (b,), generator=gen, dtype=torch.int32).cuda()
    out = crop_normalize(img, tops, lefts, crop)
    ref = crop_normalize_reference(img, tops, lefts, crop)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    print(f"K3 crop_normalize B={b} R={r} crop={crop}: max|err|={err:.3e} (tol {tol:.0e})")
    if err > tol:
        fail("crop_normalize")
    ms = cuda_ms(lambda: crop_normalize(img, tops, lefts, crop))
    plain = cuda_ms(lambda: crop_normalize_reference(img, tops, lefts, crop))
    print(f"K3 B={b}: kernel {ms:.4f} ms, plain {plain:.4f} ms")
    results["crop_normalize"] = dict(
        route="cuda", source="vilmedic_torch/csrc/image_preproc.cu",
        replaces="vilmedic_tpu/ops/image_preproc.py:48",
        max_abs_err=err, ms=ms, plain_ms=plain,
        path="rrg", counter="crop_normalize",
    )


def phase_kernels():
    from vilmedic_torch.ops import cuda_lib

    t0 = time.perf_counter()
    cuda_lib.lib()  # builds the kernels unless this exact build exists
    print(f"build: {time.perf_counter() - t0:.1f} s ({cuda_lib.library_path().name})")
    set_tf32(False)
    results = {}
    check_beam_cache_attention(results)
    check_beam_cache_attention_stats(results)
    check_blocked_lm_head(results)
    check_crop_normalize(results)
    check_flash_attention(results)
    check_flash_attention_backward(results)
    return results


# ------------------------------------------------------------------ slice


def kernel_wrappers():
    from vilmedic_torch.ops.beam_cache_attention import fused_beam_cache_attention
    from vilmedic_torch.ops.blocked_lm_head import lm_head_blocked_stats
    from vilmedic_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_with_lse,
    )
    from vilmedic_torch.ops.image_preproc import crop_normalize

    return {"fused_beam_cache_attention": fused_beam_cache_attention,
            "lm_head_blocked_stats": lm_head_blocked_stats,
            "crop_normalize": crop_normalize,
            "flash_attention": flash_attention,
            "flash_attention_with_lse": flash_attention_with_lse,
            "flash_attention_bwd_dq": flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": flash_attention_bwd_dkv}


def build_flagship(dtype: str, device: str):
    """The flagship RRG from its config, vocab 50265, random weights from SEED."""
    from vilmedic_torch import registry
    from vilmedic_torch.config import load_config
    from vilmedic_torch.models import rrg  # noqa: F401  (registers RRG)
    from vilmedic_torch.models.base import get_special_token_ids
    from vilmedic_torch.models.evaluation_nlg import make_generate_fn

    cfg, _ = load_config(CONFIG, [f"model.dtype={dtype}"])
    model = registry.build("model", cfg.model, vocab_size=VOCAB, device=device, seed=SEED)
    max_len = int(cfg.dataset.seq.tokenizer_max_len)
    bos, eos, pad = get_special_token_ids(model.dec_config)
    generate = make_generate_fn([model], BEAM, max_len, bos, eos, pad, length_penalty=1.0)
    return model, generate, int(cfg.dataset.image.crop), max_len, bos


def host_batch(b: int, crop: int, seed: int):
    """An eval batch as the host collate leaves it: uint8 images already
    cropped on the host, zero device crop offsets."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    return {
        "images_u8": torch.randint(0, 256, (b, crop, crop, 3), generator=gen,
                                   dtype=torch.uint8).pin_memory(),
        "preproc_tops": torch.zeros(b, dtype=torch.int32),
        "preproc_lefts": torch.zeros(b, dtype=torch.int32),
    }


def serve(model, generate, batch, crop: int, device: str):
    """H2D of the uint8 batch, crop+normalize on the device, beam search."""
    from vilmedic_torch.data.image import finalize_device_preproc

    on_device = {k: v.to(device, non_blocking=True) for k, v in batch.items()}
    return generate(model.encoder_inputs(finalize_device_preproc(on_device, crop)))


def phase_slice():
    import torch

    set_tf32(False)
    model, generate, crop, max_len, bos = build_flagship("bfloat16", "cuda")
    layers = model.dec_config.num_hidden_layers
    print(f"slice: RRG from {os.path.relpath(CONFIG, ROOT)}: densenet169 + "
          f"{layers}-layer decoder, hidden {model.dec_config.hidden_size}, vocab "
          f"{model.dec_config.vocab_size}, bf16, beam {BEAM}, max_len {max_len}")
    batch = host_batch(16, crop, SEED)

    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    result = serve(model, generate, batch, crop, "cuda")
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}

    seqs, scores, steps = result.sequences, result.scores, result.steps
    print(f"slice batch 16: sequences {tuple(seqs.shape)}, {steps} decode steps, "
          f"launches {launches}")
    checks = {
        "shape (16, max_len)": tuple(seqs.shape) == (16, max_len),
        "BOS in column 0": bool((seqs[:, 0] == bos).all()),
        "ids in the vocabulary": bool(((seqs >= 0) & (seqs < VOCAB)).all()),
        "finite scores": bool(torch.isfinite(scores).all()),
        "crop_normalize launched": launches["crop_normalize"] >= 1,
        "beam attention = layers x steps": launches["fused_beam_cache_attention"] == layers * steps,
        "lm head = steps": launches["lm_head_blocked_stats"] == steps,
        "steps > 0": steps > 0,
    }
    for name, ok in checks.items():
        print(f"  check {name}: {'ok' if ok else 'FAILED'}")
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        fail(f"slice checks {bad}")

    for b in (16, 128):
        batch = host_batch(b, crop, SEED + b)
        serve(model, generate, batch, crop, "cuda")  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, steps_seen = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            res = serve(model, generate, batch, crop, "cuda")
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            steps_seen.append(res.steps)
        med = statistics.median(times)
        spread = (max(times) - min(times)) / med * 100
        print(f"slice batch {b}: {b / med:.2f} reports/s (median of 3: {med * 1e3:.1f} ms "
              f"per batch, spread {spread:.1f}%, steps {steps_seen}, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
    del model, generate
    torch.cuda.empty_cache()
    return launches


def phase_parity():
    """f32, TF32 off: the card (kernels) and the CPU (plain versions) must
    choose the same beams."""
    import torch

    set_tf32(False)
    results = {}
    for device in ("cuda", "cpu"):
        model, generate, crop, _, _ = build_flagship("float32", device)
        res = serve(model, generate, host_batch(2, crop, SEED + 7), crop, device)
        results[device] = (res.sequences.cpu(), res.scores.float().cpu(), res.steps)
        del model, generate
    (s_gpu, sc_gpu, n_gpu), (s_cpu, sc_cpu, n_cpu) = results["cuda"], results["cpu"]
    diff = (sc_gpu - sc_cpu).abs().max().item()
    same = torch.equal(s_gpu, s_cpu)
    print(f"parity f32 batch 2: sequences {'equal' if same else 'DIFFER'} "
          f"({n_gpu} vs {n_cpu} steps), max |score diff| {diff:.3e}")
    if not same:
        fail("f32 beam sequences differ between the card and the CPU")


# --------------------------------------------------------- VisionLanguage


def build_vl(dtype: str, device: str):
    """VisionLanguage from its config at full width: vocab 50368, random
    weights from SEED. Returns the model, its generate and the config's
    serving settings."""
    from vilmedic_torch import registry
    from vilmedic_torch.config import load_config
    from vilmedic_torch.models.vision_language import make_vl_generate_fn

    cfg, _ = load_config(VL_CONFIG, [f"model.dtype={dtype}"])
    model = registry.build("model", cfg.model, vision_hf_config=VL_TOWER, vocab_size=VL_VOCAB,
                           bos_token_id=VL_BOS, eos_token_id=VL_EOS, pad_token_id=VL_PAD,
                           device=device, seed=SEED)
    serving = dict(max_len=int(cfg.dataset.seq.tokenizer_max_len),
                   beam=int(cfg.ensemblor.beam_width), batch=int(cfg.ensemblor.batch_size),
                   image=int(cfg.dataset.image.crop))
    generate = make_vl_generate_fn(model, serving["beam"], serving["max_len"], VL_BOS, VL_EOS,
                                   VL_PAD)
    return model, generate, serving


def vl_images(b: int, size: int, seed: int):
    """A batch of normalized float images (B, 3, size, size) in pinned host
    memory, as an eval loader leaves it."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    return torch.randn(b, 3, size, size, generator=gen).pin_memory()


def phase_vl_slice():
    import torch

    set_tf32(False)
    model, generate, sv = build_vl("bfloat16", "cuda")
    module = model.module
    tower_layers = module.vision.model.config.num_hidden_layers
    layers = model.dec_config.num_hidden_layers
    print(f"VL slice: VisionLanguage from {os.path.relpath(VL_CONFIG, ROOT)}: DINOv2 "
          f"{tower_layers} layers x {module.vision.width} at {sv['image']}², prefix "
          f"{module.num_image_tokens} tokens, {layers}-layer LM hidden "
          f"{model.dec_config.hidden_size}, FFN {model.dec_config.intermediate_size}, vocab "
          f"{model.dec_config.vocab_size}, bf16, beam {sv['beam']}, max_len {sv['max_len']}")
    b = sv["batch"]
    images = vl_images(b, sv["image"], SEED)

    def serve():  # H2D of the float batch, then generate
        return generate(images.to("cuda", non_blocking=True))

    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    result = serve()
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}

    seqs, scores, steps = result.sequences, result.scores, result.steps
    print(f"VL batch {b}: sequences {tuple(seqs.shape)}, {steps} decode steps, "
          f"launches {launches}")
    checks = {
        f"shape ({b}, max_len)": tuple(seqs.shape) == (b, sv["max_len"]),
        "BOS in column 0": bool((seqs[:, 0] == VL_BOS).all()),
        "ids in the vocabulary": bool(((seqs >= 0) & (seqs < VL_VOCAB)).all()),
        "finite scores": bool(torch.isfinite(scores).all()),
        "flash = tower + LM layers": launches["flash_attention"] == tower_layers + layers,
        "beam attention = layers x steps": launches["fused_beam_cache_attention"] == layers * steps,
        "steps > 0": steps > 0,
    }
    for name, ok in checks.items():
        print(f"  check {name}: {'ok' if ok else 'FAILED'}")
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        fail(f"VL slice checks {bad}")

    torch.cuda.reset_peak_memory_stats()
    times, steps_seen = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        res = serve()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        steps_seen.append(res.steps)
    med = statistics.median(times)
    spread = (max(times) - min(times)) / med * 100
    print(f"VL batch {b}: {b / med:.2f} reports/s (median of 3: {med * 1e3:.1f} ms per batch, "
          f"spread {spread:.1f}%, steps {steps_seen}, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")

    # one batch split by the host clock: tower alone, prefill (tower included)
    # alone, then the whole generate; decode is the rest
    with torch.inference_mode():
        img = images.to("cuda")
        split = {}
        for name, fn in (("tower", lambda: module.vision(img)),
                         ("prefill", lambda: module.prefill(img, sv["max_len"])),
                         ("generate", lambda: generate(img))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            split[name] = time.perf_counter() - t0
    decode = split["generate"] - split["prefill"]
    print(f"VL batch {b} split: tower {split['tower'] * 1e3:.1f} ms, prefill after the tower "
          f"{(split['prefill'] - split['tower']) * 1e3:.1f} ms, decode {decode * 1e3:.1f} ms "
          f"({out.steps} steps, {decode / out.steps * 1e3:.2f} ms per step)")
    del model, generate, module
    torch.cuda.empty_cache()
    return launches


def phase_vl_parity():
    """f32, TF32 off, full width: the card (kernels) and the CPU (plain
    versions) must choose the same beams."""
    import torch

    set_tf32(False)
    model, generate, sv = build_vl("float32", "cpu")
    images = vl_images(2, sv["image"], SEED + 7)
    t0 = time.perf_counter()
    res_cpu = generate(images)
    cpu_s = time.perf_counter() - t0
    model.module.to("cuda")
    res_gpu = generate(images.to("cuda"))
    torch.cuda.synchronize()
    diff = (res_gpu.scores.cpu() - res_cpu.scores).abs().max().item()
    same = torch.equal(res_gpu.sequences.cpu(), res_cpu.sequences)
    print(f"VL parity f32 batch 2 ({model.module.vision.model.config.num_hidden_layers} tower "
          f"+ {model.dec_config.num_hidden_layers} LM layers, CPU half {cpu_s:.1f} s): sequences "
          f"{'equal' if same else 'DIFFER'} ({res_gpu.steps} vs {res_cpu.steps} steps), "
          f"max |score diff| {diff:.3e}")
    if not same:
        fail("VL f32 beam sequences differ between the card and the CPU")


# ------------------------------------------------ VisionLanguage training


def vl_trainor(overrides, device: str, tower=None, batches=()):
    """The port's ``Trainor`` over the VisionLanguage config's ``model:`` and
    ``trainor:`` blocks (with dotlist ``overrides``), random weights from
    SEED, on a list of batches."""
    from vilmedic_torch.config import load_config
    from vilmedic_torch.config.config import executor_config
    from vilmedic_torch.executors import Trainor

    cfg, _ = load_config(VL_CONFIG, list(overrides))
    return Trainor(executor_config(cfg, "trainor"), seed=SEED, loader=list(batches),
                   device=device,
                   model_kwargs=dict(vision_hf_config=tower or VL_TOWER, vocab_size=VL_VOCAB,
                                     bos_token_id=VL_BOS, eos_token_id=VL_EOS,
                                     pad_token_id=VL_PAD))


def to_device(batch, device):
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


def vl_train_batches(n: int, b: int, size: int, seed: int):
    """``n`` training batches made from ``seed``: float (b, 3, size, size)
    images in pinned host memory, and ids of length T_MAX (BOS, random
    tokens, EOS) with a padded tail of random length."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    batches = []
    for _ in range(n):
        lengths = torch.randint(T_MAX // 2, T_MAX + 1, (b,), generator=gen)
        ids = torch.randint(0, VL_BOS, (b, T_MAX), generator=gen)
        pos = torch.arange(T_MAX)[None, :]
        ids[:, 0] = VL_BOS
        ids = torch.where(pos == lengths[:, None] - 1, VL_EOS, ids)
        mask = (pos < lengths[:, None]).long()
        ids = torch.where(mask.bool(), ids, VL_PAD)
        images = torch.randn(b, 3, size, size, generator=gen)
        batches.append({"images": images.pin_memory(), "input_ids": ids,
                        "attention_mask": mask})
    return batches


def device_ms(fn):
    """(host ms, device-busy ms) of ``fn`` ended by a synchronize; device
    busy sums the CUDA kernels, copies and sets that ``torch.profiler``
    records, K5's and K4's among them by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
    dev = {"all": 0.0, "K5": 0.0, "K4": 0.0}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.end - e.time_range.start
        dev["all"] += us / 1e3
        if "flash_bwd" in e.name:
            dev["K5"] += us / 1e3
        elif "flash_fwd" in e.name:
            dev["K4"] += us / 1e3
    return out, host, dev


def phase_vl_train():
    """bf16 at full width and depth: 8 microbatches of 16 (2 AdamW updates
    at grad_accu 4) through the trainer, checked and timed."""
    import torch

    set_tf32(False)
    gen_batches = vl_train_batches(8, 16, 518, SEED + 11)
    trainer = vl_trainor([], "cuda", batches=gen_batches)
    model, module = trainer.model, trainer.model.module
    layers = model.dec_config.num_hidden_layers
    n_params = sum(p.numel() for p in trainer.tx.params)
    print(f"VL train: {os.path.relpath(VL_CONFIG, ROOT)} trainor: batch 16, "
          f"{trainer.config.optimizer} lr {trainer.base_lr:g}, grad_accu {trainer.grad_accu}, "
          f"warmup {trainer.training_scheduler.warmup_steps} updates; {layers}-layer LM over "
          f"{module.num_image_tokens} + {T_MAX} tokens, bf16, dropout "
          f"{model.dec_config.hidden_dropout_prob}; {len(trainer.tx.params)} trainable tensors "
          f"({n_params / 1e6:.1f} M f32), frozen {model.frozen_prefixes}")
    tower = {n: p.detach().clone() for n, p in module.named_parameters()
             if n.startswith("vision.")}
    before = [p.detach().clone() for p in trainer.tx.params]
    updates = []
    real_apply = trainer.apply_step

    def apply_and_record(lr, gate_loss):
        stepped = real_apply(lr, gate_loss)
        moved = sum(not torch.equal(p, p0) for p, p0 in zip(trainer.tx.params, before))
        updates.append((lr, stepped, moved))
        return stepped

    trainer.apply_step = apply_and_record
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    losses = trainer.train_epoch(0)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    trainer.apply_step = real_apply

    n = len(gen_batches)
    print(f"VL train: {n} microbatches, losses {[round(x, 4) for x in losses]}, launches "
          f"{launches}")
    for i, (lr, stepped, moved) in enumerate(updates, start=1):
        print(f"  update {i} at lr {lr:.4g}{' (the warmup starts at 0)' if lr == 0 else ''}: "
              f"{'stepped' if stepped else 'SKIPPED'}, {moved} of {len(before)} trainable "
              f"tensors differ from the initial weights")
    checks = {
        "every loss finite": len(losses) == n and all(map(math.isfinite, losses)),
        "tower bitwise unchanged": all(torch.equal(p, tower[n_]) for n_, p in
                                       module.named_parameters() if n_.startswith("vision.")),
        "2 updates, the first at lr 0 moves nothing": len(updates) == 2 and updates[0][0] == 0
        and updates[0][2] == 0,
        "every trainable tensor moved after update 2": len(updates) == 2 and updates[1][1]
        and updates[1][2] == len(before),
        "K4 with LSE = LM layers per microbatch": launches["flash_attention_with_lse"] == layers * n,
        "K5 dq = LM layers per microbatch": launches["flash_attention_bwd_dq"] == layers * n,
        "K5 dk/dv = LM layers per microbatch": launches["flash_attention_bwd_dkv"] == layers * n,
        "tower K4 = tower layers per microbatch": launches["flash_attention"]
        == module.vision.model.config.num_hidden_layers * n,
    }
    for name, ok in checks.items():
        print(f"  check {name}: {'ok' if ok else 'FAILED'}")
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        fail(f"VL train checks {bad}")
    del tower, before

    # timing: microbatches and updates by the host clock, each ended by a
    # synchronize (the epoch above was the warm-up)
    torch.cuda.reset_peak_memory_stats()
    batches = [to_device(b, "cuda") for b in gen_batches[:4]]
    lr = trainer.training_scheduler.current_lr()
    micro, per_update = [], []
    for _ in range(3):
        t_update = 0.0
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = trainer.grad_step(batch)
            torch.cuda.synchronize()
            micro.append(time.perf_counter() - t0)
            t_update += micro[-1]
        t0 = time.perf_counter()
        trainer.apply_step(lr, loss)
        torch.cuda.synchronize()
        per_update.append(t_update + time.perf_counter() - t0)
    ms_micro, ms_update = statistics.median(micro) * 1e3, statistics.median(per_update) * 1e3
    tokens = 16 * (module.num_image_tokens + T_MAX)
    print(f"VL train bf16 batch 16: {ms_micro:.1f} ms per microbatch (median of {len(micro)}, "
          f"{min(micro) * 1e3:.1f}-{max(micro) * 1e3:.1f}), {ms_update:.1f} ms per update of "
          f"{trainer.grad_accu} microbatches (median of 3), {tokens / ms_micro * 1e3:.0f} tokens/s, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # one microbatch and its update split by stage: host ms and device-busy
    # ms per stage (torch.profiler); LM forward = forward minus the tower
    batch = batches[0]
    trainer.zero_grads()
    with torch.no_grad():
        _, tower_host, tower_dev = device_ms(lambda: module.vision(batch["images"]))
    out, fwd_host, fwd_dev = device_ms(lambda: model.apply_train(batch, trainer.generator))
    _, bwd_host, bwd_dev = device_ms(lambda: out["loss"].backward())
    _, opt_host, opt_dev = device_ms(lambda: trainer.apply_step(lr, out["loss"].detach()))
    print(f"VL train split (host ms / device-busy ms): tower {tower_host:.1f} / "
          f"{tower_dev['all']:.1f} (K4 {tower_dev['K4']:.1f}); LM forward "
          f"{fwd_host - tower_host:.1f} / {fwd_dev['all'] - tower_dev['all']:.1f} (K4+LSE "
          f"{fwd_dev['K4'] - tower_dev['K4']:.1f}); LM backward {bwd_host:.1f} / "
          f"{bwd_dev['all']:.1f} (K5 {bwd_dev['K5']:.1f}); optimizer {opt_host:.1f} / "
          f"{opt_dev['all']:.1f}")
    del trainer, model, module, batches, batch, out
    torch.cuda.empty_cache()
    return launches


def phase_vl_train_sanity():
    """The loss falls on one repeated batch: the config at grad_accu 1 and a
    constant lr of 1e-4 (no warmup), 11 microbatches."""
    import torch

    set_tf32(False)
    batch = vl_train_batches(1, 16, 518, SEED + 12)[0]
    trainer = vl_trainor(["trainor.grad_accu=1", "trainor.optim_params.lr=1e-4",
                          "trainor.lr_decay_params.warmup_ratio=0"], "cuda",
                         batches=[batch] * 11)
    lrs = set()
    real_current_lr = trainer.training_scheduler.current_lr

    def current_lr():
        lrs.add(real_current_lr())
        return real_current_lr()

    trainer.training_scheduler.current_lr = current_lr
    losses = trainer.train_epoch(0)
    print(f"VL train sanity (one batch repeated, grad_accu {trainer.grad_accu}, lr "
          f"{sorted(lrs)}): losses {[round(x, 4) for x in losses]}")
    if not (len(losses) == 11 and lrs == {1e-4} and losses[-1] < losses[0]):
        fail("the loss did not fall over 10 updates on a repeated batch")
    del trainer
    torch.cuda.empty_cache()


def phase_vl_train_parity():
    """f32, TF32 off, batch 2: one microbatch's gradients and one AdamW
    update on the card (kernels) and on the CPU (plain versions), from the
    same weights; the LM at full depth and width, the tower cut to 2 layers
    to bound the CPU half's time, dropout off (the two devices draw other
    masks)."""
    import torch

    set_tf32(False)
    overrides = ["model.dtype=float32", "model.decoder.hidden_dropout_prob=0.0",
                 "model.decoder.attention_probs_dropout_prob=0.0"]
    tower = dict(VL_TOWER, num_hidden_layers=2)
    batch = vl_train_batches(1, 2, 518, SEED + 13)[0]
    lr = 5e-5  # the config's
    # f32 sums in another order through 12 layers at T 1470; relative to each
    # tensor's largest gradient entry. A key-projection bias has an exactly 0
    # gradient (softmax is shift-invariant per row): held against its weight's
    tol = 1e-3
    got = {}
    state = None
    for device in ("cpu", "cuda"):
        trainer = vl_trainor(overrides, device, tower=tower, batches=[batch])
        if state is None:
            state = {k: v.clone() for k, v in trainer.model.module.state_dict().items()}
        else:
            trainer.model.module.load_state_dict(state)
        t0 = time.perf_counter()
        loss = trainer.grad_step(to_device(batch, device))
        grads = {n: p.grad.detach().cpu().clone() for n, p in zip(trainer.tx.names,
                                                                   trainer.tx.params)}
        trainer.apply_step(lr, loss)
        params = {n: p.detach().cpu().clone() for n, p in zip(trainer.tx.names, trainer.tx.params)}
        got[device] = (float(loss), grads, params, time.perf_counter() - t0)
        lm_layers = trainer.model.dec_config.num_hidden_layers
        del trainer
    (l_cpu, g_cpu, p_cpu, s_cpu), (l_gpu, g_gpu, p_gpu, _) = got["cpu"], got["cuda"]
    worst_rel, worst_name, bad = 0.0, "", []
    for name, want in g_cpu.items():
        ref = name[:-len("bias")] + "weight" if name.endswith("self_attn.k.bias") else name
        rel = (g_gpu[name] - want).abs().max().item() / g_cpu[ref].abs().max().item()
        if rel > worst_rel:
            worst_rel, worst_name = rel, name
        if not rel <= tol:
            bad.append(name)
    step_err = max((p_gpu[n] - p_cpu[n]).abs().max().item() for n in p_cpu)
    print(f"VL train parity f32 batch 2 ({tower['num_hidden_layers']} "
          f"tower + {lm_layers} LM layers, CPU half {s_cpu:.1f} s): loss {l_gpu:.6f} card vs {l_cpu:.6f} "
          f"CPU; {len(g_cpu)} gradients, worst relative error {worst_rel:.3e} ({worst_name}, tol "
          f"{tol:.0e}); params after one AdamW step at lr {lr:g}: max |diff| {step_err:.3e} (tol "
          f"{2 * lr:.0e})")
    if bad or not step_err <= 2 * lr or not abs(l_gpu - l_cpu) <= tol * abs(l_cpu):
        fail(f"VL train f32 card vs CPU: gradients {bad[:5]}, step {step_err:.3e}")
    torch.cuda.empty_cache()


def main():
    if not os.path.isdir(os.path.join(ROOT, "vilmedic_torch", "csrc")):
        fail(f"no vilmedic_torch/csrc beside {__file__}: run it from a checkout")
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)  # the config's includes are relative to the repository root
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    results = phase_kernels()
    launches = {"rrg": phase_slice()}
    phase_parity()
    launches["vl"] = phase_vl_slice()
    phase_vl_parity()
    launches["vl_train"] = phase_vl_train()
    phase_vl_train_sanity()
    phase_vl_train_parity()

    # each kernel's launches are those of the path that runs it: the RRG
    # slice (K1 stage a, K2, K3), the VisionLanguage slice (K1 stage b, K4)
    # or the VisionLanguage training phase (K4 with LSE, K5)
    kernels = [{"name": name, "route": r["route"], "source": r["source"],
                "replaces": r["replaces"], "launches": launches[r["path"]][r["counter"]],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"]}
               for name, r in results.items()]
    idle = [k["name"] for k in kernels if k["launches"] <= 0]
    if idle:
        fail(f"kernels never launched on their path: {idle}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
