#!/usr/bin/env python3
"""Drive the PyTorch port (``vilmedic_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. requires a CUDA device and prints the card's name and power limit;
2. builds the hand-written CUDA kernels from ``vilmedic_torch/csrc``;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes of the paths below, in float32 (TF32 off) and bfloat16, and times
   both (the flash backward K5 and K4's LSE output at the VisionLanguage
   training shape: B 16, T 1470, H 12, D 64, causal, padded text keys; the
   flash kernels' TFLOP/s and share of their bound beside
   ``scaled_dot_product_attention``, and K4 against the dense attention
   path at T 256 to 2048);
4. serves the flagship RRG beam-8 slice (``config/RRG/baseline-mimic.yml``,
   vocab 50265, random weights from a seed, bf16) on 16 uint8 images, checks
   the output and that every kernel ran, and times reports/s at batch 16 and
   128;
5. generates a batch of 2 RRG reports in float32 (TF32 off) on the card and
   on the CPU, where the plain versions run, and requires equal beam
   sequences;
   then checks K6 (the fused LM head top-16 + logsumexp, at the flagship
   head: H 768, vocab 50265 padded to 51200, N 128 and 1024) and the three
   fp8 probes K7 (a)-(c) at the JAX spike's shapes, runs K6 on the
   flagship's own head against ``_topk_and_lse`` and the spike's main
   through K7, serves the flagship's other decode routes in bf16 at batch 16
   (ensembling of two members, greedy, the cache-permute route; launch
   counts, reports/s alternated with the kernel route) and requires their f32
   beam sequences on the card to equal the CPU's (and the permute route's the
   kernel route's);
6. serves the VisionLanguage beam-8 slice
   (``config/VL/vl-dinov2-modernbert.yml``: DINOv2-B/14 at 518², 12-layer
   prefix LM, vocab 50368, random weights from a seed, bf16) on 16 float
   images, checks the output and the flash and beam-cache launch counts,
   times reports/s at batch 16 and splits one batch into tower, prefill and
   decode;
7. generates a batch of 2 VisionLanguage reports in float32 on the card and
   on the CPU and requires equal beam sequences; then serves the int8-cache
   and fused-prefix routes in bf16 and requires their f32 sequences, and
   those of the permute route (48 heads of 16, which the beam-cache kernel
   is not built for: a plain cache reordered every step), equal card vs
   CPU;
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


def require(checks: dict, phase: str):
    """Print every named check; fail the phase if any is false."""
    for name, ok in checks.items():
        print(f"  check {name}: {'ok' if ok else 'FAILED'}")
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        fail(f"{phase} checks {bad}")


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


# the H100 SXM's published rates (NVIDIA's data sheet): HBM bytes
# per second, and dense operations per second by operand type (bf16 and fp8
# on the tensor cores, f32 outside them)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "float8_e4m3fn": 1979e12}


def bound(nbytes: float, ops: float, dtype) -> dict:
    """The least time the card could take for a kernel's work: the larger of
    its bytes (each input read once, each output written once) over the HBM
    rate and its operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[str(dtype).rpartition(".")[2]] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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


def beam_cache_bound(kc, q, mask, index: int, rows: int, stats: bool = False, scales=None,
                     prefix=None) -> dict:
    """K1's bound on this run's inputs. Read: the ancestor cache rows the
    mask names below ``index`` (K and V, each distinct row once), q, k_new,
    v_new, the mask's live part, the scales, the prefix's ``p_real``
    positions; written: out, the stats, the cache rows at ``index``.
    Operations: 4 * D per head for every attended (row, key) pair."""
    t, n, hd = kc.shape
    groups = n // rows
    live = mask.view(groups, rows, t, rows)[:, :, :index] != 0
    pairs = int(live.sum()) + n  # the current step's lane included
    nbytes = (2 * int(live.any(dim=1).sum()) * hd * kc.element_size()
              + 3 * n * hd * q.element_size() + groups * rows * index * rows * mask.element_size()
              + n * hd * 4 + 2 * n * hd * kc.element_size())
    if stats:
        nbytes += 2 * n * q.shape[1] * 4
    if scales is not None:
        nbytes += scales.numel() * 4
    if prefix is not None:
        nbytes += 2 * prefix.pk.shape[0] * prefix.p_real * hd * prefix.pk.element_size()
        pairs += n * prefix.p_real
    return bound(nbytes, 4 * pairs * hd, q.dtype)


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
                    beam_cache_bound(kc, q, mask, 99, rows),
                )
    for n, (ms, plain, bd) in timing.items():
        print(f"K1 bf16 N={n} index=99: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    results["fused_beam_cache_attention"] = dict(
        route="cuda", source="vilmedic_torch/csrc/beam_cache_attention.cu",
        replaces="vilmedic_tpu/ops/beam_cache_attention.py:94",
        max_abs_err=worst, ms=timing[1024][0], plain_ms=timing[1024][1], **timing[1024][2],
        library_ms=None, path="rrg", counter="fused_beam_cache_attention",
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
    bd = beam_cache_bound(kc, q, mask, 99, rows, stats=True)
    print(f"K1 stats bf16 N={n} index=99: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    results["fused_beam_cache_attention_stats"] = dict(
        route="cuda", source="vilmedic_torch/csrc/beam_cache_attention.cu",
        replaces="vilmedic_tpu/ops/beam_cache_attention.py:94",
        max_abs_err=worst, ms=ms, plain_ms=plain, **bd, library_ms=None,
        path="vl", counter="fused_beam_cache_attention.launches_stats",
    )


def check_beam_cache_attention_int8(results):
    """Stage (c) at the VisionLanguage decode shape (16 items x beam 8): int8
    caches with per-lane scales under which about a third of k_new/v_new
    saturates, q/k_new/v_new in f32 and bf16, with the stats the merge route
    asks for; the int8 write bitwise against the plain version on the card
    and on the CPU."""
    import torch

    from vilmedic_torch.ops.beam_cache_attention import (
        fused_beam_cache_attention, fused_beam_cache_attention_reference, quantize_cache_rows,
    )

    t, heads, d, rows, n = T_MAX, 12, 64, BEAM, 128
    # as stage (b): out f32 sums in another order, bf16 p rounded against the
    # running max in the kernel and the final max in the plain version
    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    tol_m, tol_l = 1e-5, 1e-4
    worst = 0.0
    gen = torch.Generator().manual_seed(SEED + 6)
    for dtype in (torch.float32, torch.bfloat16):
        kc, vc = (torch.randint(-127, 128, (t, n, heads * d), generator=gen, dtype=torch.int8)
                  .cuda() for _ in range(2))
        q, kn, vn = (torch.randn(n, heads, d, generator=gen).to("cuda", dtype)
                     for _ in range(3))
        scales = ((torch.rand(2, heads * d, generator=gen) * 1.5 + 0.5) / 127.0).cuda()
        mask = random_ancestry_mask(n // rows, rows, t, gen, "cuda")
        for index in (0, 1, 57, 99):
            kc1, vc1, kc2, vc2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
            out, m, l = fused_beam_cache_attention(kc1, vc1, q, kn, vn, mask, index, True,
                                                   kv_scales=scales)
            ref, rm, rl = fused_beam_cache_attention_reference(kc2, vc2, q, kn, vn, mask, index,
                                                               True, kv_scales=scales)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            err_m = (m - rm).abs().max().item()
            rel_l = ((l - rl).abs() / rl).max().item()
            worst = max(worst, err, err_m)
            write_cpu = quantize_cache_rows(kn.float().cpu(), scales[0].cpu().view(heads, d))
            write_ok = (torch.equal(kc1, kc2) and torch.equal(vc1, vc2)
                        and torch.equal(kc1[index].cpu(), write_cpu.view(n, -1)))
            saturated = (kc1[index].abs() == 127).float().mean().item()
            print(f"K1 int8 {str(dtype)[6:]:8s} N={n} index={index:2d}: max|err| out {err:.3e} "
                  f"(tol {tol[dtype]:.0e}), m {err_m:.3e} (tol {tol_m:.0e}), l rel {rel_l:.3e} "
                  f"(tol {tol_l:.0e}), int8 write bitwise vs card and CPU "
                  f"{'ok' if write_ok else 'WRONG'} ({saturated:.0%} of it saturated)")
            if err > tol[dtype] or err_m > tol_m or rel_l > tol_l or not write_ok:
                fail(f"beam cache attention int8 {dtype} index={index}")
    ms = cuda_ms(lambda: fused_beam_cache_attention(kc, vc, q, kn, vn, mask, 99, True,
                                                    kv_scales=scales))
    plain = cuda_ms(lambda: fused_beam_cache_attention_reference(kc, vc, q, kn, vn, mask, 99,
                                                                 True, kv_scales=scales))
    bd = beam_cache_bound(kc, q, mask, 99, rows, stats=True, scales=scales)
    print(f"K1 int8 bf16 N={n} index=99: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    results["fused_beam_cache_attention_int8"] = dict(
        route="cuda", source="vilmedic_torch/csrc/beam_cache_attention.cu",
        replaces="vilmedic_tpu/ops/beam_cache_attention.py:94",
        max_abs_err=worst, ms=ms, plain_ms=plain, **bd, library_ms=None,
        path="vl_int8", counter="fused_beam_cache_attention.launches_int8",
    )


def check_beam_cache_attention_prefix(results):
    """Stage (d) at the VisionLanguage decode shape: a 1370-position prefix
    per item (batch 16), f32 and bf16, with and without the stats."""
    import torch

    from vilmedic_torch.ops.beam_cache_attention import (
        KernelPrefix, fused_beam_cache_attention, fused_beam_cache_attention_reference,
    )

    t, heads, d, rows, n, b = T_MAX, 12, 64, BEAM, 128, 16
    # out: sums over 1370 + 100 keys in another order; bf16 p rounded against
    # the running max in the kernel and the final max in the plain version
    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    tol_m, tol_l = 1e-5, 1e-4
    worst = 0.0
    gen = torch.Generator().manual_seed(SEED + 8)
    for dtype in (torch.float32, torch.bfloat16):
        kc, vc = (torch.randn(t, n, heads * d, generator=gen).to("cuda", dtype)
                  for _ in range(2))
        q, kn, vn = (torch.randn(n, heads, d, generator=gen).to("cuda", dtype)
                     for _ in range(3))
        pk, pv = (torch.randn(b, VL_TOKENS, heads * d, generator=gen).to("cuda", dtype)
                  for _ in range(2))
        prefix = KernelPrefix(pk, pv, VL_TOKENS, BEAM)
        mask = random_ancestry_mask(n // rows, rows, t, gen, "cuda")
        for index, stats in ((0, True), (57, True), (99, True), (99, False)):
            kc1, vc1, kc2, vc2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
            got = fused_beam_cache_attention(kc1, vc1, q, kn, vn, mask, index, stats,
                                             prefix=prefix)
            want = fused_beam_cache_attention_reference(kc2, vc2, q, kn, vn, mask, index, stats,
                                                        prefix=prefix)
            torch.cuda.synchronize()
            got, want = (x if stats else (x,) for x in (got, want))
            err = (got[0] - want[0]).abs().max().item()
            err_m = (got[1] - want[1]).abs().max().item() if stats else 0.0
            rel_l = ((got[2] - want[2]).abs() / want[2]).max().item() if stats else 0.0
            worst = max(worst, err, err_m)
            write_ok = torch.equal(kc1, kc2) and torch.equal(vc1, vc2)
            print(f"K1 prefix {str(dtype)[6:]:8s} N={n} P={VL_TOKENS} index={index:2d} "
                  f"stats={stats!s:5s}: max|err| out {err:.3e} (tol {tol[dtype]:.0e}), m "
                  f"{err_m:.3e} (tol {tol_m:.0e}), l rel {rel_l:.3e} (tol {tol_l:.0e}), cache "
                  f"write bitwise {'ok' if write_ok else 'WRONG'}")
            if err > tol[dtype] or err_m > tol_m or rel_l > tol_l or not write_ok:
                fail(f"beam cache attention prefix {dtype} index={index}")
    ms = cuda_ms(lambda: fused_beam_cache_attention(kc, vc, q, kn, vn, mask, 99, prefix=prefix))
    plain = cuda_ms(lambda: fused_beam_cache_attention_reference(kc, vc, q, kn, vn, mask, 99,
                                                                 prefix=prefix))
    bd = beam_cache_bound(kc, q, mask, 99, rows, prefix=prefix)
    once = 2 * b * VL_TOKENS * heads * d * 2 / HBM_BYTES_PER_S * 1e3
    print(f"K1 prefix bf16 N={n} P={VL_TOKENS} index=99: kernel {ms:.4f} ms, plain {plain:.4f} "
          f"ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}; the prefix read once "
          f"{once:.4f} ms, 8 times {8 * once:.4f} ms)")
    results["fused_beam_cache_attention_prefix"] = dict(
        route="cuda", source="vilmedic_torch/csrc/beam_cache_attention.cu",
        replaces="vilmedic_tpu/ops/beam_cache_attention.py:94",
        max_abs_err=worst, ms=ms, plain_ms=plain, **bd, library_ms=None,
        path="vl_fused", counter="fused_beam_cache_attention.launches_prefix",
    )


def sdpa_layout(*xs):
    """(B, T, H, D) -> (B, H, T, D) contiguous, the layout
    ``scaled_dot_product_attention`` takes."""
    return [x.transpose(1, 2).contiguous() for x in xs]


def flash_bound(q, k, causal: bool, key_mask=None, tensors: int = 4, extra_bytes: int = 0,
                products: int = 2) -> dict:
    """A flash kernel's bound: ``tensors`` tensors of q's shape and dtype
    read or written plus ``extra_bytes``; ``products`` matrix products of
    2 * D operations per head for every (query, key) pair that the causal
    limit and the key mask leave."""
    import torch

    b, tq, heads, d = q.shape
    tk = k.shape[1]
    keep = torch.ones(b, tk, device=q.device) if key_mask is None else key_mask.float()
    # queries that see key j: all, or under the causal limit (query i sees
    # keys j <= i + tk - tq) those with i >= j - (tk - tq)
    j = torch.arange(tk, device=q.device)
    seers = (tq - (j - (tk - tq))).clamp(0, tq) if causal else torch.full_like(j, tq)
    pairs = float((keep * seers).sum())
    nbytes = tensors * q.numel() * q.element_size() + extra_bytes
    return bound(nbytes, products * 2 * d * heads * pairs, q.dtype)


def check_flash_attention(results):
    """K4 at the VisionLanguage tower and prefill shapes, plus a padded key
    mask and a Tq < Tk causal case. The library call beside it is
    ``scaled_dot_product_attention`` on the same inputs in its (B, H, T, D)
    layout."""
    import torch
    import torch.nn.functional as F

    from vilmedic_torch.ops.flash_attention import flash_attention, flash_attention_reference

    b, t, heads, d = 16, VL_TOKENS, 12, 64
    # f32: the same f32 products summed in another order (online softmax over
    # key tiles vs one softmax); bf16: p is rounded to bf16 against the
    # running max in the kernel and against the final max in the plain version
    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    gen = torch.Generator("cuda").manual_seed(SEED + 3)
    # the last case is the permute route's prefill (the LM at 48 heads of 16)
    cases = [("tower", t, t, False, False, heads, d), ("prefill", t, t, True, False, heads, d),
             ("padded keys", t, t, False, True, heads, d),
             ("Tq<Tk causal", 1000, t, True, False, heads, d),
             ("prefill D 16", t, t, True, False, 48, 16)]
    worst, timing = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, tq, tk, causal, padded, hc, dc in cases:
            q = torch.randn(b, tq, hc, dc, generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn(b, tk, hc, dc, generator=gen, device="cuda").to(dtype)
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
                  f"H={hc} D={dc}: max|err|={err:.3e} (tol {tol[dtype]:.0e})")
            if not err <= tol[dtype]:
                fail(f"flash attention {dtype} {name}")
            if dtype == torch.bfloat16 and name in ("tower", "prefill", "prefill D 16"):
                qh, kh, vh = sdpa_layout(q, k, v)
                timing[name] = dict(
                    ms=cuda_ms(lambda: flash_attention(q, k, v, None, causal)),
                    plain_ms=cuda_ms(lambda: flash_attention_reference(q, k, v, None, causal)),
                    library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                        qh, kh, vh, is_causal=causal)),
                    **flash_bound(q, k, causal))
                del qh, kh, vh
            del q, k, v, out, ref
    for name, tm in timing.items():
        flops = 4 * b * heads * t * t * d / (1 if name == "tower" else 2)  # H * D 768 in each
        print(f"K4 bf16 {name} T={t}: kernel {tm['ms']:.4f} ms ({flops / tm['ms'] / 1e9:.1f} "
              f"TFLOP/s, {tm['bound_ms'] / tm['ms'] * 100:.1f}% of the bound), plain "
              f"{tm['plain_ms']:.4f} ms, scaled_dot_product_attention {tm['library_ms']:.4f} ms, "
              f"bound {tm['bound_ms']:.4f} ms ({tm['bound_by']})")
    flash_dense_crossover(b, heads, d, gen)
    results["flash_attention"] = dict(
        route="cuda", source="vilmedic_torch/csrc/flash_attention.cu",
        replaces="vilmedic_tpu/ops/flash_attention.py:287",
        max_abs_err=worst, **timing["tower"], path="vl", counter="flash_attention",
    )


def flash_dense_crossover(b: int, heads: int, d: int, gen):
    """K4 against the port's dense attention (``dot_product_attention`` with
    the flash threshold out of reach) at T 256 to 2048, bf16, with and
    without the causal mask: where flash starts to pay on this card (the
    thresholds ``FLASH_MIN_LEN(_TRAIN)`` are the JAX package's)."""
    import torch

    import vilmedic_torch.ops.attention as attn

    for causal in (False, True):
        row = []
        for t in (256, 512, 1024, 1370, 2048):
            q, k, v = (torch.randn(b, t, heads, d, generator=gen, device="cuda").bfloat16()
                       for _ in range(3))
            flash = cuda_ms(lambda: attn.flash_attention(q, k, v, None, causal))
            threshold = attn.FLASH_MIN_LEN
            attn.FLASH_MIN_LEN = 1 << 30
            try:
                dense = cuda_ms(lambda: attn.dot_product_attention(q, k, v, dtype=q.dtype,
                                                                   causal=causal))
            finally:
                attn.FLASH_MIN_LEN = threshold
            row.append(f"T {t}: K4 {flash:.4f} / dense {dense:.4f} ms")
            del q, k, v
            torch.cuda.empty_cache()
        print(f"K4 vs dense attention bf16 B={b} H={heads} D={d} "
              f"{'causal' if causal else 'non-causal'}: " + "; ".join(row))


def train_key_mask(b: int, t: int, device):
    """The VisionLanguage training key mask: the last 20 text keys are
    padding on half of the items."""
    import torch

    mask = torch.ones(b, t, dtype=torch.bool, device=device)
    mask[b // 2:, t - 20:] = False
    return mask


def check_flash_attention_backward(results):
    """K4 with LSE and K5 (dq kernel, dk/dv/dbias kernel) at the VisionLanguage
    training shape: B 16, T 1370 + 100, H 12, D 64, causal, padded text keys.
    The library calls beside them: ``scaled_dot_product_attention`` forward
    with the causal and key masks as one boolean mask, and its backward by
    autograd (forward and backward timed together, less the forward)."""
    import torch
    import torch.nn.functional as F

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
        if dtype == torch.bfloat16:
            stats = 2 * b * heads * t * 4 + bias.numel() * 4  # lse, delta; the key bias
            timing[dtype].update(
                bound_lse=flash_bound(q, k, True, key_mask, extra_bytes=key_mask.numel()
                                      + b * heads * t * 4),
                bound_dq=flash_bound(q, k, True, key_mask, tensors=5, extra_bytes=stats,
                                     products=3),
                bound_dkv=flash_bound(q, k, True, key_mask, tensors=6,
                                      extra_bytes=stats + b * heads * t * 4, products=4))
            leaves = [x.requires_grad_() for x in sdpa_layout(q, k, v)]
            (dout_h,) = sdpa_layout(dout)
            allowed = (torch.ones(t, t, dtype=torch.bool, device="cuda").tril()[None, None]
                       & key_mask[:, None, None, :])

            def sdpa_fwd_bwd():
                o = F.scaled_dot_product_attention(*leaves, attn_mask=allowed)
                torch.autograd.grad(o, leaves, dout_h)

            lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(*leaves, attn_mask=allowed))
            timing[dtype].update(lib_fwd=lib_fwd, lib_bwd=cuda_ms(sdpa_fwd_bwd) - lib_fwd)
            del leaves, dout_h, allowed
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
    bwd_bound = tm["bound_dq"]["bound_ms"] + tm["bound_dkv"]["bound_ms"]
    print(f"K4+LSE bf16 bound {tm['bound_lse']['bound_ms']:.4f} ms "
          f"({tm['bound_lse']['bound_ms'] / tm['lse'] * 100:.1f}% reached), "
          f"scaled_dot_product_attention forward {tm['lib_fwd']:.4f} ms; K5 bound dq "
          f"{tm['bound_dq']['bound_ms']:.4f} + dk/dv/dbias {tm['bound_dkv']['bound_ms']:.4f} ms "
          f"({bwd_bound / (tm['dq'] + tm['dkv']) * 100:.1f}% reached), autograd backward of "
          f"scaled_dot_product_attention {tm['lib_bwd']:.4f} ms")
    common = dict(route="cuda", path="vl_train")
    results["flash_attention_with_lse"] = dict(
        common, source="vilmedic_torch/csrc/flash_attention.cu",
        replaces="vilmedic_tpu/ops/flash_attention.py:352", max_abs_err=worst["lse"],
        ms=tm["lse"], plain_ms=tm["lse_plain"], **tm["bound_lse"], library_ms=tm["lib_fwd"],
        counter="flash_attention_with_lse")
    # each K5 kernel against the whole plain backward and the whole library
    # backward, which compute both
    results["flash_attention_bwd_dq"] = dict(
        common, source="vilmedic_torch/csrc/flash_attention_bwd.cu",
        replaces="vilmedic_tpu/ops/flash_attention.py:598", max_abs_err=worst["dq"],
        ms=tm["dq"], plain_ms=tm["bwd_plain"], **tm["bound_dq"], library_ms=tm["lib_bwd"],
        counter="flash_attention_bwd_dq")
    results["flash_attention_bwd_dkv"] = dict(
        common, source="vilmedic_torch/csrc/flash_attention_bwd.cu",
        replaces="vilmedic_tpu/ops/flash_attention.py:665", max_abs_err=worst["dkv"],
        ms=tm["dkv"], plain_ms=tm["bwd_plain"], **tm["bound_dkv"], library_ms=tm["lib_bwd"],
        counter="flash_attention_bwd_dkv")


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
                # read h, w, b; write the logits and two (N, Vp / 128) stats
                nbytes = (h.numel() + w.numel()) * 2 + vp * 4 + n * vp * 4 + 2 * n * (vp // 128) * 4
                timing[n] = dict(
                    ms=cuda_ms(lambda: lm_head_blocked_stats(h, w, b)),
                    plain_ms=cuda_ms(lambda: lm_head_blocked_stats_reference(h, w, b)),
                    product_ms=cuda_ms(lambda: torch.matmul(h, w.t())),
                    **bound(nbytes, 2 * n * hidden * vp, dtype))
    for n, tm in timing.items():
        flops = 2 * n * hidden * vp
        print(f"K2 bf16 N={n}: kernel {tm['ms']:.4f} ms ({flops / tm['ms'] / 1e9:.1f} TFLOP/s), "
              f"plain {tm['plain_ms']:.4f} ms, torch.matmul of the product only "
              f"{tm['product_ms']:.4f} ms, bound {tm['bound_ms']:.4f} ms ({tm['bound_by']})")
    tm = timing[1024]
    # no single library call computes the logits with their block stats
    results["lm_head_blocked_stats"] = dict(
        route="cuda", source="vilmedic_torch/csrc/blocked_lm_head.cu",
        replaces="vilmedic_tpu/ops/blocked_lm_head.py:52", max_abs_err=worst, ms=tm["ms"],
        plain_ms=tm["plain_ms"], bound_ms=tm["bound_ms"], bound_by=tm["bound_by"],
        library_ms=None, path="rrg", counter="lm_head_blocked_stats",
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
    # read the crop windows (uint8) and the offsets, write f32; 2 ops a value
    values = b * crop * crop * 3
    bd = bound(values + 2 * b * 4 + values * 4, 2 * values, torch.float32)
    print(f"K3 B={b}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bd['bound_ms']:.4f} ms "
          f"({bd['bound_by']})")
    results["crop_normalize"] = dict(
        route="cuda", source="vilmedic_torch/csrc/image_preproc.cu",
        replaces="vilmedic_tpu/ops/image_preproc.py:48",
        max_abs_err=err, ms=ms, plain_ms=plain, **bd, library_ms=None,
        path="rrg", counter="crop_normalize",
    )


def topk_agrees(vals, idx, logits, ref, tol: float) -> bool:
    """A kernel's top-r (vals, idx) against f32 logits and a reference top
    r + 1 of them, ``ref = (values, columns)``: values within ``tol``;
    distinct columns, each as good as the reference's entry at its rank;
    equal columns wherever the reference's value lies more than ``tol`` from
    its neighbours (near-ties compare as sets)."""
    r = vals.shape[1]
    ref_v, ref_i = ref
    picked = logits.gather(1, idx.long())
    gaps = ref_v[:, :-1] - ref_v[:, 1:]
    lone = gaps[:, :r] > tol
    lone[:, 1:] &= gaps[:, :r - 1] > tol
    distinct = bool((idx.sort(dim=1).values.diff(dim=1) != 0).all())
    return bool((vals - ref_v[:, :r]).abs().max() <= tol
                and (picked - ref_v[:, :r]).abs().max() <= tol and distinct
                and (idx.long() == ref_i[:, :r])[lone].all())


TOPK_R, TOPK_TILE = 16, 2048  # r = 2 x beam 8; the JAX kernel's tile_v
# K6: f32 sums of 768 products of |h| ~ 1, |w| ~ 0.02 in another order
# (~1e-5); lse: a sum of exp in another order (128-column partials merged
# across blocks against one logsumexp), relative
TOL_TOPK, TOL_TOPK_LSE = 1e-4, 1e-5


def topk_bound(h, w, r: int) -> dict:
    """K6's bound: read h, w (H, Vp) and the f32 bias, write the (N, r) f32
    values and int32 columns and the (N,) lse; 2 * N * H * Vp operations."""
    n, hidden = h.shape
    vp = w.shape[1]
    nbytes = (h.numel() + w.numel()) * h.element_size() + vp * 4 + n * r * 8 + n * 4
    return bound(nbytes, 2 * n * hidden * vp, h.dtype)


def check_fused_lm_head(results):
    """K6 at the flagship head: H 768, vocab 50265 padded to 51200, r 16,
    N 128 and 1024, f32 (TF32 off) and bf16. No single library call computes
    it: the product alone (``torch.matmul``) and matmul + topk + logsumexp
    as three calls are timed beside it."""
    import torch

    from vilmedic_torch.decoding.decode import top_k
    from vilmedic_torch.ops.fused_lm_head import (
        lm_head_topk_lse, lm_head_topk_lse_reference, pad_lm_head_weights,
    )

    hidden = 768
    gen = torch.Generator().manual_seed(SEED + 9)
    w32, b32 = pad_lm_head_weights(torch.randn(hidden, VOCAB, generator=gen) * 0.02,
                                   torch.randn(VOCAB, generator=gen) * 0.02, TOPK_TILE)
    b = b32.cuda()
    worst, timing = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        w = w32.to("cuda", dtype)
        for n in (128, 1024):
            h = torch.randn(n, hidden, generator=gen).to("cuda", dtype)
            vals, idx, lse = lm_head_topk_lse(h, w, b, TOPK_R, TOPK_TILE)
            rvals, _, rlse = lm_head_topk_lse_reference(h, w, b, TOPK_R, TOPK_TILE)
            logits = h.float() @ w.float() + b
            torch.cuda.synchronize()
            ok = topk_agrees(vals, idx, logits, top_k(logits, TOPK_R + 1), TOL_TOPK)
            err = (vals - rvals).abs().max().item()
            rel = ((lse - rlse).abs() / rlse.abs()).max().item()
            worst = max(worst, err)
            print(f"K6 lm_head_topk_lse {str(dtype)[6:]:8s} N={n:5d} r={TOPK_R}: max|err| "
                  f"values {err:.3e} (tol {TOL_TOPK:.0e}), columns "
                  f"{'agree' if ok else 'DIFFER'}, lse rel {rel:.3e} (tol {TOL_TOPK_LSE:.0e})")
            if not ok or rel > TOL_TOPK_LSE:
                fail(f"fused lm head {dtype} N={n}")
            if dtype == torch.bfloat16:
                def three_calls():
                    x = torch.matmul(h, w).float() + b
                    torch.topk(x, TOPK_R)
                    torch.logsumexp(x, dim=-1)

                timing[n] = dict(
                    ms=cuda_ms(lambda: lm_head_topk_lse(h, w, b, TOPK_R, TOPK_TILE)),
                    plain_ms=cuda_ms(lambda: lm_head_topk_lse_reference(h, w, b, TOPK_R,
                                                                        TOPK_TILE)),
                    product_ms=cuda_ms(lambda: torch.matmul(h, w)),
                    three_ms=cuda_ms(three_calls), **topk_bound(h, w, TOPK_R))
            del h, logits
    for n, tm in timing.items():
        flops = 2 * n * hidden * w32.shape[1]
        print(f"K6 bf16 N={n}: kernel {tm['ms']:.4f} ms ({flops / tm['ms'] / 1e9:.1f} TFLOP/s), "
              f"plain {tm['plain_ms']:.4f} ms, torch.matmul of the product only "
              f"{tm['product_ms']:.4f} ms, matmul + topk + logsumexp {tm['three_ms']:.4f} ms, "
              f"bound {tm['bound_ms']:.4f} ms ({tm['bound_by']})")
    tm = timing[1024]
    results["lm_head_topk_lse"] = dict(
        route="cuda", source="vilmedic_torch/csrc/fused_lm_head.cu",
        replaces="vilmedic_tpu/ops/fused_lm_head.py:61", max_abs_err=worst, ms=tm["ms"],
        plain_ms=tm["plain_ms"], bound_ms=tm["bound_ms"], bound_by=tm["bound_by"],
        library_ms=None, path="topk_head", counter="lm_head_topk_lse",
    )


# K7 (b): the tensor cores may add e4m3 products with fewer bits than f32's
# 24; held to 2^-10 of sum |a| |b| for each output
TOL_FP8_MM = 2.0 ** -10


def check_fp8_probe(results):
    """K7 (a), (b), (c) at the spike's shapes against their plain versions on
    the card: (a) and (c) bitwise, with every e4m3 code (NaN, and values
    whose doubling overflows) among the inputs, and (a) at the rounding edge
    (8 x 58 = 464 -> 448) and at infinity; (b) within ``TOL_FP8_MM``. These
    are latency probes: each moves under 100 KB."""
    import torch

    from vilmedic_torch.ops.fp8_probe import (
        E4M3, fp8_matmul, fp8_matmul_reference, fp8_scale2, fp8_scale2_reference, fp8_slab_copy,
        fp8_slab_copy_reference, spike_inputs,
    )

    x, a, b = spike_inputs("cuda")
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8).cuda()
    x.view(torch.uint8)[0] = codes  # every code in the first row, NaN included
    x.view(torch.uint8)[9] = codes
    slab = x[:16].contiguous()
    checks = {}
    for scale in (2.0, 58.0, 1e38):
        got = fp8_scale2(x, scale).view(torch.uint8)
        want = fp8_scale2_reference(x, scale).view(torch.uint8)
        checks[f"(a) x {scale:g} bitwise"] = torch.equal(got, want)
    edge = fp8_scale2(codes.view(E4M3), 58.0).view(torch.uint8)
    checks["(a) 8 x 58 = 464 -> 448, 16 x 58 -> NaN"] = (edge[0x50].item() == 0x7E
                                                         and edge[0x58].item() == 0x7F)
    mm = fp8_matmul(a, b)
    mm_err = ((mm - fp8_matmul_reference(a, b)).abs()
              / (a.float().abs() @ b.float().abs())).max().item()
    checks[f"(b) within {TOL_FP8_MM:.1e} of sum |a||b|"] = mm_err <= TOL_FP8_MM
    got_c = fp8_slab_copy(slab, 8)
    checks["(c) bitwise, NaN bits included"] = torch.equal(
        got_c.view(torch.int32), fp8_slab_copy_reference(slab, 8).view(torch.int32))
    torch.cuda.synchronize()
    print(f"K7 fp8 probes: (b) max error relative to sum |a||b| {mm_err:.3e}")
    require(checks, "K7 fp8 probes")
    b_cm = b.t().contiguous().t()  # the column-major operand _scaled_mm takes
    one = torch.ones((), device="cuda")
    lib_mm = cuda_ms(lambda: torch._scaled_mm(a, b_cm, one, one, out_dtype=torch.float32))
    lib_err = (torch._scaled_mm(a, b_cm, one, one, out_dtype=torch.float32)
               - fp8_matmul_reference(a, b)).abs().max().item()
    n_a, (m, k), n_b = x.numel(), a.shape, b.shape[1]
    rows = {
        "fp8_scale2": dict(
            replaces="experiments/spike_fp8_cache.py:26", max_abs_err=0.0,
            ms=cuda_ms(lambda: fp8_scale2(x)), plain_ms=cuda_ms(lambda: fp8_scale2_reference(x)),
            **bound(2 * n_a, n_a, torch.float32), library_ms=None),
        "fp8_matmul": dict(
            replaces="experiments/spike_fp8_cache.py:47", max_abs_err=mm_err,
            ms=cuda_ms(lambda: fp8_matmul(a, b)),
            plain_ms=cuda_ms(lambda: fp8_matmul_reference(a, b)),
            **bound(m * k + k * n_b + m * n_b * 4, 2 * m * k * n_b, E4M3), library_ms=lib_mm),
        "fp8_slab_copy": dict(
            replaces="experiments/spike_fp8_cache.py:72", max_abs_err=0.0,
            ms=cuda_ms(lambda: fp8_slab_copy(slab, 8)),
            plain_ms=cuda_ms(lambda: fp8_slab_copy_reference(slab, 8)),
            **bound(8 * 256 * 5, 0, torch.float32),
            library_ms=cuda_ms(lambda: slab[:8].float())),
    }
    for name, row in rows.items():
        print(f"K7 {name}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.6f} ms ({row['bound_by']}), library "
              + ("none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms")
              + " (latency probes: launch time, not bytes)")
        results[name] = dict(route="cuda", source="vilmedic_torch/csrc/fp8_probe.cu", **row,
                             path="fp8_probe", counter=name)
    print(f"K7 fp8_matmul library: torch._scaled_mm (cuBLAS fp8, f32 out) {lib_mm:.4f} ms, "
          f"max |diff| to the plain version {lib_err:.3e}")


def phase_kernels():
    from vilmedic_torch.ops import cuda_lib

    t0 = time.perf_counter()
    cuda_lib.lib()  # builds the kernels unless this exact build exists
    print(f"build: {time.perf_counter() - t0:.1f} s ({cuda_lib.library_path().name})")
    set_tf32(False)
    results = {}
    check_beam_cache_attention(results)
    check_beam_cache_attention_stats(results)
    check_beam_cache_attention_int8(results)
    check_beam_cache_attention_prefix(results)
    check_blocked_lm_head(results)
    check_fused_lm_head(results)
    check_fp8_probe(results)
    check_crop_normalize(results)
    check_flash_attention(results)
    check_flash_attention_backward(results)
    return results


# ------------------------------------------------------------------ slice


def launch_counters():
    """Every launch count, by name: (wrapper, attribute). The beam-cache
    wrapper counts all its launches and, apart, those of stages (b), (c)
    and (d)."""
    from vilmedic_torch.ops.beam_cache_attention import fused_beam_cache_attention
    from vilmedic_torch.ops.blocked_lm_head import lm_head_blocked_stats
    from vilmedic_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_with_lse,
    )
    from vilmedic_torch.ops.fp8_probe import fp8_matmul, fp8_scale2, fp8_slab_copy
    from vilmedic_torch.ops.fused_lm_head import lm_head_topk_lse
    from vilmedic_torch.ops.image_preproc import crop_normalize

    counters = {name: (fn, "launches") for name, fn in (
        ("fused_beam_cache_attention", fused_beam_cache_attention),
        ("lm_head_blocked_stats", lm_head_blocked_stats),
        ("crop_normalize", crop_normalize),
        ("flash_attention", flash_attention),
        ("flash_attention_with_lse", flash_attention_with_lse),
        ("flash_attention_bwd_dq", flash_attention_bwd_dq),
        ("flash_attention_bwd_dkv", flash_attention_bwd_dkv),
        ("lm_head_topk_lse", lm_head_topk_lse),
        ("fp8_scale2", fp8_scale2),
        ("fp8_matmul", fp8_matmul),
        ("fp8_slab_copy", fp8_slab_copy))}
    for stage in ("launches_stats", "launches_int8", "launches_prefix"):
        counters[f"fused_beam_cache_attention.{stage}"] = (fused_beam_cache_attention, stage)
    return counters


def reset_launches():
    for fn, attr in launch_counters().values():
        setattr(fn, attr, 0)


def read_launches():
    return {name: getattr(fn, attr) for name, (fn, attr) in launch_counters().items()}


def build_flagship(dtype: str, device: str, seed: int = SEED):
    """The flagship RRG from its config, vocab 50265, random weights from
    ``seed``, with its single-model beam-8 generate (the kernel route)."""
    from vilmedic_torch import registry
    from vilmedic_torch.config import load_config
    from vilmedic_torch.models import rrg  # noqa: F401  (registers RRG)
    from vilmedic_torch.models.base import get_special_token_ids
    from vilmedic_torch.models.evaluation_nlg import make_generate_fn

    cfg, _ = load_config(CONFIG, [f"model.dtype={dtype}"])
    model = registry.build("model", cfg.model, vocab_size=VOCAB, device=device, seed=seed)
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

    reset_launches()
    result = serve(model, generate, batch, crop, "cuda")
    torch.cuda.synchronize()
    launches = read_launches()

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
    require(checks, "slice")

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


def phase_topk_head():
    """K6's own path: ``lm_head_topk_lse`` on the flagship RRG's LM head
    (its (V, H) weight transposed to the JAX layout, rounded to bf16 as the
    bf16 head computes, and padded once; the f32 bias), N(0, 1) bf16 hidden
    states at N 128 and 1024, r 16. Its columns must agree with
    ``_topk_and_lse`` over that head's f32 logits (bf16 products, f32
    sums)."""
    import torch

    from vilmedic_torch.decoding.decode import _topk_and_lse
    from vilmedic_torch.ops.fused_lm_head import lm_head_topk_lse, pad_lm_head_weights

    set_tf32(False)
    model = build_flagship("bfloat16", "cuda")[0]
    head = model.module.dec.lm_head
    with torch.no_grad():
        w, b = pad_lm_head_weights(head.weight.t().to(torch.bfloat16), head.bias, TOPK_TILE)
    gen = torch.Generator("cuda").manual_seed(SEED + 10)
    hs = [torch.randn(n, w.shape[0], generator=gen, device="cuda").to(torch.bfloat16)
          for n in (128, 1024)]
    reset_launches()
    outs = [lm_head_topk_lse(h, w, b, TOPK_R, TOPK_TILE) for h in hs]
    torch.cuda.synchronize()
    launches = read_launches()
    checks = {"K6 = 2 launches": launches["lm_head_topk_lse"] == 2}
    vocab = head.weight.shape[0]
    for h, (vals, idx, lse) in zip(hs, outs):
        logits = h.float() @ w[:, :vocab].float() + b[:vocab]
        ref_v, ref_i, ref_lse = _topk_and_lse(logits, TOPK_R + 1)
        rel = ((lse - ref_lse).abs() / ref_lse.abs()).max().item()
        checks[f"N {h.shape[0]}: top-{TOPK_R} columns agree with _topk_and_lse"] = topk_agrees(
            vals, idx, logits, (ref_v, ref_i), TOL_TOPK)
        checks[f"N {h.shape[0]}: lse rel {rel:.2e} <= {TOL_TOPK_LSE:.0e}"] = rel <= TOL_TOPK_LSE
    print(f"topk head: flagship LM head {tuple(head.weight.shape)} -> w {tuple(w.shape)} bf16, "
          f"launches {launches['lm_head_topk_lse']}")
    require(checks, "topk head")
    del model, w, b, hs, outs
    torch.cuda.empty_cache()
    return launches


def phase_fp8_probe():
    """K7's own path: the spike's main (``fp8_probe.probe``) on the card."""
    import torch

    from vilmedic_torch.ops.fp8_probe import probe

    reset_launches()
    res = probe("cuda")
    torch.cuda.synchronize()
    launches = read_launches()
    errs = {name: err for name, (_, err) in res.items()}
    print(f"fp8 probe (the spike's checks): {errs}, launches "
          f"{[launches[n] for n in ('fp8_scale2', 'fp8_matmul', 'fp8_slab_copy')]}")
    require({"(a) x * 2 exact": errs["scale2"] == 0.0,
             "(b) within 1e-2 of |ref| + 1e-3 (the spike's check)": errs["matmul"] <= 1e-2,
             "(c) the rows exact": errs["slab"] == 0.0,
             "one launch each": all(launches[n] == 1 for n in ("fp8_scale2", "fp8_matmul",
                                                               "fp8_slab_copy"))}, "fp8 probe")
    return launches


def permute_generate(model, max_len: int, ids):
    """The cache-permute route at the flagship's width. ``make_generate_fn``
    takes it only for a decoder whose head dim K1 is not built for, and the
    flagship's 64 is one K1 takes, so this drives the port's ``beam_search``
    over the plain self cache directly, after make_generate_fn's one-member
    set-up: encode, ``init_cache``, the self cache tiled for the beams, the
    blocked-stats head (K2)."""
    import torch
    from vilmedic_torch.blocks.transformer import make_blocked_head_weights
    from vilmedic_torch.decoding import beam_search, tile_for_beams

    module = model.module

    @torch.inference_mode()
    def generate(enc_inputs):
        images = enc_inputs["images"]
        enc_h, enc_m = module.encode(images, enc_inputs.get("images_mask"))
        self_cache, cross_cache = module.init_cache(enc_h, max_len)
        self_cache = tile_for_beams(self_cache, BEAM)
        head = make_blocked_head_weights(module.dec) + ("stats",)
        enc_m = enc_m.to(torch.int32)

        def step_fn(tokens, index):
            return module.decode_step(tokens, self_cache, cross_cache, enc_m, index,
                                      blocked_head=head)

        return beam_search(step_fn, images.shape[0], BEAM, max_len, *ids, images.device,
                           caches=self_cache)

    return generate


def rrg_routes(models, max_len: int):
    """The flagship's decode routes: the kernel route (one member, beam 8),
    ensembling (every member, beam 8), greedy (one member) and the permute
    route (one member, beam 8, :func:`permute_generate`)."""
    from vilmedic_torch.models.base import get_special_token_ids
    from vilmedic_torch.models.evaluation_nlg import make_generate_fn

    ids = get_special_token_ids(models[0].dec_config)
    return {
        "kernel": make_generate_fn(models[:1], BEAM, max_len, *ids),
        "ensemble": make_generate_fn(models, BEAM, max_len, *ids),
        "greedy": make_generate_fn(models[:1], 1, max_len, *ids),
        "permute": permute_generate(models[0], max_len, ids),
    }


def phase_rrg_routes():
    """bf16, batch 16, the flagship config: ensembling of two members (seeds
    0 and 1), greedy and the permute route beside the kernel route, each
    checked with its launch counts, then timed in alternated blocks (kernel,
    ensemble, greedy, permute, then back); greedy at batch 128 too. Also the
    f32 blocked head that ensembling runs per member per step."""
    import torch

    set_tf32(False)
    first, _, crop, max_len, bos = build_flagship("bfloat16", "cuda")
    models = [first, build_flagship("bfloat16", "cuda", SEED + 1)[0]]
    routes = rrg_routes(models, max_len)
    layers = models[0].dec_config.num_hidden_layers
    print(f"RRG routes: {os.path.relpath(CONFIG, ROOT)}, bf16, batch 16: ensemble of 2 "
          f"(seeds {SEED}, {SEED + 1}) beam {BEAM}, greedy, permute beam {BEAM}")
    batch = host_batch(16, crop, SEED + 20)
    runs = {}
    for name, generate in routes.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        res = serve(models[0], generate, batch, crop, "cuda")
        torch.cuda.synchronize()
        runs[name] = (res, read_launches(), torch.cuda.max_memory_allocated() / 2**30)
    kernel_seqs = runs["kernel"][0].sequences
    for name in ("ensemble", "greedy", "permute"):
        res, launches, _ = runs[name]
        seqs, steps = res.sequences, res.steps
        k1, k2 = launches["fused_beam_cache_attention"], launches["lm_head_blocked_stats"]
        print(f"RRG {name} route batch 16: sequences {tuple(seqs.shape)}, {steps} decode steps "
              f"({steps} host syncs), launches K1 {k1}, K2 {k2}, K3 {launches['crop_normalize']}")
        checks = {
            "shape (16, max_len)": tuple(seqs.shape) == (16, max_len),
            "BOS in column 0": bool((seqs[:, 0] == bos).all()),
            "ids in the vocabulary": bool(((seqs >= 0) & (seqs < VOCAB)).all()),
            "crop_normalize launched": launches["crop_normalize"] >= 1,
            "steps > 0": steps > 0,
        }
        if name == "greedy":
            checks["lengths in [1, max_len]"] = bool(((res.lengths >= 1)
                                                      & (res.lengths <= max_len)).all())
            checks["K1 = 0, K2 = 0"] = k1 == 0 and k2 == 0
        else:
            checks["finite scores"] = bool(torch.isfinite(res.scores).all())
        if name == "ensemble":
            checks["K1 = members x layers x steps"] = k1 == 2 * layers * steps
            checks["K2 = 0 (no stats head for two members)"] = k2 == 0
        if name == "permute":
            checks["K1 = 0"] = k1 == 0
            checks["K2 = steps"] = k2 == steps
        require(checks, f"RRG {name} route")
    agree = (runs["permute"][0].sequences == kernel_seqs).all(dim=1).float().mean().item()
    print(f"RRG permute route: {agree:.4f} of 16 beam sequences equal to the kernel route's in "
          f"bf16 (reported; f32 equality is required in the parity phase)")

    times = {name: [] for name in routes}
    for name in ("kernel", "ensemble", "greedy", "permute", "permute", "greedy", "ensemble",
                 "kernel"):
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serve(models[0], routes[name], batch, crop, "cuda")
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    for name, ts in times.items():
        med = statistics.median(ts)
        print(f"RRG {name:8s} route batch 16: {16 / med:.2f} reports/s (median of {len(ts)} in "
              f"two alternated blocks: {16 / statistics.median(ts[:3]):.2f} / "
              f"{16 / statistics.median(ts[3:]):.2f}; spread {(max(ts) - min(ts)) / med * 100:.1f}%), "
              f"{runs[name][0].steps} steps, peak {runs[name][2]:.2f} GiB")
    big = host_batch(128, crop, SEED + 21)
    serve(models[0], routes["greedy"], big, crop, "cuda")  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ts, steps_seen = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        res = serve(models[0], routes["greedy"], big, crop, "cuda")
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
        steps_seen.append(res.steps)
    med = statistics.median(ts)
    print(f"RRG greedy route batch 128: {128 / med:.2f} reports/s (median of 3, spread "
          f"{(max(ts) - min(ts)) / med * 100:.1f}%, steps = host syncs {steps_seen}, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")

    # the f32 blocked head each ensemble member runs per step
    from vilmedic_torch.blocks.transformer import make_blocked_head_weights

    dec = models[0].module.dec
    blocked = make_blocked_head_weights(dec)
    with torch.inference_mode():
        for n in (128, 1024):
            h = torch.randn(n, 1, dec.config.hidden_size, device="cuda").to(torch.bfloat16)
            ms = cuda_ms(lambda: dec._head_blocked(h, blocked))
            flops = 2 * n * dec.config.hidden_size * blocked[0].shape[0]
            print(f"RRG ensemble head (_head_blocked, f32 product) N={n}: {ms:.4f} ms per member "
                  f"per step ({flops / ms / 1e9:.1f} TFLOP/s; f32 peak outside the tensor cores "
                  f"67 TFLOP/s)")
    del first, models, routes, runs
    torch.cuda.empty_cache()


def phase_rrg_routes_parity():
    """f32, TF32 off, batch 2: each new route's sequences on the card
    (kernels) equal the CPU plain versions'; the permute route's equal the
    kernel route's on the card."""
    import torch

    set_tf32(False)
    got = {}
    for device in ("cuda", "cpu"):
        first, _, crop, max_len, _ = build_flagship("float32", device)
        models = [first, build_flagship("float32", device, SEED + 1)[0]]
        routes = rrg_routes(models, max_len)
        if device == "cpu":
            del routes["kernel"]
        batch = host_batch(2, crop, SEED + 7)
        t0 = time.perf_counter()
        got[device] = {name: serve(models[0], generate, batch, crop, device)
                       for name, generate in routes.items()}
        got[device]["seconds"] = time.perf_counter() - t0
        del first, models, routes
    bad = []
    for name in ("ensemble", "greedy", "permute"):
        card, cpu = got["cuda"][name], got["cpu"][name]
        same = torch.equal(card.sequences.cpu(), cpu.sequences)
        diff = ("" if name == "greedy" else
                f", max |score diff| {(card.scores.cpu() - cpu.scores).abs().max().item():.3e}")
        print(f"RRG {name} route parity f32 batch 2: sequences {'equal' if same else 'DIFFER'} "
              f"({card.steps} vs {cpu.steps} steps){diff}")
        if not same:
            bad.append(name)
    same_kernel = torch.equal(got["cuda"]["permute"].sequences, got["cuda"]["kernel"].sequences)
    print(f"RRG permute vs kernel route on the card, f32: sequences "
          f"{'equal' if same_kernel else 'DIFFER'} (CPU half {got['cpu']['seconds']:.1f} s)")
    if bad or not same_kernel:
        fail(f"RRG f32 route parity: card vs CPU differ on {bad}, permute vs kernel "
             f"{'equal' if same_kernel else 'differ'}")
    torch.cuda.empty_cache()


# --------------------------------------------------------- VisionLanguage


def build_vl(dtype: str, device: str, overrides=(), tower=None):
    """VisionLanguage from its config (with dotlist ``overrides``) at full
    width: vocab 50368, random weights from SEED. Returns the model, its
    generate with the ``ensemblor:`` block's cache dtypes and the config's
    serving settings."""
    from vilmedic_torch import registry
    from vilmedic_torch.config import load_config
    from vilmedic_torch.models.vision_language import make_vl_generate_fn

    cfg, _ = load_config(VL_CONFIG, [f"model.dtype={dtype}", *overrides])
    model = registry.build("model", cfg.model, vision_hf_config=tower or VL_TOWER,
                           vocab_size=VL_VOCAB, bos_token_id=VL_BOS, eos_token_id=VL_EOS,
                           pad_token_id=VL_PAD, device=device, seed=SEED)
    serving = dict(max_len=int(cfg.dataset.seq.tokenizer_max_len),
                   beam=int(cfg.ensemblor.beam_width), batch=int(cfg.ensemblor.batch_size),
                   image=int(cfg.dataset.image.crop),
                   prefix_kv_dtype=cfg.ensemblor.get("prefix_kv_dtype"),
                   gen_kv_dtype=cfg.ensemblor.get("gen_kv_dtype"))
    generate = make_vl_generate_fn(model, serving["beam"], serving["max_len"], VL_BOS, VL_EOS,
                                   VL_PAD, prefix_kv_dtype=serving["prefix_kv_dtype"],
                                   gen_kv_dtype=serving["gen_kv_dtype"])
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

    reset_launches()
    result = serve()
    torch.cuda.synchronize()
    launches = read_launches()

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
    require(checks, "VL slice")

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


# ------------------------------- VisionLanguage int8 and fused-prefix routes

# the eval keys that turn on the int8 prefix and generated caches
INT8_SERVING = ("ensemblor.prefix_kv_dtype=int8", "ensemblor.gen_kv_dtype=int8")
OPS_LEN = 12  # max_len of the short generates whose device ops are counted


def device_ops(fn):
    """(fn's result, the number of CUDA kernel, copy and set events that
    ``torch.profiler`` records while it runs, their summed ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return out, len(events), sum(e.time_range.end - e.time_range.start for e in events) / 1e3


def phase_vl_routes():
    """bf16, full width, one model: the int8-cache route (the config with
    the ensemblor's prefix_kv_dtype and gen_kv_dtype at int8) and the
    fused-prefix route beside the merge route, each checked, then timed in
    alternated blocks (merge, int8, fused, fused, int8, merge)."""
    import torch

    from vilmedic_torch.blocks.transformer import to_kernel_cache
    from vilmedic_torch.decoding import tile_for_beams
    from vilmedic_torch.models.vision_language import derive_gen_kv_scales, make_vl_generate_fn

    set_tf32(False)
    model, generate_int8, sv = build_vl("bfloat16", "cuda", INT8_SERVING)
    module = model.module
    layers = model.dec_config.num_hidden_layers
    tower_layers = module.vision.model.config.num_hidden_layers
    b = sv["batch"]
    images = vl_images(b, sv["image"], SEED)
    args = (model, sv["beam"], sv["max_len"], VL_BOS, VL_EOS, VL_PAD)
    routes = {
        "merge": (make_vl_generate_fn(*args), {}),
        "int8": (generate_int8, dict(prefix_kv_dtype=sv["prefix_kv_dtype"],
                                     gen_kv_dtype=sv["gen_kv_dtype"])),
        "fused": (make_vl_generate_fn(*args, fused_prefix=True), dict(fused_prefix=True)),
    }
    print(f"VL routes: {os.path.relpath(VL_CONFIG, ROOT)} with {', '.join(INT8_SERVING)}, and "
          f"make_vl_generate_fn(fused_prefix=True); bf16, batch {b}, beam {sv['beam']}, max_len "
          f"{sv['max_len']}")
    img = images.to("cuda")
    with torch.inference_mode():  # the int8 route's caches, as its generate makes them
        cache, pkv, _ = module.prefill(img, sv["max_len"], quantize_prefix=True)
        kcache = to_kernel_cache(tile_for_beams(cache, sv["beam"]),
                                 scales=derive_gen_kv_scales(pkv))
        int8_leaves = (
            all(kv[0].dtype == kv[2].dtype == torch.int8 for kv in pkv)
            and all(lc["self_k_tnf"].dtype == lc["self_v_tnf"].dtype == torch.int8
                    and tuple(lc["self_kv_sc"].shape) == (2, model.dec_config.hidden_size)
                    for lc in kcache))
        del cache, pkv, kcache

    runs = {}
    for name, (generate, _) in routes.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        res = generate(img)
        torch.cuda.synchronize()
        runs[name] = (res, read_launches(), torch.cuda.max_memory_allocated() / 2**30)
    merge_seqs = runs["merge"][0].sequences
    for name, stage, letter in (("int8", "launches_int8", "c"), ("fused", "launches_prefix", "d")):
        res, launches, _ = runs[name]
        seqs, steps = res.sequences, res.steps
        print(f"VL {name} route batch {b}: sequences {tuple(seqs.shape)}, {steps} decode steps, "
              f"launches {launches}")
        per_step = layers * steps
        checks = {
            f"shape ({b}, max_len)": tuple(seqs.shape) == (b, sv["max_len"]),
            "BOS in column 0": bool((seqs[:, 0] == VL_BOS).all()),
            "ids in the vocabulary": bool(((seqs >= 0) & (seqs < VL_VOCAB)).all()),
            "finite scores": bool(torch.isfinite(res.scores).all()),
            "flash = tower + LM layers": launches["flash_attention"] == tower_layers + layers,
            f"stage ({letter}) = layers x steps":
                launches[f"fused_beam_cache_attention.{stage}"] == per_step,
            "beam attention = layers x steps": launches["fused_beam_cache_attention"] == per_step,
            "steps > 0": steps > 0,
        }
        if name == "int8":
            checks["int8 prefix and generated-cache leaves"] = int8_leaves
            checks["stage (b) stats for the merge = layers x steps"] = (
                launches["fused_beam_cache_attention.launches_stats"] == per_step)
        else:
            checks["no stage (b) launches"] = launches["fused_beam_cache_attention.launches_stats"] == 0
        require(checks, f"VL {name} route")
        agree = (seqs == merge_seqs).all(dim=1).float().mean().item()
        diff = (res.scores - runs["merge"][0].scores).abs().max().item()
        print(f"VL {name} route: {agree:.4f} of {b} beam sequences equal to the merge route's "
              f"(reported, not required), max |score diff| {diff:.3e}")

    # device ops and device-busy ms per decode step: a short generate's
    # events less its prefill's
    ops = {}
    for name, (_, kwargs) in routes.items():
        short = make_vl_generate_fn(model, sv["beam"], OPS_LEN, VL_BOS, VL_EOS, VL_PAD, **kwargs)
        res, n_all, ms_all = device_ops(lambda: short(img))
        with torch.inference_mode():
            _, n_prefill, ms_prefill = device_ops(lambda: module.prefill(
                img, OPS_LEN, quantize_prefix=name == "int8"))
        ops[name] = ((n_all - n_prefill) / res.steps, (ms_all - ms_prefill) / res.steps)

    times = {name: [] for name in routes}
    for name in ("merge", "int8", "fused", "fused", "int8", "merge"):
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            routes[name][0](images.to("cuda", non_blocking=True))
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    for name, ts in times.items():
        med = statistics.median(ts)
        print(f"VL {name:5s} route batch {b}: {b / med:.2f} reports/s (median of {len(ts)} in two "
              f"alternated blocks: {b / statistics.median(ts[:3]):.2f} / "
              f"{b / statistics.median(ts[3:]):.2f}; spread {(max(ts) - min(ts)) / med * 100:.1f}%), "
              f"{ops[name][0]:.1f} device ops and {ops[name][1]:.3f} device-busy ms per decode "
              f"step, peak {runs[name][2]:.2f} GiB")
    launches = {"vl_int8": runs["int8"][1], "vl_fused": runs["fused"][1]}
    del model, module, routes, runs, img
    torch.cuda.empty_cache()
    return launches


def phase_vl_routes_parity():
    """f32, TF32 off, batch 2: the int8-cache and fused-prefix routes on the
    card (stages c and d) and on the CPU (plain versions) must choose the same
    beams. The LM at full depth and width; the tower cut to 2 layers to bound
    the CPU half's time. Each route's agreement with the merge route on the
    card is reported beside it."""
    import torch

    from vilmedic_torch.models.vision_language import make_vl_generate_fn

    set_tf32(False)
    tower = dict(VL_TOWER, num_hidden_layers=2)
    model, generate_int8, sv = build_vl("float32", "cpu", INT8_SERVING, tower=tower)
    generates = {"int8": generate_int8, "fused": make_vl_generate_fn(
        model, sv["beam"], sv["max_len"], VL_BOS, VL_EOS, VL_PAD, fused_prefix=True)}
    images = vl_images(2, sv["image"], SEED + 7)
    t0 = time.perf_counter()
    res_cpu = {name: generate(images) for name, generate in generates.items()}
    cpu_s = time.perf_counter() - t0
    model.module.to("cuda")
    merge = make_vl_generate_fn(model, sv["beam"], sv["max_len"], VL_BOS, VL_EOS,
                                VL_PAD)(images.to("cuda")).sequences.cpu()
    bad = []
    for name, generate in generates.items():
        res = generate(images.to("cuda"))
        torch.cuda.synchronize()
        same = torch.equal(res.sequences.cpu(), res_cpu[name].sequences)
        diff = (res.scores.cpu() - res_cpu[name].scores).abs().max().item()
        agree = (res.sequences.cpu() == merge).all(dim=1).float().mean().item()
        print(f"VL {name} route parity f32 batch 2 ({tower['num_hidden_layers']} tower + "
              f"{model.dec_config.num_hidden_layers} LM layers, CPU half of both routes "
              f"{cpu_s:.1f} s): sequences {'equal' if same else 'DIFFER'} ({res.steps} vs "
              f"{res_cpu[name].steps} steps), max |score diff| {diff:.3e}; {agree:.2f} of the "
              f"sequences equal to the f32 merge route's on the card (reported)")
        if not same:
            bad.append(name)
    if bad:
        fail(f"VL f32 beam sequences differ between the card and the CPU on routes {bad}")
    del model, generates
    torch.cuda.empty_cache()
    vl_permute_parity(tower, images)


def vl_permute_parity(tower, images):
    """The permute route: the LM at full width and depth with 48 heads of 16,
    a head dim the beam-cache kernel is not built for, so
    ``make_vl_generate_fn`` keeps the plain generated cache and beam search
    reorders it; the prefill's attention runs K4 at head dim 16. f32
    sequences on the card must equal the CPU's, with no K1 launch."""
    import torch

    from vilmedic_torch.models.evaluation_nlg import kernel_route_ok

    model, generate, sv = build_vl("float32", "cpu", ["model.decoder.num_attention_heads=48"],
                                   tower=tower)
    head_dim = model.dec_config.head_dim
    t0 = time.perf_counter()
    res_cpu = generate(images)
    cpu_s = time.perf_counter() - t0
    model.module.to("cuda")
    reset_launches()
    res = generate(images.to("cuda"))
    torch.cuda.synchronize()
    launches = read_launches()
    same = torch.equal(res.sequences.cpu(), res_cpu.sequences)
    diff = (res.scores.cpu() - res_cpu.scores).abs().max().item()
    print(f"VL permute route parity f32 batch 2 (head dim {head_dim}, "
          f"{tower['num_hidden_layers']} tower + {model.dec_config.num_hidden_layers} LM layers, "
          f"CPU half {cpu_s:.1f} s): sequences {'equal' if same else 'DIFFER'} ({res.steps} vs "
          f"{res_cpu.steps} steps), max |score diff| {diff:.3e}; launches {launches}")
    require({
        "head dim 16 takes the permute route": not kernel_route_ok([model], sv["beam"]),
        "sequences equal card vs CPU": same,
        "no beam-cache kernel launch": launches["fused_beam_cache_attention"] == 0,
        "flash = tower + LM layers": launches["flash_attention"]
        == tower["num_hidden_layers"] + model.dec_config.num_hidden_layers,
    }, "VL permute route")
    del model, generate
    torch.cuda.empty_cache()


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
    reset_launches()
    losses = trainer.train_epoch(0)
    torch.cuda.synchronize()
    launches = read_launches()
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
    require(checks, "VL train")
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


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main():
    if not os.path.isdir(os.path.join(ROOT, "vilmedic_torch", "csrc")):
        fail(f"no vilmedic_torch/csrc beside {__file__}: run it from a checkout")
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)  # the config's includes are relative to the repository root
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    card = card_name()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    results = phase_kernels()
    launches = {"rrg": phase_slice()}
    phase_parity()
    launches["topk_head"] = phase_topk_head()
    launches["fp8_probe"] = phase_fp8_probe()
    phase_rrg_routes()
    phase_rrg_routes_parity()
    launches["vl"] = phase_vl_slice()
    phase_vl_parity()
    launches.update(phase_vl_routes())
    phase_vl_routes_parity()
    launches["vl_train"] = phase_vl_train()
    phase_vl_train_sanity()
    phase_vl_train_parity()

    # each kernel's launches are those of the path that runs it: the RRG
    # slice (K1 stage a, K2, K3), the VisionLanguage slice (K1 stage b, K4),
    # its int8-cache route (K1 stage c), its fused-prefix route (K1 stage d),
    # the VisionLanguage training phase (K4 with LSE, K5), K6's top-k head
    # and K7's fp8 probe
    keys = ("route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    kernels = [{"name": name, **{key: launches[r["path"]][r["counter"]] if key == "launches"
                                 else r[key] for key in keys}}
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
