"""Time the PyTorch port of the checkout at ROOT on one NVIDIA card and print
one JSON line:

    python3 time_port.py ROOT [--flash-only]

(``--flash-only``: the first two items and the flash kernels above head dim
128, nothing else: bf16 256 to 512 and f32 256 to 512 at B 16, and the heads
wider than a cluster splits, bf16 5184 and f32 1088 and 2048, at B 2)

- the flash kernels at the VisionLanguage shapes, through the public entry
  points of ``vilmedic_torch.ops.flash_attention`` (CUDA events, median of 9
  after 2 warm-ups, bf16): ``flash_attention`` at the tower shape (B 16,
  T 1370, H 12, D 64), causal (the prefill), and with the same H * D split
  into heads of each head dim the kernels take, ``flash_attention_with_lse``
  and ``flash_attention_backward`` at the training shape (T 1470, causal,
  padded text keys);
- the same flash shapes in float32 (the f32 card-vs-CPU parities' route):
  the tower, the prefill, the tower's H * D as heads of 16, 32, 64 and 128,
  with LSE and the backward at the training shape; beside each, the library
  call that computes the same function, ``scaled_dot_product_attention`` in
  float32 (TF32 off: ``torch.backends.cuda.matmul.allow_tf32 = False``),
  forward and, by autograd, backward (forward and backward timed together,
  less the forward);
- the host's microseconds per call of ``flash_attention`` and of
  ``flash_attention_backward`` at a shape whose kernels take a few
  microseconds (B 1, T 128, H 1, D 64), the launches not waited for, and
  per call of the forward's C entry (``vt_flash_attention_bf16``) alone;
- the beam-cache attention (K1) through ``fused_beam_cache_attention`` at
  the decode shapes (T 100, 12 heads of 64, beam 8, index 99, bf16): stage
  (a) at N 1024 (the RRG batch of 128), (b), (c) and (d) (P 1370) at N 128
  (the VisionLanguage batch of 16), L2-cold: 12 layers' own caches (and
  prefixes) called in a row, as a decode step calls them; device ms per
  call from ``torch.profiler`` and, host-paced, events around the step
  (``chip_smoke.beam_cache_cold``); the blocked LM head (K2) through
  ``lm_head_blocked_stats`` at N 128 and 1024 (K 768, Vp 50304), device
  ms; the host's microseconds per call of both wrappers and of their C
  entries;
- the uint8 crop + normalize (K3) through ``crop_normalize`` at B 16 and 128,
  R 256 / crop 224 at random offsets and R = crop = 224 at zero offsets (the
  serving path's batches); the fused LM head top-16 + logsumexp (K6) through
  ``lm_head_topk_lse`` at N 128 and 1024 (H 768, vocab 50265 padded to
  51200, bf16) beside ``torch.matmul`` of its product and matmul + topk +
  logsumexp; the fp8 probes (K7 a-c) at the spike's shapes beside
  ``torch._scaled_mm`` and ``x[:8].float()``: all device ms per call
  (``torch.profiler``);
- the flash kernels above head dim 128 (after the first item): bf16, B 16,
  T 1370, 3 heads of 256, 320, 384, 448 and 512, and f32 at 3 heads of 256,
  320, 384 and 512, and at B 2 the heads wider than a cluster splits, bf16
  5184 and f32 1088 and 2048 (forward, causal forward, with LSE and the
  whole backward, causal, padded text keys), CUDA events;
  ``null`` where the checkout raises; where the checkout pads the head dim
  (448 to 512), the padding copies alone of a forward (q, k, v in, out
  back) and of a backward (q, k, v, dO into each of the two kernels; dq,
  dk, dv back);
- serving through the slices' generate functions (the helpers of
  ``chip_smoke.py``, random weights from seed 0, bf16): RRG reports/s at
  batch 16 and 128; VisionLanguage reports/s at batch 16 on the merge, int8
  and fused-prefix routes, each with its device ops and device-busy ms per
  decode step (``torch.profiler``, a 12-token generate less its prefill);
- the VisionLanguage training microbatch through the port's ``Trainor``
  (``config/VL/vl-dinov2-modernbert.yml``, batch 16, bf16, random weights
  from seed 0): ms per ``grad_step`` by the host clock, each ended by a
  synchronize (median of 8 after 2 warm-ups), tokens/s and peak memory.

Two commits compare in one call by running the script once per checkout, in
turn (A, B, B, A): unpack the other commit with ``git archive`` into a
directory that ``.gitignore`` lists and pass that as ROOT. Each run builds
ROOT's kernels into ROOT's own build directory.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

SEED = 0
B, HEADS, D = 16, 12, 64
TOKENS = 1370  # the tower's and the prefill's length
T_MAX = 100  # text tokens in training
VL_VOCAB, VL_BOS, VL_EOS, VL_PAD = 50368, 50281, 50282, 50283
VL_TOWER = dict(model_type="dinov2", hidden_size=768, num_hidden_layers=12,
                num_attention_heads=12, mlp_ratio=4.0, patch_size=14, image_size=518,
                layer_norm_eps=1e-6, use_swiglu_ffn=False, hidden_act="gelu")


def cuda_ms(fn, reps: int = 9, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, calls: int = 400) -> float:
    """Median host time of one call, in microseconds, launches not waited for."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def key_mask(b: int, t: int):
    """The last 20 text keys are padding on half of the items."""
    import torch

    mask = torch.ones(b, t, dtype=torch.bool, device="cuda")
    mask[1::2, t - 20:] = False
    return mask


def time_flash() -> dict:
    import torch

    from vilmedic_torch.ops import cuda_lib
    from vilmedic_torch.ops import flash_attention as fa

    gen = torch.Generator("cuda").manual_seed(SEED + 3)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    q, k, v = (randn(B, TOKENS, HEADS, D) for _ in range(3))
    ms = {"tower": cuda_ms(lambda: fa.flash_attention(q, k, v, None, False)),
          "prefill": cuda_ms(lambda: fa.flash_attention(q, k, v, None, True))}
    # the tower's operations (H * D 768) split into heads of each head dim
    # the kernels take: the products' operations stay, the scores (and
    # their exponentials) grow as 768 / D
    ms["tower_by_head_dim"] = {}
    for d in getattr(fa, "HEAD_DIMS", (32, 64, 128)):
        q, k, v = (randn(B, TOKENS, HEADS * D // d, d) for _ in range(3))
        ms["tower_by_head_dim"][d] = cuda_ms(lambda: fa.flash_attention(q, k, v, None, False))
    t = TOKENS + T_MAX
    q, k, v, dout = (randn(B, t, HEADS, D) for _ in range(4))
    mask = key_mask(B, t)
    out, lse = fa.flash_attention_with_lse(q, k, v, mask, causal=True)
    ms["lse"] = cuda_ms(lambda: fa.flash_attention_with_lse(q, k, v, mask, causal=True))
    ms["backward"] = cuda_ms(
        lambda: fa.flash_attention_backward(q, k, v, mask, out, lse, dout, causal=True))
    q, k, v, dout = (randn(1, 128, 1, D) for _ in range(4))
    mask = key_mask(1, 128)
    out, lse = fa.flash_attention_with_lse(q, k, v, mask, causal=True)
    host = {"forward": host_us(lambda: fa.flash_attention(q, k, v, mask, True)),
            "backward": host_us(
                lambda: fa.flash_attention_backward(q, k, v, mask, out, lse, dout, causal=True))}
    # the forward's C entry alone, on pointers made beforehand: the library's
    # own host work per launch (tensor maps, attributes, the launch)
    lib = cuda_lib.lib()
    o = torch.empty_like(q)
    stream = cuda_lib.stream_of(o)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), 0, o.data_ptr(), lse.data_ptr(),
            1, 128, 128, 1, D, 1, D ** -0.5, stream)
    host["forward_c_entry"] = host_us(lambda: lib.vt_flash_attention_bf16(*args), calls=2000)
    return {"ms": ms, "host_us": host}


def time_flash_f32() -> dict:
    """K4 and K5 in float32 at the shapes of :func:`time_flash`, each beside
    ``scaled_dot_product_attention`` in float32 on the same inputs (its
    (B, H, T, D) layout; the causal and key masks as one boolean mask at
    the training shape), CUDA events."""
    import torch
    import torch.nn.functional as F

    from vilmedic_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(SEED + 7)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def heads_first(*xs):
        return [x.transpose(1, 2).contiguous() for x in xs]

    q, k, v = (randn(B, TOKENS, HEADS, D) for _ in range(3))
    qh, kh, vh = heads_first(q, k, v)
    ms = {"tower": cuda_ms(lambda: fa.flash_attention(q, k, v, None, False)),
          "prefill": cuda_ms(lambda: fa.flash_attention(q, k, v, None, True)),
          "sdpa_tower": cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh)),
          "sdpa_prefill": cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                                         is_causal=True)),
          "tower_by_head_dim": {}}
    del qh, kh, vh
    for d in (16, 32, 64, 128):
        q, k, v = (randn(B, TOKENS, HEADS * D // d, d) for _ in range(3))
        ms["tower_by_head_dim"][d] = cuda_ms(lambda: fa.flash_attention(q, k, v, None, False))
    del q, k, v
    t = TOKENS + T_MAX
    q, k, v, dout = (randn(B, t, HEADS, D) for _ in range(4))
    mask = key_mask(B, t)
    out, lse = fa.flash_attention_with_lse(q, k, v, mask, causal=True)
    ms["lse"] = cuda_ms(lambda: fa.flash_attention_with_lse(q, k, v, mask, causal=True))
    ms["backward"] = cuda_ms(
        lambda: fa.flash_attention_backward(q, k, v, mask, out, lse, dout, causal=True))
    leaves = [x.requires_grad_() for x in heads_first(q, k, v)]
    (dout_h,) = heads_first(dout)
    allowed = (torch.ones(t, t, dtype=torch.bool, device="cuda").tril()[None, None]
               & mask[:, None, None, :])

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(*leaves, attn_mask=allowed)
        torch.autograd.grad(o, leaves, dout_h)

    ms["sdpa_lse"] = cuda_ms(lambda: F.scaled_dot_product_attention(*leaves, attn_mask=allowed))
    ms["sdpa_backward"] = cuda_ms(sdpa_fwd_bwd) - ms["sdpa_lse"]
    return ms


def time_small_kernels() -> dict:
    """K3, K6 and K7 in device ms per call (``torch.profiler``), each beside
    the library calls that compute the same function."""
    import torch

    from vilmedic_torch.ops.fp8_probe import fp8_matmul, fp8_scale2, fp8_slab_copy, spike_inputs
    from vilmedic_torch.ops.fused_lm_head import lm_head_topk_lse, pad_lm_head_weights
    from vilmedic_torch.ops.image_preproc import crop_normalize

    cs = helpers()

    def device(fn, calls: int = 20, kernel=None):
        return cs.device_ms_per_call(lambda: [fn() for _ in range(calls)], calls,
                                     kernel and {kernel: 1})

    gen = torch.Generator().manual_seed(SEED + 2)
    ms = {}
    for b in (16, 128):
        for r, crop in ((256, 224), (224, 224)):
            img = torch.randint(0, 256, (b, r, r, 3), generator=gen, dtype=torch.uint8).cuda()
            tops = torch.randint(0, r - crop + 1, (b,), generator=gen, dtype=torch.int32).cuda()
            lefts = torch.randint(0, r - crop + 1, (b,), generator=gen, dtype=torch.int32).cuda()
            ms[f"k3_b{b}_r{r}"] = device(lambda: crop_normalize(img, tops, lefts, crop),
                                           kernel="crop_normalize_kernel")
    w, bias = pad_lm_head_weights(torch.randn(768, 50265, generator=gen) * 0.02,
                                  torch.randn(50265, generator=gen) * 0.02, 2048)
    w, bias = w.to("cuda", torch.bfloat16), bias.cuda()
    for n in (128, 1024):
        h = torch.randn(n, 768, generator=gen).to("cuda", torch.bfloat16)

        def three_calls():
            x = torch.matmul(h, w).float() + bias
            torch.topk(x, 16)
            torch.logsumexp(x, dim=-1)

        ms[f"k6_n{n}"] = device(lambda: lm_head_topk_lse(h, w, bias, 16, 2048), 9, "topk_merge")
        ms[f"k6_n{n}_matmul"] = device(lambda: torch.matmul(h, w), 9)
        ms[f"k6_n{n}_matmul_topk_logsumexp"] = device(three_calls, 9)
    x, a, b = spike_inputs("cuda")
    slab = x[:16].contiguous()
    b_cm = b.t().contiguous().t()
    one = torch.ones((), device="cuda")
    ms["k7_a"] = device(lambda: fp8_scale2(x), kernel="fp8_scale2_kernel")
    ms["k7_b"] = device(lambda: fp8_matmul(a, b), kernel="fp8_matmul_kernel")
    ms["k7_b_scaled_mm"] = device(lambda: torch._scaled_mm(a, b_cm, one, one,
                                                           out_dtype=torch.float32))
    ms["k7_c"] = device(lambda: fp8_slab_copy(slab, 8), kernel="fp8_slab_copy_kernel")
    ms["k7_c_slice_float"] = device(lambda: slab[:8].float())
    return ms


def time_flash_wide(dtype="bfloat16", widths=(256, 320, 384, 448, 512), b: int = B) -> dict:
    """K4 and K5 at 3 heads of each of ``widths`` (B ``b``, 16 unless given,
    T 1370), CUDA events, by head dim; None for a call the checkout
    refuses."""
    import torch

    from vilmedic_torch.ops import flash_attention as fa

    dtype = getattr(torch, dtype)
    gen = torch.Generator("cuda").manual_seed(SEED + 6)
    mask = key_mask(b, TOKENS)
    ms = {}
    for d in widths:
        q, k, v, dout = (torch.randn(b, TOKENS, 3, d, generator=gen, device="cuda").to(dtype)
                         for _ in range(4))
        try:
            out, lse = fa.flash_attention_with_lse(q, k, v, mask, causal=True)
        except ValueError:
            ms[d] = {"forward": None, "causal": None, "lse": None, "backward": None}
            continue
        ms[d] = {"forward": cuda_ms(lambda: fa.flash_attention(q, k, v, None, False), reps=5),
                 "causal": cuda_ms(lambda: fa.flash_attention(q, k, v, None, True), reps=5),
                 "lse": cuda_ms(lambda: fa.flash_attention_with_lse(q, k, v, mask, causal=True),
                                reps=5),
                 "backward": cuda_ms(lambda: fa.flash_attention_backward(
                     q, k, v, mask, out, lse, dout, causal=True), reps=3)}
        try:
            width = fa.padded_head_dim(d, dtype)
        except TypeError:  # a checkout whose padding does not depend on the dtype
            width = fa.padded_head_dim(d)
        if width != d:  # the wrappers' zero-padding copies alone
            wide = fa.pad_head_dim(out, width)
            ms[d]["pad_forward"] = cuda_ms(lambda: ([fa.pad_head_dim(x, width) for x in (q, k, v)],
                                                    wide[..., :d].contiguous()), reps=5)
            ms[d]["pad_backward"] = cuda_ms(
                lambda: ([fa.pad_head_dim(x, width) for x in (q, k, v, dout) for _ in range(2)],
                         [wide[..., :d].contiguous() for _ in range(3)]), reps=3)
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    return ms


def helpers():
    """``chip_smoke.py`` beside this script, as a module: its timing helpers
    and the builders of the slices, which drive the public entry points of
    the package on ``sys.path``."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def time_decode_kernels() -> dict:
    import torch

    from vilmedic_torch.ops import cuda_lib
    from vilmedic_torch.ops.beam_cache_attention import fused_beam_cache_attention
    from vilmedic_torch.ops.blocked_lm_head import lm_head_blocked_stats

    cs = helpers()
    ms, host = {}, {}
    for stage, n in (("a", 1024), ("b", 128), ("c", 128), ("d", 128)):
        cold = cs.beam_cache_cold(stage, n, SEED + 20, library=False)
        ms[f"k1_{stage}"], ms[f"k1_{stage}_events"] = cold["ms"], cold["events_ms"]
    gen = torch.Generator("cuda").manual_seed(SEED + 4)

    def bf16(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    # host time per call at the VisionLanguage shape of stage (b)
    t, n, index = T_MAX, 128, T_MAX - 1
    kc, vc, q, kn, vn = (bf16(t, n, HEADS * D), bf16(t, n, HEADS * D), bf16(n, HEADS, D),
                         bf16(n, HEADS, D), bf16(n, HEADS, D))
    mask = cs.random_ancestry_mask(n // 8, 8, t, torch.Generator().manual_seed(SEED), "cuda")
    host["k1_b"] = host_us(lambda: fused_beam_cache_attention(kc, vc, q, kn, vn, mask, index,
                                                              return_stats=True))
    lib = cuda_lib.lib()
    out, m, l = (torch.empty(n, HEADS, D, device="cuda"), torch.empty(n, HEADS, device="cuda"),
                 torch.empty(n, HEADS, device="cuda"))
    args = (kc.data_ptr(), vc.data_ptr(), q.data_ptr(), kn.data_ptr(), vn.data_ptr(),
            mask.data_ptr(), 0, 0, 0, out.data_ptr(), m.data_ptr(), l.data_ptr(), n, HEADS, D,
            t, 8, index, 0, 0, 1, D ** -0.5, cuda_lib.stream_of(out))
    host["k1_b_c_entry"] = host_us(lambda: lib.vt_beam_cache_attention_bf16(*args), calls=2000)
    w = bf16(50304, 768) * 0.02
    b = torch.randn(50304, generator=gen, device="cuda") * 0.02
    for rows in (128, 1024):
        h = bf16(rows, 768)
        ms[f"k2_n{rows}"] = cs.device_ms_per_call(
            lambda: [lm_head_blocked_stats(h, w, b) for _ in range(9)], 9,
            {"lm_head_wgmma_kernel": 1})
    host["k2"] = host_us(lambda: lm_head_blocked_stats(h, w, b), calls=100)
    lg = torch.empty(1024, 50304, device="cuda")
    mx, sm = torch.empty(1024, 393, device="cuda"), torch.empty(1024, 393, device="cuda")
    args = (h.data_ptr(), w.data_ptr(), b.data_ptr(), lg.data_ptr(), mx.data_ptr(), sm.data_ptr(),
            1024, 768, 50304, cuda_lib.stream_of(h))
    host["k2_c_entry"] = host_us(lambda: lib.vt_lm_head_blocked_stats_bf16(*args), calls=100)
    return {"ms": ms, "host_us": host}


def time_serving() -> dict:
    """Reports/s through the generate functions (median of 3 after a
    warm-up), and the VisionLanguage routes' device ops and device-busy ms
    per decode step."""
    import torch

    from vilmedic_torch.models.vision_language import make_vl_generate_fn

    cs = helpers()
    def rate(fn, b: int) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return b / statistics.median(times)

    out = {}
    model, generate, crop, _, _ = cs.build_flagship("bfloat16", "cuda")
    for b in (16, 128):
        batch = cs.host_batch(b, crop, SEED + b)
        out[f"rrg_b{b}_reports_per_s"] = rate(lambda: cs.serve(model, generate, batch, crop,
                                                               "cuda"), b)
    del model, generate
    torch.cuda.empty_cache()
    model, generate_int8, sv = cs.build_vl("bfloat16", "cuda", cs.INT8_SERVING)
    args = (model, sv["beam"], sv["max_len"], cs.VL_BOS, cs.VL_EOS, cs.VL_PAD)
    kwargs = {"merge": {}, "int8": dict(prefix_kv_dtype=sv["prefix_kv_dtype"],
                                        gen_kv_dtype=sv["gen_kv_dtype"]),
              "fused": dict(fused_prefix=True)}
    images = cs.vl_images(sv["batch"], sv["image"], SEED)
    img = images.to("cuda")
    for name, kw in kwargs.items():
        generate = make_vl_generate_fn(*args, **kw)
        out[f"vl_{name}_reports_per_s"] = rate(
            lambda: generate(images.to("cuda", non_blocking=True)), sv["batch"])
        short = make_vl_generate_fn(model, sv["beam"], cs.OPS_LEN, cs.VL_BOS, cs.VL_EOS,
                                    cs.VL_PAD, **kw)
        res, n_all, ms_all = cs.device_ops(lambda: short(img))
        with torch.inference_mode():
            _, n_pre, ms_pre = cs.device_ops(lambda: model.module.prefill(
                img, cs.OPS_LEN, quantize_prefix=name == "int8"))
        out[f"vl_{name}_device_ops_per_step"] = (n_all - n_pre) / res.steps
        out[f"vl_{name}_device_busy_ms_per_step"] = (ms_all - ms_pre) / res.steps
    del model
    torch.cuda.empty_cache()
    return out


def train_batches(n: int, seed: int):
    """``n`` batches of 16: float images at 518², ids of length T_MAX (BOS,
    random tokens, EOS) with a padded tail of random length."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    batches = []
    for _ in range(n):
        lengths = torch.randint(T_MAX // 2, T_MAX + 1, (B,), generator=gen)
        ids = torch.randint(0, VL_BOS, (B, T_MAX), generator=gen)
        pos = torch.arange(T_MAX)[None, :]
        ids[:, 0] = VL_BOS
        ids = torch.where(pos == lengths[:, None] - 1, VL_EOS, ids)
        mask = (pos < lengths[:, None]).long()
        ids = torch.where(mask.bool(), ids, VL_PAD)
        images = torch.randn(B, 3, 518, 518, generator=gen)
        batches.append({"images": images, "input_ids": ids, "attention_mask": mask})
    return batches


def time_training(root: str) -> dict:
    import torch

    from vilmedic_torch.config import load_config
    from vilmedic_torch.config.config import executor_config
    from vilmedic_torch.executors import Trainor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batches = train_batches(4, SEED + 11)
    cfg, _ = load_config(os.path.join(root, "config", "VL", "vl-dinov2-modernbert.yml"), [])
    trainer = Trainor(executor_config(cfg, "trainor"), seed=SEED, loader=list(batches),
                      device="cuda",
                      model_kwargs=dict(vision_hf_config=VL_TOWER, vocab_size=VL_VOCAB,
                                        bos_token_id=VL_BOS, eos_token_id=VL_EOS,
                                        pad_token_id=VL_PAD))
    batches = [{k: v.to("cuda") for k, v in b.items()} for b in batches]
    for batch in batches[:2]:
        trainer.grad_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    micro = []
    for i in range(8):  # gradients accumulate, as between two updates
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.grad_step(batches[i % len(batches)])
        torch.cuda.synchronize()
        micro.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(micro)
    tokens = B * (trainer.model.module.num_image_tokens + T_MAX)
    return {"ms_per_microbatch": ms, "ms_all": micro, "tokens_per_s": tokens / ms * 1e3,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def main():
    if len(sys.argv) < 2 or sys.argv[2:] not in ([], ["--flash-only"]):
        raise SystemExit("usage: python3 time_port.py ROOT [--flash-only]")
    flash_only = sys.argv[2:] == ["--flash-only"]
    root = os.path.abspath(sys.argv[1])
    if not os.path.isdir(os.path.join(root, "vilmedic_torch", "csrc")):
        raise SystemExit(f"time_port: no vilmedic_torch/csrc under {root}")
    sys.path.insert(0, root)
    os.chdir(root)  # the config's includes are relative to the checkout's root
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_port: torch.cuda.is_available() is False: this needs an NVIDIA GPU")
    from vilmedic_torch.ops import cuda_lib

    cuda_lib.lib()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    result = {"root": root, "card": card, "library": cuda_lib.library_path().name}
    result["flash_f32_ms"] = time_flash_f32()
    result.update(time_flash())
    result["flash_wide_ms"] = time_flash_wide()
    result["flash_wide_f32_ms"] = time_flash_wide("float32", (256, 320, 384, 512))
    # the heads wider than a cluster splits, at B 2
    result["flash_gemm_ms"] = {"bfloat16": time_flash_wide("bfloat16", (5184,), b=2),
                               "float32": time_flash_wide("float32", (1088, 2048), b=2)}
    if not flash_only:
        result["decode_kernels"] = time_decode_kernels()
        result["small_kernels_ms"] = time_small_kernels()
        result["serving"] = time_serving()
        result["train"] = time_training(root)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
