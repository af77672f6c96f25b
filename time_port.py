"""Time the PyTorch port of the checkout at ROOT on one NVIDIA card and print
one JSON line:

    python3 time_port.py ROOT

- the flash kernels at the VisionLanguage shapes, through the public entry
  points of ``vilmedic_torch.ops.flash_attention`` (CUDA events, median of 9
  after 2 warm-ups, bf16): ``flash_attention`` at the tower shape (B 16,
  T 1370, H 12, D 64), causal (the prefill), and with the same H * D split
  into heads of each head dim the kernels take, ``flash_attention_with_lse``
  and ``flash_attention_backward`` at the training shape (T 1470, causal,
  padded text keys);
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
            lambda: [lm_head_blocked_stats(h, w, b) for _ in range(9)], 9)
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
    if len(sys.argv) != 2:
        raise SystemExit("usage: python3 time_port.py ROOT")
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
    result.update(time_flash())
    result["decode_kernels"] = time_decode_kernels()
    result["serving"] = time_serving()
    result["train"] = time_training(root)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
