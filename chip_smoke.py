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
   ``scaled_dot_product_attention``, K4 at the permute route's padded head
   dim 48, and K4 against the dense attention path at T 256 to 2048; the
   beam-cache kernel K1 L2-cold, 12 layers' caches in a row, and the LM
   heads K2 and K6 at N 128 and 1024, the crop + normalize K3 at B 16 and
   128 (bitwise) and the fp8 probes K7, by ``torch.profiler`` device time,
   K1 beside ``scaled_dot_product_attention`` over the same keys; K4 and
   K5 above head dim 128: at 3 heads of 256 (B 16, T 1370) beside their
   bounds and SDPA, and at D 320 and 160 against the plain versions);
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
    parameters within the stated tolerances;
11. serves the VisionLanguage model's greedy route (beam 1: no beam-cache
    kernel) and, with ``vocab_size`` 4000, its small-vocabulary route (the
    plain head and two-stage candidates over the kernel cache) in bf16 at
    batch 16, timed beside the merge route, and requires their f32
    sequences on the card to equal the CPU's (tower cut to 2 layers);
12. trains the flagship RRG through the port's train CLI
    (``vilmedic_torch.bin.train.main`` with dotlist overrides) on a
    synthetic corpus written from the seed (512 + 32 reports over 5000
    words, so the built vocabulary takes the blocked head; JPEGs through
    ``device_preproc``): 4 RAdam steps at batch 128 in bf16 (ms per step,
    images/s, peak memory), the Validator at beam 8 (reports/s, BLEU /
    ROUGEL / METEOR / CIDERD), a best-only checkpoint, and the launches of K1, K2
    and K3 on that path (``rrg_train``); requires the loss to fall over 10
    updates on one repeated batch and the running means to leave 0
    (``rrg_train_sanity``); and runs the same CLI in f32 on the card and on
    the CPU with ``densenet_tiny`` at batch 2, requiring equal losses,
    parameters, running statistics, hypotheses and scores within the stated
    tolerances and the reloaded checkpoint to generate the same hypotheses
    (``rrg_train_parity``);
13. fine-tunes that run's best checkpoint with SCST
    (``config/RRG/rrg-scst-mimic.yml`` through the train CLI, bf16: 4
    iterations at batch 32, top-k 25, ROUGE-L rewards; rollout, reward and
    gradient ms, samples/s, the Validator's reports/s, the reward timed
    with the native and the pure-Python scorers in turns; no K1 or K2 inside
    the rollouts, K1 (a) = K2 = Validator decode steps, K3 = batches;
    ``scst_train``), trains RRS (``config/RRS/baseline-transformer-mimic.yml``
    at full width, 6 + 6 layers of 768, on synthetic findings/impression
    pairs whose target vocabulary passes 4096: 4 steps at batch 64, the
    Validator at batch 16, beam 8; K1 (a) = 6 x decode steps, K2 = decode
    steps; K1 (a) and K2 held at N 128 against their plain versions;
    ``rrs_train``), and holds the new generation paths card vs CPU in f32
    (one SCST iteration under the same injected Gumbel noise, the RRS CLI at
    2 + 2 layers, RRG_FORCE's constrained decoding; ``generation_parity``);
14. trains RRG with a ViT-B/16 tower (``config/RRG/baseline-mimic-vit.yml``
    through the train CLI on the ``rrg_train`` corpus, bf16, batch 128, 4
    steps, ``device_preproc``; the Validator at beam 8 with ROUGEL / BLEU /
    METEOR / CIDERD; K1 (a) = K2 = decode steps, K3 = batches, dense
    attention in the tower; ``rrg_vit_train``), the MVQA config
    (``config/MVQA/vqa.yml``: ResNet-50, 2 layers, 330 classes, 16 steps at
    batch 64 over 1024 synthetic JPEGs, the Validator with accuracy and
    f1-score, then the ensemble CLI over the run's checkpoint;
    ``mvqa_train``) and the CLASS config (``config/CLASS/cvamd.yml``: 1
    layer, 23 classes, 4 steps at batch 128, accuracy and auroc;
    ``class_train``), printing for each ms per step, images/s, peak memory,
    the Validator's rate and a ``torch.profiler`` host / device-busy split
    of one more step with the card's name and power limit; and holds one
    f32 training step of the MVQA config and of the ViT RRG config card vs
    CPU at full width, and the MVQA validation logits and answers
    (``tower_parity``).
15. serves the RoBERTa-width RRG (``config/RRG/biomed-roberta-baseline-mimic.yml``
    with its decoder's pretrained name pointed at a roberta-base
    ``config.json`` written into the temp dir: DenseNet-169, a 12-layer 768
    decoder with cross-attention and the BERT/RoBERTa LM-head transform,
    vocab 50265, beam 8, max_len 120) in bf16 at batch 16 and 128 (K1 (a) =
    12 x decode steps, K2 = steps; reports/s, device ops and device-busy ms
    per decode step; K1 (a) and K2 held at its shapes;
    ``rrg_roberta_serve``), requires its f32 beam sequences at 2 decoder
    layers equal card vs CPU (``roberta_parity``), trains ConVIRT and
    GLoRIA (``config/SELFSUP/convirt-mimic.yml``, ``gloria-mimic.yml``)
    at full width through the train CLI on the ``rrg_train`` corpus's
    JPEGs and reports with the corpus vocabulary (one epoch: 16 RAdam steps
    at batch 32, 10 Adam steps at batch 48; the Validator's
    ``validation_loss``, images/s, peak memory, a host / device-busy split;
    no kernel on these paths; GLoRIA's ensemble CLI gives the run's
    validation loss; ``convirt_train``, ``gloria_train``), and holds one f32
    training step of each card vs CPU at full width, batch 4, on the same
    ReLU branches, on random ids and on the corpus's reports, GLoRIA's
    beside an f64 witness on the CPU, and GLoRIA's zero-shot classes
    (``selfsup_parity``);
16. trains RRG_HF (``config/RRG/baseline-mimic-HF.yml``: a DeiT-shaped
    post-LN ViT-B/16 at 224², a 2-layer 768 decoder whose vocabulary and
    special ids come from the corpus tokenizer) through the train CLI on
    the ``rrg_train`` corpus's host float JPEGs at batch 128, the Validator
    at beam 8 (K1 (a) = 2 x decode steps, K2 = steps; ``rrg_hf_train``);
    the same with ``multi_image`` 2 over lines of one to three JPEGs at
    batch 64, then serves it at beam 8, batch 16, over the 394-token masked
    memory (``rrg_multi_image``); trains RRS_HF
    (``config/RRS/baseline-mimic-HF.yml`` with both blocks named by a
    roberta-base ``config.json``: 12 + 12 layers with the LM-head
    transform, bf16, batch 128, the ``rrs_train`` pairs; the Validator at
    beam 2: K1 (a) = 12 x decode steps; ``rrs_hf_train``), each with ms per
    iteration and per step, images/s or tokens/s, peak memory, a host /
    device-busy split and the Validator's reports/s; and holds f32 card vs
    CPU: one RRG_HF CLI step on a multi-image batch with an image masked
    and its beam-8 sequences, RRS_HF's beam-2 sequences at 2 + 2 layers,
    and the ``3d_densenet121`` and ``slice_encode`` features
    (``hf_parity``). The kernels phase also holds K1 (a) at beam 2, N 256.
17. trains the VisionLanguage config through the train CLI at full width
    (``vl_cli_train``: DINOv2-B/14 at 518² named by ``vision_model_name``,
    a ``config.json`` written into the temp dir; the 12-layer 768 LM; bf16,
    batch 16, grad_accu 4, 8 microbatches over 128 synthetic reports whose
    corpus vocabulary passes 4096 words; the Validator at beam 2 over 32
    reports with ROUGEL, BLEU and ``bertscore`` on a DistilBERT-base-shaped
    directory of random weights; then the ensemble CLI at beam 8 on the
    best checkpoint; K4, K4 with LSE, K5 and K1 (b) counted, K1 (b) held at
    beam 2), the same with ``model.vision.freeze=false`` without and with
    the LM's ``gradient_checkpointing`` (peak memory, ms per microbatch; the
    tower gets no gradient, as in JAX) and the DINOv2 tower trained as an
    RRG ``cnn`` (K4 with LSE and K5 non-causal at T 1370;
    ``vl_unfrozen_train``), holds K5 at the tower's shape, and runs the VL
    CLI in f32 card vs CPU at 2 + 2 layers (losses, every update with the
    tower's, hyps at beam 2 and 8, BERTScore, gradient checkpointing with
    dropout on; ``vl_cli_parity``).
18. runs the clinical scorers on the card through the normal entry points
    (``clinical_validate``): writes random-weight scorer files at their
    published shapes (CheXbert and BERTNLI ``.pth`` files of BERT-base, a
    BERT-base RadNER directory with RadGraph's labels, a DistilBERT-base
    BERTScore directory) in the layout of ``VILMEDIC_WEIGHTS_DIR``; trains
    ``config/RRG/biomed-roberta-baseline-mimic.yml`` through the train CLI
    (128 + 32 reports, one step) with its Validator at beam 8 scoring the
    config's eight metrics, the early stop on ``chexbert-5_micro
    avg_f1-score`` (K1 (a), K2, K3 counted; reports/s; each scorer's ms with
    its files read and loaded); holds the scorers f32 card vs CPU on those
    reports (CheXbert logits and labels, RadNER entities, BERTNLI labels,
    every clinical score); and runs SCST with ``[rougel, chexbert]``
    rewards, timing the reward against ``rougel`` alone. ``rrs_hf_train``'s
    Validator scores its config's metrics as written (``chexbert``,
    ``radgraph``, ``bertscore`` among them) on the same files.
19. reads the configs' pretrained tokenizers by name: before the training
    phases it writes ``allenai/biomed_roberta_base`` (a 50,265-entry
    ``vocab.json`` and its merges), ``emilyalsentzer/Bio_ClinicalBERT`` (a
    28,996-entry WordPiece ``vocab.txt``) and
    ``answerdotai/ModernBERT-base`` (a ``tokenizer.json`` of 50,280 BPE
    entries and 88 added tokens) into a temp hub cache, in plain Python,
    and points ``HF_HUB_CACHE`` at it, so the RoBERTa RRG, RRS_HF, ConVIRT,
    GLoRIA and VL phases run with their configs' tokenizers (K2 at V 50,265
    timed in ``clinical_validate``); then ``radeval_green``: a ModernBERT
    of RadEvalModernBERT's shape (22 x 768, local window 128, random
    weights) scores 32 pairs through ``compute_scores``' ``radevalbertscore``,
    f32 card vs CPU; the GREEN judge at Llama-2-7B widths behind a
    32,000-entry Llama-2-style ``tokenizer.json``: a 4-layer bf16
    checkpoint written and read through ``load_hf_llama`` judges 4 pairs,
    the full 32 layers built on the card prefill one batch of 4 whole
    prompts at the judge's max_length 2048 and decode 64 tokens (ms a step,
    peak GiB, a host / device split and the device ms by kernel under
    ``torch.profiler``), and a 2-layer f32 judge's greedy tokens card vs
    CPU.
20. loads the zoo (``zoo``): a reference-layout ``.pth`` of the flagship
    RRG (random weights from the seed, its saved config with
    ``device_preproc: true``) through ``vilmedic_torch.bin.convert_checkpoint``
    and ``AutoModel.from_pretrained`` on the card (every loaded tensor
    bitwise the file's), ``dataset.inference`` over 16 JPEGs served at beam
    8 through K3, K1 (a) and K2 (launch counts, reports/s) and f32 beams of
    2 card vs CPU; a dinov2-base ``model.safetensors`` under the VL config's
    ``vision_model_name`` in the hub cache, its 16² position grid re-gridded
    to 37² at load, one tower batch of 16 through K4, f32 tower output card
    vs CPU; the CheXbert labelling CLI over 32 reports, card vs CPU byte for
    byte; BERTScore by the name ``roberta-large`` (its 17 read layers
    written), 32 pairs warm on the card, 4 pairs card vs CPU.

21. runs the last modules of the port: ``dicom_serve`` writes 16 DICOM
    files at a chest radiograph's size (3,056 x 2,544, 12 bits stored in 16;
    explicit and implicit VR little endian, JPEG lossless SV1 and RLE;
    MONOCHROME2, and MONOCHROME1 with a window) and serves them through the
    zoo's ``AutoModel``-loaded flagship RRG (its config's image ``ext``
    ``.dcm``, ``dataset.inference``, ``device_preproc``, beam 8, bf16): ms
    per file decode for each syntax, reports/s with decode included, K3 /
    K1 (a) / K2 launches, f32 beams of 2 card = CPU; ``dist_train`` runs the
    train CLI in two subprocesses at once, one under torchrun's environment
    for a world of 1 (NCCL) and one without, f32, 2 steps and the Validator
    at beam 8, and requires equal losses, every checkpoint tensor equal and
    rank 0's one checkpoint, then forces the multi-process BatchNorm moments
    and gathered contrastive loss in the NCCL group and holds them against
    the one-process paths; ``optimizers`` holds one f32 step of sgd,
    rmsprop, adagrad, adadelta, adafactor, lamb and lion card vs CPU;
    ``hf_dataset`` reads a ``save_to_disk`` dataset (``hf_local``, a dict
    ``hf_filter``) through the flagship config's Validator. An early line
    prints whether ``datasets``, ``pyarrow``, scikit-learn and matplotlib
    are installed and the ``torch.distributed`` backends; the
    ``plot_representation`` phase is left out, since the card's machine
    has neither scikit-learn nor matplotlib.
22. runs the two pipelined training paths (``pipelined_train``, after
    ``generation_parity``): the Trainor's ``device_prefetch`` (the flagship
    config in f32, batch 8, ``device_preproc``, 3 steps with 0 and then 2,
    deterministic: losses and every checkpoint tensor bitwise equal, K3 once
    a step on the copy stream, ms an iteration of each beside ``rrg_train``'s,
    which runs at the default 2); ``overlap_rollout`` with the SCST config at
    full width through the train CLI (batch 32 over ``scst_train``'s 128
    reports: 4 steps, the last at the epoch's end, the Validator's K1 (a), K2
    and K3; then a serial and a pipelined epoch on the same trainer,
    samples/s and the rollout / reward / gradient ms of each); and the
    pipelined iteration f32 card vs CPU at ``densenet_tiny`` (3 batches and
    the flush).

The f32 CPU halves of the VisionLanguage parities (7's three, 10's and
11's) run in a helper process of this script (``--cpu-halves``, no card
visible), started before the VisionLanguage slice (6), while the card
runs the phases before them.

Any failed check raises and the exit code is non-zero. The second-to-last
line of output is a JSON summary of the kernels, the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or away from the
repository's files, it exits non-zero and prints no result.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import glob
import json
import logging
import math
import os
import statistics
import subprocess
import sys
import tempfile
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


PROFILE_PAD_S = 0.05  # idle host seconds on each side of a profiled call
# the pad level (a power of 4 of PROFILE_PAD_S) that last gave a whole trace:
# where a host needs a wide pad, the next measurement starts from it
PAD_LEVEL = [0]


def profiled(fn, pad_s: float = PROFILE_PAD_S):
    """(``fn``'s result, its CUDA events under ``torch.profiler``), ``fn``
    ended by a synchronize. The profiler drops a device event whose
    timestamp, mapped onto the host's clock, falls outside its window; where
    that mapping is off by a millisecond, the last kernels of a call that
    synchronizes just before the window closes were dropped (19 of 20, or
    all 20, of a 1 ms burst). ``pad_s`` of idle host time on each side of
    ``fn`` keeps them inside."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    return out, [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_ms_per_call(fn, calls: int, kernels: dict | None = None) -> float:
    """Device milliseconds per call: the CUDA kernels, copies and sets that
    ``torch.profiler`` records while ``fn`` (``calls`` calls, after one
    warm-up run) executes, summed over their own durations. Unlike events
    around back-to-back launches, the host's time between launches is not
    counted.

    A trace counts only when it is whole: every device event name recurs a
    multiple of ``calls`` times (the calls are alike), and each name in
    ``kernels`` (a part of a kernel's name: its launches per call) appears
    exactly ``calls`` times that often. A trace that falls short is printed
    and discarded, and the next one is padded four times wider, up to five
    pad levels; a measurement starts at the level that gave the last whole
    trace (:data:`PAD_LEVEL`). Without a whole trace the time is taken by
    CUDA events around ``fn`` instead (host gaps between launches
    included), and the line says so."""
    fn()
    for attempt in range(PAD_LEVEL[0], 5):
        _, events = profiled(fn, PROFILE_PAD_S * 4 ** attempt)
        names = collections.Counter(e.name for e in events)
        short = [f"{part}: {sum(n for name, n in names.items() if part in name)} of "
                 f"{per_call * calls}" for part, per_call in (kernels or {}).items()
                 if sum(n for name, n in names.items() if part in name) != per_call * calls]
        short += [f"{name[:60]}: {n}, not a multiple of {calls}"
                  for name, n in names.items() if n % calls]
        if events and not short:
            PAD_LEVEL[0] = attempt
            return sum(e.time_range.end - e.time_range.start for e in events) / 1e3 / calls
        print(f"  device_ms_per_call: trace {attempt + 1} discarded, incomplete: "
              f"{'; '.join(short) or 'no device event'}")
    ms = cuda_ms(fn, reps=5, warmup=0) / calls
    print(f"  device_ms_per_call: no whole trace; {ms:.4f} ms per call by CUDA "
          f"events around the {calls} calls stands in for the device time")
    return ms


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


LAYERS = 12  # the decoders' depth: a decode step calls K1 once per layer


def beam_cache_sdpa_inputs(kc, vc, q, k_new, v_new, mask, index: int, prefix=None):
    """The keys one K1 call attends, arranged for one
    ``scaled_dot_product_attention`` call: per item-group, its (t, slot)
    lanes below ``index`` (all of them, under the ancestry mask), the
    prefix (one item per group), then the group's current-step lanes (each
    row its own). Returns (q, k, v) as (groups, H, L, D) and the boolean
    mask (groups, 1, rows, L)."""
    import torch

    t, n, hd = kc.shape
    heads, d = q.shape[1:]
    groups, rows = mask.shape[:2]

    def lanes(c):
        return (c[:index].view(index, groups, rows, heads, d).permute(1, 3, 0, 2, 4)
                .reshape(groups, heads, index * rows, d))

    def own(x):
        return x.view(groups, rows, heads, d).permute(0, 2, 1, 3)

    ks, vs = [lanes(kc)], [lanes(vc)]
    allowed = [mask[:, :, :index * rows] != 0]
    if prefix is not None:
        p = prefix.p_real
        ks.append(prefix.pk[:, :p].view(groups, p, heads, d).permute(0, 2, 1, 3))
        vs.append(prefix.pv[:, :p].view(groups, p, heads, d).permute(0, 2, 1, 3))
        allowed.append(torch.ones(groups, rows, p, dtype=torch.bool, device=q.device))
    ks.append(own(k_new))
    vs.append(own(v_new))
    allowed.append(torch.eye(rows, dtype=torch.bool, device=q.device).expand(groups, rows, rows))
    return (own(q).contiguous(), torch.cat(ks, dim=2).contiguous(),
            torch.cat(vs, dim=2).contiguous(), torch.cat(allowed, dim=-1)[:, None])


def beam_cache_cold(stage: str, n: int, seed: int, library: bool = True) -> dict:
    """K1 in bf16 at the decode shape (T 100, 12 heads of 64, beam 8, index
    99; stage d with a 1370-position prefix), L2-cold: LAYERS layers' own
    caches (and prefixes) called in a row as a decode step calls them;
    device ms per call (``ms``) and, host-paced, events around the whole
    step (``events_ms``). Beside it, with ``library``,
    ``scaled_dot_product_attention`` over the same keys
    (:func:`beam_cache_sdpa_inputs`, arranged beforehand), L2-cold alike,
    device ms. The bound from the first layer's inputs."""
    import torch
    import torch.nn.functional as F

    from vilmedic_torch.ops.beam_cache_attention import KernelPrefix, fused_beam_cache_attention

    t, heads, d, index = T_MAX, 12, 64, T_MAX - 1
    gen = torch.Generator().manual_seed(seed)

    def bf16(*shape):
        return torch.randn(*shape, generator=gen).to("cuda", torch.bfloat16)

    layers = []
    for _ in range(LAYERS):
        if stage == "c":
            kc, vc = (torch.randint(-127, 128, (t, n, heads * d), generator=gen,
                                    dtype=torch.int8).cuda() for _ in range(2))
        else:
            kc, vc = bf16(t, n, heads * d), bf16(t, n, heads * d)
        kw = dict(return_stats=stage in "bc")
        if stage == "c":
            kw["kv_scales"] = ((torch.rand(2, heads * d, generator=gen) * 1.5 + 0.5)
                               / 127.0).cuda()
        if stage == "d":
            kw["prefix"] = KernelPrefix(bf16(n // BEAM, VL_TOKENS, heads * d),
                                        bf16(n // BEAM, VL_TOKENS, heads * d), VL_TOKENS, BEAM)
        layers.append((kc, vc, bf16(n, heads, d), bf16(n, heads, d), bf16(n, heads, d),
                       random_ancestry_mask(n // BEAM, BEAM, t, gen, "cuda"), kw))

    def step():
        for kc, vc, q, kn, vn, mask, kw in layers:
            fused_beam_cache_attention(kc, vc, q, kn, vn, mask, index, **kw)

    kc, vc, q, kn, vn, mask, kw = layers[0]
    out = dict(ms=device_ms_per_call(step, LAYERS, {"beam_attention_mma_kernel": 1}),
               events_ms=cuda_ms(step) / LAYERS,
               **beam_cache_bound(kc, q, mask, index, BEAM, stats=kw["return_stats"],
                                  scales=kw.get("kv_scales"), prefix=kw.get("prefix")))
    out["library_ms"] = None
    if library:
        arranged = [beam_cache_sdpa_inputs(kc, vc, q, kn, vn, mask, index, kw.get("prefix"))
                    for kc, vc, q, kn, vn, mask, kw in layers]
        del layers
        out["library_ms"] = device_ms_per_call(lambda: [F.scaled_dot_product_attention(
            qa, ka, va, attn_mask=ma) for qa, ka, va, ma in arranged], LAYERS)
        del arranged
    else:
        del layers
    torch.cuda.empty_cache()
    return out


def print_cold(label: str, cold: dict):
    lib = "none" if cold["library_ms"] is None else f"{cold['library_ms']:.4f} ms"
    print(f"{label} L2-cold ({LAYERS} layers' caches in a row): kernel {cold['ms']:.4f} device "
          f"ms per call ({cold['bound_ms'] / cold['ms'] * 100:.1f}% of the bound "
          f"{cold['bound_ms']:.4f} ms, {cold['bound_by']}; events around the step "
          f"{cold['events_ms']:.4f} ms per call), scaled_dot_product_attention over the same "
          f"keys {lib} device ms")


def hold_beam_cache_attention(dtype, n: int, gen, t: int = T_MAX, heads: int = 12, d: int = 64,
                              rows: int = BEAM, label: str = ""):
    """K1 stage (a) against its plain version at one shape, at indices 0, 1,
    57 and t - 1: output within 1e-5 (f32) or 2e-2 (bf16), the cache write
    bitwise. Returns the worst error and the inputs."""
    import torch

    from vilmedic_torch.ops.beam_cache_attention import (
        fused_beam_cache_attention, fused_beam_cache_attention_reference,
    )

    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2}[dtype]
    kc = torch.randn(t, n, heads * d, generator=gen).to("cuda", dtype)
    vc = torch.randn(t, n, heads * d, generator=gen).to("cuda", dtype)
    q, kn, vn = (torch.randn(n, heads, d, generator=gen).to("cuda", dtype) for _ in range(3))
    mask = random_ancestry_mask(n // rows, rows, t, gen, "cuda")
    worst = 0.0
    for index in (0, 1, 57, t - 1):
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
        print(f"K1 fused_beam_cache_attention{label} {str(dtype)[6:]:8s} N={n:5d} T={t} "
              f"{heads}x{d} index={index:2d}: max|err|={err:.3e} (tol {tol:.0e}), "
              f"cache write bitwise {'ok' if cache_ok else 'WRONG'}")
        if not (err <= tol and cache_ok):
            fail(f"beam cache attention{label} {dtype} N={n} T={t} index={index}")
    return worst, (kc, vc, q, kn, vn, mask)


def check_beam_cache_attention(results):
    import torch

    from vilmedic_torch.ops.beam_cache_attention import (
        fused_beam_cache_attention, fused_beam_cache_attention_reference,
    )

    rows = BEAM
    worst = 0.0
    timing = {}
    gen = torch.Generator().manual_seed(SEED)
    for dtype in (torch.float32, torch.bfloat16):
        for n in (128, 1024):
            err, (kc, vc, q, kn, vn, mask) = hold_beam_cache_attention(dtype, n, gen)
            worst = max(worst, err)
            if dtype == torch.bfloat16:
                timing[n] = (
                    cuda_ms(lambda: fused_beam_cache_attention(kc, vc, q, kn, vn, mask, 99)),
                    cuda_ms(lambda: fused_beam_cache_attention_reference(kc, vc, q, kn, vn, mask, 99)),
                    beam_cache_bound(kc, q, mask, 99, rows),
                )
    # beam 2 (the RRS_HF Validator's): 128 items of 2-row groups
    for dtype in (torch.float32, torch.bfloat16):
        err, _ = hold_beam_cache_attention(dtype, 256, gen, rows=2, label=" beam 2")
        worst = max(worst, err)
    for n, (ms, plain, bd) in timing.items():
        print(f"K1 bf16 N={n} index=99 (one cache, L2-warm): kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    del kc, vc, q, kn, vn, mask
    cold = beam_cache_cold("a", 1024, SEED + 14)
    print_cold("K1 (a) bf16 N=1024 index=99", cold)
    results["fused_beam_cache_attention"] = dict(
        route="cuda", source="vilmedic_torch/csrc/beam_cache_attention.cu",
        replaces="vilmedic_tpu/ops/beam_cache_attention.py:94",
        max_abs_err=worst, plain_ms=timing[1024][1], **cold,
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
    bd = beam_cache_bound(kc, q, mask, 99, rows, stats=True)
    print(f"K1 stats bf16 N={n} index=99 (one cache, L2-warm): kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    cold = beam_cache_cold("b", n, SEED + 15)
    print_cold(f"K1 (b) bf16 N={n} index=99", cold)
    results["fused_beam_cache_attention_stats"] = dict(
        route="cuda", source="vilmedic_torch/csrc/beam_cache_attention.cu",
        replaces="vilmedic_tpu/ops/beam_cache_attention.py:94",
        max_abs_err=worst, plain_ms=plain, **cold,
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
    print(f"K1 int8 bf16 N={n} index=99 (one cache, L2-warm): kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    # no single library call attends over int8 keys with per-lane scales
    cold = beam_cache_cold("c", n, SEED + 16, library=False)
    print_cold(f"K1 (c) bf16 N={n} index=99", cold)
    results["fused_beam_cache_attention_int8"] = dict(
        route="cuda", source="vilmedic_torch/csrc/beam_cache_attention.cu",
        replaces="vilmedic_tpu/ops/beam_cache_attention.py:94",
        max_abs_err=worst, plain_ms=plain, **cold,
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
    print(f"K1 prefix bf16 N={n} P={VL_TOKENS} index=99 (one cache, L2-warm): kernel {ms:.4f} "
          f"ms, plain {plain:.4f} "
          f"ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}; the prefix read once "
          f"{once:.4f} ms, 8 times {8 * once:.4f} ms)")
    del kc, vc, q, kn, vn, pk, pv, prefix, mask
    cold = beam_cache_cold("d", n, SEED + 17)
    print_cold(f"K1 (d) bf16 N={n} P={VL_TOKENS} index=99", cold)
    results["fused_beam_cache_attention_prefix"] = dict(
        route="cuda", source="vilmedic_torch/csrc/beam_cache_attention.cu",
        replaces="vilmedic_tpu/ops/beam_cache_attention.py:94",
        max_abs_err=worst, plain_ms=plain, **cold,
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
    limit and the key mask leave: 2 forward (S = QKᵀ, PV); 5 for the whole
    backward (S recomputed, dP = dO Vᵀ, dV = Pᵀ dO, dQ = dS K, dK = dSᵀ Q),
    of which the dq kernel alone needs 3 (S, dP, dQ) and the dk/dv kernel
    4 (S, dP, dV, dK)."""
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
    # the last cases are the permute route's prefill: the LM at 48 heads of
    # 16, and at 16 heads of 48 (a head dim K4 runs padded to 64)
    cases = [("tower", t, t, False, False, heads, d), ("prefill", t, t, True, False, heads, d),
             ("padded keys", t, t, False, True, heads, d),
             ("Tq<Tk causal", 1000, t, True, False, heads, d),
             ("prefill D 16", t, t, True, False, 48, 16),
             ("prefill D 48", t, t, True, False, 16, 48)]
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
            if dtype == torch.bfloat16 and name in ("tower", "prefill", "prefill D 16",
                                                    "prefill D 48"):
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


def flash_head_dims() -> str:
    """The head dims K4/K5 are built for and the kernels that run each, from
    ``flash_attention``'s own ``HEAD_DIMS``, ``WIDE_STEP`` and ``wide_route``."""
    import torch

    from vilmedic_torch.ops import flash_attention as fa

    def wgmma(dtype, backward: bool) -> str:
        return "/".join(str(d) for d in fa.HEAD_DIMS if not fa.wide_route(dtype, d, backward))

    wide = [d for d in fa.HEAD_DIMS if fa.wide_route(torch.float32, d, False)]
    return (f"built {'/'.join(map(str, fa.HEAD_DIMS))}; wgmma: bf16 forward "
            f"{wgmma(torch.bfloat16, False)}, bf16 backward {wgmma(torch.bfloat16, True)}, f32 "
            f"{wgmma(torch.float32, False)}; flash_attention_wide.cu: the rest of "
            f"{'/'.join(map(str, wide))} and multiples of {fa.WIDE_STEP} above "
            f"{fa.HEAD_DIMS[-1]}; other head dims zero-padded to the next of these")


FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # K4's out and K5's dq / dk / dv
FLASH_TOL_LSE, FLASH_TOL_DBIAS = 1e-5, 1e-4


def flash_grads_match(q, k, v, key_mask, causal, label, gen):
    """K4 with LSE and K5 against their plain versions on the same inputs
    and a random dO from ``gen``: out within ``FLASH_TOL`` of the plain
    forward and lse within 1e-5 (max abs), then dq, dk, dv (``FLASH_TOL``)
    and dbias (1e-4) relative to each one's largest entry, the plain
    backward taking the kernel's checked out and lse. Fails on any miss;
    returns (out, lse, dO, errors)."""
    import torch

    from vilmedic_torch.ops.flash_attention import (
        flash_attention_backward, flash_attention_backward_reference, flash_attention_reference,
        flash_attention_with_lse,
    )

    dout = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    out, lse = flash_attention_with_lse(q, k, v, key_mask, causal)
    rout, rlse = flash_attention_reference(q, k, v, key_mask, causal, return_lse=True)
    got = flash_attention_backward(q, k, v, key_mask, out, lse, dout, causal)
    want = flash_attention_backward_reference(q, k, v, key_mask, out, lse, dout, causal)
    torch.cuda.synchronize()
    errs = {"out": (out.float() - rout.float()).abs().max().item(),
            "lse": (lse - rlse).abs().max().item()}
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        errs[name] = (g.float() - w.float()).abs().max().item() / w.float().abs().max().item()
    dtype = str(q.dtype)[6:]
    tol = FLASH_TOL[dtype]
    limits = {"out": tol, "lse": FLASH_TOL_LSE, "dq": tol, "dk": tol, "dv": tol,
              "dbias": FLASH_TOL_DBIAS}
    print(f"K4/K5 {label} {dtype}: max|err| out {errs['out']:.3e}, lse {errs['lse']:.3e}; "
          f"relative dq {errs['dq']:.3e} dk {errs['dk']:.3e} dv {errs['dv']:.3e} dbias "
          f"{errs['dbias']:.3e} (tol {tol:.0e}, lse {FLASH_TOL_LSE:.0e}, dbias "
          f"{FLASH_TOL_DBIAS:.0e})")
    bad = [n for n, e in errs.items() if not e <= limits[n]]
    if bad:
        fail(f"flash attention {label} {dtype}: {bad}")
    return out, lse, dout, errs


def check_flash_wide(results):
    """K4 and K5 above head dim 128. bf16 at the VisionLanguage width split
    into 3 heads of 256 (B 16, T 1370): K4 (the wgmma kernel at D 256)
    unmasked and causal, K4 with LSE and K5 (the wide kernels) causal with
    padded keys, against the plain versions and timed beside their bounds and
    ``scaled_dot_product_attention`` (forward; forward and backward by
    autograd, less the forward). Then D 320 (the wide kernels) and D 160
    (zero-padded to 256) in f32 and bf16 against the plain versions at B 2,
    T 300 / 200, 3 heads, causal with a key mask."""
    import torch
    import torch.nn.functional as F

    from vilmedic_torch.ops.flash_attention import (
        flash_attention, flash_attention_backward, flash_attention_reference,
        flash_attention_with_lse,
    )

    gen = torch.Generator("cuda").manual_seed(SEED + 6)

    b, t, heads, d = 16, VL_TOKENS, 3, 256
    key_mask = train_key_mask(b, t, "cuda")
    q, k, v = (torch.randn(b, t, heads, d, generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    worst = 0.0
    for causal in (False, True):
        err = (flash_attention(q, k, v, None, causal).float()
               - flash_attention_reference(q, k, v, None, causal).float()).abs().max().item()
        worst = max(worst, err)
        if not err <= FLASH_TOL["bfloat16"]:
            fail(f"flash attention D 256 bf16 causal={causal}: {err:.3e}")
    out, lse, dout, errs = flash_grads_match(q, k, v, key_mask, True,
                                             f"B={b} T={t} H={heads} D={d}", gen)
    qh, kh, vh = sdpa_layout(q, k, v)
    tm = {name: cuda_ms(fn, reps=5, warmup=1) for name, fn in (
        ("fwd", lambda: flash_attention(q, k, v, None, False)),
        ("fwd_causal", lambda: flash_attention(q, k, v, None, True)),
        ("lse", lambda: flash_attention_with_lse(q, k, v, key_mask, True)),
        ("bwd", lambda: flash_attention_backward(q, k, v, key_mask, out, lse, dout, True)),
        ("sdpa", lambda: F.scaled_dot_product_attention(qh, kh, vh)),
        ("sdpa_causal", lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)))}
    tm["plain"] = cuda_ms(lambda: flash_attention_reference(q, k, v, None, False), reps=3)
    leaves = [x.requires_grad_() for x in (qh, kh, vh)]
    (dout_h,) = sdpa_layout(dout)
    allowed = (torch.ones(t, t, dtype=torch.bool, device="cuda").tril()[None, None]
               & key_mask[:, None, None, :])

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(*leaves, attn_mask=allowed)
        torch.autograd.grad(o, leaves, dout_h)

    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(*leaves, attn_mask=allowed), reps=5)
    tm["sdpa_bwd"] = cuda_ms(sdpa_fwd_bwd, reps=5) - lib_fwd
    stats = 2 * b * heads * t * 4 + b * t * 4
    bounds = {"fwd": flash_bound(q, k, False), "fwd_causal": flash_bound(q, k, True),
              "lse": flash_bound(q, k, True, key_mask, extra_bytes=key_mask.numel()
                                 + b * heads * t * 4),
              "bwd": flash_bound(q, k, True, key_mask, tensors=8, extra_bytes=stats,
                                 products=5)}
    for name in ("fwd", "fwd_causal", "lse", "bwd"):
        bd = bounds[name]
        lib = {"fwd": tm["sdpa"], "fwd_causal": tm["sdpa_causal"], "lse": lib_fwd,
               "bwd": tm["sdpa_bwd"]}[name]
        print(f"K4/K5 bf16 D 256 {name} (B {b}, T {t}, 3 heads of 256): kernel {tm[name]:.4f} ms "
              f"({bd['bound_ms'] / tm[name] * 100:.1f}% of the bound), bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}), scaled_dot_product_attention "
              f"{lib:.4f} ms")
    print(f"K4 bf16 D 256 plain version {tm['plain']:.4f} ms")
    del q, k, v, qh, kh, vh, leaves, dout_h, allowed, out, lse, dout
    torch.cuda.empty_cache()
    for d, tq, tk in ((320, 300, 300), (160, 200, 300)):
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(2, tq, 3, d, generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn(2, tk, 3, d, generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            mask = torch.ones(2, tk, dtype=torch.bool, device="cuda")
            mask[1, tk - tk // 3:] = False
            flash_grads_match(q, k, v, mask, True, f"B=2 Tq={tq} Tk={tk} H=3 D={d} causal", gen)
    # the wide kernels' speed at 3 heads of 320 (B 16, T 1370), not on any path
    q, k, v, dout = (torch.randn(b, t, heads, 320, generator=gen, device="cuda").bfloat16()
                     for _ in range(4))
    out, lse = flash_attention_with_lse(q, k, v, key_mask, True)
    qh, kh, vh = sdpa_layout(q, k, v)
    wide = {"fwd": cuda_ms(lambda: flash_attention(q, k, v, None, False), reps=3, warmup=1),
            "bwd": cuda_ms(lambda: flash_attention_backward(q, k, v, key_mask, out, lse, dout,
                                                            True), reps=3, warmup=1),
            "sdpa": cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), reps=3)}
    leaves = [x.requires_grad_() for x in (qh, kh, vh)]
    (dout_h,) = sdpa_layout(dout)
    allowed = (torch.ones(t, t, dtype=torch.bool, device="cuda").tril()[None, None]
               & key_mask[:, None, None, :])
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(*leaves, attn_mask=allowed), reps=3)
    wide["sdpa_bwd"] = cuda_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*leaves, attn_mask=allowed), leaves, dout_h),
        reps=3) - lib_fwd
    bd_f = flash_bound(q, k, False)
    bd_b = flash_bound(q, k, True, key_mask, tensors=8, extra_bytes=stats, products=5)
    print(f"K4/K5 bf16 D 320 (B {b}, T {t}, 3 heads of 320, the wide kernels): forward "
          f"{wide['fwd']:.4f} ms (bound {bd_f['bound_ms']:.4f}, {bd_f['bound_by']}; "
          f"scaled_dot_product_attention {wide['sdpa']:.4f} ms), causal backward with padded "
          f"keys {wide['bwd']:.4f} ms (bound {bd_b['bound_ms']:.4f}, {bd_b['bound_by']}; autograd "
          f"backward of scaled_dot_product_attention {wide['sdpa_bwd']:.4f} ms)")
    del q, k, v, dout, out, lse, qh, kh, vh, leaves, dout_h, allowed
    torch.cuda.empty_cache()
    results["flash_attention"]["d256"] = dict(
        ms=tm["fwd"], causal_ms=tm["fwd_causal"], lse_ms=tm["lse"], backward_ms=tm["bwd"],
        bound_ms=bounds["fwd"]["bound_ms"], backward_bound_ms=bounds["bwd"]["bound_ms"],
        library_ms=tm["sdpa"], library_backward_ms=tm["sdpa_bwd"], max_abs_err=worst,
        backward_rel_err=max(errs[n] for n in ("dq", "dk", "dv")))


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


def lm_head_weights(vocab: int, gen, hidden: int = 768):
    """A head's f32 weight and bias on the CPU, padded to a multiple of 128
    rows as the decoder pads them (zero rows, bias NEG)."""
    import torch

    from vilmedic_torch.ops.blocked_lm_head import NEG

    vp = -(-vocab // 128) * 128
    w32 = torch.randn(vp, hidden, generator=gen) * 0.02
    w32[vocab:] = 0.0
    b = torch.randn(vp, generator=gen) * 0.02
    b[vocab:] = NEG
    return w32, b


def hold_blocked_lm_head(h, w, b, label: str = "") -> float:
    """K2 against its plain version on these inputs: logits and block
    maxima within 1e-4 absolute, block sums of exponentials within 1e-4
    relative (f32 sums of 768 products of |h| ~ 1, |w| ~ 0.02 in another
    order differ by ~1e-5). Returns the logits' and maxima's error."""
    import torch

    from vilmedic_torch.ops.blocked_lm_head import (
        lm_head_blocked_stats, lm_head_blocked_stats_reference,
    )

    tol_abs, tol_rel_sum = 1e-4, 1e-4
    lg, mx, sm = lm_head_blocked_stats(h, w, b)
    rlg, rmx, rsm = lm_head_blocked_stats_reference(h, w, b)
    torch.cuda.synchronize()
    err = max((lg - rlg).abs().max().item(), (mx - rmx).abs().max().item())
    rel = ((sm - rsm).abs() / rsm).max().item()
    print(f"K2 lm_head_blocked_stats{label} {str(h.dtype)[6:]:8s} N={h.shape[0]:5d} "
          f"Vp={w.shape[0]}: max|err| logits/max={err:.3e} (tol {tol_abs:.0e}), "
          f"sumexp rel={rel:.3e} (tol {tol_rel_sum:.0e})")
    if err > tol_abs or rel > tol_rel_sum:
        fail(f"blocked lm head{label} {h.dtype} N={h.shape[0]} Vp={w.shape[0]}")
    return err


def check_blocked_lm_head(results):
    import torch

    hidden = 768
    worst = 0.0
    timing = {}
    gen = torch.Generator().manual_seed(SEED + 1)
    w32, b = lm_head_weights(VOCAB, gen, hidden)
    vp = w32.shape[0]
    b = b.cuda()
    for dtype in (torch.float32, torch.bfloat16):
        w = w32.to("cuda", dtype)
        for n in (128, 1024):
            h = torch.randn(n, hidden, generator=gen).to("cuda", dtype)
            worst = max(worst, hold_blocked_lm_head(h, w, b))
            if dtype == torch.bfloat16:
                timing[n] = time_blocked_lm_head(h, w, b)
    for n, tm in timing.items():
        report_blocked_lm_head(tm, n, VOCAB, vp, "")
    tm = timing[1024]
    # no single library call computes the logits with their block stats
    results["lm_head_blocked_stats"] = dict(
        route="cuda", source="vilmedic_torch/csrc/blocked_lm_head.cu",
        replaces="vilmedic_tpu/ops/blocked_lm_head.py:52", max_abs_err=worst, ms=tm["ms"],
        plain_ms=tm["plain_ms"], bound_ms=tm["bound_ms"], bound_by=tm["bound_by"],
        library_ms=None, path="rrg", counter="lm_head_blocked_stats",
    )


def hold_crop_normalize(b: int, r: int, crop: int, gen, label: str = ""):
    """K3 bitwise against its plain version at one shape, at random
    in-range offsets (zero where R = crop). Returns the inputs."""
    import torch

    from vilmedic_torch.ops.image_preproc import crop_normalize, crop_normalize_reference

    img = torch.randint(0, 256, (b, r, r, 3), generator=gen, dtype=torch.uint8).cuda()
    tops = torch.randint(0, r - crop + 1, (b,), generator=gen, dtype=torch.int32).cuda()
    lefts = torch.randint(0, r - crop + 1, (b,), generator=gen, dtype=torch.int32).cuda()
    out = crop_normalize(img, tops, lefts, crop)
    ref = crop_normalize_reference(img, tops, lefts, crop)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        fail(f"crop_normalize{label} B={b} R={r}: not bitwise the plain version "
             f"({(out - ref).abs().max().item():.3e})")
    return img, tops, lefts


def check_crop_normalize(results):
    """K3 bitwise against its plain version at B 16 and 128, at two shapes:
    R 256, crop 224 at random in-range offsets, and R = crop = 224 at zero
    offsets, what the serving path's ``host_batch`` feeds it (the row of the
    kernels line). Device time from ``torch.profiler``, events beside it."""
    import torch

    from vilmedic_torch.ops.image_preproc import crop_normalize, crop_normalize_reference

    gen = torch.Generator().manual_seed(SEED + 2)
    timing = {}
    for b in (16, 128):
        for r, crop in ((256, 224), (224, 224)):
            img, tops, lefts = hold_crop_normalize(b, r, crop, gen)
            # read the crop windows (uint8) and the offsets, write f32; 2 ops a value
            values = b * crop * crop * 3
            timing[b, r] = dict(
                ms=device_ms_per_call(lambda: [crop_normalize(img, tops, lefts, crop)
                                               for _ in range(20)], 20,
                                      {"crop_normalize_kernel": 1}),
                events_ms=cuda_ms(lambda: crop_normalize(img, tops, lefts, crop)),
                plain_ms=cuda_ms(lambda: crop_normalize_reference(img, tops, lefts, crop)),
                max_abs_err=0.0, **bound(values + 2 * b * 4 + values * 4, 2 * values,
                                         torch.float32))
            tm = timing[b, r]
            print(f"K3 crop_normalize B={b} R={r} crop={crop}: bitwise; kernel {tm['ms']:.4f} "
                  f"device ms ({tm['bound_ms'] / tm['ms'] * 100:.1f}% of the bound; events "
                  f"around one call {tm['events_ms']:.4f} ms), plain {tm['plain_ms']:.4f} ms, "
                  f"bound {tm['bound_ms']:.4f} ms ({tm['bound_by']})")
            del img
    tm = timing[16, 224]
    results["crop_normalize"] = dict(
        route="cuda", source="vilmedic_torch/csrc/image_preproc.cu",
        replaces="vilmedic_tpu/ops/image_preproc.py:74",
        max_abs_err=max(t["max_abs_err"] for t in timing.values()), ms=tm["ms"],
        plain_ms=tm["plain_ms"], bound_ms=tm["bound_ms"], bound_by=tm["bound_by"],
        library_ms=None, path="rrg", counter="crop_normalize",
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
                    ms=device_ms_per_call(lambda: [lm_head_topk_lse(h, w, b, TOPK_R, TOPK_TILE)
                                                   for _ in range(9)], 9,
                                          {"topk_wgmma": 1, "topk_merge": 1}),
                    events_ms=cuda_ms(lambda: lm_head_topk_lse(h, w, b, TOPK_R, TOPK_TILE)),
                    plain_ms=cuda_ms(lambda: lm_head_topk_lse_reference(h, w, b, TOPK_R,
                                                                        TOPK_TILE)),
                    product_ms=device_ms_per_call(lambda: [torch.matmul(h, w)
                                                           for _ in range(9)], 9),
                    three_ms=device_ms_per_call(lambda: [three_calls() for _ in range(9)], 9),
                    values_err=err, lse_rel=rel, **topk_bound(h, w, TOPK_R))
            del h, logits
    for n, tm in timing.items():
        flops = 2 * n * hidden * w32.shape[1]
        print(f"K6 bf16 N={n}: kernel {tm['ms']:.4f} device ms ({flops / tm['ms'] / 1e9:.1f} "
              f"TFLOP/s, {tm['bound_ms'] / tm['ms'] * 100:.1f}% of the bound; events around one "
              f"call {tm['events_ms']:.4f} ms), plain {tm['plain_ms']:.4f} ms, torch.matmul of "
              f"the product only {tm['product_ms']:.4f} device ms, matmul + topk + logsumexp "
              f"{tm['three_ms']:.4f} device ms, bound {tm['bound_ms']:.4f} ms ({tm['bound_by']}); "
              f"max|err| values {tm['values_err']:.3e}, lse rel {tm['lse_rel']:.3e}")
    tm = timing[1024]
    results["lm_head_topk_lse"] = dict(
        route="cuda", source="vilmedic_torch/csrc/fused_lm_head.cu",
        replaces="vilmedic_tpu/ops/fused_lm_head.py:112", max_abs_err=worst, ms=tm["ms"],
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

    def device(fn, kernel=None):  # device ms per call, 20 calls in a row
        return device_ms_per_call(lambda: [fn() for _ in range(20)], 20,
                                  kernel and {kernel: 1})

    rows = {
        "fp8_scale2": dict(
            replaces="experiments/spike_fp8_cache.py:34", max_abs_err=0.0,
            ms=device(lambda: fp8_scale2(x), "fp8_scale2_kernel"), events_ms=cuda_ms(lambda: fp8_scale2(x)),
            plain_ms=cuda_ms(lambda: fp8_scale2_reference(x)),
            **bound(2 * n_a, n_a, torch.float32), library_ms=None),
        "fp8_matmul": dict(
            replaces="experiments/spike_fp8_cache.py:60", max_abs_err=mm_err,
            ms=device(lambda: fp8_matmul(a, b), "fp8_matmul_kernel"), events_ms=cuda_ms(lambda: fp8_matmul(a, b)),
            plain_ms=cuda_ms(lambda: fp8_matmul_reference(a, b)),
            **bound(m * k + k * n_b + m * n_b * 4, 2 * m * k * n_b, E4M3),
            library_ms=device(lambda: torch._scaled_mm(a, b_cm, one, one,
                                                       out_dtype=torch.float32)),
            library_events_ms=lib_mm),
        "fp8_slab_copy": dict(
            replaces="experiments/spike_fp8_cache.py:79", max_abs_err=0.0,
            ms=device(lambda: fp8_slab_copy(slab, 8), "fp8_slab_copy_kernel"),
            events_ms=cuda_ms(lambda: fp8_slab_copy(slab, 8)),
            plain_ms=cuda_ms(lambda: fp8_slab_copy_reference(slab, 8)),
            **bound(8 * 256 * 5, 0, torch.float32),
            library_ms=device(lambda: slab[:8].float()),
            library_events_ms=cuda_ms(lambda: slab[:8].float())),
    }
    for name, row in rows.items():
        print(f"K7 {name}: kernel {row['ms']:.4f} device ms (events around one call "
              f"{row.pop('events_ms'):.4f} ms), plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.6f} ms ({row['bound_by']}), library "
              + ("none" if row["library_ms"] is None else
                 f"{row['library_ms']:.4f} device ms (events {row.pop('library_events_ms'):.4f})")
              + " (latency probes: launch time, not bytes)")
        results[name] = dict(route="cuda", source="vilmedic_torch/csrc/fp8_probe.cu", **row,
                             path="fp8_probe", counter=name)
    print(f"K7 fp8_matmul library: torch._scaled_mm (cuBLAS fp8, f32 out) {lib_mm:.4f} ms "
          f"(events), "
          f"max |diff| to the plain version {lib_err:.3e}")


def phase_kernels():
    from vilmedic_torch.ops import cuda_lib

    t0 = time.perf_counter()
    cuda_lib.lib()  # builds the kernels unless this exact build exists
    print(f"build: {time.perf_counter() - t0:.1f} s ({cuda_lib.library_path().name})")
    set_tf32(False)
    results = {}
    seconds = {}
    for check in (check_beam_cache_attention, check_beam_cache_attention_stats,
                  check_beam_cache_attention_int8, check_beam_cache_attention_prefix,
                  check_blocked_lm_head, check_fused_lm_head, check_fp8_probe,
                  check_crop_normalize, check_flash_attention, check_flash_attention_backward,
                  check_flash_wide):
        t1 = time.perf_counter()
        check(results)
        seconds[check.__name__] = round(time.perf_counter() - t1, 1)
    print(f"kernels phase seconds by check: {json.dumps(seconds)}")
    head_dims = flash_head_dims()
    for name in ("flash_attention", "flash_attention_with_lse", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        results[name]["head_dims"] = head_dims
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
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serve(models[0], routes[name], batch, crop, "cuda")
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    for name, ts in times.items():
        med = statistics.median(ts)
        print(f"RRG {name:8s} route batch 16: {16 / med:.2f} reports/s (median of {len(ts)} in "
              f"two alternated blocks: {16 / statistics.median(ts[:len(ts) // 2]):.2f} / "
              f"{16 / statistics.median(ts[len(ts) // 2:]):.2f}; spread {(max(ts) - min(ts)) / med * 100:.1f}%), "
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


def build_vl(dtype: str, device: str, overrides=(), tower=None, vocab: int = VL_VOCAB,
             ids=(VL_BOS, VL_EOS, VL_PAD)):
    """VisionLanguage from its config (with dotlist ``overrides``) at full
    width: vocab 50368 and ModernBERT's special ids (or ``vocab`` and
    ``ids``: BOS, EOS, PAD), random weights from SEED. Returns the model, its
    generate with the ``ensemblor:`` block's cache dtypes and the config's
    serving settings."""
    from vilmedic_torch import registry
    from vilmedic_torch.config import load_config
    from vilmedic_torch.models.vision_language import make_vl_generate_fn

    cfg, _ = load_config(VL_CONFIG, [f"model.dtype={dtype}", *overrides])
    model = registry.build("model", cfg.model, vision_hf_config=tower or VL_TOWER,
                           vocab_size=vocab, bos_token_id=ids[0], eos_token_id=ids[1],
                           pad_token_id=ids[2], device=device, seed=SEED)
    serving = dict(max_len=int(cfg.dataset.seq.tokenizer_max_len),
                   beam=int(cfg.ensemblor.beam_width), batch=int(cfg.ensemblor.batch_size),
                   image=int(cfg.dataset.image.crop),
                   prefix_kv_dtype=cfg.ensemblor.get("prefix_kv_dtype"),
                   gen_kv_dtype=cfg.ensemblor.get("gen_kv_dtype"))
    generate = make_vl_generate_fn(model, serving["beam"], serving["max_len"], *ids,
                                   prefix_kv_dtype=serving["prefix_kv_dtype"],
                                   gen_kv_dtype=serving["gen_kv_dtype"])
    return model, generate, serving


def vl_images(b: int, size: int, seed: int):
    """A batch of normalized float images (B, 3, size, size) in pinned host
    memory, as an eval loader leaves it (unpinned where no card is
    visible: the CPU-half helper)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    return pinned(torch.randn(b, 3, size, size, generator=gen))


def pinned(x):
    import torch

    return x.pin_memory() if torch.cuda.is_available() else x


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


# ------------------------------------------------ the f32 CPU halves, aside

# The CPU halves of the four VisionLanguage parity phases below (f32, the
# plain versions, at 12 + 12 layers, the route parities' LM at 4, the greedy /
# small-vocab and train parities' LM at 12) take about 80 s of this host's
# cores. A helper process (``python3 chip_smoke.py --cpu-halves FOLDER``,
# no card visible, CPU_HELPER_THREADS threads) computes them in this order
# while the card runs the phases before them; each phase builds the same
# models from SEED for its card half and reads the helper's results.
CPU_HALVES = ("vl_parity", "vl_routes_parity", "vl_greedy_small_vocab_parity",
              "vl_train_parity")
CPU_HELPER_THREADS = 4  # of the host's 8 cores: the rest stay with the card's phases
CPU_HELPER = {}


def timed_call(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def start_cpu_helper():
    folder = tempfile.mkdtemp(prefix="chip_smoke_cpu_")
    threads = str(CPU_HELPER_THREADS)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS=threads,
               MKL_NUM_THREADS=threads)
    log = open(os.path.join(folder, "helper.log"), "w")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--cpu-halves", folder],
                            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    CPU_HELPER.update(proc=proc, folder=folder, log=log)
    atexit.register(stop_cpu_helper)  # a failed phase ends the script before the last half


def cpu_half(name: str):
    """The helper's result ``name``, once it is written; fails if the helper
    ended without it."""
    import torch

    folder, proc = CPU_HELPER["folder"], CPU_HELPER["proc"]
    path = os.path.join(folder, f"{name}.pt")
    while not os.path.exists(path):
        if proc.poll() is not None and not os.path.exists(path):
            with open(os.path.join(folder, "helper.log")) as f:
                log = f.read()[-4000:]
            fail(f"the CPU-half helper exited {proc.returncode} before {name}:\n{log}")
        time.sleep(0.1)
    out = torch.load(path, weights_only=False)
    os.remove(path)
    return out


def stop_cpu_helper():
    """End the helper (killed if a phase failed before its last half) and
    remove its folder."""
    import shutil

    proc = CPU_HELPER.pop("proc", None)
    if proc is None:
        return
    if proc.poll() is None:
        proc.kill()
    proc.wait()
    CPU_HELPER.pop("log").close()
    shutil.rmtree(CPU_HELPER.pop("folder"), ignore_errors=True)


def run_cpu_halves(folder: str):
    """The helper's work: each CPU half in CPU_HALVES's order, saved to
    ``folder/<name>.pt`` (written whole, then renamed)."""
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import torch

    torch.set_num_threads(CPU_HELPER_THREADS)
    for name in CPU_HALVES:
        out = globals()[f"cpu_{name}"]()
        torch.save(out, os.path.join(folder, f"{name}.pt.part"))
        os.replace(os.path.join(folder, f"{name}.pt.part"), os.path.join(folder, f"{name}.pt"))
        print(f"{name} written", flush=True)


def vl_parity_setup():
    model, generate, sv = build_vl("float32", "cpu")
    return model, generate, vl_images(2, sv["image"], SEED + 7)


def cpu_vl_parity():
    _, generate, images = vl_parity_setup()
    return timed_call(generate, images)


def phase_vl_parity():
    """f32, TF32 off, full width: the card (kernels) and the CPU (plain
    versions, the helper's ``cpu_vl_parity``) must choose the same
    beams."""
    import torch

    set_tf32(False)
    model, generate, images = vl_parity_setup()
    res_cpu, cpu_s = cpu_half("vl_parity")
    model.module.to("cuda")
    res_gpu = generate(images.to("cuda"))
    torch.cuda.synchronize()
    diff = (res_gpu.scores.cpu() - res_cpu.scores).abs().max().item()
    same = torch.equal(res_gpu.sequences.cpu(), res_cpu.sequences)
    print(f"VL parity f32 batch 2 ({model.module.vision.model.config.num_hidden_layers} tower "
          f"+ {model.dec_config.num_hidden_layers} LM layers, CPU half {cpu_s:.1f} s in the helper): "
          f"sequences "
          f"{'equal' if same else 'DIFFER'} ({res_gpu.steps} vs {res_cpu.steps} steps), "
          f"max |score diff| {diff:.3e}")
    if not same:
        fail("VL f32 beam sequences differ between the card and the CPU")


# ------------------------------- VisionLanguage int8 and fused-prefix routes

# the eval keys that turn on the int8 prefix and generated caches
INT8_SERVING = ("ensemblor.prefix_kv_dtype=int8", "ensemblor.gen_kv_dtype=int8")
PARITY_LM_LAYERS = "model.decoder.num_hidden_layers=4"  # the CPU halves of the route parities
OPS_LEN = 12  # max_len of the short generates whose device ops are counted


def device_ops(fn):
    """(fn's result, the number of CUDA kernel, copy and set events that
    ``torch.profiler`` records while it runs, their summed ms)."""
    out, events = profiled(fn)
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
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            routes[name][0](images.to("cuda", non_blocking=True))
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    for name, ts in times.items():
        med = statistics.median(ts)
        print(f"VL {name:5s} route batch {b}: {b / med:.2f} reports/s (median of {len(ts)} in two "
              f"alternated blocks: {b / statistics.median(ts[:len(ts) // 2]):.2f} / "
              f"{b / statistics.median(ts[len(ts) // 2:]):.2f}; spread {(max(ts) - min(ts)) / med * 100:.1f}%), "
              f"{ops[name][0]:.1f} device ops and {ops[name][1]:.3f} device-busy ms per decode "
              f"step, peak {runs[name][2]:.2f} GiB")
    launches = {"vl_int8": runs["int8"][1], "vl_fused": runs["fused"][1]}
    del model, module, routes, runs, img
    torch.cuda.empty_cache()
    return launches


def vl_routes_setup():
    from vilmedic_torch.models.vision_language import make_vl_generate_fn

    tower = dict(VL_TOWER, num_hidden_layers=2)
    model, generate_int8, sv = build_vl("float32", "cpu", [*INT8_SERVING, PARITY_LM_LAYERS],
                                        tower=tower)
    generates = {"int8": generate_int8, "fused": make_vl_generate_fn(
        model, sv["beam"], sv["max_len"], VL_BOS, VL_EOS, VL_PAD, fused_prefix=True)}
    return model, generates, sv, vl_images(2, sv["image"], SEED + 7), tower


def vl_permute_setup(tower):
    return build_vl("float32", "cpu", ["model.decoder.num_attention_heads=48",
                                       PARITY_LM_LAYERS], tower=tower)


def cpu_vl_routes_parity():
    _, generates, _, images, tower = vl_routes_setup()
    routes = timed_call(lambda: {name: generate(images) for name, generate in generates.items()})
    _, generate, _ = vl_permute_setup(tower)
    return routes, timed_call(generate, images)


def phase_vl_routes_parity():
    """f32, TF32 off, batch 2: the int8-cache and fused-prefix routes on the
    card (stages c and d) and on the CPU (plain versions) must choose the same
    beams. The LM at full width, cut to 4 layers, and the tower to 2, to bound
    the CPU half's time (the helper's ``cpu_vl_routes_parity``). Each
    route's agreement with the merge route on the card is reported beside
    it."""
    import torch

    from vilmedic_torch.models.vision_language import make_vl_generate_fn

    set_tf32(False)
    model, generates, sv, images, tower = vl_routes_setup()
    (res_cpu, cpu_s), permute_cpu = cpu_half("vl_routes_parity")
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
              f"{cpu_s:.1f} s in the helper): sequences {'equal' if same else 'DIFFER'} ({res.steps} vs "
              f"{res_cpu[name].steps} steps), max |score diff| {diff:.3e}; {agree:.2f} of the "
              f"sequences equal to the f32 merge route's on the card (reported)")
        if not same:
            bad.append(name)
    if bad:
        fail(f"VL f32 beam sequences differ between the card and the CPU on routes {bad}")
    del model, generates
    torch.cuda.empty_cache()
    vl_permute_parity(tower, images, *permute_cpu)


def vl_permute_parity(tower, images, res_cpu, cpu_s: float):
    """The permute route: the LM at full width (4 layers) with 48 heads of 16,
    a head dim the beam-cache kernel is not built for, so
    ``make_vl_generate_fn`` keeps the plain generated cache and beam search
    reorders it; the prefill's attention runs K4 at head dim 16. f32
    sequences on the card must equal the CPU's, with no K1 launch."""
    import torch

    from vilmedic_torch.models.evaluation_nlg import kernel_route_ok

    model, generate, sv = vl_permute_setup(tower)
    head_dim = model.dec_config.head_dim
    model.module.to("cuda")
    reset_launches()
    res = generate(images.to("cuda"))
    torch.cuda.synchronize()
    launches = read_launches()
    same = torch.equal(res.sequences.cpu(), res_cpu.sequences)
    diff = (res.scores.cpu() - res_cpu.scores).abs().max().item()
    print(f"VL permute route parity f32 batch 2 (head dim {head_dim}, "
          f"{tower['num_hidden_layers']} tower + {model.dec_config.num_hidden_layers} LM layers, "
          f"CPU half {cpu_s:.1f} s in the helper): sequences {'equal' if same else 'DIFFER'} "
          f"({res.steps} vs {res_cpu.steps} steps), max |score diff| {diff:.3e}; launches "
          f"{launches}")
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
        batches.append({"images": pinned(images), "input_ids": ids,
                        "attention_mask": mask})
    return batches


def device_ms(fn):
    """(host ms, device-busy ms) of ``fn`` ended by a synchronize; device
    busy sums the CUDA kernels, copies and sets that ``torch.profiler``
    records, K5's and K4's among them by name."""
    import torch

    def timed():
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, (time.perf_counter() - t0) * 1e3

    (out, host), events = profiled(timed)
    dev = {"all": 0.0, "K5": 0.0, "K4": 0.0}
    for e in events:
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


VL_TRAIN_PARITY_LR = 5e-5  # the config's


def vl_train_parity_step(device: str, state=None):
    """The train parity's step on ``device``: one microbatch's gradients and
    one AdamW update of the f32 model, dropout off (the two devices draw
    other masks), the tower cut to 2 layers, from ``state`` (None: the
    model's own initial weights). Returns the loss, the gradients and the
    parameters after the update (on the host), the step's seconds, the
    initial state and the LM's layers."""
    overrides = ["model.dtype=float32", "model.decoder.hidden_dropout_prob=0.0",
                 "model.decoder.attention_probs_dropout_prob=0.0"]
    batch = vl_train_batches(1, 2, 518, SEED + 13)[0]
    trainer = vl_trainor(overrides, device, tower=dict(VL_TOWER, num_hidden_layers=2),
                         batches=[batch])
    if state is None:
        state = {k: v.clone() for k, v in trainer.model.module.state_dict().items()}
    else:
        trainer.model.module.load_state_dict(state)
    t0 = time.perf_counter()
    loss = trainer.grad_step(to_device(batch, device))
    grads = {n: p.grad.detach().cpu().clone() for n, p in zip(trainer.tx.names,
                                                               trainer.tx.params)}
    trainer.apply_step(VL_TRAIN_PARITY_LR, loss)
    params = {n: p.detach().cpu().clone() for n, p in zip(trainer.tx.names, trainer.tx.params)}
    return (float(loss), grads, params, time.perf_counter() - t0, state,
            trainer.model.dec_config.num_hidden_layers)


def cpu_vl_train_parity():
    return vl_train_parity_step("cpu")


def phase_vl_train_parity():
    """f32, TF32 off, batch 2: one microbatch's gradients and one AdamW
    update on the card (kernels) and on the CPU (plain versions, the
    helper's ``cpu_vl_train_parity``), from the same weights; the LM at full
    depth and width, the tower cut to 2 layers to bound the CPU half's time
    (``vl_train_parity_step``)."""
    import torch

    set_tf32(False)
    tower = dict(VL_TOWER, num_hidden_layers=2)
    lr = VL_TRAIN_PARITY_LR
    # f32 sums in another order through 12 layers at T 1470; relative to each
    # tensor's largest gradient entry. A key-projection bias has an exactly 0
    # gradient (softmax is shift-invariant per row): held against its weight's
    tol = 1e-3
    l_cpu, g_cpu, p_cpu, s_cpu, state, _ = cpu_half("vl_train_parity")
    l_gpu, g_gpu, p_gpu, _, _, lm_layers = vl_train_parity_step("cuda", state)
    del state
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
          f"tower + {lm_layers} LM layers, CPU half {s_cpu:.1f} s in the helper): loss {l_gpu:.6f} card vs {l_cpu:.6f} "
          f"CPU; {len(g_cpu)} gradients, worst relative error {worst_rel:.3e} ({worst_name}, tol "
          f"{tol:.0e}); params after one AdamW step at lr {lr:g}: max |diff| {step_err:.3e} (tol "
          f"{2 * lr:.0e})")
    if bad or not step_err <= 2 * lr or not abs(l_gpu - l_cpu) <= tol * abs(l_cpu):
        fail(f"VL train f32 card vs CPU: gradients {bad[:5]}, step {step_err:.3e}")
    torch.cuda.empty_cache()


# ---------------------------- VisionLanguage greedy and small-vocab routes

SMALL_VOCAB = 4000  # below the blocked head's 4096: the plain head's route
SMALL_IDS = (0, 2, 1)  # BOS, EOS, PAD inside it, as a corpus vocabulary orders them


def vl_route_checks(res, b: int, max_len: int, vocab: int, bos: int, launches,
                    tower_layers: int, layers: int, k1_per_step: int) -> dict:
    seqs, steps = res.sequences, res.steps
    return {
        f"shape ({b}, max_len)": tuple(seqs.shape) == (b, max_len),
        "BOS in column 0": bool((seqs[:, 0] == bos).all()),
        "ids in the vocabulary": bool(((seqs >= 0) & (seqs < vocab)).all()),
        "steps > 0": steps > 0,
        "flash = tower + LM layers": launches["flash_attention"] == tower_layers + layers,
        f"beam attention = {k1_per_step} x steps":
            launches["fused_beam_cache_attention"] == k1_per_step * steps,
    }


def phase_vl_greedy_small_vocab():
    """bf16, full width, batch 16: greedy decoding (beam 1: the plain cache
    and head, no beam-cache kernel) and beam 8 over a vocabulary of 4000
    (``vocab_size`` overridden; the kernel cache with K1 stage b, the plain
    f32 head and two-stage candidates), checked, then timed beside the merge
    route in alternated blocks."""
    import torch

    from vilmedic_torch.models.vision_language import make_vl_generate_fn

    set_tf32(False)
    model, merge, sv = build_vl("bfloat16", "cuda")
    small, _, _ = build_vl("bfloat16", "cuda", vocab=SMALL_VOCAB, ids=SMALL_IDS)
    layers = model.dec_config.num_hidden_layers
    tower_layers = model.module.vision.model.config.num_hidden_layers
    b, beam, max_len = sv["batch"], sv["beam"], sv["max_len"]
    routes = {
        "merge": (merge, VL_VOCAB, VL_BOS, layers),
        "greedy": (make_vl_generate_fn(model, 1, max_len, VL_BOS, VL_EOS, VL_PAD), VL_VOCAB,
                   VL_BOS, 0),
        "small_vocab": (make_vl_generate_fn(small, beam, max_len, *SMALL_IDS), SMALL_VOCAB,
                        SMALL_IDS[0], layers),
    }
    print(f"VL greedy and small-vocab routes: {os.path.relpath(VL_CONFIG, ROOT)}, bf16, batch "
          f"{b}, max_len {max_len}; greedy at beam 1; beam {beam} over vocab {SMALL_VOCAB} "
          "(no configuration of the repo has such a VL vocabulary)")
    images = vl_images(b, sv["image"], SEED + 21)
    img = images.to("cuda")
    launches = {}
    for name in ("greedy", "small_vocab"):
        generate, vocab, bos, k1 = routes[name]
        reset_launches()
        res = generate(img)
        torch.cuda.synchronize()
        launches[name] = read_launches()
        print(f"VL {name} route batch {b}: sequences {tuple(res.sequences.shape)}, {res.steps} "
              f"decode steps, launches {launches[name]}")
        require(vl_route_checks(res, b, max_len, vocab, bos, launches[name], tower_layers,
                                layers, k1), f"VL {name} route")
    times = {name: [] for name in routes}
    for name in ("merge", "greedy", "small_vocab", "small_vocab", "greedy", "merge"):
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = routes[name][0](images.to("cuda", non_blocking=True))
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0, res.steps))
    for name, ts in times.items():
        med = statistics.median(t for t, _ in ts)
        print(f"VL {name:11s} route batch {b} bf16: {b / med:.2f} reports/s (median of "
              f"{len(ts)} in two alternated blocks, spread "
              f"{(max(t for t, _ in ts) - min(t for t, _ in ts)) / med * 100:.1f}%, steps "
              f"{[s for _, s in ts]})")
    del model, small, routes, img
    torch.cuda.empty_cache()
    return launches


GREEDY_SMALL_ROUTES = (("greedy", VL_VOCAB, (VL_BOS, VL_EOS, VL_PAD), 1),
                       ("small_vocab", SMALL_VOCAB, SMALL_IDS, BEAM))


def vl_greedy_small_setup(route: str, tower):
    from vilmedic_torch.models.vision_language import make_vl_generate_fn

    _, vocab, ids, beam = next(r for r in GREEDY_SMALL_ROUTES if r[0] == route)
    model, _, sv = build_vl("float32", "cpu", tower=tower, vocab=vocab, ids=ids)
    return model, make_vl_generate_fn(model, beam, sv["max_len"], *ids)


def cpu_vl_greedy_small_vocab_parity():
    tower = dict(VL_TOWER, num_hidden_layers=2)
    images = vl_images(2, 518, SEED + 7)
    return {name: timed_call(vl_greedy_small_setup(name, tower)[1], images)
            for name, *_ in GREEDY_SMALL_ROUTES}


def phase_vl_greedy_small_vocab_parity():
    """f32, TF32 off, batch 2, the tower cut to 2 layers as in the other VL
    route parities: greedy and small-vocab sequences on the card (K1 on the
    small-vocab route) equal the CPU's (plain versions, the helper's
    ``cpu_vl_greedy_small_vocab_parity``)."""
    import torch

    set_tf32(False)
    tower = dict(VL_TOWER, num_hidden_layers=2)
    images = vl_images(2, 518, SEED + 7)
    cpu = cpu_half("vl_greedy_small_vocab_parity")
    bad = []
    for name, _, _, beam in GREEDY_SMALL_ROUTES:
        model, generate = vl_greedy_small_setup(name, tower)
        res_cpu, cpu_s = cpu[name]
        model.module.to("cuda")
        reset_launches()
        res = generate(images.to("cuda"))
        torch.cuda.synchronize()
        k1 = read_launches()["fused_beam_cache_attention"]
        same = torch.equal(res.sequences.cpu(), res_cpu.sequences)
        print(f"VL {name} route parity f32 batch 2 ({tower['num_hidden_layers']} tower + "
              f"{model.dec_config.num_hidden_layers} LM layers, CPU half {cpu_s:.1f} s in the "
              f"helper): "
              f"sequences {'equal' if same else 'DIFFER'} ({res.steps} vs {res_cpu.steps} "
              f"steps), beam attention launches {k1}")
        if not same or (k1 == 0) != (beam == 1):
            bad.append(name)
        del model, generate
    if bad:
        fail(f"VL f32 sequences differ between the card and the CPU (or K1 ran where it must "
             f"not) on routes {bad}")
    torch.cuda.empty_cache()


# ------------------------------------------ RRG training and evaluation

RRG_WORDS = 5000  # distinct words of the synthetic corpus: the vocab takes K2
RRG_TRAIN, RRG_VALIDATE = 512, 32  # 4 steps at batch 128, 8 validator batches of 4


def synthetic_corpus(root: str, n_train: int, n_validate: int, seed: int, image: int,
                     sweep: bool = False):
    """Reports and JPEGs made from ``seed`` under ``root``, in the files the
    flagship config names (``{split}.image.tok``, ``{split}.impression.tok``).
    Words are ``RRG_WORDS`` letter strings; reports are sentences of 3 to 14
    words, 1 to 140 words long (so some pass ``tokenizer_max_len``), drawn
    uniformly; with ``sweep`` the train reports instead split the whole word
    list between them (every word in a small corpus; each report far past
    ``tokenizer_max_len``). Images are smooth RGB noise of (image + 32) x
    image pixels."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = sorted({"".join(rng.choice(letters, rng.integers(4, 11))) for _ in range(3 * RRG_WORDS)})
    words = [words[i] for i in rng.permutation(len(words))[:RRG_WORDS]]
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    cursor = 0
    for split, n in (("train", n_train), ("validate", n_validate)):
        reports, paths = [], []
        for i in range(n):
            if sweep and split == "train":
                length = len(words) // n + (i < len(words) % n)  # no report left empty
                picked = words[cursor:cursor + length]
                cursor += length
                length = len(picked)
            else:
                length = int(rng.integers(1, 141))
                picked = list(rng.choice(words, length))
            sentences, k = [], 0
            while k < length:
                step = int(rng.integers(3, 15))
                sentences.append(" ".join(picked[k:k + step]) + " .")
                k += step
            reports.append(" ".join(sentences))
            low = rng.integers(0, 256, (image // 16 + 2, image // 16 + 1, 3)).astype(np.uint8)
            im = Image.fromarray(low).resize((image, image + 32), Image.BILINEAR)
            path = os.path.join(root, "images", f"{split}_{i}.jpg")
            im.save(path, quality=90)
            paths.append(path)
        with open(os.path.join(root, f"{split}.impression.tok"), "w") as f:
            f.write("\n".join(reports))
        with open(os.path.join(root, f"{split}.image.tok"), "w") as f:
            f.write("\n".join(paths))


def rrg_train_overrides(data: str, ckpt: str, name: str, device: str):
    """The dotlist that points the flagship config at a synthetic corpus."""
    return [CONFIG, f"ckpt_dir={ckpt}", f"name={name}", f"device={device}", f"seed={SEED}",
            f"dataset.image.root={data}", f"dataset.seq.root={data}",
            "dataset.image.device_preproc=true", "trainor.epochs=0",
            "trainor.early_stop_metric=BLEU", "validator.metrics=[BLEU,ROUGEL,METEOR,CIDERD]"]


def cpu_state(model):
    return {k: v.detach().cpu().clone() for k, v in model.module.state_dict().items()}


def update_ratios(initial, want, got, steps: int) -> dict:
    """Each parameter tensor's change over a run, ``got`` against ``want``:
    the ratio of max|Δ_got − Δ_want| to its tolerance, 1e-4 of the
    largest |Δ_want| plus one f32 rounding of the largest |parameter| per
    step (a last-bit difference of an update can move ``p + u`` by an ulp).
    The key biases (softmax is shift-invariant: their gradient is 0 up to
    rounding) are held against their weights' change, the stem BatchNorm's
    scale (its gradient nearly cancels through the batch-normalized layers
    after it) against its bias's, as the CPU tests hold their gradients;
    likewise GLoRIA's ResNet stem BatchNorm's bias against its scale's
    change: its gradient, a sum of 50,176 terms a channel at 224², cancels
    to ~1/800 of their magnitudes, so their own f32 rounding moves it by
    ~1e-4 of its largest entry on the card and on the CPU alike (the f64
    witness of :func:`phase_selfsup_parity` reads both).
    Returns {tensor name: ratio}."""
    import torch

    eps = torch.finfo(torch.float32).eps
    delta = {k: (want[k] - initial[0][k], got[k] - initial[1][k])
             for k in want if "running" not in k and want[k].is_floating_point()}
    ratios = {}
    for k, (dw, dg) in delta.items():
        sibling = k
        if k.endswith("self_attn.k.bias") or k.endswith("cross_attn.k.bias"):
            sibling = k[:-len("bias")] + "weight"
        elif k == "enc.model.norm0.weight":
            sibling = "enc.model.norm0.bias"
        elif k == "cnn.bn_init.bias":
            sibling = "cnn.bn_init.weight"
        tol = 1e-4 * delta[sibling][0].abs().max().item() + steps * eps * want[k].abs().max().item()
        ratios[k] = (dg - dw).abs().max().item() / tol if tol > 0 else float((dg != dw).any())
    return ratios


def update_agreement(initial, want, got, steps: int):
    """The worst of :func:`update_ratios`: (ratio, tensor name)."""
    ratios = update_ratios(initial, want, got, steps)
    worst = max(ratios, key=ratios.get)
    return ratios[worst], worst


class StepRecorder:
    """Wraps ``Trainor.train_epoch`` and ``Trainor.train_step`` (or the
    ``method`` named, ``grad_step`` for a microbatch of an accumulation)
    for a run, on the host clock, each time ended by a synchronize:
    ``iterations``, each
    whole training iteration (the wait for the loader's batch, its copy to
    the card, K3 and the step: from the end of the previous step, or the
    epoch's start, to the end of this one); ``times``, the step alone (from
    a synchronize after K3); ``epochs``, each epoch's training wall time;
    and each step's loss. ``initial`` is a CPU copy of the model's state at
    the first epoch's start."""

    def __init__(self, method: str = "train_step"):
        self.method = method

    def __enter__(self):
        import torch

        from vilmedic_torch.executors.trainor import Trainor

        self.iterations, self.times, self.epochs, self.losses = [], [], [], []
        self.initial = None
        self.real = getattr(Trainor, self.method), Trainor.train_epoch
        real_step, real_epoch = self.real
        recorder = self

        def sync(trainer):
            if trainer.device.type == "cuda":
                torch.cuda.synchronize()
            return time.perf_counter()

        def timed_epoch(trainer, epoch):
            if recorder.initial is None:
                recorder.initial = cpu_state(trainer.model)
            recorder.mark = start = sync(trainer)
            losses = real_epoch(trainer, epoch)
            recorder.epochs.append(sync(trainer) - start)
            return losses

        def timed_step(trainer, *args):
            t0 = sync(trainer)
            loss = real_step(trainer, *args)
            t1 = sync(trainer)
            recorder.times.append(t1 - t0)
            recorder.iterations.append(t1 - recorder.mark)
            recorder.mark = t1
            recorder.losses.append(float(loss))
            return loss

        setattr(Trainor, self.method, timed_step)
        Trainor.train_epoch = timed_epoch
        return self

    def __exit__(self, *exc):
        from vilmedic_torch.executors.trainor import Trainor

        setattr(Trainor, self.method, self.real[0])
        Trainor.train_epoch = self.real[1]


def phase_rrg_train(tmp: str):
    """The flagship config through the port's train CLI at full width, bf16:
    512 train reports (4 RAdam steps at batch 128, DenseNet-169 at 224² in
    training mode, uint8 batches through K3), one epoch, the Validator at
    beam 8 over 32 reports (batch 4: K1 stage a and K2 at N 32), BLEU /
    ROUGEL / CIDERD, a best-only checkpoint. Then times the Validator
    again, and holds K1 (a), K2 and K3 against their plain versions at the
    shapes this path gave them."""
    import torch

    from vilmedic_torch.bin.train import main

    set_tf32(False)
    data = os.path.join(tmp, "rrg_data")
    t0 = time.perf_counter()
    synthetic_corpus(data, RRG_TRAIN, RRG_VALIDATE, SEED, 256)
    print(f"RRG train: synthetic corpus of {RRG_TRAIN} + {RRG_VALIDATE} reports over "
          f"{RRG_WORDS} words, JPEGs of 288 x 256, written in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with StepRecorder() as steps:
        trainor = main(rrg_train_overrides(data, tmp, "rrg_train", "cuda"))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    model, evaluator = trainor.model, trainor.evaluator
    cfg = trainor.config
    batch = int(cfg.batch_size)
    scores = evaluator.scores[0]
    ckpts = glob.glob(os.path.join(tmp, "rrg_train", "*.ckpt"))
    iter_ms = statistics.median(steps.iterations[1:]) * 1e3
    step_ms = statistics.median(steps.times[1:]) * 1e3
    n_steps = len(steps.iterations)
    PIPELINE_REF["rrg_train_iter_ms"] = iter_ms
    print(f"RRG train: {cfg.model.cnn.backbone} at {trainor.dl.dataset.image.crop}², "
          f"{model.dec_config.num_hidden_layers}-layer decoder of {model.dec_config.hidden_size}, "
          f"vocab {model.dec_config.vocab_size} (built from the train split), "
          f"{model.dec_config.dtype}, {cfg.optimizer} lr {trainor.base_lr:g}, batch {batch}, "
          f"{trainor.dl.num_workers} loader threads, {n_steps} steps, run {run_s:.1f} s; "
          f"losses {[round(x, 4) for x in steps.losses]}")
    print(f"RRG train bf16 batch {batch}: {iter_ms:.1f} ms per training step (whole iteration: "
          f"loader wait, H2D, K3, step; median of steps 2-{n_steps}: "
          f"{[round(t * 1e3, 1) for t in steps.iterations]}), {batch / iter_ms * 1e3:.1f} "
          f"images/s; the epoch's training {steps.epochs[0]:.2f} s, "
          f"{n_steps * batch / steps.epochs[0]:.1f} images/s with the first step; the model "
          f"step alone {step_ms:.1f} ms ({[round(t * 1e3, 1) for t in steps.times]}); "
          f"peak {peak:.2f} GiB")
    print(f"RRG train: scores {scores}; checkpoint {[os.path.basename(p) for p in ckpts]}; "
          f"launches K1 {launches['fused_beam_cache_attention']}, K2 "
          f"{launches['lm_head_blocked_stats']}, K3 {launches['crop_normalize']}")
    # the Validator again, timed: 32 reports at beam 8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluator.start()
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    n_val = len(evaluator.splits[0][1].dataset)
    print(f"RRG train: Validator {n_val / val_s:.2f} reports/s bf16 (batch "
          f"{evaluator.splits[0][1].batch_size}, beam {evaluator.config.beam_width}: {val_s:.2f} s "
          f"for {n_val} reports, after the run's own evaluation)")
    require({
        "checkpoint exists": len(ckpts) == 1,
        "iteration_count 4": trainor.training_scheduler.iteration_count == 4,
        "4 finite losses": len(steps.losses) == 4 and all(map(math.isfinite, steps.losses)),
        "finite BLEU / ROUGEL / METEOR / CIDERD": all(
            scores.get(k) is not None and math.isfinite(scores[k])
            for k in ("BLEU", "ROUGEL", "METEOR", "CIDERD")),
        "vocab takes the blocked head": model.dec_config.vocab_size >= 4096,
        "K1 launched": launches["fused_beam_cache_attention"] > 0,
        "K2 launched": launches["lm_head_blocked_stats"] > 0,
        "K3 = train + validator batches":
            launches["crop_normalize"] == 4 + RRG_VALIDATE // evaluator.splits[0][1].batch_size,
    }, "rrg_train")
    # the kernels held against their plain versions at the shapes this path
    # gave them: K1 (a) and K2 at the Validator's N = batch x beam, K3 at
    # the Validator's and the train batch, uint8 already cropped (R = crop)
    val_dl = evaluator.splits[0][1]
    val_batch, beam = val_dl.batch_size, int(evaluator.config.beam_width)
    dec = model.dec_config
    crop = int(trainor.dl.dataset.image.crop)
    gen = torch.Generator().manual_seed(SEED + 30)
    hold_beam_cache_attention(torch.bfloat16, val_batch * beam, gen,
                              t=int(val_dl.dataset.tokenizer_max_len),
                              heads=dec.num_attention_heads,
                              d=dec.hidden_size // dec.num_attention_heads, rows=beam,
                              label=" (rrg_train)")
    w32, b = lm_head_weights(dec.vocab_size, gen, dec.hidden_size)
    h = torch.randn(val_batch * beam, dec.hidden_size, generator=gen)
    hold_blocked_lm_head(h.to("cuda", torch.bfloat16), w32.to("cuda", torch.bfloat16), b.cuda(),
                         label=" (rrg_train)")
    for b_images in (val_batch, batch):
        hold_crop_normalize(b_images, crop, crop, gen, label=" (rrg_train)")
    print(f"RRG train: K1 (a) bf16 at N {val_batch * beam}, K2 bf16 at N {val_batch * beam} "
          f"Vp {w32.shape[0]}, K3 at B {val_batch} and {batch} (R = crop = {crop}) agree with "
          "their plain versions")
    first = next(iter(trainor.dl))
    vocab = dec.vocab_size
    del trainor, model, evaluator
    torch.cuda.empty_cache()
    return {"fused_beam_cache_attention": launches["fused_beam_cache_attention"],
            "lm_head_blocked_stats": launches["lm_head_blocked_stats"],
            "crop_normalize": launches["crop_normalize"], "vocab": vocab}, first


def phase_rrg_train_sanity(batch, vocab: int):
    """bf16 at full width: 10 RAdam updates at lr 1e-3 on one repeated batch
    (the first six RAdam's un-rectified steps) lower the loss, and the
    tower's running means leave 0."""
    import torch

    from vilmedic_torch.blocks.vision.densenet import BatchNorm
    from vilmedic_torch.config import load_config
    from vilmedic_torch.config.config import executor_config
    from vilmedic_torch.data.image import finalize_device_preproc
    from vilmedic_torch.executors import Trainor

    set_tf32(False)
    cfg, _ = load_config(CONFIG)
    on_device = finalize_device_preproc(to_device(batch, "cuda"), int(cfg.dataset.image.crop))
    trainer = Trainor(executor_config(cfg, "trainor"), seed=SEED, loader=[on_device] * 10,
                      device="cuda", model_kwargs=dict(vocab_size=vocab))
    losses = trainer.train_epoch(0)
    moved = sum(bool(m.running_mean.abs().max() > 0) for m in trainer.model.module.modules()
                if isinstance(m, BatchNorm))
    print(f"RRG train sanity (one batch repeated, {trainer.config.optimizer} lr "
          f"{trainer.base_lr:g}): losses {[round(x, 4) for x in losses]}; {moved} BatchNorm "
          "running means moved from 0")
    if not (len(losses) == 10 and losses[-1] < losses[0] and moved > 0):
        fail("RRG training did not lower the loss over 10 updates, or no running mean moved")
    del trainer
    torch.cuda.empty_cache()


def phase_rrg_train_parity(tmp: str):
    """f32, TF32 off: the train CLI on the card and on the CPU from the same
    seed (the same weights) at batch 2 with ``densenet_tiny`` and dropout 0,
    on 8 train reports that cover 5000 words (the blocked head, K2) and 4
    validate reports (one Validator batch at beam 8): per-step losses within
    1e-5 relative, the same initial weights, each tensor's change over the
    run as :func:`update_agreement` holds it, running statistics within
    1e-5, equal validation hypotheses and scores; then the saved checkpoint,
    reloaded into a fresh model on the card, generates the same
    hypotheses."""
    import torch

    import vilmedic_torch.blocks.vision.densenet as densenet
    from vilmedic_torch.bin.train import main
    from vilmedic_torch.config.config import Config
    from vilmedic_torch.executors.checkpoint import load_checkpoint
    from vilmedic_torch.executors.utils import create_model
    from vilmedic_torch.models.evaluation_nlg import evaluation

    set_tf32(False)
    densenet.CONFIGS["densenet_tiny"] = (8, (2, 2), 16)
    data = os.path.join(tmp, "rrg_parity_data")
    synthetic_corpus(data, 8, 4, SEED + 1, 64, sweep=True)
    extra = ["trainor.batch_size=2", "model.dtype=float32", "model.cnn.backbone=densenet_tiny",
             "model.cnn.visual_projection.in_features=32", "model.decoder.hidden_dropout_prob=0.0",
             "dataset.image.resize=64", "dataset.image.crop=56", "dataset.num_workers=0"]
    runs = {}
    for device in ("cpu", "cuda"):
        t0 = time.perf_counter()
        with StepRecorder() as steps:
            trainor = main(rrg_train_overrides(data, tmp, f"rrg_parity_{device}", device) + extra)
        state = cpu_state(trainor.model)
        hyps = open(os.path.join(tmp, f"rrg_parity_{device}", f"validate_{SEED}_hyps.txt")).read()
        runs[device] = (steps.losses, state, hyps, trainor.evaluator.scores[0],
                        time.perf_counter() - t0, steps.initial)
        if device == "cuda":
            reset_launches()
            trainor.evaluator.start()
            launches = read_launches()
            ckpt = glob.glob(os.path.join(tmp, "rrg_parity_cuda", "*.ckpt"))[0]
            loaded = load_checkpoint(ckpt)
            fresh = create_model(Config(loaded["config"]), dl=trainor.dl, state_dict=loaded)
            reloaded = evaluation([fresh], trainor.evaluator.config, trainor.evaluator.splits[0][1])
            vocab, lr = trainor.model.dec_config.vocab_size, trainor.base_lr
        del trainor
    (l_cpu, s_cpu, h_cpu, sc_cpu, t_cpu, i_cpu), (l_gpu, s_gpu, h_gpu, sc_gpu, _, i_gpu) = (
        runs["cpu"], runs["cuda"])
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    same_start = all(torch.equal(i_gpu[k], i_cpu[k]) for k in i_cpu)
    ratio, worst_name = update_agreement((i_cpu, i_gpu), s_cpu, s_gpu, len(l_cpu))
    param_err = max((s_gpu[k] - s_cpu[k]).abs().max().item() for k in s_cpu
                    if "running" not in k)
    stats_err = max((s_gpu[k] - s_cpu[k]).abs().max().item() for k in s_cpu if "running" in k)
    print(f"RRG train parity f32 batch 2 (densenet_tiny, full-width decoder, vocab {vocab}, "
          f"{lr:g} lr, CPU run {t_cpu:.1f} s): losses {l_gpu} card vs {l_cpu} CPU (max relative "
          f"diff {loss_rel:.2e}); initial weights {'equal' if same_start else 'DIFFER'}; "
          f"parameter changes: worst |diff| / tol {ratio:.3g} ({worst_name}); params max |diff| "
          f"{param_err:.2e}; running stats max |diff| {stats_err:.2e}; "
          f"hyps {'equal' if h_gpu == h_cpu else 'DIFFER'}; scores "
          f"{sc_gpu} vs {sc_cpu}; validation launches {launches}; reloaded checkpoint "
          f"{os.path.basename(ckpt)}")
    require({
        "4 steps each": len(l_gpu) == len(l_cpu) == 4,
        "losses within 1e-5 relative": loss_rel <= 1e-5,
        "the same initial weights": same_start,
        "each tensor's change within 1e-4 of its largest": ratio <= 1.0,
        "running statistics within 1e-5": stats_err <= 1e-5,
        "hypotheses equal": h_gpu == h_cpu,
        "scores equal": sc_gpu == sc_cpu,
        "K1 and K2 in the validation": launches["fused_beam_cache_attention"] > 0
        and launches["lm_head_blocked_stats"] > 0,
        "reloaded checkpoint, same hypotheses": "\n".join(reloaded["hyps"]) == h_gpu,
    }, "rrg_train_parity")
    torch.cuda.empty_cache()


# ------------------------------------------------- SCST, RRS, generation

SCST_CONFIG = os.path.join(ROOT, "config", "RRG", "rrg-scst-mimic.yml")
SCST_TRAIN = 128  # 4 iterations at the config's batch 32
RRS_CONFIG = os.path.join(ROOT, "config", "RRS", "baseline-transformer-mimic.yml")
RRS_WORDS = 6000  # the train impressions split them: the built target vocab takes K2
RRS_TRAIN, RRS_VALIDATE = 256, 32  # 4 steps at batch 64, 2 validator batches of 16
K1, K2, K3 = "fused_beam_cache_attention", "lm_head_blocked_stats", "crop_normalize"
PARITY_DEVICES = ("cpu", "cuda")  # the reference first


class DecodeSteps:
    """Sums the ``steps`` of every beam search that ``evaluation`` runs
    (each step one K1 call per decoder layer and one K2 call on the
    kernel route), or with ``module="vision_language"`` that
    ``make_vl_generate_fn`` runs."""

    def __init__(self, module: str = "evaluation_nlg"):
        self.module = module

    def __enter__(self):
        import importlib

        self.target = importlib.import_module(f"vilmedic_torch.models.{self.module}")
        self.steps = 0
        self.real = self.target.beam_search

        def counted(*args, **kwargs):
            result = self.real(*args, **kwargs)
            self.steps += result.steps
            return result

        self.target.beam_search = counted
        return self

    def __exit__(self, *exc):
        self.target.beam_search = self.real


class ScstRecorder:
    """Wraps the SCST model's ``train_iteration`` and ``rollouts`` for a
    run: each whole iteration on the host clock, ended by a synchronize
    (from the end of the previous one, or the epoch's start: the loader's
    wait, the copy to the card and K3 included), its loss and mean rewards
    (sampled, greedy), its rollout / reward / gradient seconds (from the
    model's ``timing``), and the K1 and K2 launches made inside the
    rollouts. ``initial`` is a CPU copy of the model's state at the epoch's
    start."""

    def __enter__(self):
        import numpy as np
        import torch

        from vilmedic_torch.executors.trainor import Trainor
        from vilmedic_torch.models.scst_models import _SCSTBase

        self.iterations, self.losses, self.rewards, self.splits = [], [], [], []
        self.rollout_launches, self.initial, self.mark = 0, None, None
        self.real = (_SCSTBase.train_iteration, _SCSTBase.rollouts, Trainor.train_epoch)
        real_iteration, real_rollouts, real_epoch = self.real
        rec = self

        def epoch(trainer, n):
            rec.initial = cpu_state(trainer.model)
            torch.cuda.synchronize()
            rec.mark = time.perf_counter()
            return real_epoch(trainer, n)

        def iteration(model, trainor, batch, lr):
            before = dict(model.timing)
            loss, custom = real_iteration(model, trainor, batch, lr)
            rec.splits.append({k: model.timing[f"{k}_s"] - before[f"{k}_s"]
                               for k in ("rollout", "reward", "grad")})
            torch.cuda.synchronize()
            now = time.perf_counter()
            rec.iterations.append(now - rec.mark)
            rec.mark = now
            rec.losses.append(float(loss))
            rec.rewards.append((float(np.mean(model.last["reward_sampling"])),
                                float(np.mean(model.last["reward_greedy"]))))
            return loss, custom

        def kernel_launches():
            counts = read_launches()
            return counts[K1] + counts[K2]

        def rollouts(model, enc_inputs):
            before = kernel_launches()
            out = real_rollouts(model, enc_inputs)
            rec.rollout_launches += kernel_launches() - before
            return out

        _SCSTBase.train_iteration, _SCSTBase.rollouts, Trainor.train_epoch = (
            iteration, rollouts, epoch)
        return self

    def __exit__(self, *exc):
        from vilmedic_torch.executors.trainor import Trainor
        from vilmedic_torch.models.scst_models import _SCSTBase

        _SCSTBase.train_iteration, _SCSTBase.rollouts, Trainor.train_epoch = self.real


def scst_corpus(src: str, dst: str, n_train: int):
    """An RRG corpus (``rrg_train``'s, ``rrg_train_parity``'s) in ``dst``,
    its train split cut to the first ``n_train`` reports (the JPEG paths
    are absolute)."""
    os.makedirs(dst, exist_ok=True)
    for split, n in (("train", n_train), ("validate", None)):
        for kind in ("impression", "image"):
            with open(os.path.join(src, f"{split}.{kind}.tok")) as f:
                lines = f.read().split("\n")
            with open(os.path.join(dst, f"{split}.{kind}.tok"), "w") as f:
                f.write("\n".join(lines[:n]))


def scst_overrides(data: str, ckpt_dir: str, name: str, device: str, ckpt=None):
    """The dotlist that points the SCST config at a corpus (and a trained
    RRG checkpoint)."""
    out = [SCST_CONFIG, f"ckpt_dir={ckpt_dir}", f"name={name}", f"device={device}",
           f"seed={SEED}", f"dataset.image.root={data}", f"dataset.seq.root={data}",
           "dataset.image.device_preproc=true", "trainor.epochs=0",
           "validator.metrics=[BLEU,ROUGEL,CIDERD]"]
    return out + ([f"model.ckpt={ckpt}"] if ckpt else [])


def unchanged_tensors(initial, final):
    """Names of the floating tensors (running statistics left out) that
    did not change over a run."""
    return sorted(k for k in initial if "running" not in k and initial[k].is_floating_point()
                  and bool(final[k].eq(initial[k]).all()))


def phase_scst_train(tmp: str):
    """``config/RRG/rrg-scst-mimic.yml`` at full width, bf16, through the
    train CLI with dotlist overrides only: the ``rrg_train`` corpus cut to
    128 train reports (4 SCST iterations at the config's batch 32, top-k
    25, ROUGE-L reward, RAdam lr 5e-6) through ``device_preproc`` (K3), the
    base RRG from the best checkpoint ``rrg_train`` wrote (``model.ckpt``;
    its vocabulary file copied beside the run), then the Validator at beam
    8 (K1 stage a, K2). Rollouts take the plain cache and head: no K1 or K2
    inside them. Returns the path's launches of K1, K2 and K3."""
    import shutil

    import torch

    from vilmedic_torch.bin.train import main

    set_tf32(False)
    data = os.path.join(tmp, "scst_data")
    scst_corpus(os.path.join(tmp, "rrg_data"), data, SCST_TRAIN)
    ckpt = glob.glob(os.path.join(tmp, "rrg_train", "*.ckpt"))[0]
    os.makedirs(os.path.join(tmp, "scst_train"), exist_ok=True)
    shutil.copy(os.path.join(tmp, "rrg_train", "vocab.tgt"), os.path.join(tmp, "scst_train"))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with ScstRecorder() as rec, DecodeSteps() as val_steps:
        trainor = main(scst_overrides(data, tmp, "scst_train", "cuda", ckpt))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    model, evaluator, cfg = trainor.model, trainor.evaluator, trainor.config
    still = unchanged_tensors(rec.initial, cpu_state(model))
    # the last iteration's gradients are still in .grad
    no_grad = [n for n, p in zip(trainor.tx.names, trainor.tx.params)
               if p.grad is None or not (bool(p.grad.abs().max() > 0)
                                         and bool(torch.isfinite(p.grad).all()))]
    timing = dict(model.timing)
    iters = timing["iters"]
    batch = int(cfg.batch_size)
    val_dl = evaluator.splits[0][1]
    n_val_batches = len(val_dl)
    iter_ms = statistics.median(rec.iterations[1:]) * 1e3
    split = {k: statistics.median(x[k] for x in rec.splits[1:]) * 1e3
             for k in ("rollout", "reward", "grad")}
    PIPELINE_REF["scst_train"] = dict(split, samples_s=batch / iter_ms * 1e3)
    scores = evaluator.scores[0]
    print(f"SCST train: {os.path.basename(SCST_CONFIG)} from {os.path.basename(ckpt)}, "
          f"{cfg.model.cnn.backbone}, {model.dec_config.num_hidden_layers}-layer decoder of "
          f"{model.dec_config.hidden_size}, vocab {model.dec_config.vocab_size}, "
          f"{model.dec_config.dtype}, {cfg.optimizer} lr {trainor.base_lr:g}, batch {batch}, "
          f"top_k {model.scst.top_k}, rewards {model.scst.scores}, max_len "
          f"{model.scst.max_length}, {iters} iterations, run {run_s:.1f} s; losses "
          f"{[round(x, 6) for x in rec.losses]}; mean reward (sampled, greedy) per iteration "
          f"{[(round(s, 4), round(g, 4)) for s, g in rec.rewards]}")
    print(f"SCST train bf16 batch {batch}: {iter_ms:.1f} ms per iteration (whole: loader "
          f"wait, H2D, K3, rollouts, rewards, update; median of iterations 2-{iters}: "
          f"{[round(t * 1e3, 1) for t in rec.iterations]}), {batch / iter_ms * 1e3:.1f} "
          f"samples/s; per iteration (median of 2-{iters}) rollout {split['rollout']:.1f} ms, "
          f"reward {split['reward']:.1f} ms, gradient step {split['grad']:.1f} ms (the first: "
          f"{', '.join(f'{k} {v * 1e3:.1f}' for k, v in rec.splits[0].items())}; model.timing "
          f"over {iters}: {timing}); peak {peak:.2f} GiB")
    print(f"SCST train: scores {scores}; launches K1 {launches[K1]}, K2 {launches[K2]}, K3 "
          f"{launches[K3]}; {rec.rollout_launches} K1/K2 launches inside the rollouts; "
          f"Validator {val_steps.steps} decode steps over {n_val_batches} batches; "
          f"{len(trainor.tx.params)} trainable tensors, without a nonzero finite gradient in the "
          f"last iteration: {no_grad}; {len(still)} tensors unchanged after {iters} updates "
          f"(RAdam's first six updates are lr x the bias-corrected mean gradient, not normalized: "
          f"at lr {trainor.base_lr:g} an update below half an f32 ulp of its weight rounds away; "
          f"{sum('Norm' in k or 'norm' in k or '_ln' in k or '.ln.' in k for k in still)} of them "
          f"norm scales near 1), e.g. {still[:4]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluator.start()
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    n_val = len(val_dl.dataset)
    print(f"SCST train: Validator {n_val / val_s:.2f} reports/s bf16 (batch {val_dl.batch_size}, "
          f"beam {evaluator.config.beam_width}: {val_s:.2f} s for {n_val} reports)")
    # where an iteration's time goes: host and device-busy ms of the
    # rollouts and of the gradient step on one more batch (advantages drawn)
    from vilmedic_torch.executors.train_state import gated_update

    one = trainor._model_batch(next(iter(trainor.dl)))
    enc = model.encoder_inputs(one)
    (_, sampled), ro_host, ro_dev = device_ms(lambda: model.rollouts(enc))
    adv = torch.randn(1, sampled.shape[0], generator=torch.Generator().manual_seed(SEED)).cuda()

    def grad_step():
        trainor.zero_grads()
        loss = model.policy_loss(one, enc, sampled, adv)
        loss.backward()
        gated_update(trainor.tx, trainor.base_lr, loss)

    _, gr_host, gr_dev = device_ms(grad_step)
    reward_native, reward_python = scst_reward_times(model, one, sampled)
    print(f"SCST train split (torch.profiler, one more iteration): rollout host {ro_host:.1f} ms, "
          f"device busy {ro_dev['all']:.1f} ms "
          f"({int((sampled != model.scst.pad_token_id).sum(1).max())} tokens); gradient step host {gr_host:.1f} ms, device busy {gr_dev['all']:.1f} ms")
    print(f"SCST reward of {sampled.shape[0]} rollouts against their references "
          f"({model.scst.scores}), alternated 5 x: native LCS {reward_native:.1f} ms, "
          f"pure-Python LCS {reward_python:.1f} ms (medians)")
    # the key biases' gradient is 0 up to rounding (softmax is shift-invariant)
    no_grad = [k for k in no_grad if not k.endswith("attn.k.bias")]
    require({
        "4 iterations": iters == 4 and trainor.training_scheduler.iteration_count == 4,
        "finite losses": len(rec.losses) == 4 and all(map(math.isfinite, rec.losses)),
        "finite rewards": all(math.isfinite(s) and math.isfinite(g) for s, g in rec.rewards),
        "finite BLEU / ROUGEL / CIDERD": all(scores.get(k) is not None and math.isfinite(scores[k])
                                             for k in ("BLEU", "ROUGEL", "CIDERD")),
        "no K1 or K2 in the rollouts": rec.rollout_launches == 0,
        "K1 (a) = K2 = Validator decode steps":
            launches[K1] == launches[K2] == val_steps.steps > 0,
        "K3 = training + Validator batches": launches[K3] == iters + n_val_batches,
        "every trainable tensor has a nonzero finite gradient": not no_grad,
        "parameters moved": len(still) < len(rec.initial),
    }, "scst_train")
    del trainor, model, evaluator
    torch.cuda.empty_cache()
    return {K1: launches[K1], K2: launches[K2], K3: launches[K3]}


def scst_reward_times(model, batch, sampled, rounds: int = 5):
    """Median ms of the SCST reward (decode + score) of ``sampled`` against
    the batch's references with the native scorers and with the
    pure-Python ones, alternated on the same rollouts (native, Python,
    Python, native, ...); the two must give the same rewards."""
    import numpy as np

    from vilmedic_torch.scorers.scores import REWARD_COMPLIANT

    scst = model.scst
    rollouts = sampled.cpu().numpy()
    refs = batch[model.ref_key].cpu().numpy()
    kinds = {"native": True, "python": False}
    scorers = {kind: [REWARD_COMPLIANT[s][0](use_native=flag) for s in scst.scores]
               for kind, flag in kinds.items()}
    real, times, rewards = scst.scorers, {k: [] for k in kinds}, {}
    try:
        for r in range(rounds):
            for kind in (("native", "python") if r % 2 == 0 else ("python", "native")):
                scst.scorers = scorers[kind]
                t0 = time.perf_counter()
                rewards[kind], _, _ = scst.get_reward(rollouts, refs)
                times[kind].append((time.perf_counter() - t0) * 1e3)
    finally:
        scst.scorers = real
    if not all(np.allclose(a, b, rtol=0, atol=1e-7)
               for a, b in zip(rewards["native"], rewards["python"])):
        fail("SCST rewards differ between the native and the pure-Python scorers")
    return statistics.median(times["native"]), statistics.median(times["python"])


def rrs_corpus(root: str, n_train: int, n_validate: int, seed: int, sweep_words: int):
    """Findings / impression pairs made from ``seed`` in the files the RRS
    config names (``{split}.findings.tok``, ``{split}.impression.tok``):
    letter-string words; findings of 20 to 110 words (some pass the source
    length 128 after cleaning), in sentences of 3 to 14 words; validate
    impressions of 3 to 30 words; the train impressions split the first
    ``sweep_words`` words between them (the same number each), so the
    built target vocabulary holds nearly all of them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = sorted({"".join(rng.choice(letters, rng.integers(3, 11))) for _ in range(3 * RRS_WORDS)})
    words = [words[i] for i in rng.permutation(len(words))[:RRS_WORDS]]

    def text(picked):
        out, k = [], 0
        while k < len(picked):
            step = int(rng.integers(3, 15))
            out.append(" ".join(picked[k:k + step]) + " .")
            k += step
        return " ".join(out)

    os.makedirs(root, exist_ok=True)
    per = sweep_words // n_train
    for split, n in (("train", n_train), ("validate", n_validate)):
        findings = [text(list(rng.choice(words, int(rng.integers(20, 111))))) for _ in range(n)]
        if split == "train":
            impressions = [text(words[i * per:(i + 1) * per]) for i in range(n)]
        else:
            impressions = [text(list(rng.choice(words, int(rng.integers(3, 31)))))
                           for _ in range(n)]
        for kind, lines in (("findings", findings), ("impression", impressions)):
            with open(os.path.join(root, f"{split}.{kind}.tok"), "w") as f:
                f.write("\n".join(lines))


def rrs_overrides(data: str, ckpt_dir: str, name: str, device: str):
    return [RRS_CONFIG, f"ckpt_dir={ckpt_dir}", f"name={name}", f"device={device}",
            f"seed={SEED}", f"dataset.src.root={data}", f"dataset.tgt.root={data}",
            "trainor.epochs=0"]


def phase_rrs_train(tmp: str):
    """``config/RRS/baseline-transformer-mimic.yml`` at full width (6 + 6
    layers of 768, 12 heads of 64), bf16, through the train CLI: 256
    synthetic pairs (4 RAdam steps at batch 64, source 128, target 80), the
    Validator over 32 pairs at batch 16, beam 8 (K1 stage a in each of the 6
    decoder layers, K2 over the built vocabulary of more than 4096). Then
    holds K1 (a) at N 128, T 80, 12 x 64 and K2 at N 128 over that
    vocabulary against their plain versions. Returns the path's launches."""
    import torch

    from vilmedic_torch.bin.train import main

    set_tf32(False)
    data = os.path.join(tmp, "rrs_data")
    rrs_corpus(data, RRS_TRAIN, RRS_VALIDATE, SEED, RRS_WORDS)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with StepRecorder() as steps, DecodeSteps() as val_steps:
        trainor = main(rrs_overrides(data, tmp, "rrs_train", "cuda"))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    model, evaluator, cfg = trainor.model, trainor.evaluator, trainor.config
    dec, enc = model.dec_config, model.enc_config
    batch = int(cfg.batch_size)
    src_len = int(cfg.dataset.src.tokenizer_max_len)
    tgt_len = int(cfg.dataset.tgt.tokenizer_max_len)
    iter_ms = statistics.median(steps.iterations[1:]) * 1e3
    step_ms = statistics.median(steps.times[1:]) * 1e3
    scores = evaluator.scores[0]
    val_dl = evaluator.splits[0][1]
    print(f"RRS train: {enc.num_hidden_layers} + {dec.num_hidden_layers} layers of "
          f"{dec.hidden_size} ({dec.num_attention_heads} heads of {dec.head_dim}), vocab "
          f"{enc.vocab_size} -> {dec.vocab_size} (built from the train split), {dec.dtype}, "
          f"{cfg.optimizer} lr {trainor.base_lr:g}, batch {batch}, source {src_len}, target "
          f"{tgt_len}, {len(steps.losses)} steps, run {run_s:.1f} s; losses "
          f"{[round(x, 4) for x in steps.losses]}")
    print(f"RRS train bf16 batch {batch}: {iter_ms:.1f} ms per training step (whole iteration; "
          f"median of steps 2-{len(steps.iterations)}: "
          f"{[round(t * 1e3, 1) for t in steps.iterations]}), "
          f"{batch * (src_len + tgt_len) / iter_ms * 1e3:.0f} padded tokens/s (source + "
          f"target); the model step alone {step_ms:.1f} ms; peak {peak:.2f} GiB")
    print(f"RRS train: scores {scores}; launches K1 {launches[K1]}, K2 {launches[K2]}; "
          f"Validator {val_steps.steps} decode steps over {len(val_dl)} batches")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluator.start()
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    n_val = len(val_dl.dataset)
    print(f"RRS train: Validator {n_val / val_s:.2f} reports/s bf16 (batch {val_dl.batch_size}, "
          f"beam {evaluator.config.beam_width}: {val_s:.2f} s for {n_val} reports)")
    # where a step's time goes: one more step on a batch of the run
    one = trainor._model_batch(next(iter(trainor.dl)))
    trainor.zero_grads()
    out, f_host, f_dev = device_ms(lambda: model.apply_train(one, trainor.generator))
    _, b_host, b_dev = device_ms(lambda: out["loss"].backward())
    _, o_host, o_dev = device_ms(lambda: trainor.apply_step(trainor.base_lr,
                                                            out["loss"].detach()))
    print(f"RRS train split (torch.profiler, one more step): forward host {f_host:.1f} / device "
          f"busy {f_dev['all']:.1f} ms, backward {b_host:.1f} / {b_dev['all']:.1f} ms, RAdam "
          f"{o_host:.1f} / {o_dev['all']:.1f} ms")
    require({
        "4 finite losses": len(steps.losses) == 4 and all(map(math.isfinite, steps.losses)),
        "finite ROUGEL / BLEU": all(scores.get(k) is not None and math.isfinite(scores[k])
                                    for k in ("ROUGEL", "BLEU")),
        "target vocab takes the blocked head": dec.vocab_size >= 4096,
        "K1 (a) = 6 x decode steps": launches[K1] == dec.num_hidden_layers * val_steps.steps > 0,
        "K2 = decode steps": launches[K2] == val_steps.steps,
    }, "rrs_train")
    beam = int(evaluator.config.beam_width)
    n = val_dl.batch_size * beam
    gen = torch.Generator().manual_seed(SEED + 40)
    hold_beam_cache_attention(torch.bfloat16, n, gen, t=tgt_len, heads=dec.num_attention_heads,
                              d=dec.head_dim, rows=beam, label=" (rrs_train)")
    w32, b = lm_head_weights(dec.vocab_size, gen, dec.hidden_size)
    h = torch.randn(n, dec.hidden_size, generator=gen)
    hold_blocked_lm_head(h.to("cuda", torch.bfloat16), w32.to("cuda", torch.bfloat16), b.cuda(),
                         label=" (rrs_train)")
    print(f"RRS train: K1 (a) bf16 at N {n}, T {tgt_len}, {dec.num_attention_heads} x "
          f"{dec.head_dim} and K2 bf16 at N {n}, Vp {w32.shape[0]} agree with their plain versions")
    del trainor, model, evaluator
    torch.cuda.empty_cache()
    return {K1: launches[K1], K2: launches[K2]}


class InjectedNoise:
    """A stand-in for ``decoding.decode.gumbel_noise``: the same Gumbel
    draws on every device, made on the CPU from ``seed`` and the call's
    number, then moved to the device."""

    def __init__(self, seed: int):
        self.seed, self.calls = seed, 0

    def __call__(self, shape, generator, device):
        import torch

        gen = torch.Generator().manual_seed(self.seed + self.calls)
        self.calls += 1
        return self.real(shape, gen, "cpu").to(device)

    def __enter__(self):
        from vilmedic_torch.decoding import decode

        self.real = decode.gumbel_noise
        decode.gumbel_noise = self
        return self

    def __exit__(self, *exc):
        from vilmedic_torch.decoding import decode

        decode.gumbel_noise = self.real


def scst_parity(tmp: str):
    """One SCST iteration on the card and on the CPU from the same weights
    (random, from the seed) and the same Gumbel draws, f32: the SCST config
    at full decoder width with ``densenet_tiny``, batch 2 of the
    ``rrg_train_parity`` corpus (5000 words: the top-k threshold is
    blockwise). Equal greedy and sampled ids and rewards, the loss within
    1e-5 relative, each tensor's change as :func:`update_agreement` holds
    it."""
    import numpy as np
    import torch

    import vilmedic_torch.blocks.vision.densenet as densenet
    from vilmedic_torch.config import load_config
    from vilmedic_torch.config.config import executor_config
    from vilmedic_torch.executors import Trainor

    densenet.CONFIGS["densenet_tiny"] = (8, (2, 2), 16)
    data = os.path.join(tmp, "rrg_parity_data")
    runs = []
    for i, device in enumerate(PARITY_DEVICES):
        ckpt_dir = os.path.join(tmp, f"scst_parity_{i}")
        os.makedirs(ckpt_dir, exist_ok=True)
        config, *overrides = scst_overrides(data, tmp, "unused", device)
        cfg, _ = load_config(config, overrides + [
            "trainor.batch_size=2", "model.dtype=float32", "model.cnn.backbone=densenet_tiny",
            "model.cnn.visual_projection.in_features=32", "model.decoder.hidden_dropout_prob=0.0",
            "dataset.image.resize=64", "dataset.image.crop=56", "dataset.num_workers=0"])
        train_cfg = executor_config(cfg, "trainor")
        train_cfg.ckpt_dir = ckpt_dir
        trainor = Trainor(train_cfg, seed=SEED, device=device)
        batch = trainor._model_batch(next(iter(trainor.dl)))
        initial = cpu_state(trainor.model)
        with InjectedNoise(SEED + 50):
            loss, _ = trainor.model.train_iteration(trainor, batch, trainor.base_lr)
        last = trainor.model.last
        runs.append((last["greedy"], last["sampled"], last["reward_greedy"],
                     last["reward_sampling"], float(loss), initial, cpu_state(trainor.model)))
        vocab = trainor.model.dec_config.vocab_size
        del trainor
    (g_c, s_c, rg_c, rs_c, l_c, i_c, f_c), (g_g, s_g, rg_g, rs_g, l_g, i_g, f_g) = runs
    ratio, worst = update_agreement((i_c, i_g), f_c, f_g, 1)
    rel = abs(l_g - l_c) / abs(l_c)
    same_rewards = all(np.array_equal(a, b) for a, b in zip(rg_c + rs_c, rg_g + rs_g))
    print(f"generation parity, SCST f32 batch 2 (densenet_tiny, vocab {vocab}): greedy ids "
          f"{'equal' if np.array_equal(g_c, g_g) else 'DIFFER'}, sampled ids "
          f"{'equal' if np.array_equal(s_c, s_g) else 'DIFFER'}, rewards "
          f"{'equal' if same_rewards else 'DIFFER'} (sampled {[list(map(float, r)) for r in rs_c]}"
          f", greedy {[list(map(float, r)) for r in rg_c]}); loss {l_g!r} card vs {l_c!r} CPU "
          f"(relative {rel:.2e}); parameter changes: worst |diff| / tol {ratio:.3g} ({worst})")
    return {
        "SCST greedy ids equal": np.array_equal(g_c, g_g),
        "SCST sampled ids equal": np.array_equal(s_c, s_g),
        "SCST sampled differ from greedy": not np.array_equal(g_c, s_c),
        "SCST rewards equal": same_rewards,
        "SCST loss within 1e-5 relative": rel <= 1e-5,
        "SCST update within update_agreement": ratio <= 1.0,
    }


def rrs_parity(tmp: str):
    """The RRS CLI in f32 on the card and on the CPU from the same seed:
    full width, 2 + 2 layers, dropout 0, 8 train pairs whose impressions
    cover 5000 words (the blocked head, K2) at batch 4, the Validator over
    4 pairs at batch 4, beam 8. Per-step losses within 1e-5 relative,
    equal hypotheses and scores."""
    from vilmedic_torch.bin.train import main

    data = os.path.join(tmp, "rrs_parity_data")
    rrs_corpus(data, 8, 4, SEED + 2, 5000)
    extra = ["model.dtype=float32", "model.encoder.num_hidden_layers=2",
             "model.decoder.num_hidden_layers=2", "model.encoder.hidden_dropout_prob=0.0",
             "model.decoder.hidden_dropout_prob=0.0", "trainor.batch_size=4",
             "validator.batch_size=4", "dataset.num_workers=0"]
    runs = []
    for i, device in enumerate(PARITY_DEVICES):
        with StepRecorder() as steps:
            trainor = main(rrs_overrides(data, tmp, f"rrs_parity_{i}", device) + extra)
        with open(os.path.join(tmp, f"rrs_parity_{i}", f"validate_{SEED}_hyps.txt")) as f:
            hyps = f.read()
        runs.append((steps.losses, hyps, trainor.evaluator.scores[0]))
        vocab = trainor.model.dec_config.vocab_size
        del trainor
    (l_c, h_c, sc_c), (l_g, h_g, sc_g) = runs
    rel = max(abs(a - b) / abs(b) for a, b in zip(l_g, l_c))
    print(f"generation parity, RRS f32 (2 + 2 layers of 768, vocab {vocab}, beam 8): losses "
          f"{l_g} card vs {l_c} CPU (max relative {rel:.2e}); hyps "
          f"{'equal' if h_g == h_c else 'DIFFER'}; scores {sc_g} vs {sc_c}")
    return {
        "RRS 2 steps each": len(l_c) == len(l_g) == 2,
        "RRS losses within 1e-5 relative": rel <= 1e-5,
        "RRS hypotheses equal": h_g == h_c,
        "RRS scores equal": sc_g == sc_c,
        "RRS target vocab takes the blocked head": vocab >= 4096,
    }


def force_parity():
    """RRG_FORCE: the flagship config with ``model.proto=RRG_FORCE`` in f32,
    the same random weights on the card and on the CPU, constrained greedy
    decoding of 2 reports with 3 forced tokens each: equal sequences, and
    every forced token present."""
    import torch

    from vilmedic_torch import registry
    from vilmedic_torch.config import load_config
    from vilmedic_torch.models import rrg_force
    from vilmedic_torch.models.base import get_special_token_ids

    cfg, _ = load_config(CONFIG, ["model.dtype=float32", "model.proto=RRG_FORCE"])
    max_len = int(cfg.dataset.seq.tokenizer_max_len)
    crop = int(cfg.dataset.image.crop)
    force = torch.randint(5, VOCAB, (2, 3), generator=torch.Generator().manual_seed(SEED + 60))
    seqs = []
    for device in PARITY_DEVICES:
        model = registry.build("model", cfg.model, vocab_size=VOCAB, device=device, seed=SEED)
        generate = rrg_force.make_force_generate_fn(model, max_len,
                                                    *get_special_token_ids(model.dec_config))
        batch = finalize_batch(host_batch(2, crop, SEED + 61), crop, device)
        seqs.append(generate(model.encoder_inputs(batch), force.to(device)).sequences.cpu())
        del model
    same = torch.equal(*seqs)
    present = all(int(t) in row.tolist() for row, f in zip(seqs[1], force) for t in f)
    print(f"generation parity, RRG_FORCE f32 batch 2 (vocab {VOCAB}, forced {force.tolist()}): "
          f"sequences {'equal' if same else 'DIFFER'}, forced tokens "
          f"{'all present' if present else 'MISSING'}; lengths "
          f"{(seqs[1] != 1).sum(dim=1).tolist()}")
    return {"RRG_FORCE sequences equal": same, "RRG_FORCE forced tokens present": present}


def finalize_batch(batch, crop: int, device: str):
    from vilmedic_torch.data.image import finalize_device_preproc

    return finalize_device_preproc(to_device(batch, device), crop)


def phase_generation_parity(tmp: str):
    """f32, TF32 off, card against CPU at small depth: one SCST iteration
    under injected Gumbel noise, the RRS CLI, and RRG_FORCE's constrained
    decoding."""
    import torch

    set_tf32(False)
    t0 = time.perf_counter()
    checks = {**scst_parity(tmp), **rrs_parity(tmp), **force_parity()}
    print(f"generation parity: {time.perf_counter() - t0:.1f} s")
    require(checks, "generation_parity")
    torch.cuda.empty_cache()


# ------------------------------------------------- the pipelined training paths

PIPELINE_REF = {}  # rrg_train's and scst_train's figures, printed beside pipelined_train's
PREFETCH_TRAIN = 24  # 3 steps at batch 8
OVERLAP_PARITY_TRAIN = 6  # 3 batches of 2: 2 steps in the loop and the flush


@contextlib.contextmanager
def deterministic():
    """cuDNN deterministic without autotuning, TF32 off and PyTorch's
    deterministic algorithms (warnings only), as ``dist_train``'s workers
    run; restored after."""
    import torch

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=False):
            yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def config_trainor(config: str, overrides, ckpt_dir: str, vocab: str, device: str):
    """A ``Trainor`` over ``config`` + dotlist ``overrides`` (the train
    CLI's view of it) writing into ``ckpt_dir``, with ``vocab`` as its
    ``vocab.tgt``; no Validator."""
    import shutil

    from vilmedic_torch.config import load_config
    from vilmedic_torch.config.config import executor_config
    from vilmedic_torch.executors import Trainor

    os.makedirs(ckpt_dir, exist_ok=True)
    shutil.copy(vocab, os.path.join(ckpt_dir, "vocab.tgt"))
    cfg, _ = load_config(config, overrides)
    train_cfg = executor_config(cfg, "trainor")
    train_cfg.ckpt_dir = ckpt_dir
    return Trainor(train_cfg, seed=SEED, device=device)


def checkpoint_tensors(payload, prefix: str = ""):
    """Every tensor of a checkpoint payload, by its path."""
    import torch

    if isinstance(payload, torch.Tensor):
        return {prefix: payload}
    out = {}
    if isinstance(payload, dict):
        for k, v in payload.items():
            out.update(checkpoint_tensors(v, f"{prefix}/{k}"))
    elif isinstance(payload, (list, tuple)):
        for i, v in enumerate(payload):
            out.update(checkpoint_tensors(v, f"{prefix}/{i}"))
    return out


def prefetch_runs(tmp: str, card: str):
    """(a) The flagship config in f32 with ``device_preproc``, batch 8, on
    24 train reports of the ``rrg_train`` corpus (its vocabulary), 3 steps
    from the same initial weights with ``device_prefetch`` 0 and then 2,
    deterministic: every loss, and every tensor of the two checkpoint
    payloads (model and optimizer state, as the trainer saves them),
    bitwise equal; K3 launched once a step in both; ms an iteration of each
    beside ``rrg_train``'s (bf16, batch 128, the default depth 2)."""
    import torch

    data = os.path.join(tmp, "prefetch_data")
    scst_corpus(os.path.join(tmp, "rrg_data"), data, PREFETCH_TRAIN)
    vocab = os.path.join(tmp, "rrg_train", "vocab.tgt")
    runs, initial = {}, None
    with deterministic():
        for depth in (0, 2):
            name = f"prefetch_{depth}"
            overrides = rrg_train_overrides(data, tmp, name, "cuda")[1:] + [
                "model.dtype=float32", "trainor.batch_size=8", f"trainor.device_prefetch={depth}"]
            trainor = config_trainor(CONFIG, overrides, os.path.join(tmp, name), vocab, "cuda")
            if initial is None:
                initial = {k: v.clone() for k, v in trainor.model.module.state_dict().items()}
            else:
                trainor.model.module.load_state_dict(initial)
            reset_launches()
            with StepRecorder() as steps:
                trainor.dl.set_epoch(0)
                trainor.train_epoch(0)
            torch.cuda.synchronize()
            runs[depth] = dict(prefetch=trainor.device_prefetch, losses=steps.losses,
                               iterations=steps.iterations, epoch=steps.epochs[0],
                               k3=read_launches()[K3],
                               tensors=checkpoint_tensors(trainor._payload()))
            del trainor
    off, on = runs[0], runs[2]
    same = off["tensors"].keys() == on["tensors"].keys() and all(
        torch.equal(v, on["tensors"][k]) for k, v in off["tensors"].items())
    ms = {d: statistics.median(r["iterations"][1:]) * 1e3 for d, r in runs.items()}
    print(f"pipelined_train (a) prefetch ({card}): flagship f32 batch 8, device_preproc, "
          f"3 steps from the same weights; losses {off['losses']} with device_prefetch 0, "
          f"{on['losses']} with 2 ({'bitwise equal' if off['losses'] == on['losses'] else 'DIFFER'}"
          f"); {len(off['tensors'])} checkpoint tensors {'all equal' if same else 'DIFFER'}; "
          f"K3 {off['k3']} / {on['k3']}; ms an iteration (whole: loader wait, copy, K3, step; "
          f"median of steps 2-3) {ms[0]:.1f} at 0, {ms[2]:.1f} at 2 (each iteration "
          f"{[round(t * 1e3, 1) for t in off['iterations']]} / "
          f"{[round(t * 1e3, 1) for t in on['iterations']]}; epoch {off['epoch']:.3f} / "
          f"{on['epoch']:.3f} s); rrg_train (bf16, batch 128, device_prefetch 2): "
          f"{PIPELINE_REF.get('rrg_train_iter_ms', float('nan')):.1f} ms an iteration")
    return {
        "(a) device_prefetch read: 0 and 2": (off["prefetch"], on["prefetch"]) == (0, 2),
        "(a) 3 finite losses, bitwise equal": len(off["losses"]) == 3
        and all(map(math.isfinite, off["losses"])) and off["losses"] == on["losses"],
        "(a) every checkpoint tensor bitwise equal": same and len(off["tensors"]) > 0,
        "(a) K3 once a step, equal": off["k3"] == on["k3"] == 3,
    }, on["k3"]


class StepLosses:
    """Wraps the SCST model's gradient step (``_SCSTBase._step``) for a
    run: each step's rollouts, rewards and loss."""

    def __enter__(self):
        from vilmedic_torch.models.scst_models import _SCSTBase

        self.steps, self.real = [], _SCSTBase._step
        rec = self

        def step(model, trainor, ro, rewards, lr):
            loss, custom = rec.real(model, trainor, ro, rewards, lr)
            rec.steps.append((ro.greedy, ro.sampled, rewards[0], rewards[1], float(loss)))
            return loss, custom

        _SCSTBase._step = step
        return self

    def __exit__(self, *exc):
        from vilmedic_torch.models.scst_models import _SCSTBase

        _SCSTBase._step = self.real


def scst_epoch(trainor, epoch: int, overlap: bool):
    """One more SCST epoch on the trainer, serial or pipelined: (wall s,
    per-iteration rollout / reward / gradient ms, steps)."""
    import torch

    model = trainor.model
    model.overlap_rollout = overlap
    before = dict(model.timing)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainor.dl.set_epoch(epoch)
    trainor.train_epoch(epoch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = model.timing["iters"] - before["iters"]
    split = {k: (model.timing[f"{k}_s"] - before[f"{k}_s"]) / steps * 1e3
             for k in ("rollout", "reward", "grad")}
    return wall, split, steps


def overlap_run(tmp: str, card: str):
    """(b) ``config/RRG/rrg-scst-mimic.yml`` with ``model.overlap_rollout=true``
    through the train CLI at full width, bf16, batch 32 over ``scst_train``'s
    128 reports from ``rrg_train``'s checkpoint, the Validator at beam 8:
    4 iterations give 4 steps (3 in the loop, 1 at the epoch's end),
    ``iteration_count`` 4, finite losses, nothing pending, K1 (a), K2 and K3
    in the Validator. Then 2 more epochs on the same trainer, serial and
    pipelined: samples/s and the rollout / reward / gradient ms of each
    beside ``scst_train``'s. Returns (checks, launches)."""
    import shutil

    import torch

    from vilmedic_torch.bin.train import main

    data = os.path.join(tmp, "scst_data")
    ckpt = glob.glob(os.path.join(tmp, "rrg_train", "*.ckpt"))[0]
    os.makedirs(os.path.join(tmp, "overlap_scst"), exist_ok=True)
    shutil.copy(os.path.join(tmp, "rrg_train", "vocab.tgt"), os.path.join(tmp, "overlap_scst"))
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with StepLosses() as rec, DecodeSteps() as val_steps:
        trainor = main(scst_overrides(data, tmp, "overlap_scst", "cuda", ckpt)
                       + ["model.overlap_rollout=true"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_launches()
    model = trainor.model
    first = dict(model.timing)
    batch, n_iter = int(trainor.config.batch_size), len(trainor.dl)
    n_val_batches = len(trainor.evaluator.splits[0][1])
    losses = [x[4] for x in rec.steps]
    checks = {
        "(b) overlap_rollout on": model.overlap_rollout,
        "(b) 4 iterations, 4 steps (3 in the loop, 1 flushed)":
            n_iter == 4 and first["iters"] == 4 and len(rec.steps) == 4,
        "(b) iteration_count 4": trainor.training_scheduler.iteration_count == 4,
        "(b) finite losses, one epoch loss": all(map(math.isfinite, losses))
        and len(trainor.epoch_losses) == 1 and math.isfinite(trainor.epoch_losses[0]),
        "(b) nothing pending": model._pending is None,
        "(b) K1 (a) = K2 = Validator decode steps":
            launches[K1] == launches[K2] == val_steps.steps > 0,
        "(b) K3 = training + Validator batches": launches[K3] == n_iter + n_val_batches,
    }
    rows = ["pipelined (the CLI run): " + ", ".join(
        f"{k} {first[f'{k}_s'] / first['iters'] * 1e3:.1f}" for k in ("rollout", "reward", "grad"))
        + " ms a step"]
    for e, overlap in enumerate((False, True), start=1):
        wall, split, steps = scst_epoch(trainor, e, overlap)
        checks[f"(b) epoch {e}: 4 steps"] = steps == 4 and model._pending is None
        rows.append(f"{'pipelined' if overlap else 'serial'}: {n_iter * batch / wall:.1f} "
                    f"samples/s ({wall:.3f} s an epoch), "
                    + ", ".join(f"{k} {v:.1f}" for k, v in split.items()) + " ms a step")
    ref = PIPELINE_REF.get("scst_train", {})  # absent when the phase runs alone
    print(f"pipelined_train (b) overlap_rollout ({card}): {os.path.basename(SCST_CONFIG)} bf16 "
          f"batch {batch}, {n_iter} iterations, run {run_s:.1f} s (Validator included); step "
          f"losses {[round(x, 6) for x in losses]}; launches K1 {launches[K1]}, K2 "
          f"{launches[K2]}, K3 {launches[K3]} (Validator {val_steps.steps} decode steps); then "
          f"alternated on the same trainer: " + "; ".join(rows)
          + "; scst_train (serial, its own run): " + ", ".join(
              f"{k} {v:.1f}" for k, v in ref.items()) + " (samples/s; ms, medians of iterations 2-4)")
    del trainor, model
    torch.cuda.empty_cache()
    return checks, {K1: launches[K1], K2: launches[K2], K3: launches[K3]}


def overlap_parity(tmp: str):
    """(c) The pipelined iteration in f32 on the card and on the CPU from
    the same weights and Gumbel draws: ``scst_parity``'s setup
    (``densenet_tiny``, the full-width decoder over the parity corpus's
    5000-word vocabulary), 3 batches of 2 and the flush. Equal greedy and
    sampled ids and rewards at every step, each loss within 1e-5 relative,
    each tensor's change over the 3 steps as :func:`update_agreement`
    holds it."""
    import numpy as np

    import vilmedic_torch.blocks.vision.densenet as densenet

    densenet.CONFIGS["densenet_tiny"] = (8, (2, 2), 16)
    data = os.path.join(tmp, "overlap_parity_data")
    scst_corpus(os.path.join(tmp, "rrg_parity_data"), data, OVERLAP_PARITY_TRAIN)
    vocab = os.path.join(tmp, "scst_parity_0", "vocab.tgt")
    runs = []
    for i, device in enumerate(PARITY_DEVICES):
        _, *overrides = scst_overrides(data, tmp, "unused", device)
        trainor = config_trainor(SCST_CONFIG, overrides + [
            "trainor.batch_size=2", "model.dtype=float32", "model.cnn.backbone=densenet_tiny",
            "model.cnn.visual_projection.in_features=32", "model.decoder.hidden_dropout_prob=0.0",
            "dataset.image.resize=64", "dataset.image.crop=56", "dataset.num_workers=0",
            "model.overlap_rollout=true"], os.path.join(tmp, f"overlap_parity_{i}"), vocab, device)
        initial = cpu_state(trainor.model)
        t0 = time.perf_counter()
        with InjectedNoise(SEED + 80), StepLosses() as rec:
            trainor.dl.set_epoch(0)
            trainor.train_epoch(0)
        runs.append((rec.steps, initial, cpu_state(trainor.model), time.perf_counter() - t0,
                     trainor.model._pending is None))
        vocab_size = trainor.model.dec_config.vocab_size
        del trainor
    (s_c, i_c, f_c, t_c, p_c), (s_g, i_g, f_g, t_g, p_g) = runs
    same_ids = len(s_c) == len(s_g) == 3 and all(
        np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) for a, b in zip(s_c, s_g))
    same_rewards = all(np.array_equal(x, y) for a, b in zip(s_c, s_g)
                       for x, y in zip(a[2] + a[3], b[2] + b[3]))
    rel = max(abs(a[4] - b[4]) / abs(a[4]) for a, b in zip(s_c, s_g))
    ratio, worst = update_agreement((i_c, i_g), f_c, f_g, 3)
    print(f"pipelined_train (c) overlap_rollout f32 card vs CPU (densenet_tiny, vocab "
          f"{vocab_size}, 3 batches of 2 and the flush; CPU {t_c:.1f} s, card {t_g:.1f} s): "
          f"greedy and sampled ids {'equal' if same_ids else 'DIFFER'} at every step, rewards "
          f"{'equal' if same_rewards else 'DIFFER'}; losses {[x[4] for x in s_g]} card vs "
          f"{[x[4] for x in s_c]} CPU (max relative {rel:.2e}); parameter changes: worst "
          f"|diff| / tol {ratio:.3g} ({worst})")
    return {
        "(c) 3 steps each, nothing pending": len(s_c) == len(s_g) == 3 and p_c and p_g,
        "(c) greedy and sampled ids equal at every step": same_ids,
        "(c) sampled differ from greedy": not np.array_equal(s_g[0][0], s_g[0][1]),
        "(c) rewards equal": same_rewards,
        "(c) losses within 1e-5 relative": rel <= 1e-5,
        "(c) updates within update_agreement": ratio <= 1.0,
    }


def phase_pipelined_train(tmp: str, card: str):
    """The two pipelined training paths (``pipelined_train``): (a) the
    Trainor's ``device_prefetch`` against synchronous placement, (b)
    ``overlap_rollout`` at full width beside the serial iteration, (c) the
    pipelined iteration f32 card vs CPU. Returns the path's launches of
    K1, K2 and K3 (K3 of (a)'s prefetched run and (b)'s CLI run)."""
    set_tf32(False)
    checks, k3_prefetch = prefetch_runs(tmp, card)
    more, launches = overlap_run(tmp, card)
    checks.update(more)
    checks.update(overlap_parity(tmp))
    require(checks, "pipelined_train")
    launches[K3] += k3_prefetch
    return launches


# ------------------------------------------- MVQA / CLASS, the ViT RRG tower

MVQA_CONFIG = os.path.join(ROOT, "config", "MVQA", "vqa.yml")
CLASS_CONFIG = os.path.join(ROOT, "config", "CLASS", "cvamd.yml")
VIT_CONFIG = os.path.join(ROOT, "config", "RRG", "baseline-mimic-vit.yml")
MVQA_TRAIN, MVQA_VALIDATE = 1024, 128  # 16 steps at the config's batch 64
CLASS_TRAIN, CLASS_VALIDATE = 512, 128  # 4 steps at the config's batch 128


def label_corpus(root: str, n_train: int, n_validate: int, n_classes: int, seed: int,
                 image: int):
    """JPEGs and labels made from ``seed`` in the files the MVQA and CLASS
    configs name (``{split}.image.tok``, ``{split}.label.tok``). Labels are
    ``n_classes`` names dealt round robin and then shuffled, so each split
    holds every class it has room for. Images are smooth RGB noise of
    (image + 32) x image pixels."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for split, n in (("train", n_train), ("validate", n_validate)):
        labels = [f"class{i % n_classes:03d}" for i in range(n)]
        labels = [labels[i] for i in rng.permutation(n)]
        paths = []
        for i in range(n):
            low = rng.integers(0, 256, (image // 16 + 2, image // 16 + 1, 3)).astype(np.uint8)
            path = os.path.join(root, "images", f"{split}_{i}.jpg")
            Image.fromarray(low).resize((image, image + 32), Image.BILINEAR).save(path,
                                                                                 quality=90)
            paths.append(path)
        with open(os.path.join(root, f"{split}.label.tok"), "w") as f:
            f.write("\n".join(labels))
        with open(os.path.join(root, f"{split}.image.tok"), "w") as f:
            f.write("\n".join(paths))


def label_overrides(config: str, data: str, ckpt: str, name: str, device: str):
    return [config, f"ckpt_dir={ckpt}", f"name={name}", f"device={device}", f"seed={SEED}",
            f"dataset.image.root={data}", f"dataset.label.root={data}", "trainor.epochs=0",
            "ensemblor.splits=[validate]"]


class EvalRecorder:
    """Keeps a copy of every result the classifier's ensemble evaluation
    returns (the Validator pops its keys)."""

    def __enter__(self):
        from vilmedic_torch.models import mvqa

        self.results, self.real = [], mvqa.evaluation

        def recorded(*args, **kwargs):
            out = self.real(*args, **kwargs)
            self.results.append(dict(out))
            return out

        mvqa.evaluation = recorded
        return self

    def __exit__(self, *exc):
        from vilmedic_torch.models import mvqa

        mvqa.evaluation = self.real


def train_split(trainor, label: str, card: str):
    """One more training step, traced: (host ms, device-busy ms)."""
    one = trainor._model_batch(next(iter(trainor.dl)))
    lr = trainor.training_scheduler.current_lr()
    _, host, dev = device_ms(lambda: trainor.train_step(one, lr))
    print(f"{label} split (torch.profiler, one more step, {card}): host {host:.1f} ms, device "
          f"busy {dev['all']:.1f} ms ({100 * dev['all'] / host:.0f}% of the step)")
    return host, dev["all"]


def classifier_train(config: str, tmp: str, name: str, n_train: int, n_validate: int,
                     n_classes: int, metrics, card: str):
    """A classification config through the train CLI at full width, bf16:
    its corpus, one epoch, the Validator, and timings. Returns (trainor,
    steps, launches, validator seconds)."""
    import torch

    from vilmedic_torch.bin.train import main

    set_tf32(False)
    data = os.path.join(tmp, f"{name}_data")
    t0 = time.perf_counter()
    label_corpus(data, n_train, n_validate, n_classes, SEED, 256)
    print(f"{name}: synthetic corpus of {n_train} + {n_validate} JPEGs of 288 x 256 over "
          f"{n_classes} classes, written in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with StepRecorder() as steps:
        trainor = main(label_overrides(config, data, tmp, name, "cuda"))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    model, cfg = trainor.model, trainor.config
    batch = int(cfg.batch_size)
    n_steps = len(steps.iterations)
    iter_ms = statistics.median(steps.iterations[1:]) * 1e3
    step_ms = statistics.median(steps.times[1:]) * 1e3
    tcfg = model.transformer_cfg
    print(f"{name}: {cfg.model.cnn.backbone} to {cfg.model.cnn.output_layer} at "
          f"{trainor.dl.dataset.image.crop}², adapter to {tcfg.hidden_size}, "
          f"{tcfg.num_hidden_layers} layers of {tcfg.hidden_size} x {tcfg.num_attention_heads} "
          f"heads, {model.num_classes} classes, {type(model.loss_fn).__name__}, {tcfg.dtype}, "
          f"{cfg.optimizer} lr {trainor.base_lr:g}, batch {batch}, {trainor.dl.num_workers} "
          f"loader threads, {n_steps} steps, run {run_s:.1f} s; losses "
          f"{[round(x, 4) for x in steps.losses]}")
    print(f"{name} bf16 batch {batch} ({card}): {iter_ms:.1f} ms per training step (whole "
          f"iteration: loader wait, H2D, step; median of steps 2-{n_steps}: "
          f"{[round(t * 1e3, 1) for t in steps.iterations]}), {batch / iter_ms * 1e3:.1f} images/s;"
          f" the model step alone {step_ms:.1f} ms, {batch / step_ms * 1e3:.1f} images/s; the "
          f"epoch's training {steps.epochs[0]:.2f} s; peak {peak:.2f} GiB")
    evaluator = trainor.evaluator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluator.start()
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    scores = evaluator.scores[0]
    print(f"{name}: Validator {n_validate / val_s:.1f} images/s bf16 ({card}; batch "
          f"{evaluator.splits[0][1].batch_size}: {val_s:.2f} s for {n_validate} images); scores "
          f"{ {k: v for k, v in scores.items() if k != 'f1-score'} }")
    train_split(trainor, name, card)
    require({
        f"{n_train // batch} steps": trainor.training_scheduler.iteration_count
        == n_train // batch == n_steps,
        "finite losses": all(map(math.isfinite, steps.losses)),
        "checkpoint exists": len(glob.glob(os.path.join(tmp, name, "*.ckpt"))) == 1,
        "metrics scored": all(scores.get(m) is not None for m in metrics),
        "no K1, K2, K3 or K4 on this path": not any(
            launches[k] for k in (K1, K2, K3, "flash_attention", "flash_attention_with_lse")),
    }, name)
    return trainor, launches, scores


def phase_mvqa_train(tmp: str, card: str):
    """``config/MVQA/vqa.yml`` at full width through the train CLI: 1024
    JPEGs (16 Adam steps at batch 64, ResNet-50 to layer4 in training mode:
    49 tokens of 2048, the adapter to 768, 2 post-LN layers, 330 classes,
    label smoothing 0.1), the Validator with accuracy and f1-score over 128,
    then ``python -m vilmedic_torch.bin.ensemble`` over the run's checkpoint
    (one member: the same scores)."""
    import torch

    from vilmedic_torch.bin.ensemble import main as ensemble

    trainor, launches, scores = classifier_train(
        MVQA_CONFIG, tmp, "mvqa_train", MVQA_TRAIN, MVQA_VALIDATE, 330,
        ("accuracy", "f1-score"), card)
    data = os.path.join(tmp, "mvqa_train_data")
    t0 = time.perf_counter()
    ens = ensemble(label_overrides(MVQA_CONFIG, data, tmp, "mvqa_train", "cuda"))
    ens_s = time.perf_counter() - t0
    got = ens.scores[0]
    print(f"mvqa_train: ensemble CLI over {len(ens.models)} checkpoint in {ens_s:.1f} s: "
          f"accuracy {got['accuracy']} (the run's {scores['accuracy']}), validation loss "
          f"{got['validation_loss']:.6f} (the run's {scores['validation_loss']:.6f})")
    require({
        "ensemble of the run's checkpoint": len(ens.models) == 1,
        "ensemble scores the run's": got["accuracy"] == scores["accuracy"]
        and got["f1-score"] == scores["f1-score"]
        and abs(got["validation_loss"] - scores["validation_loss"]) <= 1e-3,
    }, "mvqa_train")
    del trainor, ens
    torch.cuda.empty_cache()
    return {K1: launches[K1], K2: launches[K2], K3: launches[K3]}


def phase_class_train(tmp: str, card: str):
    """``config/CLASS/cvamd.yml`` the same way: 512 JPEGs (4 Adam steps at
    batch 128; 1 layer, 23 classes, cross entropy), the Validator with
    accuracy and auroc over 128 (every class present)."""
    import torch

    trainor, launches, _ = classifier_train(CLASS_CONFIG, tmp, "class_train", CLASS_TRAIN,
                                            CLASS_VALIDATE, 23, ("accuracy", "auroc"), card)
    del trainor
    torch.cuda.empty_cache()
    return {K1: launches[K1], K2: launches[K2], K3: launches[K3]}


def vit_overrides(data: str, ckpt: str, name: str, device: str):
    return [VIT_CONFIG, f"ckpt_dir={ckpt}", f"name={name}", f"device={device}", f"seed={SEED}",
            f"dataset.image.root={data}", f"dataset.seq.root={data}", "trainor.epochs=0",
            "trainor.early_stop_metric=BLEU", "validator.metrics=[ROUGEL,BLEU,METEOR,CIDERD]"]


def phase_rrg_vit_train(tmp: str, card: str):
    """``config/RRG/baseline-mimic-vit.yml`` through the train CLI on the
    ``rrg_train`` corpus, bf16: ViT-B/16 at 224² (pre-LN, tanh GELU, 12
    layers of 768, trained), the 1-layer decoder, RAdam lr 1e-3, batch 128,
    ``device_preproc`` (K3), 4 steps; the Validator at batch 4, beam 8 (K1
    stage a, K2) with ROUGEL, BLEU, METEOR and CIDERD."""
    import torch

    from vilmedic_torch.bin.train import main

    set_tf32(False)
    data = os.path.join(tmp, "rrg_data")
    overrides = vit_overrides(data, tmp, "rrg_vit_train", "cuda") + [
        "dataset.image.device_preproc=true"]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with StepRecorder() as steps, DecodeSteps() as val_steps:
        trainor = main(overrides)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    model, evaluator, cfg = trainor.model, trainor.evaluator, trainor.config
    vit = model.module.enc.model
    batch = int(cfg.batch_size)
    n_steps = len(steps.iterations)
    iter_ms = statistics.median(steps.iterations[1:]) * 1e3
    step_ms = statistics.median(steps.times[1:]) * 1e3
    scores = evaluator.scores[0]
    print(f"rrg_vit_train: ViT pre_ln={vit.pre_ln} {vit.config.hidden_act}, "
          f"{vit.config.num_hidden_layers} layers of {vit.config.hidden_size} at "
          f"{trainor.dl.dataset.image.crop}² ({vit.pos_embed.shape[1]} tokens), "
          f"{model.dec_config.num_hidden_layers}-layer decoder, vocab "
          f"{model.dec_config.vocab_size}, {model.dec_config.dtype}, {cfg.optimizer} lr "
          f"{trainor.base_lr:g}, batch {batch}, {n_steps} steps, run {run_s:.1f} s; losses "
          f"{[round(x, 4) for x in steps.losses]}")
    print(f"rrg_vit_train bf16 batch {batch} ({card}): {iter_ms:.1f} ms per training step "
          f"(whole iteration; median of steps 2-{n_steps}: "
          f"{[round(t * 1e3, 1) for t in steps.iterations]}), {batch / iter_ms * 1e3:.1f} "
          f"images/s; the model step alone {step_ms:.1f} ms; peak {peak:.2f} GiB")
    val_dl = evaluator.splits[0][1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluator.start()
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    n_val = len(val_dl.dataset)
    print(f"rrg_vit_train: Validator {n_val / val_s:.2f} reports/s bf16 ({card}; batch "
          f"{val_dl.batch_size}, beam {evaluator.config.beam_width}: {val_s:.2f} s for {n_val} "
          f"reports); scores {scores}; launches K1 {launches[K1]}, K2 {launches[K2]}, K3 "
          f"{launches[K3]}, K4 {launches['flash_attention']}")
    train_split(trainor, "rrg_vit_train", card)
    require({
        "4 steps": trainor.training_scheduler.iteration_count == 4 == n_steps,
        "finite losses": all(map(math.isfinite, steps.losses)),
        "the ViT trains": any(n.startswith("enc.model.layer_11.") for n in trainor.tx.names),
        "finite ROUGEL / BLEU / METEOR / CIDERD": all(
            scores.get(k) is not None and math.isfinite(scores[k])
            for k in ("ROUGEL", "BLEU", "METEOR", "CIDERD")),
        "K1 (a) = K2 = Validator decode steps": launches[K1] == launches[K2] == val_steps.steps > 0,
        "K3 = training + Validator batches":
            launches[K3] == 4 + RRG_VALIDATE // val_dl.batch_size,
        "dense attention in the tower (197 tokens)": launches["flash_attention"] == 0
        and launches["flash_attention_with_lse"] == 0,
    }, "rrg_vit_train")
    del trainor, model, evaluator
    torch.cuda.empty_cache()
    return {K1: launches[K1], K2: launches[K2], K3: launches[K3]}


def cli_parity(overrides, data_dir: str, tmp: str, name: str):
    """The train CLI in f32 on the CPU and then the card: per device the
    step losses, the initial and final states and the recorded
    evaluations."""
    from vilmedic_torch.bin.train import main

    runs = []
    for device in PARITY_DEVICES:
        t0 = time.perf_counter()
        with StepRecorder() as steps, EvalRecorder() as evals:
            trainor = main(overrides(data_dir, tmp, f"{name}_{device}", device))
        runs.append(dict(losses=steps.losses, initial=steps.initial,
                         final=cpu_state(trainor.model), evals=evals.results,
                         seconds=time.perf_counter() - t0))
        del trainor
    return runs


def phase_class_parity(tmp: str):
    """f32, TF32 off: ``config/MVQA/vqa.yml`` at full width through the
    train CLI on the CPU and on the card from the same seed: one training
    step at batch 4 (dropout 0; Adam with eps 1, so that a gradient entry
    that is 0 up to rounding takes a step of its own size, not a full lr
    step of either sign), then the Validator over 4 images: the loss within
    1e-5 relative, each tensor's change as ``update_agreement`` holds it,
    the validation logits within 1e-4 of their largest, equal answers."""
    import numpy as np
    import torch

    set_tf32(False)
    data = os.path.join(tmp, "mvqa_parity_data")
    label_corpus(data, 4, 4, 330, SEED + 2, 256)

    def overrides(d, ckpt, name, device):
        return label_overrides(MVQA_CONFIG, d, ckpt, name, device) + [
            "model.dtype=float32", "model.transformer.hidden_dropout_prob=0.0",
            "trainor.batch_size=4", "validator.batch_size=4", "trainor.optim_params.eps=1.0",
            "dataset.num_workers=0"]

    cpu, gpu = cli_parity(overrides, data, tmp, "mvqa_parity")
    loss_rel = abs(gpu["losses"][0] - cpu["losses"][0]) / abs(cpu["losses"][0])
    same_start = all(torch.equal(gpu["initial"][k], cpu["initial"][k]) for k in cpu["initial"])
    ratio, worst = update_agreement((cpu["initial"], gpu["initial"]), cpu["final"], gpu["final"],
                                    1)
    want, got = cpu["evals"][-1], gpu["evals"][-1]
    logit_err = float(np.abs(got["hyps"] - want["hyps"]).max() / np.abs(want["hyps"]).max())
    same_answers = bool((got["hyps"].argmax(-1) == want["hyps"].argmax(-1)).all())
    print(f"mvqa parity f32 batch 4 (ResNet-50, 2 layers of 768, 330 classes; CPU run "
          f"{cpu['seconds']:.1f} s): loss {gpu['losses']} card vs {cpu['losses']} CPU (relative "
          f"diff {loss_rel:.2e}); initial weights {'equal' if same_start else 'DIFFER'}; parameter "
          f"changes: worst |diff| / tol {ratio:.3g} ({worst}); validation logits max |diff| / max "
          f"{logit_err:.2e}; answers {'equal' if same_answers else 'DIFFER'}")
    return {"mvqa loss within 1e-5 relative": loss_rel <= 1e-5,
            "mvqa the same initial weights": same_start,
            "mvqa each tensor's change within tolerance": ratio <= 1.0,
            "mvqa validation logits within 1e-4": logit_err <= 1e-4,
            "mvqa equal answers": same_answers}


def phase_vit_parity(tmp: str):
    """f32, TF32 off: ``config/RRG/baseline-mimic-vit.yml`` at full width
    (ViT-B/16, 12 layers) through the train CLI on the CPU and on the card:
    one RAdam step at batch 2 (dropout 0; RAdam's first step is the
    un-normalized mean gradient), no evaluation: the loss within 1e-5
    relative and each tensor's change as ``update_agreement`` holds it."""
    import torch

    set_tf32(False)
    data = os.path.join(tmp, "vit_parity_data")
    synthetic_corpus(data, 2, 2, SEED + 3, 256)

    def overrides(d, ckpt, name, device):
        return vit_overrides(d, ckpt, name, device) + [
            "model.dtype=float32", "model.decoder.hidden_dropout_prob=0.0",
            "trainor.batch_size=2", "trainor.eval_start=99", "dataset.num_workers=0"]

    cpu, gpu = cli_parity(overrides, data, tmp, "vit_parity")
    loss_rel = abs(gpu["losses"][0] - cpu["losses"][0]) / abs(cpu["losses"][0])
    same_start = all(torch.equal(gpu["initial"][k], cpu["initial"][k]) for k in cpu["initial"])
    ratio, worst = update_agreement((cpu["initial"], gpu["initial"]), cpu["final"], gpu["final"],
                                    1)
    print(f"rrg_vit parity f32 batch 2 (ViT-B/16 12 layers, CPU run {cpu['seconds']:.1f} s): "
          f"loss {gpu['losses']} card vs {cpu['losses']} CPU (relative diff {loss_rel:.2e}); "
          f"initial weights {'equal' if same_start else 'DIFFER'}; parameter changes: worst "
          f"|diff| / tol {ratio:.3g} ({worst})")
    return {"vit loss within 1e-5 relative": loss_rel <= 1e-5,
            "vit the same initial weights": same_start,
            "vit each tensor's change within tolerance": ratio <= 1.0}


def phase_tower_parity(tmp: str):
    import torch

    t0 = time.perf_counter()
    checks = {**phase_class_parity(tmp), **phase_vit_parity(tmp)}
    print(f"tower parity: {time.perf_counter() - t0:.1f} s")
    require(checks, "tower_parity")
    torch.cuda.empty_cache()


ROBERTA_CONFIG = os.path.join(ROOT, "config", "RRG", "biomed-roberta-baseline-mimic.yml")
CONVIRT_CONFIG = os.path.join(ROOT, "config", "SELFSUP", "convirt-mimic.yml")
GLORIA_CONFIG = os.path.join(ROOT, "config", "SELFSUP", "gloria-mimic.yml")
# roberta-base's published config.json keys; the decoder adds cross-attention
ROBERTA_BASE = dict(model_type="roberta", num_hidden_layers=12, hidden_size=768,
                    num_attention_heads=12, intermediate_size=3072, max_position_embeddings=514,
                    layer_norm_eps=1e-5, pad_token_id=1, bos_token_id=0, eos_token_id=2,
                    vocab_size=50265, type_vocab_size=1, add_cross_attention=True)
SELFSUP_VALIDATE = 64  # the rrg_train corpus's 32 validate images and reports + 32 of train


def roberta_config_dir(tmp: str) -> str:
    """A directory holding roberta-base's ``config.json`` (written here from
    its published keys, not fetched): the decoder's ``proto``."""
    folder = os.path.join(tmp, "roberta-base")
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "config.json"), "w") as f:
        json.dump(ROBERTA_BASE, f)
    return folder


def build_roberta(dtype: str, device: str, folder: str, overrides=()):
    """``config/RRG/biomed-roberta-baseline-mimic.yml`` with its decoder's
    pretrained name pointed at ``folder``: vocab 50265 from the config file,
    the LM-head transform, random weights from the seed; its single-model
    beam-8 generate at the config's ``tokenizer_max_len``."""
    from vilmedic_torch import registry
    from vilmedic_torch.config import load_config
    from vilmedic_torch.models import rrg  # noqa: F401  (registers RRG)
    from vilmedic_torch.models.base import get_special_token_ids
    from vilmedic_torch.models.evaluation_nlg import make_generate_fn

    cfg, _ = load_config(ROBERTA_CONFIG, [f"model.dtype={dtype}",
                                          f"model.decoder.proto={folder}", *overrides])
    model = registry.build("model", cfg.model, device=device, seed=SEED)
    max_len = int(cfg.dataset.seq.tokenizer_max_len)
    bos, eos, pad = get_special_token_ids(model.dec_config)
    generate = make_generate_fn([model], BEAM, max_len, bos, eos, pad, length_penalty=1.0)
    return model, generate, int(cfg.dataset.image.crop), max_len, (bos, eos, pad)


def phase_rrg_roberta_serve(tmp: str, card: str):
    """The RoBERTa-width RRG (DenseNet-169 at 224², a 12-layer 768 decoder
    with cross-attention and the BERT/RoBERTa LM-head transform, vocab
    50265), bf16, beam 8, max_len 120, on uint8 batches of 16 and 128:
    launches (K1 (a) = 12 x decode steps, K2 = steps, K3 = 1), reports/s,
    and device ops and device-busy ms per decode step (a 24-token generate
    less a 12-token one). Then holds K1 (a) and K2 at this path's shapes
    against their plain versions."""
    import torch

    set_tf32(False)
    folder = roberta_config_dir(tmp)
    model, generate, crop, max_len, (bos, eos, pad) = build_roberta("bfloat16", "cuda", folder)
    dec = model.dec_config
    layers, vocab = dec.num_hidden_layers, dec.vocab_size
    print(f"rrg_roberta_serve: RRG from {os.path.relpath(ROBERTA_CONFIG, ROOT)}, decoder.proto = "
          f"a roberta-base config.json: densenet169 + {layers}-layer decoder of "
          f"{dec.hidden_size} ({dec.num_attention_heads} heads), vocab {vocab}, LM-head transform "
          f"{dec.lm_head_transform}, special ids {bos}/{eos}/{pad}, bf16, beam {BEAM}, max_len "
          f"{max_len}")
    reset_launches()
    res = serve(model, generate, host_batch(16, crop, SEED), crop, "cuda")
    torch.cuda.synchronize()
    launches = read_launches()
    seqs, steps = res.sequences, res.steps
    print(f"rrg_roberta_serve batch 16: sequences {tuple(seqs.shape)}, {steps} decode steps, "
          f"launches K1 {launches[K1]}, K2 {launches[K2]}, K3 {launches[K3]}")
    require({
        "the RoBERTa config resolved": dec.lm_head_transform and vocab == 50265
        and dec.max_position_embeddings == 514 and (bos, eos, pad) == (0, 2, 1)
        and hasattr(model.module.dec, "lm_transform_ln"),
        "shape (16, max_len)": tuple(seqs.shape) == (16, max_len),
        "BOS in column 0": bool((seqs[:, 0] == bos).all()),
        "ids in the vocabulary": bool(((seqs >= 0) & (seqs < vocab)).all()),
        "finite scores": bool(torch.isfinite(res.scores).all()),
        "K1 (a) = layers x steps": launches[K1] == layers * steps > 0,
        "K2 = steps": launches[K2] == steps,
        "K3 = 1": launches[K3] == 1,
    }, "rrg_roberta_serve")

    from vilmedic_torch.models.evaluation_nlg import make_generate_fn

    gen_short, gen_long = (make_generate_fn([model], BEAM, n, bos, eos, pad, length_penalty=1.0)
                           for n in (OPS_LEN, 2 * OPS_LEN))
    batch16 = host_batch(16, crop, SEED)
    full, n_full, ms_full = device_ops(lambda: serve(model, gen_long, batch16, crop, "cuda"))
    part, n_part, ms_part = device_ops(lambda: serve(model, gen_short, batch16, crop, "cuda"))
    per_step = ((n_full - n_part) / (full.steps - part.steps),
                (ms_full - ms_part) / (full.steps - part.steps))
    rates = {}
    for b in (16, 128):
        batch = host_batch(b, crop, SEED + b)
        serve(model, generate, batch, crop, "cuda")  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, steps_seen = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            r = serve(model, generate, batch, crop, "cuda")
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            steps_seen.append(r.steps)
        med = statistics.median(times)
        rates[b] = b / med
        print(f"rrg_roberta_serve batch {b} ({card}): {b / med:.2f} reports/s (median of "
              f"{len(times)}: "
              f"{med * 1e3:.1f} ms per batch, spread {(max(times) - min(times)) / med * 100:.1f}%, "
              f"steps {steps_seen}, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
    print(f"rrg_roberta_serve batch 16 ({card}): {per_step[0]:.1f} device ops and "
          f"{per_step[1]:.3f} device-busy ms per decode step (torch.profiler: a "
          f"{2 * OPS_LEN}-token generate less a {OPS_LEN}-token one, {full.steps - part.steps} "
          "steps)")
    gen = torch.Generator().manual_seed(SEED + 50)
    w32, b = lm_head_weights(vocab, gen, dec.hidden_size)
    for n in (16 * BEAM, 128 * BEAM):
        hold_beam_cache_attention(torch.bfloat16, n, gen, t=max_len, heads=dec.num_attention_heads,
                                  d=dec.head_dim, label=" (rrg_roberta_serve)")
        h = torch.randn(n, dec.hidden_size, generator=gen)
        hold_blocked_lm_head(h.to("cuda", torch.bfloat16), w32.to("cuda", torch.bfloat16),
                             b.cuda(), label=" (rrg_roberta_serve)")
    print(f"rrg_roberta_serve: K1 (a) bf16 at N 128 and 1024, T {max_len}, "
          f"{dec.num_attention_heads} x {dec.head_dim}, and K2 bf16 at N 128 and 1024, Vp "
          f"{w32.shape[0]}, agree with their plain versions")
    del model, generate, gen_short, gen_long
    torch.cuda.empty_cache()
    return {K1: launches[K1], K2: launches[K2], K3: launches[K3]}


def phase_roberta_parity(tmp: str):
    """f32, TF32 off: the RoBERTa-width RRG cut to 2 decoder layers (the
    LM-head transform kept) on the card and on the CPU from the same
    weights, batch 2, beam 8: equal beam sequences."""
    import torch

    set_tf32(False)
    folder = roberta_config_dir(tmp)
    results = {}
    t0 = time.perf_counter()
    for device in ("cuda", "cpu"):
        model, generate, crop, _, _ = build_roberta(
            "float32", device, folder, ["model.decoder.num_hidden_layers=2"])
        res = serve(model, generate, host_batch(2, crop, SEED + 7), crop, device)
        results[device] = (res.sequences.cpu(), res.scores.float().cpu(), res.steps)
        del model, generate
    (s_gpu, sc_gpu, n_gpu), (s_cpu, sc_cpu, n_cpu) = results["cuda"], results["cpu"]
    same = torch.equal(s_gpu, s_cpu)
    print(f"roberta parity f32 batch 2 (2 decoder layers with the LM-head transform, "
          f"{time.perf_counter() - t0:.1f} s): sequences {'equal' if same else 'DIFFER'} "
          f"({n_gpu} vs {n_cpu} steps), max |score diff| {(sc_gpu - sc_cpu).abs().max().item():.3e}")
    require({"equal f32 beam sequences card vs CPU": same}, "roberta_parity")
    torch.cuda.empty_cache()


def selfsup_corpus(tmp: str) -> str:
    """The SELFSUP configs' files (``{split}.image.tok``,
    ``{split}.report.tok``) over the ``rrg_train`` corpus: its 512 train
    JPEGs and reports, and for validate its 32 plus the first 32 of train."""
    src, data = os.path.join(tmp, "rrg_data"), os.path.join(tmp, "selfsup_data")
    os.makedirs(data, exist_ok=True)
    rows = {}
    for split in ("train", "validate"):
        with open(os.path.join(src, f"{split}.image.tok")) as f:
            images = f.read().split("\n")
        with open(os.path.join(src, f"{split}.impression.tok")) as f:
            reports = f.read().split("\n")
        rows[split] = (images, reports)
    extra = SELFSUP_VALIDATE - len(rows["validate"][0])
    rows["validate"] = tuple(v + t[:extra] for v, t in zip(rows["validate"], rows["train"]))
    for split, (images, reports) in rows.items():
        with open(os.path.join(data, f"{split}.image.tok"), "w") as f:
            f.write("\n".join(images))
        with open(os.path.join(data, f"{split}.report.tok"), "w") as f:
            f.write("\n".join(reports))
    return data


def selfsup_overrides(config: str, data: str, ckpt: str, name: str, device: str):
    """A SELFSUP config on the synthetic corpus: the config's pretrained
    tokenizer (from the temp hub cache, :func:`write_hub_tokenizers`), one
    epoch, the ensemblor on the validate split."""
    return [config, f"ckpt_dir={ckpt}", f"name={name}", f"device={device}", f"seed={SEED}",
            f"dataset.image.root={data}", f"dataset.seq.root={data}",
            "trainor.epochs=0", "ensemblor.splits=[validate]"]


def selfsup_train(config: str, tmp: str, name: str, card: str):
    """A SELFSUP config through the train CLI at full width, bf16: one epoch
    over the corpus, the Validator (``validation_loss``), timings. Returns
    (trainor, launches, scores)."""
    import torch

    from vilmedic_torch.bin.train import main

    set_tf32(False)
    data = selfsup_corpus(tmp)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with StepRecorder() as steps:
        trainor = main(selfsup_overrides(config, data, tmp, name, "cuda"))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    model, cfg = trainor.model, trainor.config
    enc = model.enc_config
    batch = int(cfg.batch_size)
    n_steps = len(steps.iterations)
    n_train = len(trainor.dl.dataset)
    iter_ms = statistics.median(steps.iterations[1:]) * 1e3
    step_ms = statistics.median(steps.times[1:]) * 1e3
    n_params = sum(p.numel() for p in model.module.parameters())
    print(f"{name}: {cfg.model.proto} from {os.path.relpath(config, ROOT)}: "
          f"{cfg.model.cnn.backbone} at {trainor.dl.dataset.image.crop}², a "
          f"{enc.num_hidden_layers}-layer encoder of {enc.hidden_size} ({enc.num_attention_heads} "
          f"heads) at T {trainor.dl.dataset.tokenizer_max_len}, vocab {enc.vocab_size} (the "
          f"tokenizer {cfg.dataset.seq.tokenizer}'s), {n_params / 1e6:.1f} M parameters, "
          f"{enc.dtype}, "
          f"{type(model.loss_fn).__name__}, {cfg.optimizer} {dict(cfg.optim_params.to_dict())}, "
          f"batch {batch}, {trainor.dl.num_workers} loader threads, {n_steps} steps, run "
          f"{run_s:.1f} s; losses {[round(x, 4) for x in steps.losses]}")
    print(f"{name} bf16 batch {batch} ({card}): {iter_ms:.1f} ms per training step (whole "
          f"iteration: loader wait, H2D, step; median of steps 2-{n_steps}: "
          f"{[round(t * 1e3, 1) for t in steps.iterations]}), {batch / iter_ms * 1e3:.1f} images/s;"
          f" the model step alone {step_ms:.1f} ms, {batch / step_ms * 1e3:.1f} images/s; the "
          f"epoch's training {steps.epochs[0]:.2f} s; peak {peak:.2f} GiB")
    evaluator = trainor.evaluator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluator.start()
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    scores = evaluator.scores[0]
    n_val = len(evaluator.splits[0][1].dataset)
    print(f"{name}: Validator {n_val / val_s:.1f} images/s bf16 ({card}; batch "
          f"{evaluator.splits[0][1].batch_size}: {val_s:.2f} s for {n_val} image-report pairs); "
          f"validation_loss {scores['validation_loss']:.6f}")
    train_split(trainor, name, card)
    require({
        f"{n_train // batch} steps": trainor.training_scheduler.iteration_count
        == n_train // batch == n_steps,
        "finite losses": all(map(math.isfinite, steps.losses)),
        "finite validation_loss": math.isfinite(scores["validation_loss"]),
        "checkpoint exists": len(glob.glob(os.path.join(tmp, name, "*.ckpt"))) == 1,
        "no K1, K2, K3 or K4 on this path (dense attention, host float images)": not any(
            launches[k] for k in (K1, K2, K3, "flash_attention", "flash_attention_with_lse")),
    }, name)
    return trainor, launches, scores


def phase_convirt_train(tmp: str, card: str):
    """``config/SELFSUP/convirt-mimic.yml`` at full width through the train
    CLI: ResNet-50 to avgpool (trained), a 12-layer 768 encoder at T 128
    (the config's pretrained name does not resolve here, so the explicit
    keys and BERT-base's defaults build it, as in the JAX package), the two
    projections to 768, ConVIRTLoss, RAdam 5e-5, ReduceLROnPlateau (abs
    threshold, min_lr), batch 32: 16 steps over 512 JPEGs, the Validator
    over 64."""
    import torch

    trainor, launches, _ = selfsup_train(CONVIRT_CONFIG, tmp, "convirt_train", card)
    del trainor
    torch.cuda.empty_cache()
    return {K1: launches[K1], K2: launches[K2], K3: launches[K3]}


def phase_gloria_train(tmp: str, card: str):
    """``config/SELFSUP/gloria-mimic.yml`` the same way: ResNet-50 with
    layer3 captured (14 x 14 = 196 regions of 1024 -> 768), a 12-layer
    encoder at T 97, GLoRIALoss (the local loss over the 48 x 48 grid),
    Adam 5e-5 with L2 1e-6, batch 48: 10 steps; then ``python -m
    vilmedic_torch.bin.ensemble`` over the run's checkpoint, which must give
    the run's validation loss within 1e-3."""
    import torch

    from vilmedic_torch.bin.ensemble import main as ensemble

    trainor, launches, scores = selfsup_train(GLORIA_CONFIG, tmp, "gloria_train", card)
    data = os.path.join(tmp, "selfsup_data")
    t0 = time.perf_counter()
    ens = ensemble(selfsup_overrides(GLORIA_CONFIG, data, tmp, "gloria_train", "cuda"))
    ens_s = time.perf_counter() - t0
    got = ens.scores[0]["validation_loss"]
    print(f"gloria_train: ensemble CLI over {len(ens.models)} checkpoint in {ens_s:.1f} s: "
          f"validation loss {got:.6f} (the run's {scores['validation_loss']:.6f})")
    require({
        "ensemble of the run's checkpoint": len(ens.models) == 1,
        "ensemble gives the run's validation loss": abs(got - scores["validation_loss"]) <= 1e-3,
    }, "gloria_train")
    del trainor, ens
    torch.cuda.empty_cache()
    return {K1: launches[K1], K2: launches[K2], K3: launches[K3]}


class ReluReplay:
    """Holds two runs of a ReLU network to the same branches. A pre-activation
    within rounding of 0 can land on either side of the kink on the card and
    on the CPU; its element then passes the whole downstream gradient on one
    device and none on the other, so a parameter's gradient (a sum over such
    elements) moves by that term, far more than f32 rounding of the sums.
    Recording (``masks`` None) keeps each ``F.relu`` call's mask z > 0 of
    the ResNet tower and the SELFSUP projections, in call order; replaying
    (``masks`` from a recording) applies them, and counts the elements whose
    own mask differs (``flips``) and their largest |z| against that call's
    largest (``worst``): flips are allowed only within rounding of 0."""

    def __init__(self, masks=None):
        self.recording = masks is None
        self.masks = [] if masks is None else masks
        self.calls = self.flips = 0
        self.worst = 0.0

    def relu(self, x, inplace: bool = False):
        import torch

        if self.recording:
            self.masks.append((x > 0).cpu())
            return torch.relu(x)
        mask = self.masks[self.calls].to(x.device)
        self.calls += 1
        flipped = (x > 0) != mask
        if bool(flipped.any()):
            z = x.detach().abs()
            self.flips += int(flipped.sum())
            self.worst = max(self.worst, float(z[flipped].max() / z.max()))
        return torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device))

    def __enter__(self):
        import torch.nn.functional as F

        from vilmedic_torch.blocks.vision import resnet
        from vilmedic_torch.models import selfsup

        replay = self

        class Functional:
            relu = staticmethod(replay.relu)

            def __getattr__(self, name):
                return getattr(F, name)

        self.modules = (resnet, selfsup)
        for m in self.modules:
            m.F = Functional()
        return self

    def __exit__(self, *exc):
        import torch.nn.functional as F

        for m in self.modules:
            m.F = F


class _CorpusLoader:
    """Stands in for a loader where a SELFSUP model reads its tokenizer."""

    def __init__(self, tokenizer):
        self.dataset = type("Dataset", (), {"tokenizer": tokenizer})()


class Float64Witness:
    """Runs a model of the port in f64 on the CPU, as a witness of what its
    f32 runs round: its parameters and buffers in f64, every module
    attribute that names f32 as a compute or output dtype (and each config's
    ``dtype``) set to f64, and ``Tensor.float()`` of an f64 tensor left in
    f64, so that the norms and losses that compute "in f32" keep f64."""

    def __init__(self, module):
        self.module = module

    def __enter__(self):
        import dataclasses

        import torch

        self.module.double()
        for m in self.module.modules():
            for k, v in list(vars(m).items()):
                if v is torch.float32:
                    setattr(m, k, torch.float64)
                elif dataclasses.is_dataclass(v) and getattr(v, "dtype", None) is torch.float32:
                    object.__setattr__(v, "dtype", torch.float64)
        real = self.real = torch.Tensor.float
        torch.Tensor.float = lambda t, *a, **k: t if t.dtype == torch.float64 else real(t, *a, **k)
        return self

    def __exit__(self, *exc):
        import torch

        torch.Tensor.float = self.real


def selfsup_step(config: str, device: str, tokenizer, batch, eps=None, relu=None,
                 witness: bool = False, capture: dict | None = None):
    """One f32 training step of a SELFSUP config at full width on
    ``device`` (dropout 0): the model from the seed, the loss, its backward
    and one update with the config's optimizer (``eps`` replaces Adam's);
    the forward under ``relu`` (a :class:`ReluReplay`) where given; with
    ``witness``, the same from the same f32 weights in f64
    (:class:`Float64Witness`, on the CPU). A ``capture`` dict (GLoRIA)
    receives the ResNet stem BatchNorm's output gradient (``terms``) and
    its bias's gradient (``sum``), in f64 on the CPU. Returns (model, loss,
    initial state, final state)."""
    import torch

    from vilmedic_torch import registry
    from vilmedic_torch.config import load_config
    from vilmedic_torch.executors.train_state import create_optimizer, gated_update
    from vilmedic_torch.models import selfsup  # noqa: F401  (registers the models)

    cfg, _ = load_config(config, ["model.dtype=float32", "model.encoder.hidden_dropout_prob=0.0"])
    model = registry.build("model", cfg.model, dl=_CorpusLoader(tokenizer), device=device,
                           seed=SEED)
    initial = cpu_state(model)
    params = cfg.trainor.optim_params.to_dict()
    if eps is not None:
        params["eps"] = eps
    if capture is not None:
        def keep_terms(module, args, y):
            y.register_hook(lambda g: capture.__setitem__("terms", g.detach().double().cpu()))

        stem = model.module.cnn.bn_init
        hook = stem.register_forward_hook(keep_terms)
    with Float64Witness(model.module) if witness else contextlib.nullcontext():
        tx = create_optimizer(cfg.trainor.optimizer, params,
                              frozen_prefixes=getattr(model, "frozen_prefixes", ()),
                              named_parameters=model.module.named_parameters())
        with relu or contextlib.nullcontext():
            out = model.apply_train({k: v.to(device) for k, v in batch.items()})
        out["loss"].backward()
        if capture is not None:
            capture["sum"] = stem.bias.grad.detach().double().cpu()
            hook.remove()
        gated_update(tx, float(params["lr"]), out["loss"].detach())
    return model, float(out["loss"].detach()), initial, cpu_state(model)


def reports_for_parity(tmp: str):
    """The 4 longest validate reports of the SELFSUP corpus."""
    with open(os.path.join(tmp, "selfsup_data", "validate.report.tok")) as f:
        return sorted(f.read().split("\n"), key=len)[-4:]


def phase_selfsup_parity(tmp: str):
    """f32, TF32 off, full width, batch 4, card against CPU from the same
    weights and batch: one training step of each SELFSUP config (ConVIRT:
    RAdam's first step, un-normalized; GLoRIA: Adam with eps 1, so that a
    gradient entry that is 0 up to rounding steps by its own size, not by a
    full lr of either sign) — the loss within 1e-5 relative and each
    tensor's change as ``update_agreement`` holds it, the CPU run on the
    card run's ReLU branches (:class:`ReluReplay`: the elements whose branch
    differs must lie within 1e-5 of their call's largest pre-activation) —
    on two batches of text: random ids over the config's tokenizer's
    vocabulary, and the corpus's reports through that tokenizer. GLoRIA's
    step runs a third time, in f64 on the CPU (:class:`Float64Witness`, on
    the same branches): each f32 run's change against the witness's, per
    tensor, shows which device's rounding the card-vs-CPU difference is.
    Then GLoRIA's ``zero_shot_classification`` (3 classes of 4 prompts): the
    same classes."""
    import torch

    from vilmedic_torch.data.auto_tokenizer import AutoTokenizer

    set_tf32(False)
    t0 = time.perf_counter()
    checks = {}
    gen = torch.Generator().manual_seed(SEED + 60)
    images = torch.randn(4, 3, 224, 224, generator=gen)
    for name, config, tok_name, t, eps in (
            ("convirt", CONVIRT_CONFIG, ROBERTA_TOKENIZER, 128, None),
            ("gloria", GLORIA_CONFIG, CLINICALBERT_TOKENIZER, 97, 1.0)):
        tokenizer = AutoTokenizer.from_pretrained(tok_name)
        random_ids = torch.randint(5, tokenizer.vocab_size, (4, t), generator=gen)
        # 4 of the corpus's reports through the config's tokenizer, as the
        # path sees them (GLoRIA sums each word's pieces)
        reports = [torch.from_numpy(a) for a in tokenizer.encode_batch(
            reports_for_parity(tmp), max_length=t, add_special_tokens=False)]
        for text, (ids, mask) in (("random ids", (random_ids, torch.ones_like(random_ids))),
                                  ("reports", reports)):
            # rows cut to t, t // 2, 7 and t - 3 tokens
            mask = mask.clone()
            for row, length in enumerate((t, t // 2, 7, t - 3)):
                mask[row, length:] = 0
            ids = ids * mask + tokenizer.pad_token_id * (1 - mask)
            batch = {"input_ids": ids, "attention_mask": mask, "images": images}
            record = ReluReplay()
            caps = {"card": {}, "CPU f32": {}} if name == "gloria" else {}
            m_gpu, l_gpu, i_gpu, f_gpu = selfsup_step(config, "cuda", tokenizer, batch, eps,
                                                      record, capture=caps.get("card"))
            replay = ReluReplay(record.masks)
            m_cpu, l_cpu, i_cpu, f_cpu = selfsup_step(config, "cpu", tokenizer, batch, eps,
                                                      replay, capture=caps.get("CPU f32"))
            loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
            same_start = all(torch.equal(i_gpu[k], i_cpu[k]) for k in i_cpu)
            ratio, worst = update_agreement((i_cpu, i_gpu), f_cpu, f_gpu, 1)
            label = f"{name} ({text})"
            print(f"selfsup parity {label} f32 batch 4 (full width): loss {l_gpu:.8f} card vs "
                  f"{l_cpu:.8f} CPU (relative diff {loss_rel:.2e}); initial weights "
                  f"{'equal' if same_start else 'DIFFER'}; parameter changes: worst |diff| / tol "
                  f"{ratio:.3g} ({worst}); ReLU calls {replay.calls}, elements on the other "
                  f"branch on the CPU {replay.flips}, their largest |z| / the call's "
                  f"{replay.worst:.2e}")
            checks.update({f"{label} loss within 1e-5 relative": loss_rel <= 1e-5,
                           f"{label} ReLU branches differ only within rounding of 0":
                           replay.calls == len(replay.masks) and replay.worst <= 1e-5,
                           f"{label} the same initial weights": same_start,
                           f"{label} each tensor's change within tolerance": ratio <= 1.0})
            if name == "gloria":
                checks.update(selfsup_witness(label, config, tokenizer, batch, eps, record,
                                              (l_gpu, i_gpu, f_gpu), (l_cpu, i_cpu, f_cpu), caps))
            del record, replay
            if name == "gloria" and text == "reports":
                prompts = {}
                for cls in ("effusion", "pneumonia", "normal"):
                    p_ids = torch.randint(5, tokenizer.vocab_size, (4, 12), generator=gen)
                    prompts[cls] = {"input_ids": p_ids, "attention_mask": torch.ones_like(p_ids)}
                picks = {}
                for device, model in (("cpu", m_cpu), ("cuda", m_gpu)):
                    on = {c: {k: v.to(device) for k, v in p.items()} for c, p in prompts.items()}
                    picks[device] = model.zero_shot_classification(images.to(device), on)
                print(f"selfsup parity gloria zero-shot: card {picks['cuda']} vs CPU "
                      f"{picks['cpu']}")
                checks["gloria zero-shot classes equal"] = picks["cuda"] == picks["cpu"]
            del m_cpu, m_gpu
    print(f"selfsup parity: {time.perf_counter() - t0:.1f} s")
    require(checks, "selfsup_parity")
    torch.cuda.empty_cache()


def selfsup_witness(label: str, config: str, tokenizer, batch, eps, record, card, cpu,
                    caps: dict) -> dict:
    """The f64 witness of one GLoRIA step (see :func:`phase_selfsup_parity`):
    each f32 run's change (card, CPU) held against the f64 run's by
    :func:`update_ratios`; prints the worst tensor of each comparison and,
    for the tensors where the card and the CPU lie furthest apart, each
    one's distance from the witness. Then the ResNet stem BatchNorm's bias
    gradient, a sum over (B, H, W) of its output gradient (``caps``): how
    far its terms cancel (sum |terms| / |sum| a channel), and for each f32
    run its terms' largest relative error and the sum's error, in 1e-4 of
    the sum's largest entry (the check's unit)."""
    (l_gpu, i_gpu, f_gpu), (l_cpu, i_cpu, f_cpu) = card, cpu
    t0 = time.perf_counter()
    replay, exact = ReluReplay(record.masks), {}
    _, l_64, _, f_64 = selfsup_step(config, "cpu", tokenizer, batch, eps, replay, witness=True,
                                    capture=exact)
    pair = update_ratios((i_cpu, i_gpu), f_cpu, f_gpu, 1)
    to_card = update_ratios((i_cpu, i_gpu), f_64, f_gpu, 1)
    to_cpu = update_ratios((i_cpu, i_cpu), f_64, f_cpu, 1)
    worst = sorted(pair, key=pair.get, reverse=True)[:3]
    card_worst, cpu_worst = max(to_card, key=to_card.get), max(to_cpu, key=to_cpu.get)
    print(f"selfsup parity {label} f64 witness on the CPU ({time.perf_counter() - t0:.1f} s): "
          f"loss {l_64:.10f} (card {abs(l_gpu - l_64) / abs(l_64):.2e}, CPU f32 "
          f"{abs(l_cpu - l_64) / abs(l_64):.2e} relative off it); |diff| / tol against the "
          f"witness, worst tensor: card {to_card[card_worst]:.3g} ({card_worst}), CPU f32 "
          f"{to_cpu[cpu_worst]:.3g} ({cpu_worst}); where card and CPU differ most: "
          + "; ".join(f"{k} card-CPU {pair[k]:.3g}, card-f64 {to_card[k]:.3g}, CPU-f64 "
                      f"{to_cpu[k]:.3g}" for k in worst))
    terms, total = exact["terms"], exact["sum"]
    kappa = terms.abs().sum((0, 2, 3)) / total.abs()
    unit = 1e-4 * total.abs().max()
    runs = "; ".join(
        f"{name}: terms {((c['terms'] - terms).abs().max() / terms.abs().max()).item():.2e} "
        f"relative, sum {((c['sum'] - total).abs().max() / unit).item():.3g}"
        for name, c in caps.items())
    print(f"selfsup parity {label} stem BatchNorm bias gradient: sums of "
          f"{terms.numel() // terms.shape[1]} terms a channel, sum |terms| / |sum| median "
          f"{kappa.median().item():.3g}, 90th percentile {kappa.quantile(0.9).item():.3g}; "
          f"against the witness, {runs}")
    return {f"{label} ReLU branches of the f64 witness within rounding of 0":
            replay.calls == len(replay.masks) and replay.worst <= 1e-5}


HF_RRG_CONFIG = os.path.join(ROOT, "config", "RRG", "baseline-mimic-HF.yml")
HF_RRS_CONFIG = os.path.join(ROOT, "config", "RRS", "baseline-mimic-HF.yml")
MULTI_TRAIN, MULTI_VALIDATE = 256, 32  # 4 steps at batch 64, 8 validator batches of 4


def rrg_hf_overrides(data: str, ckpt: str, name: str, device: str):
    """The dotlist that points ``config/RRG/baseline-mimic-HF.yml`` at a
    synthetic corpus; BLEU and ROUGEL stand in for ``bertscore``, which is
    not ported."""
    return [HF_RRG_CONFIG, f"ckpt_dir={ckpt}", f"name={name}", f"device={device}",
            f"seed={SEED}", f"dataset.image.root={data}", f"dataset.seq.root={data}",
            "trainor.epochs=0", "trainor.early_stop_metric=BLEU",
            "validator.metrics=[BLEU,ROUGEL]"]


def multi_image_corpus(src: str, dst: str, n_train: int, n_validate: int):
    """Lines of one, two and three of ``src``'s JPEGs in turn (at
    ``multi_image`` 2 a third of the samples are padded and a third
    truncated), with ``src``'s reports, in the files the HF config names."""
    os.makedirs(dst, exist_ok=True)
    for split, n in (("train", n_train), ("validate", n_validate)):
        with open(os.path.join(src, f"{split}.image.tok")) as f:
            paths = f.read().split("\n")
        with open(os.path.join(src, f"{split}.impression.tok")) as f:
            reports = f.read().split("\n")
        lines = [",".join(paths[(i + j) % len(paths)] for j in range(i % 3 + 1))
                 for i in range(n)]
        with open(os.path.join(dst, f"{split}.image.tok"), "w") as f:
            f.write("\n".join(lines))
        with open(os.path.join(dst, f"{split}.impression.tok"), "w") as f:
            f.write("\n".join(reports[:n]))


def rrg_hf_run(overrides, label: str, card: str):
    """The train CLI over ``overrides`` in bf16, timed: prints the run's
    rates, the Validator's and a host / device-busy split; returns the
    trainor, the launches, the Validator's decode steps and the steps'
    recorder."""
    import torch

    from vilmedic_torch.bin.train import main

    set_tf32(False)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with StepRecorder() as steps, DecodeSteps() as val_steps:
        trainor = main(overrides)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    model, evaluator, cfg = trainor.model, trainor.evaluator, trainor.config
    vit, dec = model.module.enc.model, model.dec_config
    image = trainor.dl.dataset.image
    batch = int(cfg.batch_size)
    n_images = batch * max(image.multi_image, 1)
    n_steps = len(steps.iterations)
    iter_ms = statistics.median(steps.iterations[1:]) * 1e3
    step_ms = statistics.median(steps.times[1:]) * 1e3
    print(f"{label}: ViT pre_ln={vit.pre_ln} {vit.config.hidden_act}, "
          f"{vit.config.num_hidden_layers} layers of {vit.config.hidden_size} at {image.crop}² "
          f"({vit.pos_embed.shape[1]} tokens), multi_image {image.multi_image}, "
          f"{dec.num_hidden_layers}-layer decoder of {dec.hidden_size}, vocab {dec.vocab_size} "
          f"(special ids {dec.bos_token_id}/{dec.eos_token_id}/{dec.pad_token_id} from the "
          f"tokenizer), {dec.dtype}, {cfg.optimizer} lr {trainor.base_lr:g}, batch {batch}, "
          f"{n_steps} steps, run {run_s:.1f} s; losses {[round(x, 4) for x in steps.losses]}")
    print(f"{label} bf16 batch {batch} ({n_images} images; {card}): {iter_ms:.1f} ms per "
          f"training step (whole iteration; median of steps 2-{n_steps}: "
          f"{[round(t * 1e3, 1) for t in steps.iterations]}), {n_images / iter_ms * 1e3:.1f} "
          f"images/s; the model step alone {step_ms:.1f} ms; peak {peak:.2f} GiB")
    val_dl = evaluator.splits[0][1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluator.start()
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    n_val = len(val_dl.dataset)
    print(f"{label}: Validator {n_val / val_s:.2f} reports/s bf16 ({card}; batch "
          f"{val_dl.batch_size}, beam {evaluator.config.beam_width}: {val_s:.2f} s for {n_val} "
          f"reports); scores {evaluator.scores[0]}; launches K1 {launches[K1]}, K2 "
          f"{launches[K2]}, K3 {launches[K3]} over {val_steps.steps} decode steps")
    train_split(trainor, label, card)
    return dict(trainor=trainor, launches=launches, val_steps=val_steps.steps, steps=steps)


def rrg_hf_checks(run, tokens: int):
    trainor, launches = run["trainor"], run["launches"]
    model, steps = trainor.model, run["steps"]
    vit, dec = model.module.enc.model, model.dec_config
    scores = trainor.evaluator.scores[0]
    return {
        "RRG_HF built from the config": type(model).__name__ == "RRG_HF",
        "DeiT-shaped post-LN ViT-B/16, gelu": not vit.pre_ln and vit.config.hidden_act == "gelu"
        and vit.config.num_hidden_layers == 12 and vit.pos_embed.shape[1] == tokens,
        "2-layer 768 decoder, no projection": dec.num_hidden_layers == 2
        and dec.hidden_size == 768 and model.module.enc.visual_projection is None,
        "the tokenizer's special ids": (dec.bos_token_id, dec.eos_token_id, dec.pad_token_id)
        == (trainor.dl.dataset.tokenizer.cls_token_id, trainor.dl.dataset.tokenizer.sep_token_id,
            trainor.dl.dataset.tokenizer.pad_token_id),
        f"{len(steps.losses)} finite losses": len(steps.losses) >= 2
        and all(map(math.isfinite, steps.losses)),
        "the ViT trains": any(n.startswith("enc.model.layer_11.") for n in trainor.tx.names),
        "finite BLEU / ROUGEL": all(scores.get(k) is not None and math.isfinite(scores[k])
                                    for k in ("BLEU", "ROUGEL")),
        "K1 (a) = 2 x decode steps": launches[K1] == 2 * run["val_steps"] > 0,
        "K2 = decode steps": launches[K2] == run["val_steps"],
        "no K3 (host float images)": launches[K3] == 0,
    }


def top_device_kernels(fn, n: int = 6):
    """The ``n`` device kernels (by name, shortened) that take the most of
    ``fn``'s device time under ``torch.profiler``: [(name, ms, calls)], and
    the summed device ms of all of them."""
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in profiled(fn)[1]:
        by_name[e.name[:60]][0] += (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name[:60]][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return [(k, ms, calls) for k, (ms, calls) in top], sum(v[0] for v in by_name.values())


def phase_rrg_hf_train(tmp: str, card: str):
    """``config/RRG/baseline-mimic-HF.yml`` (RRG_HF) through the train CLI
    on the ``rrg_train`` corpus, bf16: a DeiT-shaped post-LN ViT-B/16 at
    224² (197 tokens, trained), a 2-layer 768 decoder whose vocabulary and
    special ids come from the corpus tokenizer, RAdam 5e-5,
    ReduceLROnPlateau, batch 128 (4 steps, host float images); the
    Validator at batch 4, beam 8 (K1 stage a in both layers, K2) with BLEU
    and ROUGEL."""
    import torch

    data = os.path.join(tmp, "rrg_data")
    run = rrg_hf_run(rrg_hf_overrides(data, tmp, "rrg_hf_train", "cuda"), "rrg_hf_train", card)
    require({**rrg_hf_checks(run, 197),
             "4 steps": run["trainor"].training_scheduler.iteration_count == 4}, "rrg_hf_train")
    launches = run["launches"]
    del run
    torch.cuda.empty_cache()
    return {K1: launches[K1], K2: launches[K2], K3: launches[K3]}


def phase_rrg_multi_image(tmp: str, card: str):
    """The same model with ``dataset.image.multi_image=2`` over lines of
    one, two and three of the ``rrg_train`` corpus's JPEGs: training at
    batch 64 (the tower sees 128 images a step; 4 steps), the Validator at
    beam 8; then serving at beam 8, batch 16, over the 394-token masked
    memory (the padded images' 197 tokens masked): launches and reports/s."""
    import torch

    from vilmedic_torch.models.base import get_special_token_ids
    from vilmedic_torch.models.evaluation_nlg import make_generate_fn

    data = os.path.join(tmp, "rrg_multi_data")
    multi_image_corpus(os.path.join(tmp, "rrg_data"), data, MULTI_TRAIN, MULTI_VALIDATE)
    run = rrg_hf_run(rrg_hf_overrides(data, tmp, "rrg_multi_image", "cuda") + [
        "dataset.image.multi_image=2", "trainor.batch_size=64"], "rrg_multi_image", card)
    trainor = run["trainor"]
    model = trainor.model
    ds = trainor.evaluator.splits[0][1].dataset
    batch = trainor._model_batch(ds.get_collate_fn()([ds[i] for i in range(16)]))
    inputs = model.encoder_inputs(batch)
    with torch.inference_mode():
        memory, memory_mask = model.module.encode(**inputs)
    mask = batch["images_mask"]
    padded = memory_mask.view(16, 2, 197)[~mask]
    tokenizer = ds.tokenizer
    bos, eos, pad = get_special_token_ids(model.dec_config, tokenizer)
    max_len = int(ds.tokenizer_max_len)
    generate = make_generate_fn([model], BEAM, max_len, bos, eos, pad, length_penalty=1.0)
    generate(inputs)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    res = generate(inputs)
    torch.cuda.synchronize()
    served = read_launches()
    times, steps_seen = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        r = generate(inputs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        steps_seen.append(r.steps)
    med = statistics.median(times)
    print(f"rrg_multi_image serving bf16 batch 16, beam {BEAM} ({card}): images "
          f"{tuple(batch['images'].shape)}, {int((~mask).sum())} padded images, memory "
          f"{tuple(memory.shape)}; {16 / med:.2f} reports/s (median of 3: {med * 1e3:.1f} ms, "
          f"steps {steps_seen}); launches K1 {served[K1]}, K2 {served[K2]} over {res.steps} "
          "steps")
    layers = model.dec_config.num_hidden_layers
    require({
        **rrg_hf_checks(run, 197),
        "4 steps at batch 64": trainor.training_scheduler.iteration_count == 4,
        "images (B, 2, 3, 224, 224)": tuple(batch["images"].shape) == (16, 2, 3, 224, 224),
        "some images padded": bool((~mask).any()) and bool(mask[:, 0].all()),
        "a 394-token memory": tuple(memory.shape) == (16, 394, 768),
        "the padded images' tokens masked": padded.numel() > 0 and not bool(padded.any()),
        "the real images' tokens kept": bool(memory_mask.view(16, 2, 197)[mask].all()),
        "serving: K1 (a) = layers x steps": served[K1] == layers * res.steps > 0,
        "serving: K2 = steps": served[K2] == res.steps,
        "finite scores": bool(torch.isfinite(res.scores).all()),
    }, "rrg_multi_image")
    launches = run["launches"]
    del run, trainor, model, generate, memory
    torch.cuda.empty_cache()
    return {K1: launches[K1], K2: launches[K2], K3: launches[K3]}


def rrs_hf_overrides(data: str, ckpt: str, name: str, device: str, folder: str):
    """``config/RRS/baseline-mimic-HF.yml`` with both blocks' pretrained name
    pointed at ``folder`` and the data at the ``rrs_train`` phase's files
    (no HF dataset; the config's RoBERTa tokenizer on both sides); the
    Validator's metrics and the early-stop metric as written."""
    return [HF_RRS_CONFIG, f"ckpt_dir={ckpt}", f"name={name}", f"device={device}",
            f"seed={SEED}", f"model.encoder={folder}", f"model.decoder={folder}",
            f"dataset.src.root={data}", f"dataset.tgt.root={data}",
            "dataset.src.file=findings.tok", "dataset.tgt.file=impression.tok",
            "dataset.src.hf_dataset=null", "dataset.tgt.hf_dataset=null", "trainor.epochs=0"]


def phase_rrs_hf_train(tmp: str, card: str):
    """``config/RRS/baseline-mimic-HF.yml`` (RRS_HF) through the train CLI,
    bf16 by override (the config names no dtype, so it builds f32 in both
    packages): encoder and decoder from a roberta-base ``config.json`` (12 + 12
    layers of 768, the LM-head transform), source 128, target 80, batch 128
    over the ``rrs_train`` phase's 256 pairs (2 RAdam steps), the Validator
    at batch 4, beam 2 (K1 stage a at beam 2 in each of the 12 layers, K2
    over the target vocabulary). Then holds K1 (a) and K2 at this path's
    shapes against their plain versions."""
    import torch

    from vilmedic_torch.bin.train import main

    set_tf32(False)
    folder = roberta_config_dir(tmp)
    data = os.path.join(tmp, "rrs_data")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with StepRecorder() as steps, DecodeSteps() as val_steps, weights_dir(scorer_weights(tmp)):
        trainor = main(rrs_hf_overrides(data, tmp, "rrs_hf_train", "cuda", folder)
                       + ["model.dtype=bfloat16"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    model, evaluator, cfg = trainor.model, trainor.evaluator, trainor.config
    dec, enc = model.dec_config, model.enc_config
    batch = int(cfg.batch_size)
    src_len = int(cfg.dataset.src.tokenizer_max_len)
    tgt_len = int(cfg.dataset.tgt.tokenizer_max_len)
    iter_ms = statistics.median(steps.iterations[1:]) * 1e3
    step_ms = statistics.median(steps.times[1:]) * 1e3
    scores = evaluator.scores[0]
    val_dl = evaluator.splits[0][1]
    print(f"rrs_hf_train: RRS_HF from a roberta-base config.json, {enc.num_hidden_layers} + "
          f"{dec.num_hidden_layers} layers of {dec.hidden_size} ({dec.num_attention_heads} "
          f"heads of {dec.head_dim}), LM-head transform {dec.lm_head_transform}, vocab "
          f"{enc.vocab_size} -> {dec.vocab_size}, {dec.dtype}, {cfg.optimizer} lr "
          f"{trainor.base_lr:g}, batch {batch}, source {src_len}, target {tgt_len}, "
          f"{len(steps.losses)} steps, run {run_s:.1f} s; losses "
          f"{[round(x, 4) for x in steps.losses]}")
    print(f"rrs_hf_train bf16 batch {batch} ({card}): {iter_ms:.1f} ms per training step "
          f"(whole iteration; steps {[round(t * 1e3, 1) for t in steps.iterations]}), "
          f"{batch * (src_len + tgt_len) / iter_ms * 1e3:.0f} padded tokens/s (source + "
          f"target); the model step alone {step_ms:.1f} ms; peak {peak:.2f} GiB")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with weights_dir(scorer_weights(tmp)):
        evaluator.start()
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    n_val = len(val_dl.dataset)
    print(f"rrs_hf_train: Validator {n_val / val_s:.2f} reports/s bf16 ({card}; batch "
          f"{val_dl.batch_size}, beam {evaluator.config.beam_width}: {val_s:.2f} s for {n_val} "
          f"reports); scores {scores}; launches K1 {launches[K1]}, K2 {launches[K2]} over "
          f"{val_steps.steps} decode steps")
    # where a step's device time goes: forward / backward / RAdam, and the
    # kernels that take most of one more step
    one = trainor._model_batch(next(iter(trainor.dl)))
    trainor.zero_grads()
    out, f_host, f_dev = device_ms(lambda: model.apply_train(one, trainor.generator))
    _, b_host, b_dev = device_ms(lambda: out["loss"].backward())
    _, o_host, o_dev = device_ms(lambda: trainor.apply_step(trainor.base_lr,
                                                            out["loss"].detach()))
    print(f"rrs_hf_train split (torch.profiler, one more step, {card}): forward host "
          f"{f_host:.1f} / device busy {f_dev['all']:.1f} ms, backward {b_host:.1f} / "
          f"{b_dev['all']:.1f} ms, RAdam {o_host:.1f} / {o_dev['all']:.1f} ms")
    lr = trainor.training_scheduler.current_lr()
    top, total = top_device_kernels(lambda: trainor.train_step(one, lr))
    print(f"rrs_hf_train top device kernels of one more step ({total:.1f} device ms): "
          + "; ".join(f"{name} {ms:.1f} ms x {calls}" for name, ms, calls in top))
    beam = int(evaluator.config.beam_width)
    require({
        "RRS_HF built from the config": type(model).__name__ == "RRS_HF",
        "12 + 12 layers of 768 with the transform, bf16": enc.num_hidden_layers
        == dec.num_hidden_layers == 12 and dec.hidden_size == 768 and dec.lm_head_transform
        and dec.dtype == torch.bfloat16,
        "beam 2": beam == 2,
        "finite losses": len(steps.losses) == 2 and all(map(math.isfinite, steps.losses)),
        "the config's metrics, every one a number": sorted(scores) == sorted(
            ["validation_loss", "ROUGEL", "BLEU", "bertscore", "radgraph_simple",
             "radgraph_partial", "radgraph_complete"] + [
                f"chexbert-{k}_{a} avg_f1-score" for k in ("5", "all") for a in ("micro", "macro")])
        and all(v is not None and math.isfinite(v) for v in scores.values()),
        "target vocab takes the blocked head": dec.vocab_size >= 4096,
        "K1 (a) = 12 x decode steps": launches[K1] == 12 * val_steps.steps > 0,
        "K2 = decode steps": launches[K2] == val_steps.steps,
    }, "rrs_hf_train")
    n = val_dl.batch_size * beam
    gen = torch.Generator().manual_seed(SEED + 60)
    hold_beam_cache_attention(torch.bfloat16, n, gen, t=tgt_len, heads=dec.num_attention_heads,
                              d=dec.head_dim, rows=beam, label=" (rrs_hf_train, beam 2)")
    w32, b = lm_head_weights(dec.vocab_size, gen, dec.hidden_size)
    h = torch.randn(n, dec.hidden_size, generator=gen)
    hold_blocked_lm_head(h.to("cuda", torch.bfloat16), w32.to("cuda", torch.bfloat16), b.cuda(),
                         label=" (rrs_hf_train)")
    print(f"rrs_hf_train: K1 (a) bf16 at N {n} (beam 2), T {tgt_len}, and K2 bf16 at N {n}, Vp "
          f"{w32.shape[0]}, agree with their plain versions")
    del trainor, model, evaluator
    torch.cuda.empty_cache()
    return {K1: launches[K1], K2: launches[K2]}


def rrg_hf_parity(tmp: str):
    """RRG_HF f32, TF32 off, through the train CLI on the CPU and on the
    card: the ViT cut to 2 layers, ``multi_image`` 2, batch 2 (one sample's
    second image padded), dropout 0, one RAdam step, no evaluation: the
    loss within 1e-5 relative, each tensor's change as ``update_agreement``
    holds it; then, with the CPU's trained weights on both, equal beam-8
    sequences over the validate lines."""
    import torch

    from vilmedic_torch.bin.train import main
    from vilmedic_torch.models.base import get_special_token_ids
    from vilmedic_torch.models.evaluation_nlg import make_generate_fn

    base = os.path.join(tmp, "hf_parity_base")
    data = os.path.join(tmp, "hf_parity_data")
    synthetic_corpus(base, 2, 2, SEED + 4, 256)
    multi_image_corpus(base, data, 2, 2)
    runs = {}
    for device in PARITY_DEVICES:
        with StepRecorder() as steps:
            trainor = main(rrg_hf_overrides(data, tmp, f"hf_parity_{device}", device) + [
                "dataset.image.multi_image=2", "model.dtype=float32",
                "model.vision.proto_config_args.num_hidden_layers=2",
                "model.decoder.proto_config_args.hidden_dropout_prob=0.0",
                "model.decoder.proto_config_args.attention_probs_dropout_prob=0.0",
                "trainor.batch_size=2", "trainor.eval_start=99", "dataset.num_workers=0"])
        runs[device] = dict(trainor=trainor, losses=steps.losses, initial=steps.initial,
                            final=cpu_state(trainor.model))
    cpu, gpu = runs["cpu"], runs["cuda"]
    loss_rel = abs(gpu["losses"][0] - cpu["losses"][0]) / abs(cpu["losses"][0])
    same_start = all(torch.equal(gpu["initial"][k], cpu["initial"][k]) for k in cpu["initial"])
    ratio, worst = update_agreement((cpu["initial"], gpu["initial"]), cpu["final"],
                                    gpu["final"], 1)
    cpu_losses, gpu_losses = cpu["losses"], gpu["losses"]
    seqs = {}
    for device, run in runs.items():
        model = run["trainor"].model
        model.module.load_state_dict(cpu["final"])
        vds = run["trainor"].evaluator.splits[0][1].dataset
        batch = run["trainor"]._model_batch(vds.get_collate_fn()([vds[i] for i in range(2)]))
        ids = get_special_token_ids(model.dec_config, vds.tokenizer)
        res = make_generate_fn([model], BEAM, int(vds.tokenizer_max_len), *ids)(
            model.encoder_inputs(batch))
        seqs[device] = (res.sequences.cpu(), batch["images_mask"].cpu())
    same = torch.equal(seqs["cpu"][0], seqs["cuda"][0])
    print(f"hf parity RRG_HF f32 batch 2, multi_image 2 (masks {seqs['cpu'][1].tolist()}; ViT-B "
          f"2 layers): loss {gpu['losses']} card vs {cpu['losses']} CPU (relative diff "
          f"{loss_rel:.2e}); initial weights {'equal' if same_start else 'DIFFER'}; parameter "
          f"changes: worst |diff| / tol {ratio:.3g} ({worst}); beam-8 sequences "
          f"{'equal' if same else 'DIFFER'}")
    del runs, cpu, gpu
    return {"RRG_HF one step each": len(cpu_losses) == len(gpu_losses) == 1,
            "RRG_HF a padded image in the batch": not bool(seqs["cpu"][1].all()),
            "RRG_HF loss within 1e-5 relative": loss_rel <= 1e-5,
            "RRG_HF the same initial weights": same_start,
            "RRG_HF each tensor's change within tolerance": ratio <= 1.0,
            "RRG_HF equal beam sequences": same}


def rrs_hf_parity(tmp: str):
    """RRS_HF f32 from a roberta-base ``config.json`` cut to 2 + 2 layers,
    random weights from the seed on the CPU and on the card, vocab 50265:
    equal beam-2 sequences over 2 sources of 128 (one padded)."""
    import torch

    from vilmedic_torch import registry
    from vilmedic_torch.config import load_config
    from vilmedic_torch.models import hf_compat  # noqa: F401  (registers RRS_HF)
    from vilmedic_torch.models.base import get_special_token_ids
    from vilmedic_torch.models.evaluation_nlg import make_generate_fn

    folder = os.path.join(tmp, "roberta-base-2")
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "config.json"), "w") as f:
        json.dump(dict(ROBERTA_BASE, num_hidden_layers=2), f)
    cfg, _ = load_config(HF_RRS_CONFIG, [f"model.encoder={folder}", f"model.decoder={folder}",
                                         "model.dtype=float32"])
    gen = torch.Generator().manual_seed(SEED + 8)
    ids = torch.randint(5, 50265, (2, 128), generator=gen)
    mask = torch.ones_like(ids)
    mask[1, 90:] = 0
    ids[1, 90:] = 1
    out = {}
    for device in PARITY_DEVICES:
        model = registry.build("model", cfg.model, device=device, seed=SEED)
        special = get_special_token_ids(model.dec_config)
        res = make_generate_fn([model], 2, 80, *special)(model.encoder_inputs(
            {"input_ids": ids.to(device), "attention_mask": mask.to(device)}))
        out[device] = (res.sequences.cpu(), res.scores.float().cpu(), res.steps)
        layers = (model.enc_config.num_hidden_layers, model.dec_config.num_hidden_layers)
        del model
    same = torch.equal(out["cpu"][0], out["cuda"][0])
    print(f"hf parity RRS_HF f32 ({layers[0]} + {layers[1]} layers of 768, vocab 50265, beam 2): "
          f"sequences {'equal' if same else 'DIFFER'} ({out['cuda'][2]} vs {out['cpu'][2]} "
          f"steps), max |score diff| {(out['cuda'][1] - out['cpu'][1]).abs().max().item():.3e}")
    return {"RRS_HF 2 + 2 layers": layers == (2, 2), "RRS_HF equal beam-2 sequences": same}


def tower_volume_parity():
    """f32, TF32 off: ``3d_densenet121`` (avgpool) on (2, 1, 32, 32, 32)
    volumes and ``slice_encode`` of a 2-D densenet121 over 4 slices along D,
    the same weights on the CPU and the card: features within 1e-4 of the
    largest, equal masks."""
    import torch

    from vilmedic_torch.blocks.vision.visual_encoder import build_visual_encoder
    from vilmedic_torch.models.base import init_weights_

    checks = {}
    gen = torch.Generator().manual_seed(SEED + 9)
    for name, block, shape in (
            ("3d_densenet121", dict(backbone="3d_densenet121", output_layer="avgpool"),
             (2, 1, 32, 32, 32)),
            ("slice_encode", dict(backbone="densenet121", output_layer="avgpool",
                                  slice_encode=True, slice_dim=1), (2, 1, 4, 32, 32))):
        enc = build_visual_encoder(block, in_channels=1).eval()
        init_weights_(enc, torch.Generator().manual_seed(SEED), 0.02, lambda n: False)
        x = torch.randn(*shape, generator=gen)
        with torch.no_grad():
            want, want_mask = enc.encode(x)
            got, got_mask = enc.to("cuda").encode(x.to("cuda"))
        err = (got.cpu() - want).abs().max().item() / want.abs().max().item()
        print(f"hf parity {name} f32 {tuple(x.shape)} -> {tuple(got.shape)}: max |diff| / max "
              f"{err:.2e} (tol 1e-4), masks {'equal' if torch.equal(got_mask.cpu(), want_mask) else 'DIFFER'}")
        checks[f"{name} within 1e-4"] = err <= 1e-4
        checks[f"{name} equal masks"] = torch.equal(got_mask.cpu(), want_mask)
    return checks


def phase_hf_parity(tmp: str):
    import torch

    set_tf32(False)
    t0 = time.perf_counter()
    checks = {**rrg_hf_parity(tmp), **rrs_hf_parity(tmp), **tower_volume_parity()}
    print(f"hf parity: {time.perf_counter() - t0:.1f} s")
    require(checks, "hf_parity")
    torch.cuda.empty_cache()


# ------------------------------------------------- the VL config's entry points

VL_TRAIN, VL_VALIDATE = 128, 32  # 8 microbatches of 16 (2 updates at grad_accu 4)
VL_UNFROZEN_TRAIN = 64  # 4 microbatches of 16
# BERTScore's encoder: distilbert-base-uncased's shape (random weights)
DISTILBERT_BASE = dict(model_type="distilbert", vocab_size=30522, dim=768, n_layers=6,
                       n_heads=12, hidden_dim=3072, max_position_embeddings=512,
                       activation="gelu")
K4, K4L, K5Q, K5KV = ("flash_attention", "flash_attention_with_lse", "flash_attention_bwd_dq",
                      "flash_attention_bwd_dkv")
K1B = "fused_beam_cache_attention.launches_stats"


def vl_config_dirs(tmp: str):
    """The VL corpus (``synthetic_corpus`` at 518², the train reports
    sweeping its 5000 words, so the built vocabulary takes the blocked
    head), its 64-report cut, the DINOv2-B/14 ``config.json`` that
    ``vision_model_name`` names (no weights: the tower keeps its random
    init, with the JAX package's warning) and a DistilBERT-base-shaped
    BERTScore directory (``config.json``, ``vocab.txt`` of the special
    tokens, the corpus words and fillers, ``pytorch_model.bin`` of random
    weights from SEED). Made once; returns (data, 64-report data, 4-report
    data, tower, bert)."""
    data, small, tiny = (os.path.join(tmp, f"vl_data{s}") for s in ("", "_small", "_tiny"))
    tower, bert = os.path.join(tmp, "dinov2-base"), os.path.join(tmp, "bertscore-distilbert")
    if os.path.isdir(bert):
        return data, small, tiny, tower, bert
    synthetic_corpus(data, VL_TRAIN, VL_VALIDATE, SEED + 21, 518, sweep=True)
    for folder, n_train in ((small, VL_UNFROZEN_TRAIN), (tiny, 4)):
        os.makedirs(folder)
        for split, n in (("train", n_train), ("validate", 4)):
            for name in ("image", "impression"):
                with open(os.path.join(data, f"{split}.{name}.tok")) as f:
                    lines = f.read().split("\n")[:n]
                with open(os.path.join(folder, f"{split}.{name}.tok"), "w") as f:
                    f.write("\n".join(lines))
    os.makedirs(tower)
    with open(os.path.join(tower, "config.json"), "w") as f:
        json.dump(VL_TOWER, f)
    with open(os.path.join(data, "train.impression.tok")) as f:
        write_distilbert_dir(bert, sorted(set(f.read().split())))
    return data, small, tiny, tower, bert


def vl_cli_overrides(data: str, tower: str, ckpt: str, name: str, device: str, extra=()):
    """The dotlist that points ``config/VL/vl-dinov2-modernbert.yml`` at the
    synthetic corpus (the config's ModernBERT tokenizer, from the temp hub
    cache) and the DINOv2 directory; one epoch (the loop runs ``epochs +
    1``); the ensemble CLI on the validate split. ModernBERT's special
    tokens are added tokens past its 50,280-entry model vocabulary, so the
    decoder takes ``vocab_size`` = the tokenizer's length, 50,368 (the JAX
    VisionLanguage sizes it by ``vocab_size`` and reads NaN there; the port
    raises without the override)."""
    return [VL_CONFIG, f"ckpt_dir={ckpt}", f"name={name}", f"device={device}", f"seed={SEED}",
            f"dataset.image.root={data}", f"dataset.seq.root={data}",
            f"model.vocab_size={VL_VOCAB}", f"model.vision.vision_model_name={tower}",
            "trainor.epochs=0", "ensemblor.splits=[validate]", *extra]


@contextlib.contextmanager
def bertscore_model(folder: str):
    """``BERTSCORE_MODEL`` set to ``folder`` (no baseline: raw scores)."""
    old = os.environ.get("BERTSCORE_MODEL")
    os.environ["BERTSCORE_MODEL"] = folder
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("BERTSCORE_MODEL")
        else:
            os.environ["BERTSCORE_MODEL"] = old


def read_run_text(run_dir: str, split: str):
    """(refs, hyps) a Validator dumped."""
    out = []
    for kind in ("refs", "hyps"):
        with open(os.path.join(run_dir, f"{split}_{SEED}_{kind}.txt")) as f:
            out.append(f.read().split("\n"))
    return out


def timed_eval(models, config, dl):
    """(seconds, hyps) of one ``vl_evaluation`` pass over ``dl``."""
    import torch

    from vilmedic_torch.models.vision_language import vl_evaluation

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = vl_evaluation(models, config, dl)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out["hyps"]


def hold_k1_stats_beam2(card: str):
    """K1 (b) at the Validator's shape: 16 items x beam 2 (N 32), T 100,
    12 heads of 64, bf16, against its plain version."""
    import torch

    from vilmedic_torch.ops.beam_cache_attention import (
        fused_beam_cache_attention, fused_beam_cache_attention_reference,
    )

    gen = torch.Generator().manual_seed(SEED + 22)
    t, heads, d, rows, n = T_MAX, 12, 64, 2, 32
    kc, vc = (torch.randn(t, n, heads * d, generator=gen).to("cuda", torch.bfloat16)
              for _ in range(2))
    q, kn, vn = (torch.randn(n, heads, d, generator=gen).to("cuda", torch.bfloat16)
                 for _ in range(3))
    mask = random_ancestry_mask(n // rows, rows, t, gen, "cuda")
    worst = 0.0
    for index in (0, 1, 57, 99):
        kc1, vc1, kc2, vc2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        out, m, _ = fused_beam_cache_attention(kc1, vc1, q, kn, vn, mask, index,
                                               return_stats=True)
        ref, rm, _ = fused_beam_cache_attention_reference(kc2, vc2, q, kn, vn, mask, index,
                                                          return_stats=True)
        torch.cuda.synchronize()
        worst = max(worst, (out - ref).abs().max().item(), (m - rm).abs().max().item())
        if not (torch.equal(kc1, kc2) and torch.equal(vc1, vc2)):
            fail(f"K1 (b) beam 2 cache write, index {index}")
    def calls():
        for _ in range(50):
            fused_beam_cache_attention(kc, vc, q, kn, vn, mask, 99, return_stats=True)

    ms = cuda_ms(calls) / 50
    print(f"K1 (b) bf16 beam 2 N={n} T={t} 12x64 (the VL Validator's shape; {card}): max|err| "
          f"{worst:.3e} (tol 2e-02), {ms:.4f} ms per call (CUDA events over 50 back-to-back "
          f"calls: the host's launch cost included)")
    if worst > 2e-2:
        fail("K1 (b) at beam 2")
    return worst


def phase_vl_cli_train(tmp: str, card: str):
    """``config/VL/vl-dinov2-modernbert.yml`` through the train CLI at full
    width, bf16: DINOv2-B/14 at 518² (frozen, 1370 tokens), the 12-layer 768
    prefix LM, AdamW, grad_accu 4, batch 16 over 128 reports (8
    microbatches, 2 updates) of host float images; the Validator at beam 2
    over 32 reports with ROUGEL, BLEU and bertscore (the DistilBERT-base
    directory, on the card); then the ensemble CLI at beam 8 on the saved
    checkpoint. K4 (tower, prefill), K4 with LSE and K5 (LM training), K1
    (b) (decode) counted."""
    import torch

    from vilmedic_torch.bin import ensemble
    from vilmedic_torch.bin.train import main
    from vilmedic_torch.scorers import bertscore_impl
    from vilmedic_torch.scorers.clinical import BertScore

    set_tf32(False)
    data, _, _, tower, bert = vl_config_dirs(tmp)
    overrides = vl_cli_overrides(data, tower, tmp, "vl_cli_train", "cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with bertscore_model(bert), StepRecorder("grad_step") as steps, \
            DecodeSteps("vision_language") as val_steps:
        t0 = time.perf_counter()
        trainor = main(overrides)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    model, evaluator = trainor.model, trainor.evaluator
    module, dec, tok = model.module, model.dec_config, trainor.dl.dataset.tokenizer
    tower_cfg = module.vision.model.config
    n_micro = len(steps.times)
    updates = trainor.training_scheduler.iteration_count
    micro_ms = statistics.median(steps.iterations[1:]) * 1e3
    step_ms = statistics.median(steps.times[1:]) * 1e3
    # the second update: its 4 microbatches, the first update's AdamW apply
    # and the loader waits among them
    update_ms = sum(steps.iterations[trainor.grad_accu:2 * trainor.grad_accu]) * 1e3
    tokens = 16 * (module.num_image_tokens + T_MAX)
    print(f"vl_cli_train: DINOv2 {tower_cfg.num_hidden_layers} layers of "
          f"{tower_cfg.hidden_size} at 518² (frozen {model.frozen_prefixes}), "
          f"{dec.num_hidden_layers}-layer LM of {dec.hidden_size}, vocab {dec.vocab_size} "
          f"(special ids {dec.bos_token_id}/{dec.eos_token_id}/{dec.pad_token_id} from the "
          f"tokenizer), {dec.dtype}, {trainor.config.optimizer} lr {trainor.base_lr:g}, "
          f"grad_accu {trainor.grad_accu}; {n_micro} microbatches, {updates} updates, run "
          f"{run_s:.1f} s; losses {[round(x, 4) for x in steps.losses]}")
    print(f"vl_cli_train bf16 batch 16 ({card}): {micro_ms:.1f} ms per microbatch (whole "
          f"iteration, loader wait included; median of 2-{n_micro}: "
          f"{[round(t * 1e3, 1) for t in steps.iterations]}), the model step alone "
          f"{step_ms:.1f} ms, {update_ms:.1f} ms per update (the second's microbatches and "
          f"the first's apply), "
          f"{16 / micro_ms * 1e3:.1f} images/s, {tokens / micro_ms * 1e3:.0f} tokens/s; peak "
          f"{peak:.2f} GiB")
    scores = evaluator.scores[0]
    refs, hyps = read_run_text(os.path.join(tmp, "vl_cli_train"), "validate")
    val_dl = evaluator.splits[0][1]
    def bert_call_ms():
        """One BertScore call as the Validator makes it, in ms."""
        with bertscore_model(bert):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            BertScore(device="cuda")(refs, hyps)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

    bertscore_impl._load_scorer.cache_clear()
    bert_cold_ms = bert_call_ms()  # the encoder's load included, as the first call
    bert_ms = bert_call_ms()  # the encoder kept, as every later call
    val_s, _ = timed_eval([model], evaluator.config, val_dl)
    print(f"vl_cli_train: Validator beam {evaluator.config.beam_width} batch "
          f"{val_dl.batch_size}: scores {scores}; {len(refs) / val_s:.2f} reports/s "
          f"(vl_evaluation alone, bf16, {card}); {val_steps.steps} decode steps; BERTScore "
          f"of {len(refs)} pairs on the card {bert_ms:.1f} ms a call with the encoder kept "
          f"({bert_cold_ms:.1f} ms the first, with its load)")
    ckpts = glob.glob(os.path.join(tmp, "vl_cli_train", "*.ckpt"))
    layers, tower_layers = dec.num_hidden_layers, tower_cfg.num_hidden_layers
    val_batches = -(-VL_VALIDATE // val_dl.batch_size)
    checks = {
        "VisionLanguage from the config, CLS dropped": type(model).__name__ == "VisionLanguage"
        and module.drop_cls_token and module.num_image_tokens == VL_TOKENS,
        "DINOv2-B/14 from vision_model_name": tower_cfg.hidden_size == 768
        and tower_layers == 12 and module.vision.model.pos_embed.shape[1] == VL_TOKENS,
        "the ModernBERT tokenizer's length (blocked head) and ids": dec.vocab_size == len(tok)
        == VL_VOCAB and tok.vocab_size == MODERNBERT_MODEL_VOCAB
        and (dec.bos_token_id, dec.eos_token_id, dec.pad_token_id)
        == (tok.cls_token_id, tok.sep_token_id, tok.pad_token_id) == (VL_BOS, VL_EOS, VL_PAD),
        "8 microbatches, 2 updates": n_micro == VL_TRAIN // 16 and updates == 2,
        "finite losses": all(map(math.isfinite, steps.losses)),
        "finite ROUGEL / BLEU / bertscore": all(scores.get(k) is not None
                                                and math.isfinite(scores[k])
                                                for k in ("ROUGEL", "BLEU", "bertscore")),
        "a best checkpoint": len(ckpts) == 1,
        "K4 with LSE = K5 dq = K5 dk/dv = LM layers per microbatch":
        launches[K4L] == launches[K5Q] == launches[K5KV] == layers * n_micro,
        "K4 = tower per microbatch + (tower + prefill) per Validator batch":
        launches[K4] == tower_layers * n_micro + (tower_layers + layers) * val_batches,
        "K1 (b) at beam 2 = LM layers per decode step": launches[K1B] == launches[K1]
        == layers * val_steps.steps > 0,
    }
    require(checks, "vl_cli_train")
    k1_beam2 = hold_k1_stats_beam2(card)
    del trainor, model, module, evaluator
    torch.cuda.empty_cache()

    reset_launches()
    with bertscore_model(bert), DecodeSteps("vision_language") as ens_steps:
        t0 = time.perf_counter()
        validator = ensemble.main(overrides)
        torch.cuda.synchronize()
        ens_run_s = time.perf_counter() - t0
    ens_launches = read_launches()
    ens_dl = validator.splits[0][1]
    ens_s, _ = timed_eval(validator.models, validator.config, ens_dl)
    ens_scores = validator.scores[0]
    print(f"vl_cli_train ensemble CLI (mode {validator.config.mode}, "
          f"{len(validator.models)} checkpoint, beam {validator.config.beam_width}, batch "
          f"{ens_dl.batch_size}): scores {ens_scores}; run {ens_run_s:.1f} s (build, load, "
          f"decode, score); {VL_VALIDATE / ens_s:.2f} reports/s (vl_evaluation alone, bf16, "
          f"{card}); K1 (b) {ens_launches[K1B]} over {ens_steps.steps} decode steps")
    require({
        "beam 8, one checkpoint": validator.config.beam_width == 8
        and len(validator.models) == 1,
        "finite ROUGEL / BLEU / bertscore": all(ens_scores.get(k) is not None
                                                and math.isfinite(ens_scores[k])
                                                for k in ("ROUGEL", "BLEU", "bertscore")),
        "K1 (b) at beam 8 = LM layers per decode step": ens_launches[K1B] == layers
        * ens_steps.steps > 0,
    }, "vl_cli_train ensemble")
    del validator
    bertscore_impl._load_scorer.cache_clear()
    torch.cuda.empty_cache()
    return ({name: launches[name] + ens_launches[name] for name in launches}, k1_beam2,
            (launches[K1B], ens_launches[K1B]))


def phase_vl_unfrozen_train(tmp: str, card: str):
    """The VL config with ``model.vision.freeze=false`` through the train
    CLI (4 microbatches of 16 at grad_accu 2, so that the second update runs
    past the warmup's lr 0; no Validator), without and with the LM's
    ``gradient_checkpointing``: peak memory and ms per microbatch. The JAX
    module stops the gradient at the tower whatever ``freeze`` says, so the
    tower joins the optimizer and only AdamW's decay can move it (lr 5e-5 x
    decay 1e-4 rounds away in f32 almost everywhere), and K5 runs only in
    the LM. Then the DINOv2-B/14 tower trained where the JAX package
    trains it, as an RRG ``cnn`` (``config/RRG/baseline-mimic.yml`` with
    ``model.cnn.backbone=dinov2``, unfrozen, 518², batch 16, 4 RAdam steps):
    K4 with LSE and K5 non-causal at T 1370 in every tower layer."""
    import torch

    from vilmedic_torch.bin.train import main

    set_tf32(False)
    _, small, _, tower, _ = vl_config_dirs(tmp)
    runs = {}
    for remat in (False, True):
        name = f"vl_unfrozen_{'remat' if remat else 'plain'}"
        overrides = vl_cli_overrides(small, tower, tmp, name, "cuda", [
            "model.vision.freeze=false", f"model.decoder.gradient_checkpointing={remat}",
            "trainor.grad_accu=2", "trainor.eval_start=2",
            "trainor.early_stop_metric=training_loss"])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with StepRecorder("grad_step") as steps:
            trainor = main(overrides)
            torch.cuda.synchronize()
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        module = trainor.model.module
        initial, final = steps.initial, cpu_state(trainor.model)
        tower_names = [k for k in final if k.startswith("vision.") and "running" not in k]
        moved = sum(not torch.equal(initial[k], final[k]) for k in tower_names)
        finite = all(torch.isfinite(final[k]).all() for k in tower_names)
        in_opt = sum(n.startswith("vision.") for n in trainor.tx.names)
        # AdamW's decoupled decay, at most lr x wd x |p| an update, plus a rounding
        wd = trainor.tx.optimizer.param_groups[0]["weight_decay"]
        decay_only = all((final[k] - initial[k]).abs().max().item()
                         <= (2 * trainor.base_lr * wd + 2 * 2**-24)
                         * initial[k].abs().max().item() for k in tower_names)
        lm_names = [k for k in trainor.tx.names if not k.startswith("vision.")]
        lm_moved = sum(not torch.equal(initial[k], final[k]) for k in lm_names)
        micro_ms = statistics.median(steps.iterations[1:]) * 1e3
        step_ms = statistics.median(steps.times[1:]) * 1e3
        runs[remat] = dict(peak=peak, losses=steps.losses, launches=launches)
        layers = trainor.model.dec_config.num_hidden_layers
        n_micro = len(steps.times)
        print(f"{name} bf16 batch 16 ({card}): gradient_checkpointing {remat}; {n_micro} "
              f"microbatches, {micro_ms:.1f} ms per microbatch (whole iteration, median of "
              f"2-{n_micro}), model step {step_ms:.1f} ms; peak {peak:.2f} GiB; tower: "
              f"{in_opt} tensors in the optimizer, {moved} of {len(tower_names)} moved (by "
              f"the decay alone: {decay_only}), finite {finite}; {lm_moved} of "
              f"{len(lm_names)} LM tensors moved; K5 dk/dv {launches[K5KV]} (LM {layers} x "
              f"{n_micro}); losses {[round(x, 4) for x in steps.losses]}")
        require({
            "the tower in the optimizer": trainor.model.frozen_prefixes == () and in_opt
            == len([n for n, _ in module.named_parameters() if n.startswith("vision.")]),
            "the tower finite, changed by AdamW's decay at most": decay_only and finite,
            "every LM tensor moved": lm_moved == len(lm_names),
            "finite losses": all(map(math.isfinite, steps.losses)),
            "K5 only in the LM (the prefix stops the tower's gradient)":
            launches[K5KV] == launches[K5Q] == layers * n_micro,
            "remat recomputes the LM forward": launches[K4L] == (2 if remat else 1) * layers
            * n_micro,
        }, name)
        del trainor, module, initial, final
    print(f"vl_unfrozen_train: peak {runs[False]['peak']:.2f} GiB without and "
          f"{runs[True]['peak']:.2f} GiB with gradient_checkpointing ({card})")
    require({"checkpointing keeps the losses (same dropout masks)": all(
        abs(a - b) <= 1e-2 * abs(a) for a, b in zip(runs[False]["losses"], runs[True]["losses"]))},
        "vl_unfrozen_train")

    # the tower trained, as an RRG cnn
    overrides = rrg_dinov2_overrides(small, tmp, "rrg_dinov2_unfrozen", "cuda",
                                     ["trainor.batch_size=16"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with StepRecorder() as steps:
        trainor = main(overrides)
        torch.cuda.synchronize()
    rrg_launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    enc = trainor.model.module.enc
    initial, final = steps.initial, cpu_state(trainor.model)
    tower_names = [k for k in final if k.startswith("enc.model.")]
    moved = sum(not torch.equal(initial[k], final[k]) for k in tower_names)
    finite = all(torch.isfinite(final[k]).all() for k in tower_names)
    n_steps, tower_layers = len(steps.times), enc.model.config.num_hidden_layers
    step_ms = statistics.median(steps.times[1:]) * 1e3
    print(f"rrg_dinov2_unfrozen bf16 batch 16 ({card}): DINOv2 {tower_layers} layers of "
          f"{enc.model.config.hidden_size} at 518² ({enc.model.pos_embed.shape[1]} tokens) "
          f"trained under a {trainor.model.dec_config.num_hidden_layers}-layer decoder; "
          f"{n_steps} steps, {step_ms:.1f} ms per step (median of 2-{n_steps}), "
          f"{16 / step_ms * 1e3:.1f} images/s, peak {peak:.2f} GiB; {moved} of "
          f"{len(tower_names)} tower tensors moved, finite {finite}; K4 with LSE "
          f"{rrg_launches[K4L]}, K5 dq {rrg_launches[K5Q]}, K5 dk/dv {rrg_launches[K5KV]} "
          f"(non-causal, T 1370); losses {[round(x, 4) for x in steps.losses]}")
    require({
        "finite losses": all(map(math.isfinite, steps.losses)),
        "every tower tensor moved and is finite": moved == len(tower_names) and finite,
        "K4 with LSE = K5 dq = K5 dk/dv = tower layers per step":
        rrg_launches[K4L] == rrg_launches[K5Q] == rrg_launches[K5KV] == tower_layers * n_steps,
    }, "rrg_dinov2_unfrozen")
    del trainor, enc, initial, final
    torch.cuda.empty_cache()
    return {name: runs[False]["launches"][name] + runs[True]["launches"][name]
            + rrg_launches[name] for name in rrg_launches}, rrg_launches


def rrg_dinov2_overrides(data: str, ckpt: str, name: str, device: str, extra=()):
    """The flagship RRG config with an unfrozen DINOv2-B/14 ``cnn`` at 518²
    (the JAX package trains the tower there), on ``data``; one epoch, no
    Validator."""
    return [CONFIG, f"ckpt_dir={ckpt}", f"name={name}", f"device={device}", f"seed={SEED}",
            f"dataset.image.root={data}", f"dataset.seq.root={data}", "dataset.image.resize=518",
            "dataset.image.crop=518", "trainor.epochs=0", "trainor.eval_start=2",
            "trainor.early_stop_metric=training_loss", "validator.metrics=[BLEU]",
            "model.cnn.backbone=dinov2", "model.cnn.freeze=false", *extra]


def hold_tower_flash_backward(card: str):
    """K4 with LSE and K5 at the unfrozen tower's shape (B 16, T 1370, 12
    heads of 64, non-causal, no key mask, bf16) against their plain versions
    (``flash_grads_match``: out, lse, then dq / dk / dv / dbias); times the
    whole backward beside the plain one and SDPA's."""
    import torch

    from vilmedic_torch.ops.flash_attention import (
        flash_attention_backward, flash_attention_backward_reference,
    )

    gen = torch.Generator("cuda").manual_seed(SEED + 23)
    q, k, v = (torch.randn(16, VL_TOKENS, 12, 64, generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    out, lse, dout, errs = flash_grads_match(
        q, k, v, None, False, f"tower shape B=16 T={VL_TOKENS} H=12 D=64 non-causal", gen)
    ms = cuda_ms(lambda: flash_attention_backward(q, k, v, None, out, lse, dout, False))
    plain = cuda_ms(lambda: flash_attention_backward_reference(q, k, v, None, out, lse, dout,
                                                               False), reps=3)
    # q, k, v, out, dO read, dq, dk, dv written; the f32 LSE read
    bd = flash_bound(q, k, False, tensors=8, extra_bytes=lse.numel() * 4, products=5)
    qs, ks, vs, ds = sdpa_layout(q, k, v, dout)
    for x in (qs, ks, vs):
        x.requires_grad_()
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)
    library = cuda_ms(lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), ds,
                                                  retain_graph=True))
    print(f"K5 bf16 tower shape B 16 T {VL_TOKENS} 12x64 non-causal ({card}): whole backward "
          f"{ms:.3f} ms, plain {plain:.3f} ms, bound {bd['bound_ms']:.4f} ms "
          f"({bd['bound_by']}), SDPA backward by autograd {library:.3f} ms (CUDA events)")
    return max(errs["dq"], errs["dk"], errs["dv"])


def phase_vl_cli_parity(tmp: str):
    """f32 (TF32 off), card vs CPU, the VL config through the train CLI at
    tower 2 + LM 2 layers (full width, 518²), dropout 0, the tower unfrozen
    (it joins the optimizer; the prefix stops its gradient, as in the JAX
    module), batch 2 over 4 reports (2 AdamW steps at lr 1e-2 and eps 1:
    Adam's eps 1e-8 turns a key bias's rounding-noise gradient into a full
    step of either sign), the vl_cli_train run's vocabulary (blocked head),
    the Validator at beam 2 over 4 reports: equal losses (1e-5 relative),
    every tensor's update (1e-4 of its largest change), equal hyps at beam 2
    and at beam 8 (``vl_evaluation``), BERTScore P / R / F (1e-5). Then the
    tower trained by its gradient: the RRG config's unfrozen DINOv2 ``cnn``
    (2 layers of 768 at 518², T 1370: K4 with LSE and K5 non-causal in f32
    on the card), 2 RAdam steps of batch 2, dropout 0, card vs CPU: losses
    (1e-5 relative) and every tensor's update, the tower's included
    (:func:`update_agreement`). Then gradient checkpointing with dropout on
    against off on the card, equal gradients."""
    import shutil

    import torch

    from vilmedic_torch.bin.train import main
    from vilmedic_torch.config.config import Config
    from vilmedic_torch.models.vision_language import vl_evaluation
    from vilmedic_torch.scorers.bertscore_impl import bert_score_prf

    set_tf32(False)
    _, _, tiny, tower, bert = vl_config_dirs(tmp)
    runs = {}
    for device in PARITY_DEVICES:
        name = f"vl_parity_{device}"
        os.makedirs(os.path.join(tmp, name), exist_ok=True)
        for vocab in glob.glob(os.path.join(tmp, "vl_cli_train", "vocab.*")):
            shutil.copy(vocab, os.path.join(tmp, name))
        overrides = vl_cli_overrides(tiny, tower, tmp, name, device, [
            "model.dtype=float32", "model.vision.freeze=false",
            "model.vision.num_hidden_layers=2", "model.decoder.num_hidden_layers=2",
            "model.decoder.hidden_dropout_prob=0.0", "trainor.batch_size=2",
            "trainor.grad_accu=1", "trainor.optim_params.lr=0.01", "trainor.optim_params.eps=1",
            "validator.batch_size=2", "validator.metrics=[ROUGEL,BLEU]",
            "dataset.num_workers=0"])
        with StepRecorder() as steps:
            trainor = main(overrides)
        refs, hyps = read_run_text(os.path.join(tmp, name), "validate")
        dl = trainor.evaluator.splits[0][1]
        beam8 = vl_evaluation([trainor.model], Config({"beam_width": 8}), dl)["hyps"]
        prf = bert_score_prf(bert, refs, hyps, rescale_with_baseline=False, device=device)
        runs[device] = dict(losses=steps.losses, initial=steps.initial,
                            final=cpu_state(trainor.model), hyps=hyps, beam8=beam8, prf=prf,
                            vocab=trainor.model.dec_config.vocab_size)
        del trainor
    cpu, gpu = runs["cpu"], runs["cuda"]
    n_steps = len(gpu["losses"])
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(cpu["losses"], gpu["losses"]))
    ratio, worst = update_agreement((cpu["initial"], gpu["initial"]), cpu["final"],
                                    gpu["final"], n_steps)
    prf_err = max(abs(a - b) for x, y in zip(cpu["prf"], gpu["prf"]) for a, b in zip(x, y))
    print(f"vl_cli_parity f32 (vocab {gpu['vocab']}, {n_steps} steps): loss rel err "
          f"{loss_rel:.2e} (tol 1e-5), worst update {ratio:.3f} of its tolerance ({worst}); "
          f"beam 2 hyps equal {cpu['hyps'] == gpu['hyps']}, beam 8 equal "
          f"{cpu['beam8'] == gpu['beam8']}; BERTScore P/R/F max err {prf_err:.2e} (tol 1e-5)")
    checks = {
        "the blocked head's vocabulary": gpu["vocab"] >= 4096,
        "losses within 1e-5": n_steps == 2 and loss_rel <= 1e-5,
        "every update within 1e-4 of its largest change": ratio <= 1.0,
        "equal hyps at beam 2": cpu["hyps"] == gpu["hyps"] and any(cpu["hyps"]),
        "equal hyps at beam 8": cpu["beam8"] == gpu["beam8"],
        "BERTScore P / R / F within 1e-5": prf_err <= 1e-5,
    }

    # the unfrozen DINOv2 trained by its gradient, as an RRG cnn
    towers = {}
    for device in PARITY_DEVICES:
        t0 = time.perf_counter()
        with StepRecorder() as steps:
            trainor = main(rrg_dinov2_overrides(tiny, tmp, f"rrg_dinov2_parity_{device}", device, [
                "model.dtype=float32", "model.cnn.num_hidden_layers=2", "trainor.batch_size=2",
                "model.decoder.hidden_dropout_prob=0.0", "dataset.num_workers=0"]))
        towers[device] = dict(losses=steps.losses, initial=steps.initial,
                              final=cpu_state(trainor.model), s=time.perf_counter() - t0,
                              layers=trainor.model.module.enc.model.config.num_hidden_layers)
        del trainor
    cpu, gpu = towers["cpu"], towers["cuda"]
    tower_rel = max(abs(a - b) / abs(a) for a, b in zip(cpu["losses"], gpu["losses"]))
    tower_ratio, tower_worst = update_agreement((cpu["initial"], gpu["initial"]), cpu["final"],
                                                gpu["final"], len(gpu["losses"]))
    tower_names = [k for k in cpu["final"] if k.startswith("enc.model.")]
    moved = sum(not torch.equal(cpu["initial"][k], cpu["final"][k]) for k in tower_names)
    print(f"vl_cli_parity unfrozen DINOv2 as an RRG cnn f32 ({gpu['layers']} layers of 768 at "
          f"518², {len(gpu['losses'])} steps, CPU run {cpu['s']:.1f} s): loss rel err "
          f"{tower_rel:.2e} (tol 1e-5), worst update {tower_ratio:.3f} of its tolerance "
          f"({tower_worst}); {moved} of {len(tower_names)} tower tensors moved")
    checks.update({
        "unfrozen DINOv2: losses within 1e-5": len(gpu["losses"]) == 2 and tower_rel <= 1e-5,
        "unfrozen DINOv2: every update within 1e-4 of its largest change": tower_ratio <= 1.0,
        "unfrozen DINOv2: every tower tensor moved": moved == len(tower_names),
    })

    # gradient checkpointing with dropout on (the LM's 0.1), on the card
    from vilmedic_torch import registry
    from vilmedic_torch.config import load_config

    cfg, _ = load_config(VL_CONFIG, ["model.dtype=float32", "model.vision.num_hidden_layers=2",
                                     "model.decoder.num_hidden_layers=2"])
    batch = vl_train_batches(1, 2, 518, SEED + 24)[0]
    grads = []
    for remat in (False, True):
        block = cfg.model.to_dict()
        block["decoder"]["gradient_checkpointing"] = remat
        model = registry.build("model", Config(block), vision_hf_config=VL_TOWER,
                               vocab_size=VL_VOCAB, bos_token_id=VL_BOS, eos_token_id=VL_EOS,
                               pad_token_id=VL_PAD, device="cuda")
        gen = torch.Generator("cuda").manual_seed(SEED)
        model.apply_train(to_device(batch, "cuda"), gen)["loss"].backward()
        grads.append({n: p.grad.cpu() for n, p in model.module.named_parameters()
                      if p.grad is not None})
        del model
    worst = max(((grads[1][n] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item()
                for n, g in grads[0].items() if not n.endswith("k.bias"))
    print(f"vl_cli_parity gradient checkpointing (dropout "
          f"{cfg.model.decoder.hidden_dropout_prob}, f32, card): {len(grads[0])} gradients, "
          f"worst relative difference {worst:.2e} (tol 1e-5)")
    checks["gradient checkpointing keeps the gradients"] = (
        sorted(grads[0]) == sorted(grads[1]) and worst <= 1e-5)
    require(checks, "vl_cli_parity")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- clinical scorers

BERT_BASE = dict(model_type="bert", vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072, max_position_embeddings=512,
                 type_vocab_size=2, hidden_act="gelu", layer_norm_eps=1e-12)
RADGRAPH_LABELS = ["O", "ANAT-DP", "OBS-DP", "OBS-U", "OBS-DA"]
CLINICAL_METRICS = ["chexbert", "radgraph", "radentitymatchexact", "radentitynli",
                    "stanford_ct_abd_accuracy"]
CLINICAL_SCST_TRAIN = 64  # 2 SCST iterations at the config's batch 32


def seeded_scorer_weights(module, gen, body_std: float = 0.05, head_std: float = 0.5):
    """Random weights from ``gen``: the encoder's matrices and embeddings
    N(0, body_std), the heads' N(0, head_std) (labels far from ties),
    LayerNorms 1, biases 0."""
    import torch

    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif "LayerNorm" in name:
                p.fill_(1.0)
            else:
                p.normal_(0.0, body_std if name.startswith("bert.") else head_std, generator=gen)
    return module


def write_distilbert_dir(folder: str, words):
    """A DistilBERT-base-shaped BERTScore directory: ``config.json``,
    ``vocab.txt`` (the special tokens, ``words``, fillers) and
    ``pytorch_model.bin`` of random weights from SEED."""
    import torch

    from vilmedic_torch.scorers.bert_encoder import BertEncoder

    os.makedirs(folder)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *words]
    vocab += [f"[unused{i}]" for i in range(DISTILBERT_BASE["vocab_size"] - len(vocab))]
    with open(os.path.join(folder, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab))
    with open(os.path.join(folder, "config.json"), "w") as f:
        json.dump(DISTILBERT_BASE, f)
    torch.manual_seed(SEED)
    torch.save(BertEncoder(DISTILBERT_BASE).state_dict(),
               os.path.join(folder, "pytorch_model.bin"))


def scorer_weights(tmp: str) -> str:
    """The clinical scorers' files at their published shapes, random weights
    from the seed, in the layout of ``VILMEDIC_WEIGHTS_DIR`` (made once):
    ``chexbert/chexbert.pth`` (BERT-base, 12 x 768, 512 positions, 14 heads,
    ``module.``-prefixed inside ``model_state_dict``, as shipped) and a
    30,522-entry WordPiece ``vocab.txt`` of bert-base-uncased's special
    tokens, the ``rrg_train`` corpus words and fillers; ``radnli/`` (BERTNLI:
    BERT-base, its pooler, a 3-way ``linear``); ``radner/`` (a BERT-base
    ``BertForTokenClassification`` directory with RadGraph's labels);
    ``bertscore/model/`` (DistilBERT-base). Reads the ``rrg_train`` corpus."""
    import torch

    from vilmedic_torch.scorers.chexbert import CheXbertModule
    from vilmedic_torch.scorers.nli import BertPairClassifier
    from vilmedic_torch.scorers.ner import TokenClassifier

    root = os.path.join(tmp, "scorer_weights")
    if os.path.isdir(root):
        return root
    t0 = time.perf_counter()
    words = set()
    for split in ("train", "validate"):
        with open(os.path.join(tmp, "rrg_data", f"{split}.impression.tok")) as f:
            words.update(f.read().split())
    words = sorted(words)
    special = ["[PAD]", *(f"[unused{i}]" for i in range(99)), "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab = special + words
    vocab += [f"filler{i}" for i in range(BERT_BASE["vocab_size"] - len(vocab))]
    for sub in ("chexbert", "radnli", "radner"):
        os.makedirs(os.path.join(root, sub))
        with open(os.path.join(root, sub, "vocab.txt"), "w") as f:
            f.write("\n".join(vocab))
    gen = torch.Generator().manual_seed(SEED + 70)
    chexbert = seeded_scorer_weights(CheXbertModule(BERT_BASE), gen)
    torch.save({"model_state_dict": {f"module.{k}": v for k, v in chexbert.state_dict().items()},
                "epoch": 0}, os.path.join(root, "chexbert", "chexbert.pth"))
    nli = seeded_scorer_weights(BertPairClassifier(BERT_BASE), gen)
    torch.save(nli.state_dict(), os.path.join(root, "radnli", "model_medrad_19k.pth"))
    ner = seeded_scorer_weights(TokenClassifier(BERT_BASE, len(RADGRAPH_LABELS)), gen)
    torch.save(ner.state_dict(), os.path.join(root, "radner", "pytorch_model.bin"))
    with open(os.path.join(root, "radner", "config.json"), "w") as f:
        json.dump(dict(BERT_BASE, architectures=["BertForTokenClassification"],
                       id2label={str(i): x for i, x in enumerate(RADGRAPH_LABELS)},
                       label2id={x: i for i, x in enumerate(RADGRAPH_LABELS)}), f)
    with open(os.path.join(root, "radner", "tokenizer_config.json"), "w") as f:
        json.dump({"do_lower_case": True, "model_max_length": 512}, f)
    write_distilbert_dir(os.path.join(root, "bertscore", "model"), words)
    print(f"scorer files (CheXbert, BERTNLI, RadNER at BERT-base, DistilBERT-base) written in "
          f"{time.perf_counter() - t0:.1f} s")
    return root


@contextlib.contextmanager
def weights_dir(folder: str):
    """``VILMEDIC_WEIGHTS_DIR`` set to ``folder`` (no BERTScore baseline:
    raw scores)."""
    old = os.environ.get("VILMEDIC_WEIGHTS_DIR")
    os.environ["VILMEDIC_WEIGHTS_DIR"] = folder
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("VILMEDIC_WEIGHTS_DIR")
        else:
            os.environ["VILMEDIC_WEIGHTS_DIR"] = old


def clear_scorer_caches():
    """Forget every loaded scorer network (the next call reads its files)."""
    from vilmedic_torch.scorers import bertscore_impl, chexbert, ner, nli

    for fn in (chexbert._load_labeler, chexbert.vocab_tokenizer, ner._load_radner,
               nli._load_nli, bertscore_impl._load_scorer):
        fn.cache_clear()


def scorer_networks(device):
    """The loaded scorer networks on ``device``: CheXbert, RadNER, BERTNLI,
    the BERTScore encoder."""
    from vilmedic_torch.scorers import bertscore_impl
    from vilmedic_torch.scorers.chexbert import CheXbert
    from vilmedic_torch.scorers.nli import NLIPredictor
    from vilmedic_torch.scorers.ner import RadNER
    from vilmedic_torch.scorers.weights import resolve

    return {"CheXbert": CheXbert(device=device).module, "RadNER": RadNER(device=device).module,
            "BERTNLI": NLIPredictor(device=device).module,
            "BERTScore": bertscore_impl.load_scorer(resolve("BERTSCORE_MODEL"), device)[1]}


class ValidatorClock:
    """Wraps ``Validator.start`` for a run: the seconds of each call on the
    host clock, ended by a synchronize."""

    def __enter__(self):
        import torch

        from vilmedic_torch.executors.validator import Validator

        self.seconds, self.real = [], Validator.start
        clock = self

        def timed(validator):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = clock.real(validator)
            torch.cuda.synchronize()
            clock.seconds.append(time.perf_counter() - t0)
            return out

        Validator.start = timed
        return self

    def __exit__(self, *exc):
        from vilmedic_torch.executors.validator import Validator

        Validator.start = self.real


def scorer_ms(metrics, refs, hyps, device, rounds: int = 1):
    """Per metric: ms of its ``compute_scores`` with the networks loaded
    from their files (cold) and the median of ``rounds`` calls after
    (warm)."""
    import torch

    from vilmedic_torch.scorers.scores import compute_scores

    out = {}
    for metric in metrics:
        times = []
        clear_scorer_caches()
        for _ in range(rounds + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            compute_scores([metric], refs, hyps, "validate", SEED, {}, 0,
                           logging.getLogger("clinical"), dump=False, device=device)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[metric] = (times[0], statistics.median(times[1:]))
    return out


def clinical_parity(refs, hyps, pairs: int):
    """f32 (TF32 off) card vs CPU on the reports (refs and hyps together):
    CheXbert logits (1e-4 abs + rel) and labels (equal), RadNER entities
    and BERTNLI labels (equal); every clinical ``compute_scores`` value over
    the first ``pairs`` pairs (1e-6; the CPU's RadEntityNLI scores every
    sentence pair)."""
    import torch

    from vilmedic_torch.scorers.chexbert import CheXbert
    from vilmedic_torch.scorers.nli import NLIPredictor
    from vilmedic_torch.scorers.ner import RadNER, split_sentences
    from vilmedic_torch.scorers.scores import compute_scores

    texts = refs + hyps
    sides = {d: CheXbert(device=d) for d in PARITY_DEVICES}
    rows = [sides["cpu"].tokenizer.encode_truncated(t.strip(), max_length=512) for t in texts]
    width = max(len(r) for r in rows)
    ids = torch.zeros((len(rows), width), dtype=torch.long)
    mask = torch.zeros_like(ids)
    for i, r in enumerate(rows):
        ids[i, :len(r)], mask[i, :len(r)] = torch.tensor(r), 1
    with torch.no_grad():
        logits = {d: [x.cpu() for x in m.module(ids.to(d), mask.to(d))] for d, m in sides.items()}
    logit_err = max(((a - b).abs() / (1 + a.abs())).max().item()
                    for a, b in zip(logits["cpu"], logits["cuda"]))
    labels = {d: m.predict_classes(texts) for d, m in sides.items()}
    entities = {d: RadNER(device=d).extract(texts) for d in PARITY_DEVICES}
    sentences = [s for t in texts for s in split_sentences(t.lower())]
    nli_pairs = list(zip(sentences, sentences[::-1]))[:64]
    nli = {d: NLIPredictor(device=d).predict([p[0] for p in nli_pairs],
                                             [p[1] for p in nli_pairs]) for d in PARITY_DEVICES}
    scores, secs = {}, {}
    for d in PARITY_DEVICES:
        t0 = time.perf_counter()
        scores[d] = compute_scores(CLINICAL_METRICS, refs[:pairs], hyps[:pairs], "validate", SEED,
                                   {}, 0, logging.getLogger("clinical"), dump=False, device=d)
        secs[d] = time.perf_counter() - t0
    score_err = max(abs(scores["cuda"][k] - v) for k, v in scores["cpu"].items())
    n_entities = sum(len(s["entities"]) for doc in entities["cpu"] for s in doc)
    print(f"clinical_validate parity f32 card vs CPU on {len(refs)} + {len(hyps)} reports: "
          f"CheXbert logits max |diff| / (1 + |logit|) {logit_err:.2e} (tol 1e-4; logits up to "
          f"{max(x.abs().max().item() for x in logits['cpu']):.1f}), labels "
          f"{'equal' if (labels['cpu'] == labels['cuda']).all() else 'DIFFER'} "
          f"({len({tuple(r) for r in labels['cpu']})} distinct rows); RadNER "
          f"{n_entities} entities {'equal' if entities['cpu'] == entities['cuda'] else 'DIFFER'}; "
          f"BERTNLI {len(nli_pairs)} pairs {'equal' if nli['cpu'] == nli['cuda'] else 'DIFFER'} "
          f"({collections.Counter(nli['cpu'])}); compute_scores over {pairs} pairs max |diff| "
          f"{score_err:.2e} (tol 1e-6; CPU {secs['cpu']:.1f} s, card {secs['cuda']:.1f} s): "
          f"{scores['cuda']}")
    return {
        "CheXbert logits card = CPU": logit_err <= 1e-4,
        "CheXbert labels card = CPU": bool((labels["cpu"] == labels["cuda"]).all()),
        "RadNER entities card = CPU": entities["cpu"] == entities["cuda"] and n_entities > 0,
        "BERTNLI labels card = CPU": nli["cpu"] == nli["cuda"],
        "clinical scores card = CPU": all(v is not None for v in scores["cpu"].values())
        and sorted(scores["cpu"]) == sorted(scores["cuda"]) and score_err <= 1e-6,
    }


def roberta_cli_overrides(data: str, ckpt: str, name: str, folder: str):
    """``config/RRG/biomed-roberta-baseline-mimic.yml`` as ``rrg_roberta_serve``
    sets it up (its decoder's pretrained name pointed at a roberta-base
    ``config.json``; the config's RoBERTa tokenizer from the temp hub cache),
    on a corpus through ``device_preproc``, one epoch; the Validator's
    metrics and the early-stop metric as written."""
    return [ROBERTA_CONFIG, f"ckpt_dir={ckpt}", f"name={name}", "device=cuda", f"seed={SEED}",
            f"model.decoder.proto={folder}",
            f"dataset.image.root={data}", f"dataset.seq.root={data}",
            "dataset.image.device_preproc=true", "trainor.epochs=0"]


def clinical_scst_reward(tmp: str, card: str):
    """``config/RRG/rrg-scst-mimic.yml`` through the train CLI with
    ``scores: [rougel, chexbert]`` (weights 0.5 / 0.5) from the ``rrg_train``
    checkpoint: 2 iterations at batch 32 over 64 reports, the Validator over
    4; then one batch of rollouts rewarded with [rougel, chexbert] and with
    rougel alone, alternated. Returns the SCST run's checks."""
    import shutil

    import numpy as np

    from vilmedic_torch.bin.train import main
    from vilmedic_torch.scorers.clinical import F1CheXbert

    data = os.path.join(tmp, "clinical_scst_data")
    os.makedirs(data)
    for split, n in (("train", CLINICAL_SCST_TRAIN), ("validate", 4)):
        for kind in ("impression", "image"):
            with open(os.path.join(tmp, "rrg_data", f"{split}.{kind}.tok")) as f:
                lines = f.read().split("\n")[:n]
            with open(os.path.join(data, f"{split}.{kind}.tok"), "w") as f:
                f.write("\n".join(lines))
    ckpt = glob.glob(os.path.join(tmp, "rrg_train", "*.ckpt"))[0]
    os.makedirs(os.path.join(tmp, "clinical_scst"))
    shutil.copy(os.path.join(tmp, "rrg_train", "vocab.tgt"), os.path.join(tmp, "clinical_scst"))
    with ScstRecorder() as rec:
        trainor = main(scst_overrides(data, tmp, "clinical_scst", "cuda", ckpt)
                       + ["model.scores=[rougel,chexbert]", "model.scores_weights=[0.5,0.5]"])
    model = trainor.model
    scst = model.scst
    one = trainor._model_batch(next(iter(trainor.dl)))
    _, sampled = model.rollouts(model.encoder_inputs(one))
    rollouts, refs = sampled.cpu().numpy(), one[model.ref_key].cpu().numpy()
    both, alone, times = scst.scorers, scst.scorers[:1], {"both": [], "rougel": []}
    scores, rewards = scst.scores, {}
    try:
        for r in range(6):
            for kind in (("both", "rougel") if r % 2 == 0 else ("rougel", "both")):
                scst.scorers = both if kind == "both" else alone
                scst.scores = scores if kind == "both" else scores[:1]
                t0 = time.perf_counter()
                rewards[kind], _, _ = scst.get_reward(rollouts, refs)
                times[kind].append((time.perf_counter() - t0) * 1e3)
    finally:
        scst.scorers, scst.scores = both, scores
    ms = {k: statistics.median(v) for k, v in times.items()}
    chexbert_reward = rewards["both"][1]
    print(f"clinical_validate SCST ({card}): {os.path.basename(SCST_CONFIG)} rewards "
          f"{scores}, weights {scst.scores_weights}, {len(rec.losses)} iterations at batch "
          f"{sampled.shape[0]}: losses {[round(x, 6) for x in rec.losses]}, per iteration "
          f"rollout / reward / gradient ms "
          f"{[{k: round(v * 1e3, 1) for k, v in s.items()} for s in rec.splits]}; one batch's "
          f"reward (decode + score, median of 6 alternated): [rougel, chexbert] {ms['both']:.1f} "
          f"ms, rougel alone {ms['rougel']:.1f} ms; chexbert rewards {np.round(chexbert_reward, 3)}")
    checks = {
        "SCST [rougel, chexbert] built": isinstance(scst.scorers[1], F1CheXbert),
        "SCST 2 finite losses": len(rec.losses) == 2 and all(map(math.isfinite, rec.losses)),
        "SCST chexbert reward per sample": chexbert_reward.shape == (sampled.shape[0],)
        and bool(np.isin(chexbert_reward, (0.0, 1.0)).all()),
        "SCST rougel reward unchanged beside chexbert":
            np.array_equal(rewards["both"][0], rewards["rougel"][0]),
    }
    del trainor, model
    return checks


def phase_clinical_validate(tmp: str, card: str):
    """The clinical scorers on the card through the normal entry points
    (module doc, item 18): the scorer files (:func:`scorer_weights`), then
    ``config/RRG/biomed-roberta-baseline-mimic.yml`` through the train CLI
    over the ``rrg_train`` corpus cut to 128 + 32 reports (one RAdam step at
    batch 128, bf16), its Validator at beam 8 with the config's eight
    metrics (every one a number; early stop on ``chexbert-5_micro
    avg_f1-score``; the scorer networks on the card; K1 (a), K2 and K3
    counted); the Validator's reports/s, each clinical scorer's ms cold and
    warm; f32 card vs CPU on 16 of the reports and their hypotheses
    (:func:`clinical_parity`); an SCST run rewarded with [rougel, chexbert]
    (:func:`clinical_scst_reward`). Returns the path's launches."""
    import torch

    from vilmedic_torch.bin.train import main

    set_tf32(False)
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    folder = scorer_weights(tmp)
    write_s = time.perf_counter() - t0
    data = os.path.join(tmp, "clinical_data")
    scst_corpus(os.path.join(tmp, "rrg_data"), data, 128)
    roberta = roberta_config_dir(tmp)
    clear_scorer_caches()
    with weights_dir(folder):
        reset_launches()
        t0 = time.perf_counter()
        with DecodeSteps() as val_steps, ValidatorClock() as val_clock:
            trainor = main(roberta_cli_overrides(data, tmp, "clinical_validate", roberta))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = read_launches()
        evaluator, cfg = trainor.evaluator, trainor.config
        scores = evaluator.scores[0]
        sched = trainor.training_scheduler
        networks = scorer_networks(evaluator.device)
        on_card = {name: {p.device.type for p in m.parameters()} == {"cuda"}
                   for name, m in networks.items()}
        run_dir = os.path.join(tmp, "clinical_validate")
        refs, hyps = read_run_text(run_dir, "validate")
        n_val = len(refs)
        val_s = val_clock.seconds[0]
        ms = scorer_ms(evaluator.metrics[4:], refs, hyps, evaluator.device)
        print(f"clinical_validate ({card}): {os.path.basename(ROBERTA_CONFIG)} through the train "
              f"CLI, {cfg.model.cnn.backbone}, {trainor.model.dec_config.num_hidden_layers}-layer "
              f"decoder of {trainor.model.dec_config.hidden_size}, vocab "
              f"{trainor.model.dec_config.vocab_size}, {trainor.model.dec_config.dtype}, batch "
              f"{cfg.batch_size}, {sched.iteration_count} step(s), run {run_s:.1f} s (scorer "
              f"files written in {write_s:.1f} s); Validator beam "
              f"{evaluator.config.beam_width}, batch {evaluator.splits[0][1].batch_size}, metrics "
              f"{evaluator.metrics}; early stop {sched.early_stop_metric} = "
              f"{sched.current_best_metric}; scores {scores}")
        print(f"clinical_validate Validator in the run ({card}): {n_val / val_s:.2f} reports/s "
              f"({val_s:.2f} s for {n_val} reports: beam decode, then the 8 metrics, the "
              f"scorers' files read on first use); "
              f"scorer networks on the card: {on_card}; per metric over {n_val} refs + hyps, "
              f"ms cold (files read) / warm: "
              + ", ".join(f"{m} {c:.1f} / {w:.1f}" for m, (c, w) in ms.items())
              + f"; launches K1 {launches[K1]}, K2 {launches[K2]}, K3 {launches[K3]} over "
              f"{val_steps.steps} decode steps")
        checks = {
            "the config's eight metrics": [str(m).lower() for m in evaluator.metrics] == [
                "rougel", "bleu", "meteor", "ciderd", "chexbert", "radentitymatchexact",
                "radentitynli", "radgraph"],
            "every metric a number": all(v is not None and math.isfinite(v)
                                         for v in scores.values()) and len(scores) == 14,
            "early stop reads chexbert-5_micro avg_f1-score":
                sched.early_stop_metric == "chexbert-5_micro avg_f1-score"
                and sched.current_best_metric == scores["chexbert-5_micro avg_f1-score"],
            "scorer networks on the card": all(on_card.values()),
            "K1 (a) = 12 x decode steps": launches[K1] == 12 * val_steps.steps > 0,
            "K2 = decode steps": launches[K2] == val_steps.steps,
            "K3 = training + Validator batches": launches[K3] == 1 + len(evaluator.splits[0][1]),
        }
        dec = trainor.model.dec_config
        checks["the RoBERTa tokenizer's vocabulary"] = (
            trainor.dl.dataset.tokenizer.vocab_size == dec.vocab_size == ROBERTA_VOCAB)
        n_rows = evaluator.splits[0][1].batch_size * evaluator.config.beam_width
        del trainor, evaluator
        torch.cuda.empty_cache()
        time_blocked_lm_head_at(n_rows, dec.vocab_size, dec.hidden_size,
                                " (clinical_validate, the Validator's rows)", card)
        checks.update(clinical_parity(refs[:16], hyps[:16], pairs=8))
        checks.update(clinical_scst_reward(tmp, card))
        set_tf32(False)
    require(checks, "clinical_validate")
    torch.cuda.empty_cache()
    print(f"clinical_validate: {time.perf_counter() - t_phase:.1f} s")
    return {K1: launches[K1], K2: launches[K2], K3: launches[K3]}


# ------------------------------------ pretrained tokenizers, RadEval and GREEN

ROBERTA_TOKENIZER = "allenai/biomed_roberta_base"
CLINICALBERT_TOKENIZER = "emilyalsentzer/Bio_ClinicalBERT"
MODERNBERT_TOKENIZER = "answerdotai/ModernBERT-base"
RADEVAL_MODEL = "IAMJB/RadEvalModernBERT"
# published sizes: RoBERTa's vocab.json, Bio_ClinicalBERT's vocab.txt,
# ModernBERT's BPE model vocabulary (its 88 special and unused tokens are
# added after it, up to the config's 50,368), Llama-2's SentencePiece BPE
ROBERTA_VOCAB, CLINICALBERT_VOCAB, MODERNBERT_MODEL_VOCAB, LLAMA_VOCAB = (
    50265, 28996, 50280, 32000)
LETTERS = "abcdefghijklmnopqrstuvwxyz"
# IAMJB/RadEvalModernBERT's config.json (ModernBERT-base's shape)
RADEVAL_MODERNBERT = dict(
    model_type="modernbert", vocab_size=50368, hidden_size=768, intermediate_size=1152,
    num_hidden_layers=22, num_attention_heads=12, hidden_activation="gelu", norm_eps=1e-5,
    norm_bias=False, attention_bias=False, mlp_bias=False, global_rope_theta=160000.0,
    local_rope_theta=10000.0, local_attention=128, global_attn_every_n_layers=3,
    max_position_embeddings=8192, pad_token_id=VL_PAD, cls_token_id=VL_BOS,
    sep_token_id=VL_EOS, bos_token_id=VL_BOS, eos_token_id=VL_EOS)
# Llama-2-7B's config.json (the GREEN judge StanfordAIMI/GREEN-radllama2-7b)
JUDGE_LEN = 2048  # the GREEN judge's default max_length
JUDGE_STEPS = 64  # decode steps timed on the 32-layer judge
LLAMA2_7B = dict(model_type="llama", vocab_size=LLAMA_VOCAB, hidden_size=4096,
                 intermediate_size=11008, num_hidden_layers=32, num_attention_heads=32,
                 num_key_value_heads=32, max_position_embeddings=4096, rms_norm_eps=1e-5,
                 rope_theta=10000.0, tie_word_embeddings=False, bos_token_id=1, eos_token_id=2,
                 torch_dtype="bfloat16")


def gpt2_byte_chars():
    """GPT-2's byte -> printable character table, in byte order."""
    keep = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    table, n = {}, 0
    for b in range(256):
        if b in keep:
            table[b] = chr(b)
        else:
            table[b] = chr(256 + n)
            n += 1
    return [table[b] for b in range(256)]


def ngram_merges(count: int, marker: str):
    """``count`` BPE merges over lowercase letters, shortest first: the word
    marker before ``.`` and each letter, then every n-gram with a letter
    appended, bare and after the marker, for n = 1, 2, ... (each merge's
    parts made by an earlier one or in the base alphabet)."""
    merges, made = [], set()

    def add(a, b):
        if len(merges) < count and a + b not in made:
            made.add(a + b)
            merges.append((a, b))

    add(marker, ".")
    for c in LETTERS:
        add(marker, c)
    grams = list(LETTERS)
    while len(merges) < count:
        longer = []
        for g in grams:
            for c in LETTERS:
                add(g, c)
                add(marker + g, c)
                longer.append(g + c)
        grams = longer
    return merges


def hub_snapshot(hub: str, name: str) -> str:
    """The snapshot directory of ``name`` in a hub cache, made with its
    ``refs/main``."""
    repo = os.path.join(hub, "models--" + name.replace("/", "--"))
    os.makedirs(os.path.join(repo, "refs"), exist_ok=True)
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write("smoke")
    folder = os.path.join(repo, "snapshots", "smoke")
    os.makedirs(folder, exist_ok=True)
    return folder


def write_json(path: str, obj):
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, ensure_ascii=False)


def modernbert_tokenizer_files(folder: str):
    """ModernBERT's layout: byte-level BPE of 50,280 entries, then [UNK]
    [CLS] [SEP] [PAD] [MASK] (``lstrip``) and 83 unused tokens added at
    50,280-50,367; ``[CLS] $A [SEP]``."""
    chars = gpt2_byte_chars()
    merges = ngram_merges(MODERNBERT_MODEL_VOCAB - 256, "Ġ")
    vocab = {c: i for i, c in enumerate(chars)}
    for a, b in merges:
        vocab[a + b] = len(vocab)
    specials = ["[UNK]", "[CLS]", "[SEP]", "[PAD]", "[MASK]"] + [f"[unused{i}]" for i in range(83)]
    added = [{"id": len(vocab) + i, "content": t, "single_word": False, "lstrip": t == "[MASK]",
              "rstrip": False, "normalized": False, "special": True}
             for i, t in enumerate(specials)]
    ids = {a["content"]: a["id"] for a in added}
    template = [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                {"Sequence": {"id": "A", "type_id": 0}},
                {"SpecialToken": {"id": "[SEP]", "type_id": 0}}]
    write_json(os.path.join(folder, "tokenizer.json"), {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": None,
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
                          "use_regex": True},
        "post_processor": {"type": "TemplateProcessing", "single": template,
                           "pair": template + [{"Sequence": {"id": "B", "type_id": 1}},
                                               {"SpecialToken": {"id": "[SEP]", "type_id": 1}}],
                           "special_tokens": {t: {"id": t, "ids": [ids[t]], "tokens": [t]}
                                              for t in ("[CLS]", "[SEP]")}},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                    "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                  "vocab": vocab, "merges": [f"{a} {b}" for a, b in merges]}})
    cfg = {"tokenizer_class": "PreTrainedTokenizerFast", "model_max_length": 8192,
           "clean_up_tokenization_spaces": True,
           "model_input_names": ["input_ids", "attention_mask"],
           "added_tokens_decoder": {str(a["id"]): {k: v for k, v in a.items() if k != "id"}
                                    for a in added}}
    for key, tok in zip(("unk", "cls", "sep", "pad", "mask"), specials):
        cfg[f"{key}_token"] = tok
    write_json(os.path.join(folder, "tokenizer_config.json"), cfg)


def llama_tokenizer_files(folder: str):
    """Llama-2's layout: ``<unk>`` ``<s>`` ``</s>``, the 256 ``<0xXX>``
    byte tokens, then BPE over ``▁``-marked words to 32,000 entries;
    ``byte_fallback``, ``fuse_unk``, the ``Prepend("▁")`` + ``Replace``
    normalizer, ``<s> $A``, left padding (no pad token)."""
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for b in range(256):
        vocab["<0x%02X>" % b] = len(vocab)
    for c in "▁." + LETTERS:
        vocab[c] = len(vocab)
    merges = ngram_merges(LLAMA_VOCAB - len(vocab), "▁")
    for a, b in merges:
        vocab[a + b] = len(vocab)
    write_json(os.path.join(folder, "tokenizer.json"), {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": c, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True}
                         for i, c in enumerate(["<unk>", "<s>", "</s>"])],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]},
        "pre_tokenizer": None,
        "post_processor": {"type": "TemplateProcessing",
                           "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                                      {"Sequence": {"id": "A", "type_id": 0}}],
                           "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                                    {"Sequence": {"id": "A", "type_id": 0}},
                                    {"SpecialToken": {"id": "<s>", "type_id": 1}},
                                    {"Sequence": {"id": "B", "type_id": 1}}],
                           "special_tokens": {"<s>": {"id": "<s>", "ids": [1],
                                                      "tokens": ["<s>"]}}},
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": [f"{a} {b}" for a, b in merges]}})
    write_json(os.path.join(folder, "tokenizer_config.json"), {
        "tokenizer_class": "LlamaTokenizer", "add_bos_token": True, "add_eos_token": False,
        "bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>", "pad_token": None,
        "model_max_length": 4096, "clean_up_tokenization_spaces": False})


def write_hub_tokenizers(tmp: str) -> str:
    """A hub cache under ``tmp`` with the configs' tokenizers at their
    published sizes, written here in plain Python (synthetic vocabularies
    and merges; the real files are not in the repository):
    ``allenai/biomed_roberta_base`` (``vocab.json`` of 50,265 + ``merges.txt``),
    ``emilyalsentzer/Bio_ClinicalBERT`` (a 28,996-entry WordPiece
    ``vocab.txt``), ``answerdotai/ModernBERT-base`` (``tokenizer.json``).
    Returns the cache's path."""
    t0 = time.perf_counter()
    hub = os.path.join(tmp, "hub")
    folder = hub_snapshot(hub, ROBERTA_TOKENIZER)
    specials = ["<s>", "<pad>", "</s>", "<unk>"]
    merges = ngram_merges(ROBERTA_VOCAB - len(specials) - 256 - 1, "Ġ")
    vocab = specials + gpt2_byte_chars() + [a + b for a, b in merges] + ["<mask>"]
    write_json(os.path.join(folder, "vocab.json"), {t: i for i, t in enumerate(vocab)})
    with open(os.path.join(folder, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")
    write_json(os.path.join(folder, "tokenizer_config.json"),
               {"tokenizer_class": "RobertaTokenizer", "model_max_length": 512})

    folder = hub_snapshot(hub, CLINICALBERT_TOKENIZER)
    vocab = ["[PAD]", *(f"[unused{i}]" for i in range(1, 100)), "[UNK]", "[CLS]", "[SEP]",
             "[MASK]", *".,;:!?()-'0123456789", *LETTERS, *(f"##{c}" for c in LETTERS)]
    grams = list(LETTERS)
    while len(vocab) < CLINICALBERT_VOCAB:
        grams = [g + c for g in grams for c in LETTERS]
        for g in grams:
            vocab += [g, f"##{g}"]
    with open(os.path.join(folder, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab[:CLINICALBERT_VOCAB]) + "\n")
    write_json(os.path.join(folder, "tokenizer_config.json"), {"tokenizer_class": "BertTokenizer"})

    modernbert_tokenizer_files(hub_snapshot(hub, MODERNBERT_TOKENIZER))
    print(f"hub tokenizers ({ROBERTA_TOKENIZER}, {CLINICALBERT_TOKENIZER}, "
          f"{MODERNBERT_TOKENIZER}) written in {time.perf_counter() - t0:.1f} s")
    return hub


SAFETENSORS_NAMES = {"torch.float32": "F32", "torch.bfloat16": "BF16", "torch.float16": "F16",
                     "torch.int64": "I64"}


def write_safetensors(path: str, tensors: dict):
    """A ``.safetensors`` file in plain Python: the 8-byte little-endian
    header length, the JSON header (dtype, shape, byte offsets), then each
    tensor's raw little-endian bytes."""
    import torch

    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": SAFETENSORS_NAMES[str(t.dtype)], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())


def green_pairs(tmp: str, n: int):
    """``n`` (reference, candidate) report pairs from the ``rrg_train``
    corpus."""
    with open(os.path.join(tmp, "rrg_data", "validate.impression.tok")) as f:
        reports = f.read().split("\n")
    return [(reports[i % len(reports)], reports[(i + 1) % len(reports)]) for i in range(n)]


def radeval_phase(tmp: str, hub: str, card: str):
    """``radevalbertscore``: a ModernBERT of RadEvalModernBERT's published
    shape (22 layers of 768, 12 heads, GeGLU 1152, a window of 128 in the
    local layers) with random weights, written with the ModernBERT-style
    tokenizer into the hub cache as ``IAMJB/RadEvalModernBERT``, scores 32
    pairs (the reports' first 64 words) in f32 on the card and on the CPU:
    the per-pair P / R / F within 1e-5; then through the port's
    ``compute_scores``."""
    import torch

    from vilmedic_torch.scorers import bertscore_impl
    from vilmedic_torch.scorers.bertscore_impl import bert_score_prf
    from vilmedic_torch.scorers.modernbert import ModernBertEncoder
    from vilmedic_torch.scorers.scores import compute_scores

    t0 = time.perf_counter()
    folder = hub_snapshot(hub, RADEVAL_MODEL)
    modernbert_tokenizer_files(folder)
    write_json(os.path.join(folder, "config.json"), RADEVAL_MODERNBERT)
    torch.manual_seed(SEED + 80)
    encoder = ModernBertEncoder(RADEVAL_MODERNBERT)
    write_safetensors(os.path.join(folder, "model.safetensors"), encoder.state_dict())
    n_params = sum(p.numel() for p in encoder.parameters())
    del encoder
    write_s = time.perf_counter() - t0
    # each report's first 64 words: the CPU half's time
    pairs = [(" ".join(r.split()[:64]), " ".join(h.split()[:64])) for r, h in green_pairs(tmp, 32)]
    refs, hyps = [r for r, _ in pairs], [h for _, h in pairs]
    prf, secs = {}, {}
    for device in PARITY_DEVICES:
        bertscore_impl._load_scorer.cache_clear()
        if device == "cuda":  # the first call reads the files; time a later one
            bert_score_prf(RADEVAL_MODEL, refs, hyps, layer=22, rescale_with_baseline=False,
                           device=device)
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        prf[device] = bert_score_prf(RADEVAL_MODEL, refs, hyps, layer=22,
                                     rescale_with_baseline=False, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        secs[device] = time.perf_counter() - t1
    err = max(abs(a - b) for x, y in zip(prf["cpu"], prf["cuda"]) for a, b in zip(x, y))
    scores = compute_scores(["radevalbertscore", "BLEU"], refs, hyps, "validate", SEED, None, 0,
                            logging.getLogger("radeval_green"), dump=False, device="cuda")
    tok, _ = bertscore_impl.load_scorer(RADEVAL_MODEL, "cuda")
    lengths = [len(tok.encode_truncated(s)) for s in refs + hyps]
    print(f"radeval_green radevalbertscore ({card}): ModernBERT {n_params / 1e6:.1f} M "
          f"parameters ({RADEVAL_MODERNBERT['num_hidden_layers']} x "
          f"{RADEVAL_MODERNBERT['hidden_size']}, local window "
          f"{RADEVAL_MODERNBERT['local_attention']}), tokenizer vocab {tok.vocab_size} (len "
          f"{len(tok)}), files written in {write_s:.1f} s; 32 pairs of {min(lengths)}-"
          f"{max(lengths)} tokens at layer 22, f32: card {secs['cuda'] * 1e3:.1f} ms a call with "
          f"the encoder kept, CPU {secs['cpu']:.2f} s (its files read); P/R/F card vs CPU max |diff| {err:.2e} "
          f"(tol 1e-5); compute_scores {scores}")
    bertscore_impl._load_scorer.cache_clear()
    return {"radevalbertscore P / R / F card = CPU within 1e-5": err <= 1e-5,
            "radevalbertscore through compute_scores": scores.get("radevalbertscore") is not None
            and math.isfinite(scores["radevalbertscore"]) and max(lengths) > 40}


def llama_hf_state(model) -> dict:
    """The port LLaMA's state dict under HF's names."""
    out = {}
    for k, v in model.state_dict().items():
        if k.startswith("layers_"):
            i, rest = k[len("layers_"):].split(".", 1)
            k = f"model.layers.{i}.{rest}"
        elif k != "lm_head.weight":
            k = f"model.{k}"
        out[k] = v
    return out


def green_phase(tmp: str, card: str):
    """The GREEN judge at Llama-2-7B widths (4096, 32 heads, MLP 11008,
    vocab 32,000) behind a Llama-2-style ``tokenizer.json``: a 4-layer bf16
    checkpoint written here and read through ``load_hf_llama`` judges 4
    pairs through ``GREENImpl`` (max_length 256); the full 32 layers built
    in memory with random bf16 weights prefill one judge batch of 4 whole
    prompts (encoded as the judge encodes them, at its default max_length
    2048) and decode :data:`JUDGE_STEPS` tokens (ms a step, peak GiB, and a
    host / device split under ``torch.profiler``); a 2-layer f32 judge's
    greedy tokens, card against CPU, over 4 left-padded prompts (the
    reports alone)."""
    import torch

    from vilmedic_torch.blocks.llm.llama import (LlamaForCausalLM, greedy_generate,
                                                 init_random_, llama_config_from_hf)
    from vilmedic_torch.data.auto_tokenizer import AutoTokenizer
    from vilmedic_torch.scorers import green
    from vilmedic_torch.zoo.convert_llm import load_hf_llama

    checks = {}
    pairs = green_pairs(tmp, 4)
    refs, hyps = [r for r, _ in pairs], [h for _, h in pairs]
    folder = os.path.join(tmp, "green_judge")
    os.makedirs(folder)
    t0 = time.perf_counter()
    llama_tokenizer_files(folder)
    cfg4 = dict(LLAMA2_7B, num_hidden_layers=4)
    write_json(os.path.join(folder, "config.json"), cfg4)
    small = init_random_(LlamaForCausalLM(llama_config_from_hf(cfg4), device="cuda"), SEED + 90)
    write_safetensors(os.path.join(folder, "model.safetensors"), llama_hf_state(small))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg, state = load_hf_llama(folder)
    read_s = time.perf_counter() - t0
    same = all(torch.equal(state[k], v.cpu()) for k, v in small.state_dict().items())
    del small, state
    torch.cuda.empty_cache()
    green.pair_to_reward_dict.clear()
    t0 = time.perf_counter()
    impl = green.GREENImpl(model_name=folder, max_length=256, batch_size=4, device="cuda")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mean, per_pair = impl(refs, hyps)
    torch.cuda.synchronize()
    judge_s = time.perf_counter() - t0
    again = impl(refs, hyps)
    tok = AutoTokenizer.from_pretrained(folder, padding_side="left")
    tok.pad_token = tok.eos_token  # as the judge sets it: Llama-2 has no pad token
    prompt_tokens = [len(tok.encode(green._chat_wrap(green.make_prompt(r, h))))
                     for r, h in pairs]
    print(f"radeval_green GREEN 4-layer judge ({card}): {cfg.num_hidden_layers} layers of "
          f"{cfg.hidden_size} ({cfg.num_attention_heads} heads, MLP {cfg.intermediate_size}), "
          f"{cfg.dtype}, tokenizer vocab {tok.vocab_size}; checkpoint written in {write_s:.1f} s, "
          f"read by load_hf_llama in {read_s:.1f} s (tensors {'equal' if same else 'DIFFER'}), "
          f"judge built in {build_s:.1f} s; 4 pairs (prompts of {prompt_tokens} tokens, cut at "
          f"256) judged in {judge_s:.2f} s: GREEN {mean} {per_pair}")
    checks.update({
        "load_hf_llama reads the written checkpoint": same and cfg.dtype == torch.bfloat16
        and cfg.num_hidden_layers == 4,
        "GREEN scores finite, memo reused": len(per_pair) == 4
        and all(math.isfinite(x) for x in per_pair) and again == (mean, per_pair),
    })
    del impl
    torch.cuda.empty_cache()

    # the full 32 layers, random bf16 weights built on the card
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    full = init_random_(LlamaForCausalLM(llama_config_from_hf(LLAMA2_7B), device="cuda"),
                        SEED + 91)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in full.parameters())
    prompts = [green.make_prompt(r, h) for r, h in pairs]
    # the whole wrapped prompts, as the judge encodes them at its default max_length
    ids, mask = tok.encode_batch([green._chat_wrap(p) for p in prompts], max_length=JUDGE_LEN,
                                 padding="longest", padding_side="left")
    ids, mask = torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()
    eos = tok.eos_token_id

    def generate(n: int):
        """(the new tokens, wall seconds) of one judge batch, ``n`` new tokens."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = greedy_generate(full, ids, mask, n, eos, eos)
        torch.cuda.synchronize()
        return toks, time.perf_counter() - t0

    generate(2)  # warm-up
    (_, one_s), (toks, gen_s) = generate(1), generate(JUDGE_STEPS)
    step_ms = (gen_s - one_s) / (JUDGE_STEPS - 1) * 1e3
    new = int((toks != eos).sum())
    responses = tok.batch_decode(toks.cpu().numpy(), skip_special_tokens=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # host / device split of a decode step, and its device ms by kernel: two
    # profiled calls, 1 and 17 new tokens, the difference over 16 steps
    split, by_name = {}, {}
    for n in (1, 17):
        (_, wall), events = profiled(lambda: generate(n))
        by_name[n] = collections.defaultdict(float)
        for e in events:
            by_name[n][e.name[:48]] += (e.time_range.end - e.time_range.start) / 1e3
        split[n] = (wall, sum(by_name[n].values()))
    wall_ms = (split[17][0] - split[1][0]) / 16 * 1e3
    busy_ms = (split[17][1] - split[1][1]) / 16
    per_step = {k: (v - by_name[1].get(k, 0.0)) / 16 for k, v in by_name[17].items()}
    top = sorted(per_step.items(), key=lambda kv: -kv[1])[:6]
    print(f"radeval_green GREEN 32-layer judge ({card}): {n_params / 1e9:.2f} B parameters "
          f"bf16 built in {build_s:.1f} s; one batch of 4 prompts of "
          f"{mask.sum(1).tolist()} tokens (max_length {JUDGE_LEN}, left padded to "
          f"{ids.shape[1]}): prefill and first token {one_s * 1e3:.1f} ms; {JUDGE_STEPS} greedy "
          f"steps {gen_s:.2f} s, {step_ms:.2f} ms a decode step at a cache of "
          f"{ids.shape[1] + JUDGE_STEPS} slots ({4 / step_ms * 1e3:.1f} new tokens/s, {new} "
          f"tokens not EOS); peak {peak:.2f} GiB; under torch.profiler a decode step "
          f"{wall_ms:.2f} ms of host time, {busy_ms:.2f} ms device-busy "
          f"({busy_ms / wall_ms * 100:.1f}%), prefill {split[1][1]:.1f} device ms; a decode "
          f"step's device ms by kernel: " + "; ".join(f"{k} {ms:.2f}" for k, ms in top))
    checks[f"32-layer judge: 4 responses, {JUDGE_STEPS} steps, prompts whole"] = (
        len(responses) == 4 and toks.shape[1] == JUDGE_STEPS and ids.shape[1] < JUDGE_LEN)
    del full
    torch.cuda.empty_cache()

    # greedy tokens, card against CPU, on a 2-layer f32 judge
    t0 = time.perf_counter()
    cfg2 = llama_config_from_hf(dict(LLAMA2_7B, num_hidden_layers=2), dtype=torch.float32)
    cpu_model = init_random_(LlamaForCausalLM(cfg2, device="cpu"), SEED + 92)
    gpu_model = LlamaForCausalLM(cfg2, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    # the reports' first 8 to 64 words as prompts: rows of different
    # lengths, left padded
    ids, mask = tok.encode_batch(
        [green._chat_wrap(" ".join(r.split()[:n])) for r, n in zip(refs, (8, 16, 32, 64))],
        max_length=128, padding="longest", padding_side="left")
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    out = {"cpu": greedy_generate(cpu_model, ids, mask, 16, tok.eos_token_id,
                                  tok.eos_token_id),
           "cuda": greedy_generate(gpu_model, ids.cuda(), mask.cuda(), 16, tok.eos_token_id,
                                   tok.eos_token_id).cpu()}
    same = torch.equal(out["cpu"], out["cuda"])
    print(f"radeval_green GREEN 2-layer f32 judge at 7B widths, card vs CPU "
          f"({time.perf_counter() - t0:.1f} s): 4 prompts of {mask.sum(1).tolist()} tokens, "
          f"left padded, 16 greedy tokens {'equal' if same else 'DIFFER'}")
    checks["2-layer f32 judge: greedy tokens card = CPU"] = same and not bool(mask.all())
    del cpu_model, gpu_model
    torch.cuda.empty_cache()
    return checks


def phase_radeval_green(tmp: str, hub: str, card: str):
    """``radevalbertscore`` and the GREEN judge (:func:`radeval_phase`,
    :func:`green_phase`); no custom kernel runs on these paths (ModernBERT's
    and LLaMA's attention are plain products, as in the JAX package)."""
    import torch

    set_tf32(False)
    t0 = time.perf_counter()
    reset_launches()
    checks = {**radeval_phase(tmp, hub, card), **green_phase(tmp, card)}
    launches = read_launches()
    checks["no custom kernel on these paths"] = not any(launches.values())
    print(f"radeval_green: {time.perf_counter() - t0:.1f} s")
    require(checks, "radeval_green")
    torch.cuda.empty_cache()


# ------------------------------------------------------------------- the zoo

ZOO_JPEGS = 16  # the serving batch of dataset.inference
# roberta-large's published config.json (bert_score's "roberta-large")
ROBERTA_LARGE = dict(model_type="roberta", vocab_size=50265, hidden_size=1024,
                     num_hidden_layers=24, num_attention_heads=16, intermediate_size=4096,
                     max_position_embeddings=514, type_vocab_size=1, layer_norm_eps=1e-5,
                     pad_token_id=1, bos_token_id=0, eos_token_id=2, hidden_act="gelu")
ROBERTA_LARGE_LAYER = 17  # bert_score's layer: the file holds layers 0-16 only


def zoo_jpegs(folder: str, n: int, size: int, seed: int):
    """``n`` random RGB JPEGs of ``size``² under ``folder``; their paths."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    paths = []
    for i in range(n):
        paths.append(os.path.join(folder, f"xray{i}.jpg"))
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(paths[-1])
    return paths


def zoo_rrg(tmp: str, card: str):
    """(a) The flagship RRG from a reference checkpoint: a reference-layout
    ``.pth`` of ``config/RRG/baseline-mimic.yml`` (DenseNet-169 as
    ``enc.model.0.*``, ``enc.visual_projection``, the 1-layer 768
    BertGeneration decoder as ``dec.decoder.*``, vocab 50,265; random
    weights from SEED; its saved config with the image block's
    ``device_preproc: true``) through ``vilmedic_torch.bin.convert_checkpoint``
    and ``AutoModel.from_pretrained`` on the card; ``dataset.inference``
    over 16 JPEGs served at beam 8 (K3, K1 (a), K2), reports/s; f32 beams of
    2 card vs CPU from the same converted weights."""
    import glob as globlib
    import shutil

    import torch

    from vilmedic_torch.bin.convert_checkpoint import main as convert
    from vilmedic_torch.config import load_config
    from vilmedic_torch.data.image import prepare_batch
    from vilmedic_torch.executors.checkpoint import load_checkpoint, save_checkpoint
    from vilmedic_torch.models.base import get_special_token_ids
    from vilmedic_torch.models.evaluation_nlg import make_generate_fn, to_device
    from vilmedic_torch.zoo import AutoModel
    from vilmedic_torch.zoo.convert import convert_reference_rrg, reference_rrg_state_dict

    t0 = time.perf_counter()
    root = os.path.join(tmp, "zoo")
    os.makedirs(root)
    cfg, _ = load_config(CONFIG, ["dataset.image.device_preproc=true"])
    model, *_ = build_flagship("float32", "cpu")
    reference = reference_rrg_state_dict(model.module.state_dict())
    del model
    pth = os.path.join(root, "baseline-mimic.pth")
    torch.save({"model": {f"module.{k}": v for k, v in reference.items()},
                "config": cfg.to_dict(), "__version__": "reference"}, pth)
    ckpt_dir, f32_dir = os.path.join(root, "rrg_mimic"), os.path.join(root, "rrg_mimic_f32")
    convert([pth, ckpt_dir, "--num-layers", "1", "--backbone", "densenet169"])
    vocab = ["[CLS]", "[PAD]", "[SEP]", "[UNK]", "[MASK]"] + [f"w{i}" for i in range(VOCAB - 5)]
    with open(os.path.join(ckpt_dir, "vocab.tgt"), "w") as f:
        f.write("\n".join(vocab))
    # the f32 copy for the parity: the converted weights, the config's dtype float32
    os.makedirs(f32_dir)
    shutil.copy(os.path.join(ckpt_dir, "vocab.tgt"), f32_dir)
    ckpt = globlib.glob(os.path.join(ckpt_dir, "*.ckpt"))[0]
    state = load_checkpoint(ckpt)
    state["config"]["model"]["dtype"] = "float32"
    save_checkpoint(os.path.join(f32_dir, os.path.basename(ckpt)), state)
    del state
    images = zoo_jpegs(os.path.join(root, "images"), ZOO_JPEGS, 256, SEED + 95)
    seqs = [" ".join(f"w{(7 * i + j) % 997}" for j in range(6)) for i in range(ZOO_JPEGS)]
    want = convert_reference_rrg(reference, 1, "densenet169")
    write_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    model, dataset = AutoModel.from_pretrained(ckpt_dir, device="cuda")
    load_s = time.perf_counter() - t1
    loaded = model.module.state_dict()
    bitwise = sorted(loaded) == sorted(want) and all(
        torch.equal(v.cpu(), want[k]) for k, v in loaded.items())
    bos, eos, pad = get_special_token_ids(model.dec_config, dataset.tokenizer)
    max_len = int(dataset.tokenizer_max_len)
    layers = model.dec_config.num_hidden_layers

    def serve_zoo(m, ds, n, device):
        batch = ds.inference(seq=seqs[:n], image=images[:n])
        on = prepare_batch(to_device(batch, device), ds)
        return make_generate_fn([m], BEAM, max_len, bos, eos, pad, length_penalty=1.0)(
            m.encoder_inputs(on))

    reset_launches()
    res = serve_zoo(model, dataset, ZOO_JPEGS, "cuda")
    torch.cuda.synchronize()
    launches = read_launches()
    times = []
    for _ in range(3):
        t1 = time.perf_counter()
        timed_res = serve_zoo(model, dataset, ZOO_JPEGS, "cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    med = statistics.median(times)
    del model
    torch.cuda.empty_cache()

    set_tf32(False)
    beams, secs = {}, {}
    for device in PARITY_DEVICES:
        t1 = time.perf_counter()
        m, ds = AutoModel.from_pretrained(f32_dir, device=device)
        beams[device] = serve_zoo(m, ds, 2, device).sequences.cpu()
        secs[device] = time.perf_counter() - t1
        del m
    torch.cuda.empty_cache()
    seq = res.sequences
    print(f"zoo (a) flagship RRG from a reference .pth ({card}): files written and converted in "
          f"{write_s:.1f} s, AutoModel on the card in {load_s:.1f} s, {len(want)} tensors "
          f"bitwise the .pth's: {bitwise}; dataset.inference over {ZOO_JPEGS} JPEGs at beam "
          f"{BEAM}, bf16: {res.steps} steps, launches K3 {launches['crop_normalize']}, K1 (a) "
          f"{launches['fused_beam_cache_attention']}, K2 {launches['lm_head_blocked_stats']}; "
          f"{ZOO_JPEGS / med:.2f} reports/s (median of 3: {med * 1e3:.1f} ms a batch, JPEG "
          f"decode included, {[round(t * 1e3, 1) for t in times]}); f32 beams of 2 card vs CPU "
          f"{'equal' if torch.equal(beams['cpu'], beams['cuda']) else 'DIFFER'} (CPU half "
          f"{secs['cpu']:.1f} s)")
    checks = {
        "every loaded tensor bitwise the reference file's": bitwise,
        "sequences (16, max_len) from BOS": tuple(seq.shape) == (ZOO_JPEGS, max_len)
        and bool((seq[:, 0] == bos).all()) and timed_res.steps == res.steps,
        "finite scores": bool(torch.isfinite(res.scores).all()),
        "K3 once on the uint8 batch": launches["crop_normalize"] == 1,
        "K1 (a) = layers x steps": launches["fused_beam_cache_attention"] == layers * res.steps
        and launches["fused_beam_cache_attention.launches_stats"] == 0,
        "K2 = steps": launches["lm_head_blocked_stats"] == res.steps > 0,
        "f32 beams card = CPU": torch.equal(beams["cpu"], beams["cuda"]),
    }
    return checks, launches


def hf_dinov2_tensors(cfg: dict, grid: int, gen) -> dict:
    """A DINOv2 state dict under HF ``Dinov2Model``'s names at ``cfg``'s
    widths with a ``grid``² position table, random from ``gen`` (LayerScale
    and norm scales near 1)."""
    import torch

    d, p = cfg["hidden_size"], cfg["patch_size"]
    f = int(d * cfg["mlp_ratio"])

    def rand(*shape, scale=0.02, base=0.0):
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
            sd[f"{pre}{scale}.lambda1"] = rand(d, scale=0.1, base=1.0)
    return sd


def zoo_dinov2(hub: str, card: str):
    """(b) The VL tower from a DINOv2 weight folder: a ``model.safetensors``
    at dinov2-base widths (12 x 768, patch 14, a 16 x 16 grid: the
    ``config.json`` has no ``image_size``, so Dinov2Config's 224) under the
    VL config's ``vision_model_name`` in the hub cache; the VL config built
    on the card through ``create_model`` holds the file's tensors, the grid
    re-gridded to 1370 tokens; one tower batch of 16 through K4; the f32
    tower output of 2 images card vs CPU within 1e-4 of the largest."""
    import torch

    from vilmedic_torch.config import load_config
    from vilmedic_torch.executors.utils import create_model
    from vilmedic_torch.models.base import hf_weights
    from vilmedic_torch.zoo.convert_vision import convert_hf_dinov2

    t0 = time.perf_counter()
    cfg, _ = load_config(VL_CONFIG, ["model.dtype=bfloat16"])
    name = cfg.model.vision.vision_model_name
    folder = hub_snapshot(hub, name)
    tower_cfg = {k: v for k, v in VL_TOWER.items() if k != "image_size"}
    write_json(os.path.join(folder, "config.json"), tower_cfg)
    write_safetensors(os.path.join(folder, "model.safetensors"),
                      hf_dinov2_tensors(tower_cfg, 16, torch.Generator().manual_seed(SEED + 96)))
    want = convert_hf_dinov2(hf_weights(name), target_tokens=VL_TOKENS)
    ids = dict(vocab_size=VL_VOCAB, bos_token_id=VL_BOS, eos_token_id=VL_EOS,
               pad_token_id=VL_PAD)
    model = create_model(cfg, device="cuda", **ids)
    build_s = time.perf_counter() - t0
    tower = model.module.vision
    state = tower.model.state_dict()
    loaded = sorted(state) == sorted(want) and all(
        torch.equal(state[k].cpu(), v) for k, v in want.items())
    images = vl_images(16, 518, SEED + 97).to("cuda")
    with torch.no_grad():
        tower(images)  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t1 = time.perf_counter()
        out = tower(images)
        torch.cuda.synchronize()
        tower_ms = (time.perf_counter() - t1) * 1e3
    launches = read_launches()
    shape, finite = tuple(out.shape), bool(torch.isfinite(out).all())
    del model, tower, out
    torch.cuda.empty_cache()

    set_tf32(False)
    cfg32, _ = load_config(VL_CONFIG, ["model.dtype=float32"])
    two = vl_images(2, 518, SEED + 98)
    outs, secs = {}, {}
    for device in PARITY_DEVICES:
        t1 = time.perf_counter()
        m = create_model(cfg32, device=device, **ids)
        with torch.no_grad():
            outs[device] = m.module.vision(two.to(device)).float().cpu()
        secs[device] = time.perf_counter() - t1
        del m
    torch.cuda.empty_cache()
    err = (outs["cuda"] - outs["cpu"]).abs().max().item()
    scale = outs["cpu"].abs().max().item()
    layers = tower_cfg["num_hidden_layers"]
    print(f"zoo (b) DINOv2 weight folder {name!r} ({card}): written and built on the card in "
          f"{build_s:.1f} s; tower tensors the file's (grid 16² -> 37²): {loaded}; tower batch "
          f"16 bf16 {shape}: {tower_ms:.1f} ms, K4 launches {launches['flash_attention']}; f32 "
          f"2 images card vs CPU max |diff| {err:.3e} of max {scale:.3e} (tol 1e-4 of it; CPU "
          f"half {secs['cpu']:.1f} s)")
    checks = {
        "tower tensors the file's, re-gridded": loaded,
        "tower output (16, 1370, 768), finite": shape == (16, VL_TOKENS, 768) and finite,
        "K4 = tower layers": launches["flash_attention"] == layers,
        "f32 tower card = CPU within 1e-4 of the largest": err <= 1e-4 * scale,
    }
    return checks, launches


def zoo_chexbert_labels(tmp: str, card: str):
    """(c) The CheXbert labelling CLI over 32 reports with
    ``clinical_validate``'s random CheXbert files: the label file from the
    card equals the CPU's byte for byte."""
    import torch

    from vilmedic_torch.data_tools.get_chexbert_label import compute_labels

    reports = [r for r, _ in green_pairs(tmp, 32)]
    files, secs = {}, {}
    with weights_dir(scorer_weights(tmp)):
        for device in PARITY_DEVICES:
            folder = os.path.join(tmp, "zoo", f"labels_{device}")
            os.makedirs(folder)
            with open(os.path.join(folder, "train.report.tok"), "w") as f:
                f.write("\n".join(reports))
            clear_scorer_caches()
            t1 = time.perf_counter()
            out = compute_labels(os.path.join(folder, "train.report.tok"), device=device)
            if device == "cuda":
                torch.cuda.synchronize()
            secs[device] = time.perf_counter() - t1
            with open(out, "rb") as f:
                files[device] = f.read()
    clear_scorer_caches()
    lines = files["cuda"].decode().split("\n")
    print(f"zoo (c) CheXbert labelling CLI ({card}): 32 reports, card {secs['cuda']:.2f} s, CPU "
          f"{secs['cpu']:.2f} s (files read and loaded in each); {len(set(lines))} distinct "
          f"label lines; files equal {files['cuda'] == files['cpu']}")
    return {"label file card = CPU, byte for byte": files["cuda"] == files["cpu"],
            "32 label lines": len(lines) == 32}


def zoo_roberta_bertscore(tmp: str, hub: str, card: str):
    """(d) BERTScore with a RoBERTa-large encoder by name: ``roberta-large``
    in the hub cache (its published config.json, the RoBERTa byte-level BPE
    of ``write_hub_tokenizers``, a ``model.safetensors`` of only the 17
    layers that layer 17 reads, random from SEED); 32 pairs warm on the
    card, a 4-pair CPU witness within 1e-5 of the card's on P, R and F, and
    ``compute_scores``' ``bertscore`` with ``BERTSCORE_MODEL=roberta-large``."""
    import shutil

    import torch

    from vilmedic_torch.scorers import bertscore_impl
    from vilmedic_torch.scorers.bert_encoder import BertEncoder
    from vilmedic_torch.scorers.bertscore_impl import bert_score_prf
    from vilmedic_torch.scorers.scores import compute_scores

    t0 = time.perf_counter()
    folder = hub_snapshot(hub, "roberta-large")
    source = hub_snapshot(hub, ROBERTA_TOKENIZER)
    for name in ("vocab.json", "merges.txt", "tokenizer_config.json"):
        shutil.copy(os.path.join(source, name), folder)
    write_json(os.path.join(folder, "config.json"), ROBERTA_LARGE)
    torch.manual_seed(SEED + 98)
    encoder = BertEncoder(ROBERTA_LARGE, num_layers=ROBERTA_LARGE_LAYER)
    write_safetensors(os.path.join(folder, "model.safetensors"),
                      {f"roberta.{k}": v for k, v in encoder.state_dict().items()})
    n_params = sum(p.numel() for p in encoder.parameters())
    del encoder
    write_s = time.perf_counter() - t0
    pairs = [(" ".join(r.split()[:64]), " ".join(h.split()[:64])) for r, h in green_pairs(tmp, 32)]
    refs, hyps = [r for r, _ in pairs], [h for _, h in pairs]
    bertscore_impl._load_scorer.cache_clear()
    bert_score_prf("roberta-large", refs, hyps, rescale_with_baseline=False, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    bert_score_prf("roberta-large", refs, hyps, rescale_with_baseline=False, device="cuda")
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t1) * 1e3
    four = {d: bert_score_prf("roberta-large", refs[:4], hyps[:4], rescale_with_baseline=False,
                              device=d) for d in PARITY_DEVICES}
    err = max(abs(a - b) for x, y in zip(four["cpu"], four["cuda"]) for a, b in zip(x, y))
    with bertscore_model("roberta-large"):
        scores = compute_scores(["bertscore"], refs, hyps, "validate", SEED, None, 0,
                                logging.getLogger("zoo"), dump=False, device="cuda")
    _, enc = bertscore_impl.load_scorer("roberta-large", "cuda", ROBERTA_LARGE_LAYER)
    built = len(enc.encoder.layer)
    bertscore_impl._load_scorer.cache_clear()
    print(f"zoo (d) BERTScore roberta-large ({card}): {n_params / 1e6:.1f} M parameters written "
          f"({built} of {ROBERTA_LARGE['num_hidden_layers']} layers, 1024 wide) in "
          f"{write_s:.1f} s; 32 pairs at layer {bertscore_impl.DEFAULT_LAYERS['roberta-large']}, "
          f"f32: {warm_ms:.1f} ms warm on the card; 4 pairs P/R/F card vs CPU max |diff| "
          f"{err:.2e} (tol 1e-5); compute_scores {scores}")
    return {"BERTScore roberta-large at layer 17": built == ROBERTA_LARGE_LAYER
            and bertscore_impl.DEFAULT_LAYERS["roberta-large"] == ROBERTA_LARGE_LAYER,
            "RoBERTa P / R / F card = CPU within 1e-5": err <= 1e-5,
            "bertscore through compute_scores": scores.get("bertscore") is not None
            and math.isfinite(scores["bertscore"])}


def phase_zoo(tmp: str, hub: str, card: str):
    """The zoo (:func:`zoo_rrg`, :func:`zoo_dinov2`,
    :func:`zoo_chexbert_labels`, :func:`zoo_roberta_bertscore`). Returns
    the launches of (a)'s beam-8 serving with (b)'s tower batch's K4."""
    import torch

    t0 = time.perf_counter()
    checks, launches = zoo_rrg(tmp, card)
    more, tower = zoo_dinov2(hub, card)
    checks.update(more)
    checks.update(zoo_chexbert_labels(tmp, card))
    checks.update(zoo_roberta_bertscore(tmp, hub, card))
    launches["flash_attention"] += tower["flash_attention"]
    print(f"zoo: {time.perf_counter() - t0:.1f} s")
    require(checks, "zoo")
    torch.cuda.empty_cache()
    return launches


DICOM_FILES = 16  # the serving batch of dicom_serve
DICOM_ROWS, DICOM_COLS = 3056, 2544  # a chest radiograph's pixels, 12 bits stored in 16
# the syntaxes' names in vilmedic_torch.data.dicom
DICOM_SYNTAXES = (("explicit LE", "EXPLICIT_LE"), ("implicit LE", "IMPLICIT_LE"),
                  ("JPEG lossless SV1", "JPEG_LOSSLESS_70"), ("RLE", "RLE_LOSSLESS"))


def dicom_pixels(i: int):
    """Image ``i`` of dicom_serve: a smooth 12-bit field and noise from the
    seed, (DICOM_ROWS, DICOM_COLS) uint16."""
    import numpy as np

    rng = np.random.default_rng(SEED + 200 + i)
    yy = np.arange(DICOM_ROWS, dtype=np.float32)[:, None]
    xx = np.arange(DICOM_COLS, dtype=np.float32)[None, :]
    fy, fx, phase = rng.uniform(80, 400), rng.uniform(80, 400), rng.uniform(0, 6.28)
    field = 2048 + 1500 * np.sin(yy / fy + phase) * np.cos(xx / fx)
    noise = rng.integers(0, 48, (DICOM_ROWS, DICOM_COLS))
    return np.clip(field + noise, 0, 4095).astype(np.uint16)


def write_dicom_files(folder: str):
    """DICOM_FILES Part-10 files, file i in syntax i % 4, MONOCHROME2
    plain for i // 4 even and MONOCHROME1 windowed for odd; written in
    threads. Returns their paths and the seconds taken."""
    from concurrent.futures import ThreadPoolExecutor

    from vilmedic_torch.data import dicom
    from vilmedic_torch.data.dicom_writer import write_dicom

    os.makedirs(folder, exist_ok=True)
    paths = [os.path.join(folder, f"cxr{i}.dcm") for i in range(DICOM_FILES)]

    def write(i):
        mono1 = (i // 4) % 2 == 1
        write_dicom(paths[i], dicom_pixels(i), getattr(dicom, DICOM_SYNTAXES[i % 4][1]),
                    photometric="MONOCHROME1" if mono1 else "MONOCHROME2",
                    window=(2100, 2600) if mono1 else None)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, range(DICOM_FILES)))
    return paths, time.perf_counter() - t0


def checkpoint_with_ext(src: str, dst: str, ext: str) -> str:
    """A copy of the run directory ``src`` (its one checkpoint and
    ``vocab.tgt``) at ``dst``, the checkpoint's saved config reading images
    of extension ``ext``."""
    import shutil

    from vilmedic_torch.executors.checkpoint import load_checkpoint, save_checkpoint

    os.makedirs(dst)
    shutil.copy(os.path.join(src, "vocab.tgt"), dst)
    ckpt = glob.glob(os.path.join(src, "*.ckpt"))[0]
    state = load_checkpoint(ckpt)
    state["config"]["dataset"]["image"]["ext"] = ext
    save_checkpoint(os.path.join(dst, os.path.basename(ckpt)), state)
    return dst


def phase_dicom_serve(tmp: str, card: str):
    """DICOM input on the serving path (``dicom_serve``): DICOM_FILES files
    at a chest radiograph's size (``write_dicom_files``: explicit LE,
    implicit LE, JPEG lossless SV1 and RLE, MONOCHROME2 and windowed
    MONOCHROME1) through the zoo's flagship RRG (``zoo_rrg``'s checkpoint,
    its saved config's image ``ext`` set to ``.dcm``; ``AutoModel`` on the
    card, bf16), ``dataset.inference`` and ``device_preproc``: ms per file
    decode for each syntax (``dicom_to_uint8``, a MONOCHROME2 and a
    MONOCHROME1 file each), reports/s of one batch with
    decode included, the launches of K3, K1 (a) and K2, and f32 beams of 2
    card vs CPU."""
    import numpy as np
    import torch

    from vilmedic_torch.data.dicom import dicom_to_uint8
    from vilmedic_torch.data.image import prepare_batch
    from vilmedic_torch.models.base import get_special_token_ids
    from vilmedic_torch.models.evaluation_nlg import make_generate_fn, to_device
    from vilmedic_torch.zoo import AutoModel

    t0 = time.perf_counter()
    root = os.path.join(tmp, "dicom")
    paths, write_s = write_dicom_files(os.path.join(root, "files"))
    zoo = os.path.join(tmp, "zoo")
    bf16_dir = checkpoint_with_ext(os.path.join(zoo, "rrg_mimic"), os.path.join(root, "rrg"),
                                   ".dcm")
    f32_dir = checkpoint_with_ext(os.path.join(zoo, "rrg_mimic_f32"),
                                  os.path.join(root, "rrg_f32"), ".dcm")
    decode_ms, decoded = {}, []
    for s, (label, _) in enumerate(DICOM_SYNTAXES):
        t1 = time.perf_counter()
        decoded += [dicom_to_uint8(paths[i]) for i in (s, s + 4)]  # MONOCHROME2, MONOCHROME1
        decode_ms[label] = (time.perf_counter() - t1) / 2 * 1e3
    finite = all(im.dtype == np.uint8 and im.shape == (DICOM_ROWS, DICOM_COLS)
                 and im.max() == 255 for im in decoded)
    seqs = [" ".join(f"w{(5 * i + j) % 997}" for j in range(6)) for i in range(DICOM_FILES)]

    model, dataset = AutoModel.from_pretrained(bf16_dir, device="cuda")
    bos, eos, pad = get_special_token_ids(model.dec_config, dataset.tokenizer)
    max_len = int(dataset.tokenizer_max_len)
    layers = model.dec_config.num_hidden_layers

    def serve(m, ds, n, device):
        batch = ds.inference(seq=seqs[:n], image=paths[:n])
        on = prepare_batch(to_device(batch, device), ds)
        return make_generate_fn([m], BEAM, max_len, bos, eos, pad, length_penalty=1.0)(
            m.encoder_inputs(on))

    torch.cuda.synchronize()
    reset_launches()
    t1 = time.perf_counter()
    res = serve(model, dataset, DICOM_FILES, "cuda")
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t1
    launches = read_launches()
    del model
    torch.cuda.empty_cache()

    set_tf32(False)
    beams = {}
    for device in PARITY_DEVICES:
        m, ds = AutoModel.from_pretrained(f32_dir, device=device)
        beams[device] = serve(m, ds, 2, device).sequences.cpu()
        del m
    torch.cuda.empty_cache()
    seq = res.sequences
    print(f"dicom_serve ({card}): {DICOM_FILES} files of {DICOM_COLS} x {DICOM_ROWS} (12 bits "
          f"in 16) written in {write_s:.1f} s; dicom_to_uint8 ms per file "
          + ", ".join(f"{k} {v:.1f}" for k, v in decode_ms.items())
          + f"; dataset.inference + beam {BEAM}, bf16: {res.steps} steps, "
          f"{DICOM_FILES / batch_s:.2f} reports/s ({batch_s * 1e3:.1f} ms a batch, DICOM decode "
          f"and resize included); launches K3 {launches['crop_normalize']}, K1 (a) "
          f"{launches['fused_beam_cache_attention']}, K2 {launches['lm_head_blocked_stats']}; "
          f"f32 beams of 2 card vs CPU "
          f"{'equal' if torch.equal(beams['cpu'], beams['cuda']) else 'DIFFER'}; "
          f"{time.perf_counter() - t0:.1f} s")
    checks = {
        "decoded uint8 at full size, windowed to 255": finite,
        "sequences (16, max_len) from BOS": tuple(seq.shape) == (DICOM_FILES, max_len)
        and bool((seq[:, 0] == bos).all()),
        "finite scores": bool(torch.isfinite(res.scores).all()),
        "K3 once on the uint8 batch": launches["crop_normalize"] == 1,
        "K1 (a) = layers x steps": launches["fused_beam_cache_attention"] == layers * res.steps
        and launches["fused_beam_cache_attention.launches_stats"] == 0,
        "K2 = steps": launches["lm_head_blocked_stats"] == res.steps > 0,
        "f32 beams card = CPU": torch.equal(beams["cpu"], beams["cuda"]),
    }
    require(checks, "dicom_serve")
    return launches


# relative tolerances of global_path_errors: BatchNorm's E[x²] - E[x]² moments
# against F.batch_norm's two-pass ones in f32 over 100,352 values a channel;
# the gathered GLoRIA loss runs the same arithmetic on copied rows
GLOBAL_PATH_TOL = {"batchnorm": 1e-4, "gloria": 1e-6}


def global_path_errors(device: str = "cuda") -> dict:
    """Under a process group of any size (``dist_train`` runs it in its NCCL
    group of 1, whose training forward takes the one-process paths), the
    multi-process paths forced and held against the one-process ones on
    the same f32 inputs: BatchNorm's moments through the differentiable
    all-reduce (``BatchNorm._global_forward``) against ``F.batch_norm`` at
    DenseNet-169's first norm for a batch of 8 at crop 224, (8, 64, 112,
    112); GLoRIA's loss over the gathered rows (``mesh.gathered_loss``: the
    differentiable all-gather and the padded token axes) against the loss
    itself. Returns each output's and gradient's max abs error over the
    reference's max abs."""
    import torch

    from vilmedic_torch.blocks.losses import GLoRIALoss
    from vilmedic_torch.blocks.vision.densenet import BatchNorm
    from vilmedic_torch.parallel import mesh

    gen = torch.Generator().manual_seed(SEED + 400)

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    bn = BatchNorm(64, torch.float32).to(device)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(64, generator=gen) + 0.5)
        bn.bias.copy_(torch.randn(64, generator=gen))
    x0 = (torch.randn(8, 64, 112, 112, generator=gen) * 1.7 + 0.4).to(device)
    dy = torch.randn(x0.shape, generator=gen).to(device)
    bn_out = {}
    for route in ("plain", "global"):
        x = x0.clone().requires_grad_(True)
        bn.zero_grad(set_to_none=True)
        with mesh.global_batch():
            y = bn._global_forward(x) if route == "global" else bn._train_forward(x)
        y.backward(dy)
        bn_out[route] = (y.detach(), x.grad, bn.weight.grad, bn.bias.grad, *bn.pending_stats)
        bn.pending_stats = None
    errs = {f"batchnorm {k}": rel(a, b) for k, a, b in zip(
        ("y", "dx", "dweight", "dbias", "mean", "var"), bn_out["global"], bn_out["plain"])}

    loss_fn = GLoRIALoss()
    b, d, s, t = 8, 16, 49, 12
    inputs = [torch.randn(shape, generator=gen).to(device)
              for shape in ((b, d), (b, s, d), (b, t, d), (b, d))]
    mask = (torch.arange(t)[None] < torch.randint(3, t + 1, (b, 1), generator=gen)).float()
    mask = mask.to(device)
    gl_out = {}
    for route in ("plain", "global"):
        g, local, words, sent = (x.clone().requires_grad_(True) for x in inputs)
        with mesh.global_batch():
            if route == "global":
                loss = mesh.gathered_loss(loss_fn, g, local, (words, 1.0), sent, (mask, 0.0))
            else:
                loss = loss_fn(g, local, words, sent, mask)
        loss.backward()
        gl_out[route] = (loss.detach(), g.grad, local.grad, words.grad, sent.grad)
    errs.update({f"gloria {k}": rel(a, b) for k, a, b in zip(
        ("loss", "dglobal", "dlocal", "dwords", "dsent"), gl_out["global"], gl_out["plain"])})
    return errs


DIST_WORKER = r'''
import json, sys
import torch
import chip_smoke as c
from vilmedic_torch.bin.train import main
from vilmedic_torch.ops import cuda_lib
from vilmedic_torch.parallel import mesh

c.set_tf32(False)
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.use_deterministic_algorithms(True, warn_only=True)
cuda_lib.lib()
c.reset_launches()
trainor = main(sys.argv[1:])
torch.cuda.synchronize()
launches = c.read_launches()
print("RESULT " + json.dumps({
    "group": mesh.initialized(), "world": mesh.process_count(), "rank": mesh.process_index(),
    "backend": torch.distributed.get_backend() if mesh.initialized() else None,
    "losses": trainor.epoch_losses, "launches": launches,
    "scores": trainor.evaluator.scores[-1],
    "global_path": c.global_path_errors() if mesh.initialized() else None},
    default=float), flush=True)
mesh.destroy()
'''


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_dist_train(tmp: str, card: str):
    """The train CLI under a process group (``dist_train``): the flagship
    config in f32 on 16 + 8 reports of the ``rrg_train`` corpus (its
    5,000-word vocabulary, so the Validator takes K2), batch 8, one epoch
    (2 steps) and the Validator at beam 8, run in a subprocess under
    torchrun's environment for a world of 1 (NCCL) and, at the same time, in
    another without it; cuDNN deterministic. Requires equal losses, every
    checkpoint tensor equal, one checkpoint each (rank 0's), and K3, K1 (a)
    and K2 launched in the NCCL run. The NCCL run then forces the
    multi-process BatchNorm and contrastive-loss paths, which a group of 1
    skips, and holds them against the one-process ones
    (``global_path_errors``)."""
    import shutil

    import torch

    t0 = time.perf_counter()
    src, data = os.path.join(tmp, "rrg_data"), os.path.join(tmp, "dist_data")
    os.makedirs(data)
    for split, n in (("train", 16), ("validate", 8)):
        for kind in ("image", "impression"):
            with open(os.path.join(src, f"{split}.{kind}.tok")) as f:
                lines = f.read().split("\n")[:n]
            with open(os.path.join(data, f"{split}.{kind}.tok"), "w") as f:
                f.write("\n".join(lines))
    procs, runs = {}, {}
    for name, group in (("dist_nccl", True), ("dist_plain", False)):
        os.makedirs(os.path.join(tmp, name))
        shutil.copy(os.path.join(tmp, "rrg_train", "vocab.tgt"), os.path.join(tmp, name))
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        for key in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
            env.pop(key, None)
        if group:
            env.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(free_port()))
        argv = rrg_train_overrides(data, tmp, name, "cuda") + [
            "model.dtype=float32", "trainor.batch_size=8", "validator.batch_size=8"]
        procs[name] = subprocess.Popen([sys.executable, "-c", DIST_WORKER, *argv], cwd=ROOT,
                                       env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out = proc.communicate(timeout=600)[0]
        if proc.returncode != 0:
            fail(f"dist_train {name} exited {proc.returncode}:\n{out[-4000:]}")
        runs[name] = json.loads([x for x in out.splitlines() if x.startswith("RESULT ")][-1][7:])
    ckpts = {name: glob.glob(os.path.join(tmp, name, "*.ckpt")) for name in runs}
    states = {name: torch.load(paths[0], map_location="cpu", weights_only=False)["model"]
              for name, paths in ckpts.items() if len(paths) == 1}
    same = len(states) == 2 and sorted(states["dist_nccl"]) == sorted(states["dist_plain"]) \
        and all(torch.equal(v, states["dist_plain"][k]) for k, v in states["dist_nccl"].items())
    nccl, plain = runs["dist_nccl"], runs["dist_plain"]
    launches = nccl["launches"]
    print(f"dist_train ({card}): f32, batch 8, 2 steps + the Validator at beam {BEAM} on 8; "
          f"under torchrun's environment: group {nccl['group']}, backend {nccl['backend']}, "
          f"world {nccl['world']}, rank {nccl['rank']}; losses {nccl['losses']} vs without "
          f"{plain['losses']}; {len(states.get('dist_nccl', {}))} checkpoint tensors "
          f"{'all equal' if same else 'DIFFER'}; checkpoints {[len(v) for v in ckpts.values()]}; "
          f"launches K3 {launches['crop_normalize']}, K1 (a) "
          f"{launches['fused_beam_cache_attention']}, K2 {launches['lm_head_blocked_stats']} "
          f"(without the group {plain['launches']['crop_normalize']} / "
          f"{plain['launches']['fused_beam_cache_attention']} / "
          f"{plain['launches']['lm_head_blocked_stats']}); {time.perf_counter() - t0:.1f} s "
          "(both runs at once)")
    forced = nccl["global_path"]
    print("dist_train: the multi-process paths forced in the NCCL group, max error / max abs: "
          + ", ".join(f"{k} {v:.2e}" for k, v in forced.items()))
    checks = {
        "an NCCL group of 1, and none without the environment":
            nccl["group"] and nccl["backend"] == "nccl" and nccl["world"] == 1
            and not plain["group"],
        "finite f32 losses, equal": all(math.isfinite(x) for x in nccl["losses"])
        and nccl["losses"] == plain["losses"],
        "every checkpoint tensor equal": same,
        "rank 0 wrote the one checkpoint of each run": [len(v) for v in ckpts.values()] == [1, 1],
        "equal scores": nccl["scores"] == plain["scores"],
        "the forced multi-process paths: BatchNorm within 1e-4, GLoRIA within 1e-6": all(
            v <= GLOBAL_PATH_TOL[k.split()[0]] for k, v in forced.items()),
        "K3, K1 (a) and K2 launched": launches["crop_normalize"] == 3
        and launches["fused_beam_cache_attention"] > 0 and launches["lm_head_blocked_stats"] > 0
        and launches == plain["launches"],
    }
    require(checks, "dist_train")
    return {k: v for k, v in launches.items()}


def phase_optimizers(card: str):
    """One f32 step of each optax alias the port added (sgd, rmsprop,
    adagrad, adadelta, adafactor, lamb, lion, with the options a config can
    reach) on the card and on the CPU from the same parameters and
    gradients: every parameter within 1e-6 of its largest magnitude."""
    import torch

    from vilmedic_torch.executors.train_state import create_optimizer, gated_update

    set_tf32(False)
    options = {
        "sgd": dict(lr=0.05, momentum=0.9, nesterov=True, weight_decay=0.01),
        "rmsprop": dict(lr=0.01, eps=1e-6, momentum=0.5, weight_decay=0.01),
        "adagrad": dict(lr=0.1, eps=1e-8),
        "adadelta": dict(lr=1.0, eps=1e-6, weight_decay=0.001),
        "adafactor": dict(lr=0.01, momentum=0.9, weight_decay=0.001),
        "lamb": dict(lr=0.01, betas=(0.8, 0.99), eps=1e-6, weight_decay=0.01),
        "lion": dict(lr=1e-3, betas=(0.9, 0.99)),
    }
    shapes = {"w": (768, 1024), "t": (4, 160, 136), "b": (768,), "z": (3, 4)}
    gen = torch.Generator().manual_seed(SEED + 300)
    init = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    init["z"].zero_()
    grads = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    errs, moved = {}, {}
    for name, opts in options.items():
        after = {}
        for device in PARITY_DEVICES:
            params = torch.nn.ParameterDict({k: torch.nn.Parameter(v.clone().to(device))
                                             for k, v in init.items()})
            tx = create_optimizer(name, dict(opts), clip_grad_norm=50.0,
                                  named_parameters=params.named_parameters())
            for k, p in params.items():
                p.grad = grads[k].to(device)
            gated_update(tx, opts["lr"], torch.tensor(1.0, device=device))
            after[device] = {k: p.detach().cpu() for k, p in params.items()}
        errs[name] = max(float((after["cuda"][k] - after["cpu"][k]).abs().max())
                         / max(float(after["cpu"][k].abs().max()), 1e-30) for k in shapes)
        moved[name] = all(not torch.equal(after["cuda"][k], init[k]) for k in ("w", "t", "b"))
    print(f"optimizers ({card}): one f32 step card vs CPU, max diff / max abs: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    require({f"{k} card = CPU within 1e-6, every tensor moved": errs[k] <= 1e-6 and moved[k]
             for k in options}, "optimizers")


def phase_hf_dataset(tmp: str, card: str):
    """A ``save_to_disk`` dataset through the Validator (``hf_dataset``):
    the zoo's 16 JPEGs (an ``images_path`` field) and 16 impressions, with
    rows of another view filtered out by the config's ``hf_filter``, read
    with ``hf_local`` by the image and text datasets of the flagship
    config's Validator (uint8 batches through K3, beam 8) over the zoo's
    ``AutoModel``-loaded RRG on the card."""
    import datasets
    import torch

    from vilmedic_torch.config import load_config
    from vilmedic_torch.config.config import executor_config
    from vilmedic_torch.executors import Validator
    from vilmedic_torch.zoo import AutoModel

    t0 = time.perf_counter()
    zoo = os.path.join(tmp, "zoo")
    images = sorted(glob.glob(os.path.join(zoo, "images", "*.jpg")))
    rows = {"images_path": [os.path.basename(p) for p in images] * 2,
            "impression": [" ".join(f"w{(3 * i + j) % 997}" for j in range(8))
                           for i in range(2 * len(images))],
            "view": ["PA"] * len(images) + ["LATERAL"] * len(images)}
    folder = os.path.join(tmp, "hf_cxr")
    datasets.DatasetDict({"validate": datasets.Dataset.from_dict(rows)}).save_to_disk(folder)
    model, _ = AutoModel.from_pretrained(os.path.join(zoo, "rrg_mimic"), device="cuda")
    keep = "{view: PA}"
    cfg, _ = load_config(CONFIG, [
        f"ckpt_dir={zoo}", "name=rrg_mimic", "dataset.image.file=null",
        "dataset.seq.file=null", f"dataset.image.hf_dataset={folder}",
        "dataset.image.hf_local=true", "dataset.image.hf_field=images_path",
        f"dataset.image.hf_filter={keep}", f"dataset.image.image_path={os.path.dirname(images[0])}",
        "dataset.image.device_preproc=true", f"dataset.seq.hf_dataset={folder}",
        "dataset.seq.hf_local=true", "dataset.seq.hf_field=impression",
        f"dataset.seq.hf_filter={keep}", "validator.batch_size=16", "validator.splits=[validate]",
        "validator.metrics=[BLEU,ROUGEL]", "validator.beam_width=8"])
    val = executor_config(cfg, "validator")
    val.ckpt_dir = os.path.join(zoo, "rrg_mimic")
    reset_launches()
    evaluator = Validator(config=val, models=[model], seed=SEED)
    n = len(evaluator.splits[0][1].dataset)
    scores = evaluator.start()[0]
    torch.cuda.synchronize()
    launches = read_launches()
    del model
    torch.cuda.empty_cache()
    print(f"hf_dataset ({card}): a save_to_disk dataset of {2 * len(images)} rows, {n} kept by "
          f"hf_filter {keep}, through the Validator at beam 8: scores {scores}; launches K3 "
          f"{launches['crop_normalize']}, K1 (a) {launches['fused_beam_cache_attention']}, K2 "
          f"{launches['lm_head_blocked_stats']}; {time.perf_counter() - t0:.1f} s")
    require({"the filter kept the PA rows": n == len(images),
             "scored": all(math.isfinite(scores[k]) for k in ("BLEU", "ROUGEL")),
             "K3 per batch, K1 (a) and K2 launched": launches["crop_normalize"] == 1
             and launches["fused_beam_cache_attention"] > 0
             and launches["lm_head_blocked_stats"] > 0}, "hf_dataset")
    return launches

def time_blocked_lm_head(h, w, b) -> dict:
    """K2 on (h, w, b): its device time (events around one call beside it),
    its plain version's, ``torch.matmul``'s of the product alone, and its
    bound (read h, w, b; write the logits and two (N, Vp / 128) stats)."""
    import torch

    from vilmedic_torch.ops.blocked_lm_head import (
        lm_head_blocked_stats, lm_head_blocked_stats_reference,
    )

    n, hidden = h.shape
    vp = w.shape[0]
    nbytes = (h.numel() + w.numel()) * 2 + vp * 4 + n * vp * 4 + 2 * n * (vp // 128) * 4
    return dict(
        ms=device_ms_per_call(lambda: [lm_head_blocked_stats(h, w, b) for _ in range(9)], 9,
                              {"lm_head_wgmma_kernel": 1}),
        events_ms=cuda_ms(lambda: lm_head_blocked_stats(h, w, b)),
        plain_ms=cuda_ms(lambda: lm_head_blocked_stats_reference(h, w, b)),
        product_ms=device_ms_per_call(lambda: [torch.matmul(h, w.t()) for _ in range(9)], 9),
        flops=2 * n * hidden * vp, **bound(nbytes, 2 * n * hidden * vp, h.dtype))


def report_blocked_lm_head(tm: dict, n: int, vocab: int, vp: int, label: str):
    print(f"K2 bf16{label} N={n} V={vocab} (Vp {vp}): kernel {tm['ms']:.4f} device ms "
          f"({tm['flops'] / tm['ms'] / 1e9:.1f} TFLOP/s, {tm['bound_ms'] / tm['ms'] * 100:.1f}% "
          f"of the bound; events around one call "
          f"{tm['events_ms']:.4f} ms), plain {tm['plain_ms']:.4f} ms, torch.matmul of the "
          f"product only {tm['product_ms']:.4f} device ms, bound {tm['bound_ms']:.4f} ms "
          f"({tm['bound_by']})")


def time_blocked_lm_head_at(n: int, vocab: int, hidden: int, label: str, card: str):
    """K2 bf16 at (N, hidden) x (hidden, Vp) on random weights, held against
    its plain version, then timed and reported (:func:`time_blocked_lm_head`)."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 95)
    w32, b = lm_head_weights(vocab, gen, hidden)
    w, b = w32.to("cuda", torch.bfloat16), b.cuda()
    h = torch.randn(n, hidden, generator=gen).to("cuda", torch.bfloat16)
    hold_blocked_lm_head(h, w, b, label=label)
    report_blocked_lm_head(time_blocked_lm_head(h, w, b), n, vocab, w.shape[0],
                           f"{label} ({card})")


PHASE_SECONDS = {}


def timed(phase, *args):
    """``phase(*args)``, its wall seconds printed and kept in
    :data:`PHASE_SECONDS`."""
    t0 = time.perf_counter()
    out = phase(*args)
    PHASE_SECONDS[phase.__name__] = time.perf_counter() - t0
    print(f"{phase.__name__}: {PHASE_SECONDS[phase.__name__]:.1f} s")
    return out


def probe_packages() -> dict:
    """Whether the packages some paths need are installed on this machine
    (``datasets`` and ``pyarrow`` for ``hf_dataset``; scikit-learn and
    matplotlib for the ``post_processing`` plots, whose phase this script
    leaves out: the card's machine was found without them), and which
    ``torch.distributed`` backends it has."""
    import importlib.util

    import torch.distributed as dist

    found = {name: importlib.util.find_spec(name) is not None
             for name in ("datasets", "pyarrow", "sklearn", "matplotlib")}
    return {**found, "torch.distributed": dist.is_available(),
            "nccl": dist.is_nccl_available(), "gloo": dist.is_gloo_available()}


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
    print("packages: " + json.dumps(probe_packages()))

    t_start = time.perf_counter()
    results = timed(phase_kernels)
    launches = {"rrg": timed(phase_slice)}
    timed(phase_parity)
    launches["topk_head"] = timed(phase_topk_head)
    launches["fp8_probe"] = timed(phase_fp8_probe)
    timed(phase_rrg_routes)
    timed(phase_rrg_routes_parity)
    # not beside the RRG phases, whose launch-bound loops its CPU work slows
    start_cpu_helper()
    launches["vl"] = timed(phase_vl_slice)
    timed(phase_vl_parity)
    launches.update(timed(phase_vl_routes))
    timed(phase_vl_routes_parity)
    launches.update(timed(phase_vl_greedy_small_vocab))
    timed(phase_vl_greedy_small_vocab_parity)
    launches["vl_train"] = timed(phase_vl_train)
    timed(phase_vl_train_sanity)
    timed(phase_vl_train_parity)
    stop_cpu_helper()  # its last half is read
    with tempfile.TemporaryDirectory() as tmp:
        # the configs' pretrained tokenizers, read by name from this cache
        hub = write_hub_tokenizers(tmp)
        os.environ["HF_HUB_CACHE"] = hub
        launches["rrg_train"], batch = timed(phase_rrg_train, tmp)
        timed(phase_rrg_train_sanity, batch, launches["rrg_train"]["vocab"])
        timed(phase_rrg_train_parity, tmp)
        launches["scst_train"] = timed(phase_scst_train, tmp)
        launches["rrs_train"] = timed(phase_rrs_train, tmp)
        timed(phase_generation_parity, tmp)
        launches["pipelined_train"] = timed(phase_pipelined_train, tmp, card)
        launches["rrg_vit_train"] = timed(phase_rrg_vit_train, tmp, card)
        launches["mvqa_train"] = timed(phase_mvqa_train, tmp, card)
        launches["class_train"] = timed(phase_class_train, tmp, card)
        timed(phase_tower_parity, tmp)
        print(f"phases before rrg_roberta_serve: {time.perf_counter() - t_start:.1f} s")
        launches["rrg_roberta_serve"] = timed(phase_rrg_roberta_serve, tmp, card)
        timed(phase_roberta_parity, tmp)
        launches["convirt_train"] = timed(phase_convirt_train, tmp, card)
        launches["gloria_train"] = timed(phase_gloria_train, tmp, card)
        timed(phase_selfsup_parity, tmp)
        print(f"phases before rrg_hf_train: {time.perf_counter() - t_start:.1f} s")
        launches["rrg_hf_train"] = timed(phase_rrg_hf_train, tmp, card)
        launches["rrg_multi_image"] = timed(phase_rrg_multi_image, tmp, card)
        launches["rrs_hf_train"] = timed(phase_rrs_hf_train, tmp, card)
        timed(phase_hf_parity, tmp)
        print(f"phases before vl_cli_train: {time.perf_counter() - t_start:.1f} s")
        launches["vl_cli_train"], k1_beam2, k1_vl_cli = timed(phase_vl_cli_train, tmp, card)
        launches["vl_unfrozen_train"], rrg_dinov2 = timed(phase_vl_unfrozen_train, tmp, card)
        k5_tower = timed(hold_tower_flash_backward, card)
        timed(phase_vl_cli_parity, tmp)
        print(f"phases before clinical_validate: {time.perf_counter() - t_start:.1f} s")
        launches["clinical_validate"] = timed(phase_clinical_validate, tmp, card)
        print(f"phases before radeval_green: {time.perf_counter() - t_start:.1f} s")
        timed(phase_radeval_green, tmp, hub, card)
        print(f"phases before zoo: {time.perf_counter() - t_start:.1f} s")
        launches["zoo"] = timed(phase_zoo, tmp, hub, card)
        print(f"phases before dicom_serve: {time.perf_counter() - t_start:.1f} s")
        launches["dicom_serve"] = timed(phase_dicom_serve, tmp, card)
        launches["dist_train"] = timed(phase_dist_train, tmp, card)
        timed(phase_optimizers, card)
        launches["hf_dataset"] = timed(phase_hf_dataset, tmp, card)
        print(f"all phases: {time.perf_counter() - t_start:.1f} s; by phase "
              + json.dumps({k: round(v, 1) for k, v in PHASE_SECONDS.items()}))
    # K1 (b) on the VL CLI path: the Validator at beam 2, the ensemble CLI at 8
    results["fused_beam_cache_attention_stats"].update(
        beam2_max_abs_err=k1_beam2, vl_validator_beam2_launches=k1_vl_cli[0],
        vl_ensemble_beam8_launches=k1_vl_cli[1])
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        results[name]["tower_max_rel_err"] = k5_tower
    # K4 with LSE and K5 on the unfrozen DINOv2 tower (non-causal, T 1370)
    for name in (K4L, K5Q, K5KV):
        results[name]["tower_launches"] = rrg_dinov2[name]
    # the later paths' launches of the kernels they run (K1 stage a, K2,
    # K3): RRG training, SCST fine-tuning, the pipelined training paths
    # (K3 on the prefetch copy stream, the pipelined SCST run's Validator),
    # RRS training, RRG with the ViT
    # tower, MVQA and CLASS (none), the RoBERTa-width RRG serving, ConVIRT
    # and GLoRIA training (none), RRG_HF (single and multi-image) and RRS_HF
    # training, the RoBERTa RRG config's Validator with the clinical
    # scorers, the zoo-loaded RRG and DINOv2 tower, the DICOM-serving RRG,
    # the train CLI under a process group, and the hf_dataset Validator
    for path, key in (("rrg_train", "rrg_train_launches"), ("scst_train", "scst_launches"),
                      ("pipelined_train", "pipelined_launches"),
                      ("rrs_train", "rrs_launches"), ("rrg_vit_train", "rrg_vit_launches"),
                      ("mvqa_train", "mvqa_launches"), ("class_train", "class_launches"),
                      ("rrg_roberta_serve", "rrg_roberta_launches"),
                      ("convirt_train", "convirt_launches"), ("gloria_train", "gloria_launches"),
                      ("rrg_hf_train", "rrg_hf_launches"),
                      ("rrg_multi_image", "rrg_multi_image_launches"),
                      ("rrs_hf_train", "rrs_hf_launches"), ("vl_cli_train", "vl_cli_launches"),
                      ("vl_unfrozen_train", "vl_unfrozen_launches"),
                      ("clinical_validate", "clinical_launches"), ("zoo", "zoo_launches"),
                      ("dicom_serve", "dicom_serve_launches"),
                      ("dist_train", "dist_train_launches"),
                      ("hf_dataset", "hf_dataset_launches")):
        for name, counter in launches[path].items():
            if name in results:
                results[name][key] = counter

    # each kernel's launches are those of the path that runs it: the RRG
    # slice (K1 stage a, K2, K3), the VisionLanguage slice (K1 stage b, K4),
    # its int8-cache route (K1 stage c), its fused-prefix route (K1 stage d),
    # the VisionLanguage training phase (K4 with LSE, K5), K6's top-k head
    # and K7's fp8 probe
    keys = ("route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    # the flash kernels' head dims; K4/K5 at D 256; launches on the training paths
    extra = ("head_dims", "d256", "rrg_train_launches", "scst_launches", "pipelined_launches",
             "rrs_launches",
             "rrg_vit_launches", "mvqa_launches", "class_launches", "rrg_roberta_launches",
             "convirt_launches", "gloria_launches", "rrg_hf_launches", "rrg_multi_image_launches",
             "rrs_hf_launches", "vl_cli_launches", "vl_unfrozen_launches", "clinical_launches",
             "zoo_launches", "dicom_serve_launches", "dist_train_launches",
             "hf_dataset_launches", "tower_launches",
             "beam2_max_abs_err", "tower_max_rel_err", "vl_validator_beam2_launches",
             "vl_ensemble_beam8_launches")
    kernels = [{"name": name, **{key: launches[r["path"]][r["counter"]] if key == "launches"
                                 else r[key] for key in keys},
                **{key: r[key] for key in extra if key in r}}
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
    if sys.argv[1:2] == ["--cpu-halves"]:
        run_cpu_halves(sys.argv[2])
    else:
        main()
