"""Time each pipelined training path of the PyTorch port against its
synchronous arm on one NVIDIA card:

    python3 time_pipelined.py

- the flagship RRG config through the train CLI (``chip_smoke.py``'s
  ``rrg_train`` setup: bf16, batch 128, ``device_preproc``, 512 synthetic
  reports from seed 0), then more epochs on the same trainer with the
  trainor's ``device_prefetch`` at 0 (off) and 2 (on);
- the SCST config (``config/RRG/rrg-scst-mimic.yml``, batch 32, 128 of
  those reports, from that run's checkpoint) through the train CLI, then
  more epochs on the same trainer, serial (off) and with
  ``overlap_rollout`` (on).

After one warm-up epoch, the arms take whole epochs in turns (off, on, on,
off, three times); each epoch is timed on the host clock between two
synchronizes. Prints each arm's epoch seconds, their median and rate, and
in how many pairs the pipelined arm was faster, beside the card's name and
power limit.
"""

from __future__ import annotations

import glob
import os
import shutil
import statistics
import sys
import tempfile
import time

ORDER = (False, True, True, False) * 3


def time_arms(trainor, set_arm, label: str) -> None:
    """Whole epochs of ``trainor`` in the arms of :data:`ORDER` after a
    warm-up epoch; ``set_arm(on)`` switches the arm between epochs."""
    import torch

    items = len(trainor.dl) * int(trainor.config.batch_size)
    times = {False: [], True: []}
    trainor.dl.set_epoch(0)
    trainor.train_epoch(0)
    for epoch, on in enumerate(ORDER, start=1):
        set_arm(on)
        trainor.dl.set_epoch(epoch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainor.train_epoch(epoch)
        torch.cuda.synchronize()
        times[on].append(time.perf_counter() - t0)
    print(label)
    for on, ts in times.items():
        med = statistics.median(ts)
        print(f"  {'on' if on else 'off'}: epochs {[round(t, 3) for t in ts]} s, median "
              f"{med:.3f} s, {items / med:.1f} items/s")
    wins = sum(b < a for a, b in zip(times[False], times[True]))
    print(f"  on faster in {wins} of {len(times[True])} pairs", flush=True)


def main():
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    os.chdir(root)  # the configs' includes are relative to the repository root
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_pipelined.py needs an NVIDIA GPU")
    import chip_smoke as c
    from vilmedic_torch.bin.train import main as train
    from vilmedic_torch.ops import cuda_lib

    print(c.card_name(), flush=True)
    cuda_lib.lib()
    c.set_tf32(False)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "rrg_data")
        c.synthetic_corpus(data, c.RRG_TRAIN, c.RRG_VALIDATE, c.SEED, 256)
        trainor = train(c.rrg_train_overrides(data, tmp, "rrg_train", "cuda"))
        time_arms(trainor, lambda on: setattr(trainor, "device_prefetch", 2 if on else 0),
                  f"RRG bf16 batch {trainor.config.batch_size}, {len(trainor.dl)} steps an "
                  "epoch: device_prefetch 0 (off) / 2 (on)")
        del trainor
        torch.cuda.empty_cache()
        scst_data = os.path.join(tmp, "scst_data")
        c.scst_corpus(data, scst_data, c.SCST_TRAIN)
        ckpt = glob.glob(os.path.join(tmp, "rrg_train", "*.ckpt"))[0]
        os.makedirs(os.path.join(tmp, "scst"))
        shutil.copy(os.path.join(tmp, "rrg_train", "vocab.tgt"), os.path.join(tmp, "scst"))
        trainor = train(c.scst_overrides(scst_data, tmp, "scst", "cuda", ckpt))
        time_arms(trainor, lambda on: setattr(trainor.model, "overlap_rollout", on),
                  f"SCST bf16 batch {trainor.config.batch_size}, {len(trainor.dl)} iterations "
                  "an epoch: serial (off) / overlap_rollout (on)")


if __name__ == "__main__":
    main()
