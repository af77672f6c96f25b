"""The port's pipelined training input on the CPU, against the JAX package.

- ``DevicePrefetch`` (``vilmedic_torch/data/loader.py``) on the JAX
  package's own cases (``tests/test_data.py``), run on both packages'
  classes: batches in order through the placement, the producer running
  ``depth`` batches ahead of a slow consumer, a placement's or the loader's
  exception raised on the consumer, and an early stop that ends the
  producer thread and closes the loader's iterator; and the port's with
  the interpreter switching threads every microsecond;
- the ``Trainor`` at ``device_prefetch`` 0 and 2 (the default): a tiny
  RRG with ``device_preproc`` uint8 batches (the crop+normalize kernel's
  plain version), dropout on and a threaded loader gives bitwise equal
  losses, parameters and optimizer state over 3 steps;
- the epoch loop does not read a ``None`` loss from a model that owns its
  step (the pipelined SCST's warm-up), and the scheduler still steps;
- ``donate_state`` and ``allow_device_subset`` are logged as having no
  effect.
"""

import logging
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

import vilmedic_torch.blocks.vision.densenet as tdensenet
import vilmedic_torch.executors.trainor as trainor_module
from vilmedic_torch.config.config import Config
from vilmedic_torch.data.loader import DevicePrefetch as TDevicePrefetch
from vilmedic_torch.executors import Trainor
from vilmedic_tpu.data.loader import DevicePrefetch as JDevicePrefetch

PREFETCH = {"jax": JDevicePrefetch, "torch": TDevicePrefetch}
REPORTS = ["no acute disease .", "heart size is normal .", "small pleural effusion .",
           "lungs are clear .", "mild cardiomegaly .", "no evidence of pneumonia ."]


@pytest.mark.parametrize("package", sorted(PREFETCH))
def test_device_prefetch_keeps_order(package):
    batches = [{"x": np.full((2, 3), i, np.float32)} for i in range(6)]
    out = list(PREFETCH[package](batches, lambda b: {"x": b["x"] + 1}, depth=2))
    assert [float(b["x"][0, 0]) for b in out] == [i + 1 for i in range(6)]


@pytest.mark.parametrize("package", sorted(PREFETCH))
def test_device_prefetch_runs_ahead(package):
    batches = [{"x": np.zeros(1)} for _ in range(6)]
    placed = []

    def place(b):
        placed.append(1)
        return b

    it = iter(PREFETCH[package](batches, place, depth=2))
    next(it)
    time.sleep(0.15)  # the producer fills the queue meanwhile
    assert len(placed) >= 3  # the one consumed and two queued
    assert len(list(it)) == 5


@pytest.mark.parametrize("package", sorted(PREFETCH))
def test_device_prefetch_raises_on_the_consumer(package):
    batches = [{"x": np.zeros(1)} for _ in range(4)]

    def bad_place(b):
        raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):
        list(PREFETCH[package](batches, bad_place))

    def loader():
        yield batches[0]
        raise OSError("unreadable image")

    with pytest.raises(OSError, match="unreadable image"):
        list(PREFETCH[package](loader(), lambda b: b))


@pytest.mark.parametrize("package", sorted(PREFETCH))
def test_device_prefetch_early_exit(package):
    """Closing the consumer after one batch ends the producer thread (and,
    in the port, closes the loader's iterator)."""
    closed = []

    def loader():
        try:
            for _ in range(100):
                yield {"x": np.zeros(1)}
        finally:
            closed.append(True)

    before = threading.active_count()
    it = iter(PREFETCH[package](loader(), lambda b: b, depth=2))
    next(it)
    it.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before
    if package == "torch":
        assert closed == [True]


def test_device_prefetch_under_thread_switching():
    """The port's prefetcher with the interpreter switching threads every
    microsecond: at depths 1 to 3, 200 batches come out complete and in
    order, and a consumer that stops early at several points leaves no
    thread behind."""
    import sys

    batches = [{"x": np.full(64, i)} for i in range(200)]
    before = threading.active_count()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for depth in (1, 2, 3):
            out = [int(b["x"][0]) for b in TDevicePrefetch(
                batches, lambda b: {"x": b["x"] * 1}, depth=depth)]
            assert out == list(range(200))
            for stop_at in (0, 1, 57):
                it = iter(TDevicePrefetch(batches, lambda b: b, depth=depth))
                for _ in range(stop_at + 1):
                    next(it)
                it.close()
    finally:
        sys.setswitchinterval(interval)
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before


# ----------------------------------------------------------- the Trainor


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("prefetch")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(12):
        p = root / f"im{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (48, 48, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    (root / "train.report.tok").write_text("\n".join(REPORTS * 2))
    (root / "train.image.tok").write_text("\n".join(paths))
    return root


def _rrg_config(root, **trainor):
    decoder = dict(proto=None, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
                   intermediate_size=64, max_position_embeddings=64, hidden_dropout_prob=0.1)
    cnn = dict(proto="VisualEncoder", backbone="densenet_tiny", output_layer="features",
               dropout_out=0.1, permute="batch_first",
               visual_projection={"in_features": 32, "out_features": 32}, freeze=False)
    return Config({
        "ckpt_dir": str(root), "seed": 7,
        "dataset": {"proto": "ImSeq",
                    "image": {"root": str(root), "file": "image.tok", "resize": 40, "crop": 32,
                              "ext": ".jpg", "device_preproc": True},
                    "seq": {"root": str(root), "file": "report.tok", "source": "tgt",
                            "tokenizer_max_len": 12},
                    "num_workers": 2},
        "model": {"proto": "RRG", "decoder": decoder, "cnn": cnn, "dtype": "float32"},
        "batch_size": 4, "optimizer": "RAdam", "optim_params": {"lr": 1e-3}, "epochs": 0,
        **trainor})


def test_trainor_prefetch_is_bitwise_the_synchronous_placement(corpus, monkeypatch):
    monkeypatch.setitem(tdensenet.CONFIGS, "densenet_tiny", (8, (2, 2), 16))
    runs = {}
    for depth in (0, 2, None):
        extra = {} if depth is None else {"device_prefetch": depth}
        trainer = Trainor(_rrg_config(corpus, **extra), seed=7, device="cpu")
        assert len(trainer.dl) == 3
        losses = trainer.train_epoch(0)
        runs[depth] = (trainer.device_prefetch, losses, trainer.model.module.state_dict(),
                       trainer.tx.optimizer.state_dict()["state"])
    assert runs[None][0] == 2  # the default
    (_, l0, s0, o0), (_, l2, s2, o2) = runs[0], runs[2]
    assert len(l0) == 3 and l0 == l2 == runs[None][1]
    assert s0.keys() == s2.keys()
    assert all(torch.equal(s0[k], s2[k]) for k in s0)
    assert o0.keys() == o2.keys()
    for k in o0:
        assert all(torch.equal(v, o2[k][n]) for n, v in o0[k].items())


# ------------------------------------------ owned steps, keys without effect


class _Owned:
    """A model that owns its step; its first iteration returns no loss."""
    module = torch.nn.Linear(2, 2)
    frozen_prefixes = ()

    def __init__(self):
        self.calls = []

    def train_iteration(self, trainor, batch, lr):
        self.calls.append(float(batch["x"][0]))
        if len(self.calls) == 1:
            return None, ""
        return torch.tensor(float(batch["x"][0])), "text"

    def finish_epoch(self, trainor, lr):
        return torch.tensor(10.0), "tail"


def _owned_trainer(monkeypatch, **keys):
    config = Config({"model": {"proto": "unused"}, "optimizer": "Adam",
                     "optim_params": {"lr": 1e-3}, "epochs": 0, **keys})
    monkeypatch.setattr(trainor_module, "create_model", lambda *a, **k: _Owned())
    batches = [{"x": torch.tensor([float(i)])} for i in (1, 2, 3)]
    return Trainor(config, seed=0, loader=batches, device="cpu")


def test_owned_step_without_a_loss_is_not_read(monkeypatch):
    trainer = _owned_trainer(monkeypatch)
    assert trainer.train_epoch(0) == [2.0, 3.0, 10.0]
    assert trainer.model.calls == [1.0, 2.0, 3.0]
    assert trainer.training_scheduler.iteration_count == 3


def test_keys_without_effect_are_logged(monkeypatch, caplog):
    with caplog.at_level(logging.INFO, logger="0"):
        _owned_trainer(monkeypatch, donate_state=True, allow_device_subset=True,
                       rng_impl="rbg")
    said = [r.getMessage() for r in caplog.records if "has no effect" in r.getMessage()]
    assert [m.split("=")[0] for m in said] == [
        "trainor key rng_impl", "trainor key donate_state", "trainor key allow_device_subset"]
