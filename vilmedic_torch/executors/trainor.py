"""Trainor: the training executor on one device (port of
``executors/trainor.py``).

The step semantics of the JAX package (and of the reference torch trainer):

- ``grad_accu == 1``: :meth:`Trainor.train_step`, loss, backward and an
  update gated on the loss;
- ``grad_accu > 1``: :meth:`Trainor.grad_step` **sums** each microbatch's
  gradients into ``.grad`` with no division, and a non-finite microbatch
  resets the whole accumulation (on the device, no host read);
  :meth:`Trainor.apply_step` runs every ``grad_accu`` microbatches, gated on
  the boundary microbatch's loss, and a final partial accumulation is
  applied at the end of the epoch;
- a BatchNorm tower trains on batch statistics, and its running statistics
  take a step's batch statistics only when that step's loss is finite
  (``densenet.commit_batch_stats``, the JAX trainer's ``_gate_stats``);
- the learning rate is read from the scheduler every iteration, and
  ``scheduler.iteration_step`` runs once per update;
- losses are read on the host one microbatch late, for the epoch mean;
- frozen parameters take no gradient and are not in the optimizer, so they
  stay bitwise unchanged;
- a model with a ``train_iteration(trainor, batch, lr)`` owns its step
  (SCST: rollouts, host rewards, the policy-gradient update through this
  trainer's optimizer); it returns ``(loss on the device, log text)``, and
  the loss is read one iteration late like the others. Its
  ``finish_epoch(trainor, lr)``, where it has one, runs after the epoch's
  last batch and returns None or one more ``(loss, log text)``.

:meth:`Trainor.start` runs the JAX package's epoch loop
(``range(scheduler.epoch, epochs + 1)``): per epoch the loader's shuffle,
the steps, ``scheduler.epoch_step``, then from ``eval_start`` the
``evaluator`` (a :class:`~.validator.Validator`, set by the caller), the
early-stop score (``early_stop_metric`` averaged over the evaluated splits,
or ``training_loss``), ``scheduler.eval_step``, a best-only checkpoint, and
"Early stop reached". A ``ckpt`` key resumes the model, optimizer and
scheduler from a checkpoint.

Dropout masks come from one ``torch.Generator`` on the model's device,
seeded with the trainer's seed. The loader is the config's ``dataset:``
(``create_data_loader``, its shuffle and crops seeded by the config's
``seed:`` where it sets one, else by the trainer's seed), or an iterable of
batches with a length given as ``loader``.

``eval_only`` runs the evaluator alone, with no update; ``save_every_epoch``
also writes ``epoch_{epoch}_{seed}.ckpt`` (the same payload, written at once)
after each epoch; ``profile_dir`` traces iterations 3 to 5 of the first
epoch with ``torch.profiler`` (the card's kernels too) into
``profile_dir/trace_{seed}.json``, a Chrome trace. Not ported: multi-device
meshes and ``DevicePrefetch``; ``rng_impl`` (the JAX package's choice of PRNG
for its dropout masks) has no counterpart and is logged once and ignored.
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
import time

import torch

from .. import __version__
from ..blocks.vision.densenet import commit_batch_stats
from ..config.config import Config
from ..data.image import prepare_batch
from ..models.base import resolve_device
from ..models.evaluation_nlg import to_device
from .checkpoint import CheckpointSaver, load_checkpoint, save_checkpoint, snapshot
from .train_state import create_optimizer, gated_update
from .utils import create_data_loader, create_model, create_training_scheduler


class Trainor:
    def __init__(self, config, seed: int, loader=None, device="cuda", model_kwargs=None):
        """``config`` is the trainor view of an experiment config
        (``executor_config(config, "trainor")``: the ``trainor:`` keys plus
        ``model:``, ``dataset:`` and ``ckpt_dir``); ``loader`` replaces the
        config's data loader; ``model_kwargs`` are :func:`create_model`
        overrides. Trains on the card unless ``device`` names another."""
        self.config = config
        self.eval_only = bool(config.get("eval_only", False))
        self.save_every_epoch = bool(config.get("save_every_epoch", False))
        self.profile_dir = config.get("profile_dir")
        self.seed = seed
        self.device = resolve_device(device)
        self.logger = logging.getLogger(str(seed))
        if config.get("rng_impl"):
            self.logger.info(f"trainor key rng_impl={config.get('rng_impl')!r} has no effect: "
                             "dropout masks come from a torch.Generator")
        self.ckpt_dir = config.get("ckpt_dir")
        self.ckpt = config.get("ckpt")
        self.eval_start = config.get("eval_start", 0)
        self.decay_metric_start = config.get("decay_metric_start", 0)
        self.early_stop_start = config.get("early_stop_start", 0)
        self.grad_accu = int(config.get("grad_accu", 1) or 1)
        self.state_dict = load_checkpoint(self.ckpt) if self.ckpt else None
        self.saver = CheckpointSaver(self.ckpt_dir, self.logger, seed, ckpt=self.ckpt)

        self.dl = loader if loader is not None else create_data_loader(config, "train",
                                                                       self.logger, seed=seed)
        model_kwargs = dict(model_kwargs or {})
        if loader is None:
            model_kwargs["dl"] = self.dl
        self.model = create_model(config, logger=self.logger, state_dict=self.state_dict,
                                  seed=int(seed), device=device, **model_kwargs)

        optim_params = config.get("optim_params") or {}
        if isinstance(optim_params, Config):
            optim_params = optim_params.to_dict()
        self.base_lr = float(optim_params.get("lr"))
        self.tx = create_optimizer(
            config.get("optimizer", "Adam"), optim_params, config.get("clip_grad_norm"),
            frozen_prefixes=getattr(self.model, "frozen_prefixes", ()),
            named_parameters=self.model.module.named_parameters(),
        )
        if self.state_dict is not None and self.state_dict.get("opt_state"):
            self.tx.optimizer.load_state_dict(self.state_dict["opt_state"])
        self.training_scheduler = create_training_scheduler(
            config, self.base_lr, total_steps=len(self.dl) * int(config.get("epochs", 1)),
            state_dict=self.state_dict)
        # a resumed run's seed is the checkpoint name's text
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))
        self.evaluator = None  # set by the caller (bin/train.py)
        self.epoch_losses = []  # mean train loss per epoch

    # ------------------------------------------------------------------
    def _loss(self, batch) -> torch.Tensor:
        return self.model.apply_train(batch, self.generator)["loss"]

    def zero_grads(self) -> None:
        for p in self.tx.params:
            p.grad = None

    def train_step(self, batch, lr: float) -> torch.Tensor:
        """One microbatch, one gated update (``grad_accu == 1``). Returns the
        loss on the device."""
        self.zero_grads()
        loss = self._loss(batch)
        loss.backward()
        stepped = gated_update(self.tx, lr, loss)
        commit_batch_stats(self.model.module, stepped)
        return loss.detach()

    def grad_step(self, batch) -> torch.Tensor:
        """Add this microbatch's gradients to the accumulation in ``.grad``;
        a non-finite loss resets the accumulation to zero and keeps the
        running statistics. Returns the loss."""
        loss = self._loss(batch)
        loss.backward()
        good = torch.isfinite(loss.detach())
        for p in self.tx.params:
            if p.grad is not None:
                p.grad = torch.where(good, p.grad, torch.zeros((), dtype=p.grad.dtype,
                                                               device=p.grad.device))
        commit_batch_stats(self.model.module, good)
        return loss.detach()

    def apply_step(self, lr: float, gate_loss: torch.Tensor) -> bool:
        """Apply the accumulated gradients, gated on ``gate_loss``, and
        start a new accumulation. Returns whether it stepped."""
        stepped = gated_update(self.tx, lr, gate_loss)
        self.zero_grads()
        return stepped

    def _drain_loss(self, pending, losses, epoch: int) -> None:
        """Read a previous microbatch's loss (``(iteration, loss)``) on the
        host; non-finite losses are logged and left out of the mean."""
        if pending is None:
            return None
        it, device_loss = pending
        loss = float(device_loss)
        if math.isfinite(loss):
            losses.append(loss)
        else:
            self.logger.warning(f"NaN/Inf loss at epoch {epoch + 1}, iter {it}. Step skipped.")
        return None

    def _model_batch(self, batch):
        """The batch on the model's device, with the dataset's pending
        device preprocessing done (uint8 -> normalized float images)."""
        return prepare_batch(to_device(batch, self.device), getattr(self.dl, "dataset", None))

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int):
        """One pass over the loader; returns the finite microbatch losses."""
        scheduler = self.training_scheduler
        n = max(1, len(self.dl))
        losses, pending, iteration, loss, custom = [], None, 0, None, ""
        owned = hasattr(self.model, "train_iteration")
        t0 = time.perf_counter()
        self.zero_grads()
        profiler = self._profiler() if self.profile_dir and epoch == 0 else None
        with profiler or contextlib.nullcontext():
            for iteration, batch in enumerate(self.dl, start=1):
                batch = self._model_batch(batch)
                lr = scheduler.current_lr()
                if owned:
                    loss, custom = self.model.train_iteration(self, batch, lr)
                    pending = self._drain_loss(pending, losses, epoch)
                    pending = (iteration, loss)
                    scheduler.iteration_step(epoch + iteration / n)
                elif self.grad_accu == 1:
                    loss = self.train_step(batch, lr)
                    pending = self._drain_loss(pending, losses, epoch)
                    pending = (iteration, loss)
                    scheduler.iteration_step(epoch + iteration / n)
                else:
                    loss = self.grad_step(batch)
                    pending = self._drain_loss(pending, losses, epoch)
                    pending = (iteration, loss)
                    if iteration % self.grad_accu == 0:
                        self.apply_step(lr, loss)
                        scheduler.iteration_step(epoch + iteration / n)
                if iteration % 10 == 0 or iteration == n:
                    pending = self._drain_loss(pending, losses, epoch)
                    mean = sum(losses) / len(losses) if losses else float("nan")
                    eta = (time.perf_counter() - t0) / iteration * (n - iteration)
                    self.logger.info(
                        f"Epoch {epoch + 1}, Lr {scheduler.current_lr():.3g}, Loss {mean:.4f}, "
                        f"{scheduler.early_stop_metric} {scheduler.current_best_metric:.4g}, "
                        f"ES {scheduler.early_stop}, {iteration}/{n} it, ETA {eta:.0f}s {custom}")
                if profiler is not None:
                    profiler.step()
        tail = (self.model.finish_epoch(self, scheduler.current_lr())
                if hasattr(self.model, "finish_epoch") else None)
        if tail is not None:
            tail_loss, custom = tail
            pending = self._drain_loss(pending, losses, epoch)
            pending = (iteration, tail_loss)
        self._drain_loss(pending, losses, epoch)
        # the final partial accumulation (reference trainor.py:143-155)
        if not owned and self.grad_accu > 1 and iteration % self.grad_accu != 0 and losses:
            self.apply_step(scheduler.current_lr(), loss)
            scheduler.iteration_step(epoch + 1.0)
        return losses

    def _profiler(self):
        """A ``torch.profiler`` over iterations 3 to 5 (its steps 2 to 4,
        after one skipped and one warm-up step) that writes their Chrome
        trace into ``profile_dir``."""
        from torch.profiler import ProfilerActivity, profile, schedule

        path = os.path.join(self.profile_dir, f"trace_{self.seed}.json")

        def write(prof):
            os.makedirs(self.profile_dir, exist_ok=True)
            prof.export_chrome_trace(path)
            self.logger.info(f"profile of iterations 3-5 written to {path}")

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities, on_trace_ready=write,
                       schedule=schedule(skip_first=1, wait=0, warmup=1, active=3, repeat=1))

    def start(self) -> None:
        """The epoch loop, or with ``eval_only`` the evaluator alone; the
        background checkpoint writer is joined before it returns, whatever
        happens."""
        if self.eval_only:
            if self.evaluator is not None:
                self.evaluator.start()
            return
        try:
            self._run_epochs()
        finally:
            self.saver.wait()

    def _payload(self):
        """The checkpoint's keys, over the live state."""
        config = self.config
        return {
            "model": self.model.module.state_dict(),
            "opt_state": self.tx.optimizer.state_dict(),
            "training_scheduler": self.training_scheduler.state_dict(),
            "config": config.to_dict() if isinstance(config, Config) else dict(config),
            "__version__": __version__,
        }

    def _run_epochs(self) -> None:
        config, scheduler = self.config, self.training_scheduler
        early_stop_metric = config.get("early_stop_metric")
        for epoch in range(int(scheduler.epoch), int(config.epochs) + 1):
            if hasattr(self.dl, "set_epoch"):
                self.dl.set_epoch(epoch)
            losses = self.train_epoch(epoch)
            scheduler.epoch_step()
            training_loss = sum(losses) / len(losses) if losses else float("inf")
            self.epoch_losses.append(training_loss)

            early_stop_score, decay_metric = None, None
            do_early_stop = epoch + 1 >= self.early_stop_start
            if early_stop_metric == "training_loss" and do_early_stop:
                early_stop_score = training_loss
            if epoch + 1 >= self.eval_start and self.evaluator is not None:
                self.evaluator.epoch = epoch
                self.evaluator.start()
                if early_stop_metric != "training_loss" and do_early_stop:
                    scores = [s[early_stop_metric] for s in self.evaluator.scores]
                    early_stop_score = sum(scores) / len(scores)
            if epoch + 1 >= self.decay_metric_start:
                decay_metric = (training_loss if scheduler.decay_on_training_loss
                                else early_stop_score)

            ret = scheduler.eval_step(decay_metric=decay_metric,
                                      early_stop_score=early_stop_score)
            if self.save_every_epoch:
                path = os.path.join(self.ckpt_dir, f"epoch_{epoch + 1}_{self.seed}.ckpt")
                save_checkpoint(path, self._payload())
                self.logger.info(f"{path} saved.")
            if ret["save_state"]:
                self.saver.save(payload=snapshot(self._payload()), tag=early_stop_score,
                                current_epoch=epoch + 1)
            if ret["done_training"]:
                self.logger.info("Early stop reached")
                return
