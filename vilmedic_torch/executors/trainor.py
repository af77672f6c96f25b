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
- the learning rate is read from the scheduler every iteration, and
  ``scheduler.iteration_step`` runs once per update;
- losses are read on the host one microbatch late, for the epoch mean;
- frozen parameters take no gradient and are not in the optimizer, so they
  stay bitwise unchanged.

Dropout masks come from one ``torch.Generator`` on the model's device,
seeded with the trainer's seed. The loader is a constructor argument, an
iterable of ``{"images", "input_ids", "attention_mask"}`` batches (what the
JAX trainer's ``_device_batches`` yields) with a length, until ``data/`` is
ported. Not ported: checkpointing, the ``Validator`` and evaluation-driven
early stopping, multi-device meshes, ``DevicePrefetch``, profiling and the
CLI.
"""

from __future__ import annotations

import logging
import math

import torch

from ..config.config import Config
from .train_state import create_optimizer, gated_update
from .utils import create_model, create_training_scheduler


class Trainor:
    def __init__(self, config, seed: int, loader, device="cpu", model_kwargs=None):
        """``config`` is the trainor view of an experiment config
        (``executor_config(config, "trainor")``: the ``trainor:`` keys plus
        ``model:``); ``model_kwargs`` are :func:`create_model` overrides."""
        self.config = config
        self.seed = seed
        self.device = torch.device(device)
        self.grad_accu = int(config.get("grad_accu", 1) or 1)
        self.logger = logging.getLogger(str(seed))
        self.dl = loader
        self.model = create_model(config, seed=seed, device=device, **(model_kwargs or {}))

        optim_params = config.get("optim_params") or {}
        if isinstance(optim_params, Config):
            optim_params = optim_params.to_dict()
        self.base_lr = float(optim_params.get("lr"))
        self.tx = create_optimizer(
            config.get("optimizer", "Adam"), optim_params, config.get("clip_grad_norm"),
            frozen_prefixes=getattr(self.model, "frozen_prefixes", ()),
            named_parameters=self.model.module.named_parameters(),
        )
        self.training_scheduler = create_training_scheduler(
            config, self.base_lr, total_steps=len(self.dl) * int(config.get("epochs", 1)))
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
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
        gated_update(self.tx, lr, loss)
        return loss.detach()

    def grad_step(self, batch) -> torch.Tensor:
        """Add this microbatch's gradients to the accumulation in ``.grad``;
        a non-finite loss resets the accumulation to zero. Returns the loss."""
        loss = self._loss(batch)
        loss.backward()
        good = torch.isfinite(loss.detach())
        for p in self.tx.params:
            if p.grad is not None:
                p.grad = torch.where(good, p.grad, torch.zeros((), dtype=p.grad.dtype,
                                                               device=p.grad.device))
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

    def _to_device(self, batch):
        return {k: v.to(self.device, non_blocking=True) for k, v in batch.items()}

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int):
        """One pass over the loader; returns the finite microbatch losses."""
        scheduler = self.training_scheduler
        n = max(1, len(self.dl))
        losses, pending, iteration, loss = [], None, 0, None
        self.zero_grads()
        for iteration, batch in enumerate(self.dl, start=1):
            batch = self._to_device(batch)
            lr = scheduler.current_lr()
            if self.grad_accu == 1:
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
        self._drain_loss(pending, losses, epoch)
        # the final partial accumulation (reference trainor.py:143-155)
        if self.grad_accu > 1 and iteration % self.grad_accu != 0 and losses:
            self.apply_step(scheduler.current_lr(), loss)
            scheduler.iteration_step(epoch + 1.0)
        return losses

    def start(self) -> None:
        """The epoch loop (``range(scheduler.epoch, epochs + 1)``, as the
        reference counts it), without evaluation or checkpoints."""
        scheduler = self.training_scheduler
        for epoch in range(int(scheduler.epoch), int(self.config.epochs) + 1):
            losses = self.train_epoch(epoch)
            self.epoch_losses.append(sum(losses) / len(losses) if losses else float("inf"))
            scheduler.epoch_step()
