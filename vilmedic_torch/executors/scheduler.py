"""Training scheduler: LR scheduling + linear warmup + early stopping, host-side.

A copy of the JAX package's ``executors/scheduler.py`` (pure Python, no JAX),
kept in the port so that the port never imports ``vilmedic_tpu``. Behavioral
port of the reference ``TrainingScheduler`` (reference
vilmedic/executors/utils.py:324-491) and its warmup wrapper (:270-321):
- three step granularities — per-iteration, per-epoch, per-validation — selected by
  scheduler name exactly as the reference's three scheduler sets (:328-332);
- linear warmup over the first ``warmup_steps`` iterations;
- early stopping on any metric with min/max mode inferred from the metric name
  (validation_loss/training_loss -> min, everything else -> max, :352-361);
- fully serializable for checkpoint resume.

The scheduler *computes* the learning rate; the trainer writes it into the
optimizer's parameter groups before every update
(``train_state.set_learning_rate``). A ``lr_decay`` name outside the three
sets (the VisionLanguage config's ``cosine``) leaves the rate constant after
warmup, as in the JAX package.
"""

from __future__ import annotations

import json
import math
import operator
from typing import Dict, Optional

ITER_STEP_SCHEDULERS = {"CyclicLR", "OneCycleLR", "CosineAnnealingWarmRestarts"}
EPOCH_STEP_SCHEDULERS = {
    "LambdaLR", "MultiplicativeLR", "StepLR", "MultiStepLR", "ConstantLR",
    "LinearLR", "ExponentialLR", "ChainedScheduler", "SequentialLR",
    "CosineAnnealingLR", "LinearWarmupCosineAnnealingLR",
    "DecreasingCosineAnnealingWarmRestarts",
}
VAL_STEP_SCHEDULERS = {"ReduceLROnPlateau"}


class TrainingScheduler:
    def __init__(
        self,
        lr_decay_func: Optional[str],
        base_lr: float,
        early_stop_metric: Optional[str],
        early_stop_limit: Optional[int],
        lr_decay_params: Optional[Dict] = None,
        total_steps: Optional[int] = None,
    ):
        self.epoch = 0
        self.iteration_count = 0
        self.scheduler_name = lr_decay_func
        self.base_lr = float(base_lr)

        # Early stopping configuration (reference :352-361)
        self.early_stop = 0
        self.early_stop_limit = early_stop_limit
        self.early_stop_metric = early_stop_metric
        if early_stop_metric in ("validation_loss", "training_loss"):
            self.metric_comp_func = operator.lt
            self.mode = "min"
            self.current_best_metric = float("inf")
        else:
            self.metric_comp_func = operator.gt
            self.mode = "max"
            self.current_best_metric = -float("inf")

        params = dict(lr_decay_params or {})
        self.decay_on_training_loss = params.pop("decay_on_training_loss", False)
        self.warmup_steps = int(params.pop("warmup_steps", 0) or 0)
        warmup_ratio = params.pop("warmup_ratio", None)
        if warmup_ratio is not None and total_steps:
            self.warmup_steps = max(self.warmup_steps, int(warmup_ratio * total_steps))
        self.use_warmup = self.warmup_steps > 0
        self.lr_decay_params = params

        # scheduler-internal state
        self._lr = self.base_lr
        self._plateau_best: Optional[float] = None
        self._plateau_bad = 0
        self._frac_epoch = 0.0

    # ------------------------------------------------------------------
    # LR computation
    # ------------------------------------------------------------------
    def current_lr(self) -> float:
        if self.use_warmup and self.iteration_count < self.warmup_steps:
            return self.base_lr * self.iteration_count / float(self.warmup_steps)
        return self._lr

    def _epoch_lr(self, epoch: float) -> float:
        """LR for epoch-indexed schedules (torch semantics per scheduler)."""
        name = self.scheduler_name
        p = self.lr_decay_params
        base = self.base_lr
        if name == "StepLR":
            return base * p.get("gamma", 0.1) ** (int(epoch) // int(p.get("step_size", 1)))
        if name == "MultiStepLR":
            milestones = sorted(p.get("milestones", []))
            passed = sum(1 for m in milestones if epoch >= m)
            return base * p.get("gamma", 0.1) ** passed
        if name == "ExponentialLR":
            return base * p.get("gamma", 0.9) ** int(epoch)
        if name == "ConstantLR":
            total = p.get("total_iters", 5)
            return base * p.get("factor", 1.0 / 3) if epoch < total else base
        if name == "LinearLR":
            start = p.get("start_factor", 1.0 / 3)
            end = p.get("end_factor", 1.0)
            total = p.get("total_iters", 5)
            t = min(epoch, total) / float(total)
            return base * (start + (end - start) * t)
        if name == "CosineAnnealingLR":
            t_max = p.get("T_max", 50)
            eta_min = p.get("eta_min", 0.0)
            return eta_min + (base - eta_min) * (1 + math.cos(math.pi * epoch / t_max)) / 2
        if name == "LinearWarmupCosineAnnealingLR":
            # pl-bolts port (reference blocks/schedulers/LinearWarmupCosineAnnealingLR.py:11)
            warm = p.get("warmup_epochs", 10)
            max_e = p.get("max_epochs", 100)
            w_start = p.get("warmup_start_lr", 0.0)
            eta_min = p.get("eta_min", 0.0)
            if epoch < warm:
                return w_start + (base - w_start) * epoch / max(1, warm)
            t = (epoch - warm) / max(1, max_e - warm)
            return eta_min + (base - eta_min) * (1 + math.cos(math.pi * t)) / 2
        if name in ("CosineAnnealingWarmRestarts", "DecreasingCosineAnnealingWarmRestarts"):
            t0 = p.get("T_0", 10)
            t_mult = p.get("T_mult", 1)
            eta_min = p.get("eta_min", 0.0)
            t_cur, t_i, cycle = epoch, t0, 0
            while t_cur >= t_i:
                t_cur -= t_i
                t_i *= t_mult
                cycle += 1
            amp = base * (p.get("decay", 0.5) ** cycle) if name.startswith("Decreasing") else base
            return eta_min + (amp - eta_min) * (1 + math.cos(math.pi * t_cur / t_i)) / 2
        return self._lr

    # ------------------------------------------------------------------
    # Step hooks (reference :396-458)
    # ------------------------------------------------------------------
    def iteration_step(self, epoch_value: Optional[float] = None) -> None:
        self.iteration_count += 1
        if self.scheduler_name in ITER_STEP_SCHEDULERS:
            if not self.use_warmup or self.iteration_count > self.warmup_steps:
                self._frac_epoch = (
                    epoch_value if epoch_value is not None else self._frac_epoch + 1
                )
                self._lr = self._epoch_lr(self._frac_epoch)

    def epoch_step(self) -> None:
        self.epoch += 1
        if self.scheduler_name in EPOCH_STEP_SCHEDULERS:
            self._lr = self._epoch_lr(self.epoch)

    def _plateau_step(self, metric: float) -> None:
        p = self.lr_decay_params
        threshold = p.get("threshold", 1e-4)
        threshold_mode = p.get("threshold_mode", "rel")
        mode = p.get("mode", self.mode)
        factor = p.get("factor", 0.1)
        patience = p.get("patience", 10)
        min_lr = p.get("min_lr", 0.0)

        def improved(current, best):
            if mode == "min":
                if threshold_mode == "rel":
                    return current < best * (1 - threshold)
                return current < best - threshold
            if threshold_mode == "rel":
                return current > best * (1 + threshold)
            return current > best + threshold

        if self._plateau_best is None or improved(metric, self._plateau_best):
            self._plateau_best = metric
            self._plateau_bad = 0
        else:
            self._plateau_bad += 1
            if self._plateau_bad > patience:
                self._lr = max(self._lr * factor, min_lr)
                self._plateau_bad = 0

    def eval_step(
        self,
        decay_metric: Optional[float] = None,
        early_stop_score: Optional[float] = None,
    ) -> Dict[str, bool]:
        ret = {"done_training": False, "save_state": False}

        if decay_metric is not None and self.scheduler_name in VAL_STEP_SCHEDULERS:
            if not self.use_warmup or self.iteration_count > self.warmup_steps:
                self._plateau_step(float(decay_metric))

        if early_stop_score is not None:
            if self.metric_comp_func(early_stop_score, self.current_best_metric):
                self.current_best_metric = early_stop_score
                self.early_stop = 0
                ret["save_state"] = True
            else:
                self.early_stop += 1
                if self.early_stop == self.early_stop_limit:
                    ret["done_training"] = True
        return ret

    # ------------------------------------------------------------------
    # Serialization
    # ------------------------------------------------------------------
    def state_dict(self) -> Dict:
        return {
            k: v
            for k, v in self.__dict__.items()
            if k != "metric_comp_func"
        }

    def load_state_dict(self, state: Dict) -> None:
        state = dict(state)
        state.pop("metric_comp_func", None)
        self.__dict__.update(state)
        self.metric_comp_func = operator.lt if self.mode == "min" else operator.gt

    def __repr__(self):
        return "TrainingScheduler(\n" + json.dumps(
            {
                "scheduler": self.scheduler_name,
                "params": self.lr_decay_params,
                "warmup_steps": self.warmup_steps,
                "base_lr": self.base_lr,
                "early_stop_limit": self.early_stop_limit,
                "mode": self.mode,
                "current_best_metric": self.current_best_metric,
                "decay_on_training_loss": self.decay_on_training_loss,
            },
            indent=4,
            default=str,
        ) + "\n)"
