"""Executor factories: the model and the training scheduler (port of part of
``executors/utils.py``).

``create_model`` builds the config's ``model:`` block through the port's
registry. The tokenizer and the HF config lookup are not ported, so what
they would supply (``vocab_size``, the special ids, ``vision_hf_config``)
comes in as keyword overrides. Data loaders (``create_data_loader``) and
checkpoint restore wait for ``data/`` and ``checkpoint.py``.
"""

from __future__ import annotations

from .. import registry
from ..config.config import Config
from .scheduler import TrainingScheduler


def create_model(config, seed: int = 0, device="cuda", **overrides):
    """Instantiate ``config.model`` (its ``proto``) with random weights from
    ``seed`` on ``device``: the card unless the caller names another."""
    from ..models import rrg, vision_language  # noqa: F401  (register the protos)

    return registry.build("model", config.model, seed=seed, device=device, **overrides)


def create_training_scheduler(config, base_lr: float, total_steps=None) -> TrainingScheduler:
    """The scheduler of an executor config (``lr_decay``,
    ``lr_decay_params``, ``early_stop_metric``, ``early_stop``); warmup from
    ``warmup_ratio`` counts ``total_steps`` microbatches, as in the JAX
    package."""
    params = config.get("lr_decay_params") or {}
    return TrainingScheduler(
        lr_decay_func=config.get("lr_decay"),
        base_lr=base_lr,
        early_stop_metric=config.get("early_stop_metric"),
        early_stop_limit=config.get("early_stop"),
        lr_decay_params=params.to_dict() if isinstance(params, Config) else dict(params),
        total_steps=total_steps,
    )
