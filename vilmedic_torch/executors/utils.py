"""Executor factories: data loaders, models, the training scheduler (port of
``executors/utils.py``).

``create_data_loader`` builds the config's ``dataset:`` block through the
port's registry (``ImSeq``, ``Seq2Seq``, ``ImLabel``, ``ImSeqAny``) and
wraps it in the port's ``DataLoader``: shuffled with ``drop_last`` for the
train split, in order otherwise. ``create_model`` builds ``model:``
(``RRG``, ``RRG_FORCE``, ``RRG_SCST``, ``RRS``, ``RRS_SCST``,
``VisionLanguage``, ``MVQA``, ``ConVIRT``, ``GLoRIA``) with the loader (the
models take their vocabulary sizes from its tokenizers, a ViT tower its
crop, MVQA its label map) and restores a checkpoint's ``model`` state dict when given one.
"""

from __future__ import annotations

import copy
import logging

from .. import registry
from ..config.config import Config
from ..utils.logger import SETTINGS_LEVEL
from .scheduler import TrainingScheduler


def _as_dict(cfg):
    return cfg.to_dict() if isinstance(cfg, Config) else dict(cfg)


def get_eval_func(models):
    if not hasattr(models[0], "eval_func"):
        raise TypeError(f"{type(models[0]).__name__} has no eval_func")
    return models[0].eval_func


def create_data_loader(config, split: str, logger=None, called_by_validator: bool = False,
                       called_by_ensemblor: bool = False, seed=None):
    """The loader of ``config.dataset`` for ``split``: the config's
    ``batch_size``, ``num_workers`` (default 4) from the dataset block, and
    a seed for the shuffle and the image transforms' draws: the config's
    ``seed`` where it sets one, else ``seed`` (the run's seed, which the
    caller passes), else 0."""
    from ..data import composites  # noqa: F401  (registers the composite datasets)
    from ..data.loader import DataLoader

    logger = logger or logging.getLogger(__name__)
    dataset_config = _as_dict(copy.deepcopy(config.dataset))
    proto = dataset_config.pop("proto")
    num_workers = dataset_config.pop("num_workers", 4)
    if config.get("seed") is not None:
        seed = config.get("seed")
    seed = int(seed or 0)
    dataset = registry.get("dataset", proto)(
        split=split, ckpt_dir=config.get("ckpt_dir"), called_by_ensemblor=called_by_ensemblor,
        seed=seed, **dataset_config)
    is_train = split == "train" and not called_by_validator
    if not called_by_validator or called_by_ensemblor:
        logger.log(SETTINGS_LEVEL, "DataLoader")
        logger.info(dataset)
    return DataLoader(dataset, batch_size=int(config.get("batch_size", 1) or 1),
                      shuffle=is_train, drop_last=is_train, num_workers=num_workers, seed=seed)


def create_model(config, dl=None, logger=None, state_dict=None, seed: int = 0, device="cuda",
                 **overrides):
    """Instantiate ``config.model`` (its ``proto``) with random weights from
    ``seed`` on ``device`` (the card unless the caller names another), with
    the loader ``dl`` where the model reads its vocabulary from one; then
    load a checkpoint's ``model`` state dict if ``state_dict`` holds one.
    ``overrides`` stand in for what a tokenizer or HF config would supply
    (``vocab_size``, the special ids, ``vision_hf_config``)."""
    from ..models import (  # noqa: F401  (register the protos)
        hf_compat, mvqa, rrg, rrg_force, rrs, scst_models, selfsup, vision_language,
    )

    logger = logger or logging.getLogger(__name__)
    if dl is not None:
        overrides["dl"] = dl
    model = registry.build("model", config.model, seed=seed, device=device, **overrides)
    if state_dict is not None:
        if "model" not in state_dict:
            raise ValueError('this checkpoint is not valid: key "model" is missing')
        model.module.load_state_dict(state_dict["model"], strict=True)
        logger.info("Model state loaded")
    else:
        n_params = sum(p.numel() for p in model.module.parameters())
        logger.info(f"{model} [{n_params:,} params]")
    return model


def create_training_scheduler(config, base_lr: float, total_steps=None,
                              state_dict=None) -> TrainingScheduler:
    """The scheduler of an executor config (``lr_decay``,
    ``lr_decay_params``, ``early_stop_metric``, ``early_stop``); warmup from
    ``warmup_ratio`` counts ``total_steps`` microbatches, as in the JAX
    package. A checkpoint's ``training_scheduler`` state is restored when
    ``state_dict`` holds one."""
    params = config.get("lr_decay_params") or {}
    scheduler = TrainingScheduler(
        lr_decay_func=config.get("lr_decay"),
        base_lr=base_lr,
        early_stop_metric=config.get("early_stop_metric"),
        early_stop_limit=config.get("early_stop"),
        lr_decay_params=_as_dict(params),
        total_steps=total_steps,
    )
    if state_dict is not None and "training_scheduler" in state_dict:
        scheduler.load_state_dict(state_dict["training_scheduler"])
    return scheduler
