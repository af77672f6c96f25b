"""Validator: the per-split evaluation executor (port of
``executors/validator.py``).

One loader per split of the config's ``splits`` (``["val"]`` when none is
given); :meth:`Validator.start` runs the models' ``eval_func`` on each,
scores its refs and hyps with :func:`~vilmedic_torch.scorers.compute_scores`
and records ``{"validation_loss", <metrics>}`` per split in ``scores``
(the clinical scorers' and ``bertscore``'s networks on the models'
device), then runs the config's ``post_processing`` steps
(:mod:`~vilmedic_torch.scorers.post_processing`) on the split's results.
Unported metrics, unknown post-processing steps and steps whose packages
are missing raise when the Validator is built, before any training. The
``eval_func`` is told ``from_training``, as in the JAX package (the
ensemble CLI passes False: SELFSUP models then also return their
embeddings).

In a multi-process run each process evaluates its shard of every split:
the loss is gathered as a sample-weighted mean, refs and hyps (strings, or
a classifier's arrays) in process order, process 0 scores them and runs the
post-processing, and its scores are broadcast so every process takes the
same early-stop and checkpoint decisions.
"""

from __future__ import annotations

import json
import logging

import numpy as np

from ..parallel import mesh
from ..scorers.post_processing import check_post_processing, post_processing
from ..scorers.scores import check_metrics, compute_scores
from .utils import create_data_loader, get_eval_func


class Validator:
    def __init__(self, config, models, seed=None, from_training: bool = True):
        self.seed = seed
        self.config = config
        self.logger = logging.getLogger(str(seed))
        self.models = models
        self.from_training = from_training
        self.epoch = 0
        self.scores = []
        metrics = config.get("metrics", []) or []
        self.metrics = list(metrics) if isinstance(metrics, (list, tuple)) else [metrics]
        check_metrics(self.metrics)
        self.post_processing = config.get("post_processing")
        check_post_processing(self.post_processing)
        splits = config.get("splits")
        if splits is None:
            self.logger.warning("No splits defined in config, using ['val'] as default")
            splits = ["val"]
        self.splits = [(split, create_data_loader(config, split, self.logger,
                                                  called_by_validator=True,
                                                  called_by_ensemblor=not from_training,
                                                  seed=seed))
                       for split in splits]

    @property
    def device(self):
        """The models' device, where a scorer with a network runs."""
        module = getattr(self.models[0], "module", None)
        param = next(module.parameters(), None) if module is not None else None
        return param.device if param is not None else None

    def start(self):
        self.scores = []
        for split, dl in self.splits:
            self.logger.info(f"Running split: {split} by ensembling {len(self.models)} models.")
            results = get_eval_func(self.models)(models=self.models, config=self.config, dl=dl,
                                                 from_training=self.from_training)
            if not any(key in results for key in ("loss", "refs", "hyps")):
                raise ValueError("the evaluation function returned no evaluation keys")
            refs, hyps = results.pop("refs", None), results.pop("hyps", None)
            loss = float(results.pop("loss", 0.0))
            if mesh.process_count() > 1:
                loss = mesh.gather_weighted_mean(loss, len(refs) if isinstance(refs, list) else 1.0)
                refs, hyps = _gather(refs), _gather(hyps)
            scores = {"validation_loss": loss}
            if mesh.process_index() == 0:
                scores.update(compute_scores(
                    metrics=self.metrics, refs=refs, hyps=hyps, split=split, seed=self.seed,
                    config=self.config, epoch=self.epoch, logger=self.logger,
                    device=self.device))
                if self.post_processing:
                    post_processing(self.post_processing, results=results, split=split,
                                    seed=self.seed, ckpt_dir=self.config.get("ckpt_dir"),
                                    epoch=self.epoch, dl=dl)
                self.logger.info(json.dumps(scores, indent=4, sort_keys=False, default=str))
            if mesh.process_count() > 1:
                scores = mesh.broadcast_json(scores)
            self.scores.append(scores)
        return self.scores


def _gather(x):
    """Every process's strings or arrays, in process order."""
    if isinstance(x, list):
        return mesh.gather_string_lists(x)
    if isinstance(x, np.ndarray):
        return mesh.gather_arrays(x)
    return x
