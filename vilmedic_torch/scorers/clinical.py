"""Scorers that need model weights (port of the ``BertScore`` part of
``scorers/clinical.py``).

Weights are never fetched: a scorer whose weights are not on disk raises
``ScorerUnavailable``, which ``compute_scores`` turns into a ``None`` metric
with the error logged, as the JAX package does. :class:`BertScore` runs its
encoder on the card unless the caller names another device. The JAX
package's other clinical scorers (CheXbert, RadGraph, the entity metrics,
GREEN, ``radevalbertscore``) are not ported.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np


class ScorerUnavailable(RuntimeError):
    pass


def _require(condition: bool, what: str):
    if not condition:
        raise ScorerUnavailable(
            f"{what} requires model weights that are not available in this "
            f"environment; place them under the HF cache or $VILMEDIC_TPU_CACHE.")


class BertScore:
    """BERTScore F1: distilbert-base-uncased, layer 5, idf off, rescaled
    with the baseline (the reference's configuration). ``BERTSCORE_MODEL``
    (or ``$VILMEDIC_WEIGHTS_DIR/bertscore/model``) names a local model
    directory in place of the model name; a name is looked up in the HF hub
    cache. Calls return ``(mean F1, per-pair F1)``."""

    def __init__(self, model_type: str = "distilbert-base-uncased", idf: bool = False,
                 rescale_with_baseline: bool = True, device="cuda", **kwargs):
        from ..models.base import local_hf_config_dir
        from .weights import resolve

        self.model_type = resolve("BERTSCORE_MODEL", model_type)
        self.idf = idf
        self.rescale_with_baseline = rescale_with_baseline
        self.device = device
        if not os.path.isdir(self.model_type):
            _require(local_hf_config_dir(self.model_type) is not None, "BertScore")

    def __call__(self, refs: List[str], hyps: List[str]) -> Tuple[float, List[float]]:
        from .bertscore_impl import bert_score_f1

        scores = bert_score_f1(self.model_type, refs, hyps, idf=self.idf,
                               rescale_with_baseline=self.rescale_with_baseline,
                               device=self.device)
        return float(np.mean(scores)), scores
