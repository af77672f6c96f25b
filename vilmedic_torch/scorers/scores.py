"""Metric dispatch and the SCST rewards (port of ``compute_scores`` and
``REWARD_COMPLIANT`` of ``scorers/scores.py``).

``REWARD_COMPLIANT`` maps each ported reward name (``rougel``, ``rouge1``,
``rouge2``, ``bleu``, ``meteor``, ``ciderdrl``) to its scorer class and the
index of the scorer's per-sample output; the JAX package's other rewards
(the clinical scorers, which wait for weights outside the repository) are
named in ``UNPORTED_REWARDS`` and raise ``NotImplementedError`` where SCST
is built.

The metrics: BLEU, ROUGE1/ROUGE2/ROUGEL, METEOR, CIDERD and SPICE, the host
NLG metrics, ``bertscore`` (:class:`.clinical.BertScore`, its encoder on the
card; without its weights the metric reads ``None``), and ``accuracy``, ``f1-score`` and ``auroc`` over a
classifier's labels (refs) and averaged logits (hyps), in numpy
(:mod:`.classification`). Refs and hyps are dumped as
``{split}_{seed}_{refs,hyps}.txt`` and the scores appended to
``{split}_{seed}_metrics.txt`` in the logger's directory, as the JAX package
does. A metric that fails while it computes is logged and scored ``None``,
so one broken scorer cannot end a training run (the JAX package's error
isolation). Any other metric name (the other clinical scorers) raises
``NotImplementedError`` before anything runs.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional

import numpy as np

from ..utils.logger import get_logger_directory
from . import classification
from .nlg.bleu import Bleu
from .nlg.ciderd import CiderD, CiderDRL
from .nlg.meteor import Meteor
from .nlg.rouge import Rouge, Rouge1, Rouge2, RougeL
from .nlg.spice import Spice

PORTED = ("bleu", "rouge1", "rouge2", "rougel", "meteor", "ciderd", "spice", "bertscore",
          "accuracy", "f1-score", "auroc")

# reward name -> (scorer class, index of its per-sample output)
REWARD_COMPLIANT = {
    "rougel": (RougeL, 1),
    "rouge2": (Rouge2, 1),
    "rouge1": (Rouge1, 1),
    "bleu": (Bleu, 1),
    "meteor": (Meteor, 1),
    "ciderdrl": (CiderDRL, 1),
}
UNPORTED_REWARDS = ("radentitymatchexact", "radentitynli", "chexbert", "radgraph",
                    "bertscore")


def _metric_name(metric) -> str:
    """A metric is a name, or a one-key mapping ``{name: args}``."""
    if isinstance(metric, str):
        return metric
    keys = list(metric.keys())
    if len(keys) != 1:
        raise ValueError(f"metric badly formatted: {metric}")
    return str(keys[0])


def check_metrics(metrics) -> None:
    """Raise ``NotImplementedError`` naming every metric the port lacks."""
    missing = [_metric_name(m) for m in metrics or ()
               if _metric_name(m).lower() not in PORTED]
    if missing:
        raise NotImplementedError(f"metrics {missing} are not ported; ported: "
                                  f"{', '.join(PORTED)}")


def compute_scores(metrics, refs: Optional[List[str]], hyps: Optional[List[str]], split: str,
                   seed, config, epoch, logger, dump: bool = True, device=None) -> Dict:
    """The metrics over refs and hyps (module doc); ``bertscore`` runs its
    encoder on ``device`` (the card when None)."""
    scores: Dict = {}
    logger = logger or logging.getLogger("vilmedic_torch.scorers")
    if not metrics:
        return scores
    check_metrics(metrics)
    if refs is None or hyps is None:
        raise ValueError("metrics were asked for but the evaluation returned no refs or hyps")
    if len(refs) != len(hyps):
        raise ValueError(f"refs and hyps must have the same length: {len(refs)} vs {len(hyps)}")

    base = os.path.join(get_logger_directory(logger), f"{split}_{seed}_{{}}")
    if dump:
        with open(base.format("refs.txt"), "w") as f:
            f.write("\n".join(map(str, refs)))
        with open(base.format("hyps.txt"), "w") as f:
            f.write("\n".join(map(str, hyps)))

    for metric in metrics:
        name = _metric_name(metric)
        lower = name.lower()
        try:
            if lower == "bleu":
                scores["BLEU"] = Bleu()(refs, hyps)[0]
            elif lower == "meteor":
                scores["METEOR"] = Meteor()(refs, hyps)[0]
            elif lower == "ciderd":
                scores["CIDERD"] = CiderD()(refs, hyps)[0]
            elif lower == "spice":
                scores["SPICE"] = Spice()(refs, hyps)[0]
            elif lower == "bertscore":
                from .clinical import BertScore

                scores["bertscore"] = BertScore(device=device or "cuda")(refs, hyps)[0]
            elif lower == "accuracy":
                scores["accuracy"] = classification.accuracy(refs, hyps)
            elif lower == "f1-score":
                scores["f1-score"] = classification.classification_report(
                    refs, np.argmax(hyps, axis=-1))
            elif lower == "auroc":
                scores["auroc"] = classification.roc_auc_ovr(
                    refs, classification.softmax(np.asarray(hyps), axis=-1))
            else:
                scores[name.upper()] = Rouge(rouges=[lower])(refs, hyps)[0]
        except Exception as e:  # one broken scorer must not end the run
            logger.exception(f"Error computing metric {name}: {e}")
            scores[name] = None

    if dump:
        with open(base.format("metrics.txt"), "a+") as f:
            f.write(json.dumps({"split": split, "epoch": epoch, "scores": scores}, indent=4,
                               default=str))
    return scores
