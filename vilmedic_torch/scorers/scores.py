"""Metric dispatch and the SCST rewards (port of ``compute_scores`` and
``REWARD_COMPLIANT`` of ``scorers/scores.py``).

``REWARD_COMPLIANT`` maps each reward name to its scorer class and the
index of the scorer's per-sample output: the host NLG rewards (``rougel``,
``rouge1``, ``rouge2``, ``bleu``, ``meteor``, ``ciderdrl``) and the
clinical ones (``radentitymatchexact``, ``radentitynli``, ``chexbert``,
``radgraph``, ``bertscore``), whose networks run on the device SCST names
(:data:`DEVICE_REWARDS`).

The metrics: BLEU, ROUGE1/ROUGE2/ROUGEL, METEOR, CIDERD and SPICE, the host
NLG metrics; the clinical scorers of :mod:`.clinical`, their networks on
``device`` (the card by default), under the JAX package's keys:

- ``chexbert``: ``chexbert-{5,all}_{micro,macro} avg_f1-score``;
- ``radgraph``: ``radgraph_simple``, ``radgraph_partial``,
  ``radgraph_complete``;
- ``radentitymatchexact``, ``radentitynli``, ``bertscore``, and
  ``stanford_ct_abd_accuracy`` as ``stanford_ct_abd``;

and ``accuracy``, ``f1-score`` and ``auroc`` over a classifier's labels
(refs) and averaged logits (hyps), in numpy (:mod:`.classification`). Refs
and hyps are dumped as ``{split}_{seed}_{refs,hyps}.txt`` (CheXbert's
labels as ``{refs,hyps}.chexbert.txt``) and the scores appended to
``{split}_{seed}_metrics.txt`` in the logger's directory, as the JAX package
does. A metric that fails while it computes, a scorer whose weights are
missing among them, is logged and scored ``None`` under its own name, so one
broken scorer cannot end a training run (the JAX package's error
isolation). Any other metric name (``radevalbertscore``, GREEN) raises
``NotImplementedError`` before anything runs.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional

import numpy as np

from ..utils.logger import get_logger_directory
from . import classification, clinical
from .nlg.bleu import Bleu
from .nlg.ciderd import CiderD, CiderDRL
from .nlg.meteor import Meteor
from .nlg.rouge import Rouge, Rouge1, Rouge2, RougeL
from .nlg.spice import Spice

PORTED = ("bleu", "rouge1", "rouge2", "rougel", "meteor", "ciderd", "spice", "bertscore",
          "chexbert", "radgraph", "radentitymatchexact", "radentitynli",
          "stanford_ct_abd_accuracy", "accuracy", "f1-score", "auroc")

# reward name -> (scorer class, index of its per-sample output)
REWARD_COMPLIANT = {
    "rougel": (RougeL, 1),
    "rouge2": (Rouge2, 1),
    "rouge1": (Rouge1, 1),
    "bleu": (Bleu, 1),
    "meteor": (Meteor, 1),
    "ciderdrl": (CiderDRL, 1),
    "radentitymatchexact": (clinical.RadEntityMatchExact, 1),
    "radentitynli": (clinical.RadEntityNLI, 1),
    "chexbert": (clinical.F1CheXbert, 1),
    "radgraph": (clinical.F1RadGraph, 1),
    "bertscore": (clinical.BertScore, 1),
}
# the rewards whose scorers take the ``device`` their networks run on
DEVICE_REWARDS = ("radentitymatchexact", "radentitynli", "chexbert", "radgraph", "bertscore")


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
    """The metrics over refs and hyps (module doc); the clinical scorers
    and ``bertscore`` run their networks on ``device`` (the card when
    None)."""
    scores: Dict = {}
    device = device or "cuda"
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
                scores["bertscore"] = clinical.BertScore(device=device)(refs, hyps)[0]
            elif lower == "chexbert":
                _, _, chexbert_all, chexbert_5 = clinical.F1CheXbert(
                    refs_filename=base.format("refs.chexbert.txt") if dump else None,
                    hyps_filename=base.format("hyps.chexbert.txt") if dump else None,
                    device=device)(hyps, refs)
                for avg in ("micro", "macro"):  # the JAX package's key order
                    for kind, report in (("5", chexbert_5), ("all", chexbert_all)):
                        scores[f"chexbert-{kind}_{avg} avg_f1-score"] = \
                            report[f"{avg} avg"]["f1-score"]
            elif lower == "radgraph":
                (scores["radgraph_simple"], scores["radgraph_partial"],
                 scores["radgraph_complete"]) = clinical.F1RadGraph(
                    reward_level="all", device=device)(refs=refs, hyps=hyps)[0]
            elif lower == "radentitymatchexact":
                scores["radentitymatchexact"] = clinical.RadEntityMatchExact(
                    device=device)(refs, hyps)[0]
            elif lower == "radentitynli":
                scores["radentitynli"] = clinical.RadEntityNLI(device=device)(refs, hyps)[0]
            elif lower == "stanford_ct_abd_accuracy":
                scores["stanford_ct_abd"] = clinical.StanfordCTAbdAcc()(refs=refs, hyps=hyps)[0]
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
