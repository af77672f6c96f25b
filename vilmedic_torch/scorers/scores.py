"""Metric dispatch (port of ``compute_scores`` of ``scorers/scores.py``).

BLEU, ROUGE1/ROUGE2/ROUGEL and CIDERD, the host NLG metrics; refs and hyps
are dumped as ``{split}_{seed}_{refs,hyps}.txt`` and the scores appended to
``{split}_{seed}_metrics.txt`` in the logger's directory, as the JAX package
does. A metric that fails while it computes is logged and scored ``None``,
so one broken scorer cannot end a training run (the JAX package's error
isolation). Any other metric name (METEOR, SPICE, the clinical scorers with
the weights they wait for, the classification metrics) raises
``NotImplementedError`` before anything runs.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional

from ..utils.logger import get_logger_directory
from .nlg.bleu import Bleu
from .nlg.ciderd import CiderD
from .nlg.rouge import Rouge

PORTED = ("bleu", "rouge1", "rouge2", "rougel", "ciderd")


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
                                  "BLEU, ROUGE1, ROUGE2, ROUGEL, CIDERD")


def compute_scores(metrics, refs: Optional[List[str]], hyps: Optional[List[str]], split: str,
                   seed, config, epoch, logger, dump: bool = True) -> Dict:
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
            elif lower == "ciderd":
                scores["CIDERD"] = CiderD()(refs, hyps)[0]
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
