"""One-directory weights provisioning for the scorers (port of the JAX
package's ``scorers/weights.py``, for the entries the port reads).

``VILMEDIC_WEIGHTS_DIR`` points at a single directory with the JAX package's
layout; a scorer resolves its files from there unless its own environment
variable names them (explicit variable > weights-dir entry > the caller's
default). The port reads these entries::

    $VILMEDIC_WEIGHTS_DIR/
      chexbert/chexbert.pth           CheXbert classifier checkpoint
      chexbert/vocab.txt              bert-base-uncased vocab file
      radnli/model_medrad_19k.pth     BERTNLI checkpoint (StanfordAIMI/RRG_scorers)
      radnli/vocab.txt                bert-base-uncased vocab file
      radner/                         HF BertForTokenClassification dir (radiology NER)
      bertscore/model/                HF dir for the BERTScore encoder
      bertscore/rescale_baseline.tsv  bert_score baseline tsv (LAYER,P,R,F)

The JAX package's ``green/`` entry belongs to a scorer the port does not
have yet.
"""

from __future__ import annotations

import os
from typing import Optional

#: environment variable -> path inside $VILMEDIC_WEIGHTS_DIR
LAYOUT = {
    "CHEXBERT_PTH": "chexbert/chexbert.pth",
    "CHEXBERT_VOCAB": "chexbert/vocab.txt",
    "RADNLI_PTH": "radnli/model_medrad_19k.pth",
    "RADNLI_VOCAB": "radnli/vocab.txt",
    "RADNER_MODEL": "radner",
    "BERTSCORE_MODEL": "bertscore/model",
    "BERTSCORE_BASELINE_TSV": "bertscore/rescale_baseline.tsv",
}


def resolve(env_key: str, default: Optional[str] = None) -> Optional[str]:
    """The explicit environment variable; else the ``VILMEDIC_WEIGHTS_DIR``
    entry when it exists on disk; else ``default``."""
    explicit = os.environ.get(env_key)
    if explicit:
        return explicit
    root = os.environ.get("VILMEDIC_WEIGHTS_DIR")
    if root and env_key in LAYOUT:
        cand = os.path.join(root, LAYOUT[env_key])
        if os.path.exists(cand):
            return cand
    return default
