"""Scorers of the port: BLEU (native core), ROUGE-1/2/L (ROUGE-L on the
native core), METEOR, CIDEr-D and SPICE on the host; the clinical scorers
(CheXbert, RadGraph, RadEntityMatchExact, RadEntityNLI) and BERTScore,
whose networks run on the card; the SCST rewards among them; and the
classification metrics (accuracy, the F1 report, AUROC)."""

from .scores import compute_scores  # noqa: F401
