"""Host NLG scorers of the port: BLEU, ROUGE-1/2/L and CIDEr-D."""

from .scores import compute_scores  # noqa: F401
