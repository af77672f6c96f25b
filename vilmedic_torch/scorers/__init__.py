"""Host NLG scorers of the port: BLEU, ROUGE-1/2/L and CIDEr-D, and the
SCST rewards among them."""

from .scores import compute_scores  # noqa: F401
