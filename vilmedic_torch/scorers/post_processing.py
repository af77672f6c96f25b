"""Evaluation post-processing (``post_processing:`` in an executor config;
port of the refusal part of ``scorers/post_processing.py``).

The only step a shipped config names is ConVIRT's ensemblor's
``plot_representation`` (t-SNE scatter plots, scikit-learn and
matplotlib); ``plot_attention`` needs matplotlib too. The port depends on
neither, so :func:`check_post_processing` raises for any step when the
Validator is built, before any training, naming what the plots need.
"""

from __future__ import annotations

NEEDS = {
    "plot_representation": "scikit-learn's t-SNE and matplotlib",
    "plot_attention": "matplotlib",
}


def _names(post_processing):
    if hasattr(post_processing, "to_dict"):
        post_processing = post_processing.to_dict()
    for entry in post_processing or []:
        yield entry if isinstance(entry, str) else next(iter(entry))


def check_post_processing(post_processing) -> None:
    """Raise ``NotImplementedError`` for the first step of a
    ``post_processing`` list (a step name, or a one-key dict of its
    arguments)."""
    for name in _names(post_processing):
        why = f"needs {NEEDS[name]}, which the port does not depend on" if name in NEEDS else ""
        raise NotImplementedError(f"post_processing {name!r} is not ported {why}".strip())
