"""ROUGE-1, -2 and -L F1 without ``rouge_score`` (port of
``scorers/nlg/rouge.py``, which wraps ``rouge_score.RougeScorer(...,
use_stemmer=True)``).

The same steps as that package's ``DefaultTokenizer`` and scorer:
lower-case, every run of characters outside ``[a-z0-9]`` becomes a space,
split on whitespace, Porter-stem the tokens longer than 3 characters
(:mod:`.porter`), keep the non-empty ``[a-z0-9]+`` tokens; then per pair
ROUGE-N from clipped n-gram counts, ROUGE-L from the longest common
subsequence, precision over the hypothesis, recall over the reference,
F1 = 2PR / (P + R) (0 when P + R is 0, or for an empty side under
ROUGE-L).

``Rouge(rouges)(refs, hyps) -> (mean F1, [per-pair F1])``; ``Rouge1``,
``Rouge2`` and ``RougeL`` fix the kind (the SCST rewards). ROUGE-L runs its
LCS in the C++ core (:func:`.native.rouge_l_native`) over the tokens of
:func:`tokenize` (the stemmer is cached), as the JAX package's
``_rouge_l_fast`` does; ``use_native=False`` keeps the pure-Python LCS, the
plain version the tests hold the core against.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import List, Tuple

import numpy as np

from .porter import stem

_NON_ALPHANUM = re.compile(r"[^a-z0-9]+")
_SPACES = re.compile(r"\s+")
_VALID = re.compile(r"^[a-z0-9]+$")


def tokenize(text: str) -> List[str]:
    tokens = _SPACES.split(_NON_ALPHANUM.sub(" ", text.lower()))
    tokens = [stem(t) if len(t) > 3 else t for t in tokens]
    return [t for t in tokens if _VALID.match(t)]


def _f1(precision: float, recall: float) -> float:
    return 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0


def _ngrams(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def rouge_n(ref: List[str], hyp: List[str], n: int) -> float:
    ref_ng, hyp_ng = _ngrams(ref, n), _ngrams(hyp, n)
    overlap = sum(min(c, hyp_ng[g]) for g, c in ref_ng.items())
    return _f1(overlap / max(sum(hyp_ng.values()), 1), overlap / max(sum(ref_ng.values()), 1))


def lcs_length(a: List[str], b: List[str]) -> int:
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, start=1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1]))
        prev = cur
    return prev[-1]


def rouge_l(ref: List[str], hyp: List[str]) -> float:
    if not ref or not hyp:
        return 0.0
    lcs = lcs_length(ref, hyp)
    return _f1(lcs / len(hyp), lcs / len(ref))


class Rouge:
    def __init__(self, rouges, use_native: bool = True, **kwargs):
        kind = [r.lower() for r in rouges][0]
        if kind not in ("rouge1", "rouge2", "rougel"):
            raise NotImplementedError(f"{rouges[0]!r}: ROUGE-1, -2 and -L are ported")
        self.kind = kind
        self.use_native = use_native

    def __call__(self, refs: List[str], hyps: List[str]) -> Tuple[float, List[float]]:
        if len(refs) != len(hyps):
            raise ValueError(f"refs and hyps must be the same length, got {len(refs)} refs "
                             f"vs {len(hyps)} hyps")
        if self.kind == "rougel" and self.use_native:
            from .native import rouge_l_native

            f1 = rouge_l_native([tokenize(r) for r in refs], [tokenize(h) for h in hyps])
            return float(np.mean(f1)), f1
        f1 = []
        for r, h in zip(refs, hyps):
            ref, hyp = tokenize(r), tokenize(h)
            f1.append(rouge_l(ref, hyp) if self.kind == "rougel"
                      else rouge_n(ref, hyp, int(self.kind[-1])))
        return float(np.mean(f1)), f1


class Rouge1(Rouge):
    def __init__(self, **kwargs):
        super().__init__(rouges=["rouge1"], **kwargs)


class Rouge2(Rouge):
    def __init__(self, **kwargs):
        super().__init__(rouges=["rouge2"], **kwargs)


class RougeL(Rouge):
    def __init__(self, **kwargs):
        super().__init__(rouges=["rougel"], **kwargs)
