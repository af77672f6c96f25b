"""CIDEr-D: the TF-IDF consensus n-gram metric, and its SCST reward variant
with a frozen document-frequency table (a copy of ``CiderD`` and
``CiderDRL`` of ``scorers/nlg/ciderd.py`` of the JAX package).

The COCO ``CiderScorer``: per-n-gram TF-IDF vectors with
``idf = log(N) - log(max(1, df))`` over the corpus's references, clipped
cosine similarity, gaussian length penalty
``exp(-(len_h - len_r)^2 / (2 sigma^2))``, scaled by 10 and averaged over
n = 1..4.
"""

from __future__ import annotations

import math
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np


def _cook(sentence: str, n: int = 4) -> Dict[tuple, int]:
    words = sentence.split()
    counts: Dict[tuple, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i: i + k])] += 1
    return counts


class _CiderScorer:
    def __init__(self, n: int = 4, sigma: float = 6.0, df_mode: str = "corpus",
                 document_frequency: Optional[Dict] = None, ref_len: Optional[float] = None):
        self.n = n
        self.sigma = sigma
        self.df_mode = df_mode
        self.document_frequency = document_frequency
        self.ref_len = ref_len

    def compute_df(self, crefs: List[List[Dict]]):
        self.document_frequency = defaultdict(float)
        for refs in crefs:
            for ngram in set(ng for ref in refs for ng in ref):
                self.document_frequency[ngram] += 1
        self.ref_len = math.log(float(len(crefs)))

    def _vec(self, counts: Dict[tuple, int]):
        vec = [defaultdict(float) for _ in range(self.n)]
        norm = [0.0] * self.n
        length = 0
        for ngram, term_freq in counts.items():
            df = math.log(max(1.0, self.document_frequency.get(ngram, 0.0)))
            k = len(ngram) - 1
            vec[k][ngram] = float(term_freq) * (self.ref_len - df)
            norm[k] += vec[k][ngram] ** 2
            if k == 0:
                length += term_freq
        return vec, [math.sqrt(x) for x in norm], length

    def _sim(self, vec_h, norm_h, len_h, vec_r, norm_r, len_r):
        delta = float(len_h - len_r)
        val = np.zeros(self.n)
        for k in range(self.n):
            for ngram, count in vec_h[k].items():
                # CIDEr-D clipping: min(h, r) * r
                val[k] += min(count, vec_r[k].get(ngram, 0.0)) * vec_r[k].get(ngram, 0.0)
            if norm_h[k] != 0 and norm_r[k] != 0:
                val[k] /= norm_h[k] * norm_r[k]
            val[k] *= np.e ** (-(delta ** 2) / (2 * self.sigma ** 2))
        return val

    def score(self, crefs: List[List[Dict]], ctest: List[Dict]) -> Tuple[float, np.ndarray]:
        if self.document_frequency is None:
            self.compute_df(crefs)
            if len(crefs) < 2 and self.df_mode == "corpus":
                raise ValueError("CIDEr-D corpus df needs at least 2 samples")
        scores = []
        for refs, test in zip(crefs, ctest):
            vec_h, norm_h, len_h = self._vec(test)
            score = np.zeros(self.n)
            for ref in refs:
                vec_r, norm_r, len_r = self._vec(ref)
                score += self._sim(vec_h, norm_h, len_h, vec_r, norm_r, len_r)
            score_avg = np.mean(score / len(refs)) * 10.0
            scores.append(score_avg)
        return float(np.mean(scores)), np.asarray(scores)


class CiderD:
    def __init__(self, n: int = 4, sigma: float = 6.0, **kwargs):
        self._n = n
        self._sigma = sigma

    def __call__(self, refs: List[str], hyps: List[str]) -> Tuple[float, np.ndarray]:
        scorer = _CiderScorer(self._n, self._sigma)
        crefs = [[_cook(r, self._n) for r in (ref if isinstance(ref, list) else [ref])]
                 for ref in refs]
        ctest = [_cook(h, self._n) for h in hyps]
        return scorer.score(crefs, ctest)


class CiderDRL:
    """CIDEr-D whose document frequencies are frozen from the reference
    corpus file ``df`` (one report per line, cleaned by ``processing``), so
    that per-batch rewards do not move with the batch. Without the file it
    falls back to the batch's own frequencies, as :class:`CiderD`."""

    def __init__(self, df: Optional[str] = None, processing=None, n: int = 4,
                 sigma: float = 6.0, **kwargs):
        from ...data.processing import get_processing
        from ...data.utils import load_file

        self._n = n
        self._sigma = sigma
        self.document_frequency = None
        self.ref_len = None
        if df is not None and os.path.exists(df):
            proc = get_processing(processing)
            tmp = _CiderScorer(n, sigma)
            tmp.compute_df([[_cook(proc(s.strip()), n)] for s in load_file(df)])
            self.document_frequency = tmp.document_frequency
            self.ref_len = tmp.ref_len

    def __call__(self, refs: List[str], hyps: List[str]) -> Tuple[float, np.ndarray]:
        scorer = _CiderScorer(
            self._n, self._sigma,
            df_mode="precomputed" if self.document_frequency else "corpus",
            document_frequency=self.document_frequency, ref_len=self.ref_len)
        crefs = [[_cook(r, self._n) for r in (ref if isinstance(ref, list) else [ref])]
                 for ref in refs]
        ctest = [_cook(h, self._n) for h in hyps]
        return scorer.score(crefs, ctest)
