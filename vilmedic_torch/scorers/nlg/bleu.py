"""Corpus + per-sentence BLEU with COCO-caption semantics (port of
``scorers/nlg/bleu.py``).

The COCO ``BleuScorer`` with ``option='closest'``:
- clipped n-gram precision accumulated over the corpus,
- effective reference length = per-segment closest to the hypothesis length,
- smoothing constants tiny=1e-15 / small=1e-9,
- brevity penalty ``exp(1 - 1/ratio)`` applied when ratio < 1,
- per-sentence scores computed with the same formula on per-segment counts
  (these feed SCST rewards, reference scores.py:17-29 ``[Bleu, 1]``).

Call contract: ``Bleu(n)(refs, hyps) -> (corpus_bleu_n, [per-sentence bleu_n])``.
Single-reference pairs go through the C++ core (:mod:`.native`), as in the
JAX package; ``use_native=False``, or a list of references per hypothesis,
takes the pure-Python path below, the plain version the tests hold the core
against.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple


TINY = 1e-15
SMALL = 1e-9


def ngram_counts(tokens: Sequence[str], n: int) -> Dict[tuple, int]:
    counts: Dict[tuple, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(tokens) - k + 1):
            counts[tuple(tokens[i: i + k])] += 1
    return counts


def _segment_stats(hyp: str, refs: List[str], n: int):
    hyp_tokens = hyp.split()
    ref_token_lists = [r.split() for r in refs]
    testlen = len(hyp_tokens)
    # closest reference length (ties -> shorter, per coco cook_test)
    reflen = min(
        (abs(len(r) - testlen), len(r)) for r in ref_token_lists
    )[1] if ref_token_lists else 0

    hyp_counts = ngram_counts(hyp_tokens, n)
    max_ref_counts: Dict[tuple, int] = defaultdict(int)
    for r in ref_token_lists:
        for ng, c in ngram_counts(r, n).items():
            max_ref_counts[ng] = max(max_ref_counts[ng], c)

    guess = [max(0, testlen - k + 1) for k in range(1, n + 1)]
    correct = [0] * n
    for ng, c in hyp_counts.items():
        correct[len(ng) - 1] += min(c, max_ref_counts.get(ng, 0))
    return testlen, reflen, guess, correct


def _bleu_from_stats(testlen, reflen, guess, correct, n) -> List[float]:
    bleus = []
    log_sum = 0.0
    ratio = (testlen + TINY) / (reflen + SMALL)
    for k in range(n):
        log_sum += math.log(correct[k] + TINY) - math.log(guess[k] + SMALL)
        bleu_k = math.exp(log_sum / (k + 1))
        if ratio < 1:
            bleu_k *= math.exp(1 - 1 / ratio)
        bleus.append(bleu_k)
    return bleus


class Bleu:
    def __init__(self, n: int = 4, use_native: bool = True, **kwargs):
        self._n = n
        self._use_native = use_native

    def __call__(self, refs: List[str], hyps: List[str]) -> Tuple[float, List[float]]:
        return self.compute_score(refs, hyps)

    def compute_score(self, refs, hyps):
        n = self._n
        if self._use_native and refs and not isinstance(refs[0], list):
            from .native import bleu_native

            return bleu_native(list(refs), list(hyps), n)
        tot_testlen = tot_reflen = 0
        tot_guess = [0] * n
        tot_correct = [0] * n
        per_sentence: List[float] = []
        for hyp, ref in zip(hyps, refs):
            ref_list = ref if isinstance(ref, list) else [ref]
            testlen, reflen, guess, correct = _segment_stats(hyp, ref_list, n)
            per_sentence.append(_bleu_from_stats(testlen, reflen, guess, correct, n)[n - 1])
            tot_testlen += testlen
            tot_reflen += reflen
            for k in range(n):
                tot_guess[k] += guess[k]
                tot_correct[k] += correct[k]
        corpus = _bleu_from_stats(tot_testlen, tot_reflen, tot_guess, tot_correct, n)
        return corpus[n - 1], per_sentence
