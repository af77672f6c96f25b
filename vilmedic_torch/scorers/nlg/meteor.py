"""METEOR 1.5: alignment metric with exact / stem / synonym / paraphrase
matchers (port of ``scorers/nlg/meteor.py``).

The METEOR 1.5 algorithm (Denkowski & Lavie 2014) with the full matcher
cascade and weighted scoring:

- matcher stages with 1.5's English weights: exact 1.0, stem 0.6,
  synonym 0.8, paraphrase 0.6; each stage pairs the words the earlier
  stages left, first come first served;
- content / function word discounting (delta) with an English function-word
  list (the jar ships ``function.words``);
- parameters: alpha=0.85, beta=0.2, gamma=0.6, delta=0.75 (the 1.5 English
  defaults), fragmentation penalty ``gamma * (chunks/m) ** beta``.

Stems come from the port's Porter stemmer (:mod:`.porter`, NLTK's
``PorterStemmer`` as the JAX package runs it). Synonyms come only from the
file ``METEOR_SYNONYMS`` names (one tab-separated synonym group per line) and
paraphrases from ``METEOR_PARAPHRASE`` (lines ``phrase1 ||| phrase2``, the
format of the jar's ``paraphrase-en.gz``); either may be gzipped. There is
no WordNet branch: without a synonym file the synonym stage is inert, as the
JAX package's is when neither the file nor NLTK's WordNet corpus is there.
The JAX package reads its files once per process; here the tables are
cached per pair of file names, so a changed variable takes effect.

``Meteor()(refs, hyps) -> (corpus mean, [per-sample])``.
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .porter import stem

ALPHA = 0.85
BETA = 0.2
GAMMA = 0.6
DELTA = 0.75
STAGE_WEIGHTS = (1.0, 0.6, 0.8, 0.6)  # exact, stem, synonym, paraphrase

FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every no all both either neither
i you he she it we they me him her us them my your his its our their mine
yours hers ours theirs myself yourself himself herself itself ourselves
themselves who whom whose which what
am is are was were be been being have has had having do does did doing will
would shall should may might must can could
and or but nor so yet for if then than because although though while whereas
unless until since when where why how as
at by in of on to up off out over under with without within into onto from
about above across after against along among around before behind below
beneath beside between beyond during except inside near outside through
toward towards upon
not only also very too just there here
""".split())


def _open(path: str):
    return gzip.open(path, "rt") if path.endswith(".gz") else open(path)


def _load_synonyms(path: Optional[str]) -> Optional[Dict[str, Set[str]]]:
    if not (path and os.path.exists(path)):
        return None
    table: Dict[str, Set[str]] = {}
    with _open(path) as f:
        for line in f:
            group = line.strip().lower().split("\t")
            if len(group) < 2:
                continue
            for w in group:
                table.setdefault(w, set()).update(group)
    return table


def _load_paraphrases(path: Optional[str]) -> Optional[Dict[Tuple[str, ...], Set[Tuple[str, ...]]]]:
    if not (path and os.path.exists(path)):
        return None
    table: Dict[Tuple[str, ...], Set[Tuple[str, ...]]] = {}
    with _open(path) as f:
        for line in f:
            parts = [p.strip() for p in line.lower().split("|||")]
            if len(parts) < 2 or not parts[0] or not parts[1]:
                continue
            a, b = tuple(parts[0].split()), tuple(parts[1].split())
            table.setdefault(a, set()).add(b)
            table.setdefault(b, set()).add(a)
    return table


class _Matchers:
    """The synonym and paraphrase tables of ``METEOR_SYNONYMS`` and
    ``METEOR_PARAPHRASE`` (None where unset)."""

    _cache: Dict[Tuple[Optional[str], Optional[str]], "_Matchers"] = {}

    def __init__(self, synonyms_path: Optional[str] = None,
                 paraphrase_path: Optional[str] = None):
        self.synonyms = _load_synonyms(synonyms_path)
        self.paraphrases = _load_paraphrases(paraphrase_path)

    @classmethod
    def get(cls) -> "_Matchers":
        key = (os.environ.get("METEOR_SYNONYMS"), os.environ.get("METEOR_PARAPHRASE"))
        if key not in cls._cache:
            cls._cache[key] = cls(*key)
        return cls._cache[key]

    def are_synonyms(self, a: str, b: str) -> bool:
        if a == b:
            return True
        return self.synonyms is not None and b in self.synonyms.get(a, ())

    @property
    def has_synonyms(self) -> bool:
        return self.synonyms is not None


def _match_stage(hyp_items, ref_items, predicate):
    """First-come pairing under ``predicate``: the matches [(h_idx, r_idx)]
    and the hypothesis and reference items left unmatched."""
    matches = []
    ref_pool = list(ref_items)
    rest_hyp = []
    for h_idx, h_word in hyp_items:
        found = next((j for j, (_, r_word) in enumerate(ref_pool) if predicate(h_word, r_word)),
                     None)
        if found is None:
            rest_hyp.append((h_idx, h_word))
        else:
            r_idx, _ = ref_pool.pop(found)
            matches.append((h_idx, r_idx))
    return matches, rest_hyp, ref_pool


def _paraphrase_stage(hyp, ref, hyp_items, ref_items, table):
    """Greedy longest-phrase paraphrase matching over the unmatched spans:
    for each hypothesis start, the longest free phrase (up to 4 words) with
    a paraphrase found at the first free reference position that spells
    one of its alternatives. Each match is a list of aligned word-index
    pairs (zip of the two spans)."""
    matches = []
    hyp_free = {i for i, _ in hyp_items}
    ref_free = {i for i, _ in ref_items}
    max_len = 4
    for start in range(len(hyp)):
        for length in range(min(max_len, len(hyp) - start), 0, -1):
            span = tuple(range(start, start + length))
            if not all(i in hyp_free for i in span):
                continue
            alts = table.get(tuple(hyp[i] for i in span))
            if not alts:
                continue
            hit = None
            for r_start in range(len(ref)):
                for alt in alts:
                    r_span = tuple(range(r_start, r_start + len(alt)))
                    if (r_span and r_span[-1] < len(ref) and all(i in ref_free for i in r_span)
                            and tuple(ref[i] for i in r_span) == alt):
                        hit = r_span
                        break
                if hit:
                    break
            if hit:
                matches.append(list(zip(span, hit)))
                hyp_free -= set(span)
                ref_free -= set(hit)
                break
    return matches


def _align(hyp: Sequence[str], ref: Sequence[str], matchers: _Matchers):
    """-> sorted list of (h_idx, r_idx, stage weight) word-level matches."""
    hyp_items = list(enumerate(hyp))
    ref_items = list(enumerate(ref))
    out = []
    exact, hyp_items, ref_items = _match_stage(hyp_items, ref_items, lambda a, b: a == b)
    out += [(h, r, STAGE_WEIGHTS[0]) for h, r in exact]
    stemmed, hyp_items, ref_items = _match_stage(hyp_items, ref_items,
                                                 lambda a, b: stem(a) == stem(b))
    out += [(h, r, STAGE_WEIGHTS[1]) for h, r in stemmed]
    if matchers.has_synonyms:
        syn, hyp_items, ref_items = _match_stage(hyp_items, ref_items, matchers.are_synonyms)
        out += [(h, r, STAGE_WEIGHTS[2]) for h, r in syn]
    if matchers.paraphrases is not None:
        for pairs in _paraphrase_stage(list(hyp), list(ref), hyp_items, ref_items,
                                       matchers.paraphrases):
            out += [(h, r, STAGE_WEIGHTS[3]) for h, r in pairs]
    return sorted(out)


def _count_chunks(matches) -> int:
    if not matches:
        return 0
    chunks = 1
    for (h0, r0, _), (h1, r1, _) in zip(matches, matches[1:]):
        if not (h1 == h0 + 1 and r1 == r0 + 1):
            chunks += 1
    return chunks


def _word_weight(word: str) -> float:
    return DELTA if word not in FUNCTION_WORDS else 1 - DELTA


def single_meteor_score(ref: Sequence[str], hyp: Sequence[str],
                        matchers: Optional[_Matchers] = None) -> float:
    """METEOR 1.5 sentence score (weighted stages + function-word discount)."""
    matchers = matchers or _Matchers.get()
    matches = _align(hyp, ref, matchers)
    m = len(matches)
    if m == 0 or not hyp or not ref:
        return 0.0
    hyp_weight = sum(w * _word_weight(hyp[h]) for h, _, w in matches)
    ref_weight = sum(w * _word_weight(ref[r]) for _, r, w in matches)
    precision = hyp_weight / max(sum(_word_weight(w) for w in hyp), 1e-9)
    recall = ref_weight / max(sum(_word_weight(w) for w in ref), 1e-9)
    if precision <= 0 or recall <= 0:
        return 0.0
    fmean = (precision * recall) / (ALPHA * precision + (1 - ALPHA) * recall)
    chunks = _count_chunks(matches)
    penalty = GAMMA * (chunks / m) ** BETA if chunks > 1 else 0.0
    return (1 - penalty) * fmean


class Meteor:
    def __init__(self, **kwargs):
        self.matchers = _Matchers.get()

    def __call__(self, refs: List[str], hyps: List[str]) -> Tuple[float, List[float]]:
        scores = []
        for ref, hyp in zip(refs, hyps):
            ref_list = ref if isinstance(ref, list) else [ref]
            hyp_tokens = hyp.lower().split()
            scores.append(max(single_meteor_score(r.lower().split(), hyp_tokens, self.matchers)
                              for r in ref_list))
        return float(np.mean(scores)) if scores else 0.0, scores
