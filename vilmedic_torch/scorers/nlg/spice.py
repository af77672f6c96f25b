"""SPICE-style scene-graph tuple F1 (port of ``scorers/nlg/spice.py``).

SPICE 1.0 runs the Stanford scene-graph parser in Java; neither the JAX
package nor the port carries it. This is the JAX package's lexicon-driven
reading of the metric, tuned for radiology reports: F1 over semantic
propositions extracted from the candidate and the reference.

- objects: content nouns (anything that is not a function word, attribute or
  relation word), lemma-light (a trailing ``s`` stripped);
- attributes: a modifier lexicon (severity, laterality, extent, appearance)
  attached to the following object: "small left pleural effusion" ->
  (effusion, small), (effusion, left), (effusion, pleural);
- relations: noun PREP noun, at most 4 words apart with one preposition
  between -> (noun1, prep, noun2);
- negation: "no X" / "without X" -> (X, absent), distributed over "and" /
  "or" and ended by a preposition.

Tuples match exactly, or element by element through the METEOR synonym table
(``METEOR_SYNONYMS``, :class:`.meteor._Matchers`) when one is set. The
scores are not the Java SPICE's (another parser); the contract and the tuple
F1 are. ``Spice()(refs, hyps) -> (mean F, [per-sample F])``.
"""

from __future__ import annotations

import re
from typing import List, Set, Tuple

import numpy as np

from .meteor import _Matchers

ATTRIBUTES = frozenset("""
mild moderate severe small large tiny massive trace minimal extensive
left right bilateral unilateral upper lower central peripheral basal apical
medial lateral anterior posterior superior inferior proximal distal
acute chronic stable unchanged new old interval prior residual recurrent
patchy diffuse focal multifocal scattered streaky linear nodular reticular
coarse fine confluent segmental lobar subsegmental perihilar subpleural
normal abnormal enlarged prominent tortuous calcified degenerative
atherosclerotic ectatic aneurysmal dilated distended collapsed atrophic
hypertrophic thickened edematous consolidative cavitary cystic solid
ground glass groundglass micronodular miliary reticulonodular
pleural pulmonary cardiac mediastinal hilar interstitial vascular osseous
hepatic renal splenic adrenal pancreatic biliary gastric duodenal colonic
bowel mesenteric retroperitoneal pelvic periportal subcapsular
vertebral thoracic lumbar cervical costal rib clavicular humeral
low high increased decreased improved worsened elevated depressed reduced
clear hazy dense lucent opaque blunted obscured sharp indistinct
hyperdense hypodense isodense hyperintense hypointense heterogeneous
homogeneous enhancing nonenhancing rim simple complex loculated free
dependent layering both multiple several few numerous single two
benign malignant metastatic suspicious indeterminate incidental
postsurgical postoperative posttraumatic healed displaced nondisplaced
compressive obstructive emphysematous bronchiectatic fibrotic cicatricial
""".split())

RELATIONS = frozenset("in of at with on within into over under near to from".split())

NEGATIONS = frozenset("no without absent".split())

FUNCTION = frozenset("""
the a an is are was were be been being there this that these those and or
it its has have had by for as than such may can could seen noted identified
present evidence suggest suggests suggesting likely
""".split())

_TOKEN = re.compile(r"[a-z]+")


def _lemma(word: str) -> str:
    if len(word) > 3 and word.endswith("s") and not word.endswith("ss"):
        return word[:-1]
    return word


def extract_tuples(text: str) -> Set[Tuple]:
    """Scene-graph propositions for one report."""
    tuples: Set[Tuple] = set()
    for sentence in re.split(r"[.!?;]", text.lower()):
        words = _TOKEN.findall(sentence)
        nouns = []  # (position, lemma)
        pending_attrs: List[str] = []
        negate = False
        for pos, w in enumerate(words):
            if w in NEGATIONS:
                negate = True
                pending_attrs = []
            elif w in ATTRIBUTES:
                pending_attrs.append(w)
            elif w in RELATIONS:
                pending_attrs = []
                negate = False  # prepositions end the negation scope
            elif w in FUNCTION:
                if w not in ("the", "a", "an", "and", "or"):
                    # determiners/conjunctions keep the attr chain and let
                    # negation distribute ("no edema or effusion")
                    pending_attrs = []
                    negate = False
            else:
                noun = _lemma(w)
                tuples.add((noun,))
                for attr in pending_attrs:
                    tuples.add((noun, attr))
                if negate:
                    tuples.add((noun, "absent"))
                nouns.append((pos, noun))
                pending_attrs = []
        # relations: noun PREP noun with the preposition between them
        for (p1, n1) in nouns:
            for (p2, n2) in nouns:
                if p1 < p2:
                    between = words[p1 + 1: p2]
                    rels = [w for w in between if w in RELATIONS]
                    if len(rels) == 1 and p2 - p1 <= 4:
                        tuples.add((n1, rels[0], n2))
    return tuples


def _tuples_match(a: Tuple, b: Tuple, matchers) -> bool:
    if len(a) != len(b):
        return False
    return all(x == y or matchers.are_synonyms(x, y) for x, y in zip(a, b))


def _f1(cand: Set[Tuple], ref: Set[Tuple], matchers) -> float:
    if not cand or not ref:
        return 0.0 if cand != ref else 1.0
    if matchers.has_synonyms:
        matched_c = sum(1 for c in cand if any(_tuples_match(c, r, matchers) for r in ref))
        matched_r = sum(1 for r in ref if any(_tuples_match(r, c, matchers) for c in cand))
        p = matched_c / len(cand)
        r = matched_r / len(ref)
    else:
        inter = len(cand & ref)
        p = inter / len(cand)
        r = inter / len(ref)
    return 2 * p * r / (p + r) if p + r else 0.0


class Spice:
    def __init__(self, **kwargs):
        self.matchers = _Matchers.get()

    def __call__(self, refs: List[str], hyps: List[str]) -> Tuple[float, List[float]]:
        scores = []
        for ref, hyp in zip(refs, hyps):
            ref_list = ref if isinstance(ref, list) else [ref]
            hyp_tuples = extract_tuples(hyp)
            scores.append(max(_f1(hyp_tuples, extract_tuples(r), self.matchers)
                              for r in ref_list))
        return float(np.mean(scores)) if scores else 0.0, scores
