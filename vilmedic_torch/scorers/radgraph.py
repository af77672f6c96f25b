"""RadGraph F1: entity and relation graph-overlap rewards (port of
``scorers/radgraph.py``; host code over RadNER's entities).

The reward semantics are the ``radgraph`` package's, as the JAX package
ports them:

- **simple**: set-F1 over ``(entity tokens, label)`` pairs;
- **partial**: an entity with relations matches as ``(tokens, label,
  True)``;
- **complete**: an entity matches with its whole relation set ``(tokens,
  label, ((relation, target tokens, target label), ...))``.

Each F1 is set precision/recall over per-report annotations shaped like
radgraph's ``{"entities": {id: {"tokens", "label", "relations": [[type,
target_id], ...]}}}``. The entities come from :class:`.ner.RadNER`; the
relations, by default (``relations="heuristic"``), from the JAX package's
rules in :func:`annotation_from_ner` (the DyGIE++ relation extractor that
the ``radgraph`` package runs is not reproduced by either package).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _f1(hyp_set: set, ref_set: set) -> float:
    if not hyp_set or not ref_set:
        return 0.0
    precision = sum(1 for x in hyp_set if x in ref_set) / len(hyp_set)
    recall = sum(1 for x in ref_set if x in hyp_set) / len(ref_set)
    if precision + recall == 0.0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def _entity_sets_simple(ann: Dict) -> set:
    return {(e["tokens"], e["label"]) for e in ann["entities"].values()}


def _entity_sets_partial(ann: Dict) -> set:
    out = set()
    for e in ann["entities"].values():
        if e.get("relations"):
            out.add((e["tokens"], e["label"], True))
        else:
            out.add((e["tokens"], e["label"]))
    return out


def _entity_sets_complete(ann: Dict) -> set:
    ents = ann["entities"]
    out = set()
    for e in ents.values():
        rels = []
        for rel_type, target in e.get("relations", []):
            t = ents.get(str(target), ents.get(target))
            if t is not None:
                rels.append((rel_type, t["tokens"], t["label"]))
        out.add((e["tokens"], e["label"], tuple(sorted(rels))))
    return out


def reward_simple(hyp_ann: Dict, ref_ann: Dict) -> float:
    return _f1(_entity_sets_simple(hyp_ann), _entity_sets_simple(ref_ann))


def reward_partial(hyp_ann: Dict, ref_ann: Dict) -> float:
    return _f1(_entity_sets_partial(hyp_ann), _entity_sets_partial(ref_ann))


def reward_complete(hyp_ann: Dict, ref_ann: Dict) -> float:
    return _f1(_entity_sets_complete(hyp_ann), _entity_sets_complete(ref_ann))


def annotation_from_ner(doc: List[Dict], relations: str = "none") -> Dict:
    """RadNER per-report output -> radgraph-shaped annotation.

    ``relations="heuristic"`` adds rule-based edges following RadGraph's
    dominant patterns (the published DyGIE++ relation extractor is
    offline-unreproducible — see module docstring; applying ONE annotator
    symmetrically to refs and hyps keeps the reward meaningful even though
    absolute numbers are not comparable to the DyGIE++ graph):

    - ``modify``: adjacent same-family entities in sentence order (the
      modifier precedes its head: "left"(ANAT) -> "lobe"(ANAT),
      "small"(OBS) -> "effusion"(OBS));
    - ``located_at``: every OBS-* -> its nearest ANAT-DP in the sentence
      (ties break toward the following anatomy);
    - ``suggestive_of``: consecutive OBS pairs in sentences containing a
      hedge cue (suggest/consistent/compatible/concerning/worrisome).
    """
    entities = {}
    i = 1
    for sentence in doc:
        sent_ids = []
        for text, label in sentence["entities"]:
            entities[str(i)] = {"tokens": text, "label": label, "relations": []}
            sent_ids.append(str(i))
            i += 1
        if relations != "heuristic" or not sent_ids:
            continue
        fam = lambda eid: "ANAT" if entities[eid]["label"].startswith("ANAT") else "OBS"
        # modify: adjacent same-family pairs, modifier -> head
        for a, b in zip(sent_ids, sent_ids[1:]):
            if fam(a) == fam(b):
                entities[a]["relations"].append(["modify", b])
        # located_at: OBS -> nearest ANAT (following wins ties)
        anat_pos = [p for p, eid in enumerate(sent_ids) if fam(eid) == "ANAT"]
        for p, eid in enumerate(sent_ids):
            if fam(eid) == "OBS" and anat_pos:
                tgt = min(anat_pos, key=lambda ap: (abs(ap - p), ap < p))
                entities[eid]["relations"].append(
                    ["located_at", sent_ids[tgt]]
                )
        # suggestive_of: hedge-cued sentences chain consecutive OBS pairs
        text_l = sentence.get("text", "").lower()
        if any(c in text_l for c in ("suggest", "consistent", "compatible",
                                     "concerning", "worrisome")):
            obs_ids = [eid for eid in sent_ids if fam(eid) == "OBS"]
            for a, b in zip(obs_ids, obs_ids[1:]):
                entities[a]["relations"].append(["suggestive_of", b])
    return {"entities": entities}


class F1RadGraphImpl:
    """``__call__(refs, hyps)`` -> ``(reward, reward_list, hyp_annotations,
    ref_annotations)``; with ``reward_level="all"`` the reward is the
    (simple, partial, complete) tuple of means and ``reward_list`` the
    tuple of the three per-report lists, as radgraph's ``F1RadGraph``
    gives them. The NER runs on ``device`` (the card by default)."""

    LEVELS = {"simple": reward_simple, "partial": reward_partial,
              "complete": reward_complete, "all": None}

    def __init__(self, reward_level: str = "all", annotator=None,
                 relations: str = "heuristic", device="cuda", **kwargs):
        if reward_level not in self.LEVELS:
            raise ValueError(f"reward_level {reward_level!r}: one of {sorted(self.LEVELS)}")
        self.reward_level = reward_level
        if annotator is None:
            from .ner import RadNER

            ner = RadNER(device=device)

            def annotator(reports):
                return [annotation_from_ner(doc, relations=relations)
                        for doc in ner.extract(reports)]
        self.annotator = annotator

    def __call__(self, refs: List[str], hyps: List[str]):
        if len(refs) != len(hyps):
            raise ValueError(f"{len(refs)} refs vs {len(hyps)} hyps")
        hyp_anns = self.annotator(list(hyps))
        ref_anns = self.annotator(list(refs))
        if self.reward_level == "all":
            reward_list = tuple([fn(h, r) for h, r in zip(hyp_anns, ref_anns)]
                                for fn in (reward_simple, reward_partial, reward_complete))
            reward = tuple(float(np.mean(x)) if x else 0.0 for x in reward_list)
        else:
            fn = self.LEVELS[self.reward_level]
            reward_list = [fn(h, r) for h, r in zip(hyp_anns, ref_anns)]
            reward = float(np.mean(reward_list)) if reward_list else 0.0
        return reward, reward_list, hyp_anns, ref_anns
