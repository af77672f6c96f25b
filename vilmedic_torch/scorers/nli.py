"""The BERTNLI pair classifier and the RadEntity metrics, on the card (port
of ``scorers/nli.py``).

- :class:`BertPairClassifier` is the reference's BERTNLI: BERT with
  segments, its pooler (dense + tanh over [CLS]) and a 3-way head
  (entailment / neutral / contradiction) under the checkpoint's name
  (``linear``, else ``classifier``). :class:`NLIPredictor` reads the
  checkpoint from ``RADNLI_PTH`` (``$VILMEDIC_WEIGHTS_DIR/radnli/
  model_medrad_19k.pth``) and the vocabulary from ``RADNLI_VOCAB``, else
  ``CHEXBERT_VOCAB``, else the hub cache's ``bert-base-uncased``; pairs are
  ``[CLS] s1 [SEP] s2 [SEP]`` with segment ids, cut at 128 tokens, run in
  batches of 24 padded to their longest. The loaded model is kept per
  (checkpoint, device).
- :class:`RadEntityMatchExactImpl`: exact entity precision/recall/F1 over
  RadNER's ANAT/OBS entities, with the upstream quirk kept on purpose:
  recall's numerator counts the hypothesis entities found in the reference
  (as precision's does), so the published self-check gives 0.7.
- :class:`RadEntityNLIImpl`: entity matches gated per sentence by the NLI
  verdict against the most similar sentence of the other report (BERTScore
  F1, the port's ``bert_score_prf`` on ``BERTSCORE_MODEL``). The JAX package
  scores one report's sentence pairs and one NLI pair per call; the port
  gathers the sentence pairs of all reports into one BERTScore call and the
  NLI pairs of all reports into one ``predict``, which gives the same
  per-pair values, then does the same arithmetic.
"""

from __future__ import annotations

import functools
import os
from itertools import chain, product
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

NLI_LABELS = ["entailment", "neutral", "contradiction"]


class BertPairClassifier(nn.Module):
    """BERT + pooler + a linear head named ``head`` (BERTNLI's layout)."""

    def __init__(self, cfg, num_labels: int = 3, head: str = "linear"):
        super().__init__()
        from .bert_encoder import BertEncoder

        self.bert = BertEncoder(cfg, pooler=True)
        self.head = head
        self.add_module(head, nn.Linear(cfg["hidden_size"], num_labels))

    def forward(self, input_ids, attention_mask, token_type_ids) -> torch.Tensor:
        """(B, labels) logits."""
        hidden = self.bert(input_ids, attention_mask, token_type_ids)[-1]
        return getattr(self, self.head)(self.bert.pooled(hidden))


@functools.lru_cache(maxsize=4)
def _load_nli(pth: str, device: str) -> BertPairClassifier:
    from .bert_encoder import bert_config_from_state_dict, load_scorer_state, read_pth

    state = read_pth(pth)
    head = "linear" if "linear.weight" in state else "classifier"
    module = BertPairClassifier(bert_config_from_state_dict(state),
                                num_labels=state[f"{head}.weight"].shape[0], head=head)
    load_scorer_state(module, state)
    return module.to(device).eval()


class NLIPredictor:
    """Batched (premise, hypothesis) -> label (module doc)."""

    def __init__(self, max_len: int = 128, batch_size: int = 24, device="cuda"):
        from ..models.base import resolve_device
        from .chexbert import bert_base_vocab, vocab_tokenizer
        from .clinical import ScorerUnavailable
        from .weights import resolve

        self.max_len = max_len
        self.batch_size = batch_size
        pth = resolve("RADNLI_PTH")
        if not pth or not os.path.exists(pth):
            raise ScorerUnavailable("NLI weights unavailable: set RADNLI_PTH to a BERTNLI "
                                    "torch checkpoint (model_medrad_19k)")
        vocab = bert_base_vocab("RADNLI_VOCAB", "CHEXBERT_VOCAB")
        if vocab is None:
            raise ScorerUnavailable("NLI tokenizer unavailable: set RADNLI_VOCAB or "
                                    "CHEXBERT_VOCAB to a vocab.txt")
        self.module = _load_nli(os.path.abspath(pth), str(resolve_device(device)))
        self.tokenizer = vocab_tokenizer(os.path.abspath(vocab))

    @torch.inference_mode()
    def predict(self, premises: List[str], hypotheses: List[str]) -> List[str]:
        tok = self.tokenizer
        enc = []
        for s1, s2 in zip(premises, hypotheses):
            t1 = tok.encode(s1, add_special_tokens=False)
            t2 = tok.encode(s2, add_special_tokens=False)
            ids = ([tok.cls_token_id] + t1 + [tok.sep_token_id] + t2 + [tok.sep_token_id])
            seg = [0] * (len(t1) + 2) + [1] * (len(t2) + 1)
            enc.append((ids[:self.max_len], seg[:self.max_len]))
        dev = next(self.module.parameters()).device
        preds = []
        for start in range(0, len(enc), self.batch_size):
            chunk = enc[start:start + self.batch_size]
            t = max(len(c[0]) for c in chunk)
            ids, mask, seg = (torch.zeros((len(chunk), t), dtype=torch.long) for _ in range(3))
            for j, (c, sg) in enumerate(chunk):
                ids[j, :len(c)] = torch.tensor(c)
                mask[j, :len(c)] = 1
                seg[j, :len(sg)] = torch.tensor(sg)
            preds.append(self.module(ids.to(dev), mask.to(dev), seg.to(dev)).argmax(dim=-1))
        return [NLI_LABELS[p] for p in (torch.cat(preds).cpu().tolist() if preds else [])]


TARGET_SUBSTRINGS = ("ANAT", "OBS")  # stanza S-ANATOMY/S-OBSERVATION, radgraph ANAT-/OBS-


def _target_entities(sentence: Dict) -> List[str]:
    return [text for text, label in sentence["entities"]
            if any(t in label.upper() for t in TARGET_SUBSTRINGS)]


def _harmonic(pr: float, rc: float) -> float:
    return 2 * pr * rc / (pr + rc) if pr > 0.0 and rc > 0.0 else 0.0


class RadEntityMatchExactImpl:
    """Exact entity match (module doc). ``__call__(refs, hyps)`` ->
    ``(mean, per-report scores, hyp docs, ref docs)``."""

    def __init__(self, ner=None, device="cuda", **kwargs):
        if ner is None:
            from .ner import RadNER

            ner = RadNER(device=device)
        self.ner = ner

    def __call__(self, refs: List[str], hyps: List[str]):
        docs_h = self.ner.extract(list(hyps))
        docs_r = self.ner.extract(list(refs))
        scores_e = []
        for doc_h, doc_r in zip(docs_h, docs_r):
            ner_h = list(chain.from_iterable(_target_entities(s) for s in doc_h))
            ner_r = list(chain.from_iterable(_target_entities(s) for s in doc_r))
            match = sum(1.0 for e in ner_h if e in ner_r)
            pr_e = match / len(ner_h) if ner_h else 0.0
            # recall's numerator: the hypothesis entities found (upstream's quirk, on purpose)
            rc_e = match / len(ner_r) if ner_r else 0.0
            scores_e.append(_harmonic(pr_e, rc_e))
        return float(np.mean(scores_e)) if scores_e else 0.0, scores_e, docs_h, docs_r


class RadEntityNLIImpl:
    """Entity match gated by NLI (module doc). ``__call__(refs, hyps)`` ->
    ``(mean, per-report scores)``; a report pair where either side has no
    sentence gets no score, as upstream."""

    def __init__(self, ner=None, nli=None, sentence_scorer=None,
                 bertscore_model: Optional[str] = None, device="cuda", **kwargs):
        self.match_exact = RadEntityMatchExactImpl(ner=ner, device=device)
        self.nli = nli if nli is not None else NLIPredictor(device=device)
        if sentence_scorer is None:
            from .weights import resolve

            model = bertscore_model or resolve("BERTSCORE_MODEL", "distilbert-base-uncased")

            def sentence_scorer(cands, refs):
                from .bertscore_impl import bert_score_prf

                return bert_score_prf(model, refs, cands, device=device)[2]

        self.sentence_scorer = sentence_scorer

    def __call__(self, refs: List[str], hyps: List[str]):
        _, _, docs_h, docs_r = self.match_exact(refs, hyps)
        reports = []
        for doc_h, doc_r in zip(docs_h, docs_r):
            hyp_report = [s["text"] for s in doc_h]
            ref_report = [s["text"] for s in doc_r]
            if hyp_report and ref_report:
                reports.append((hyp_report, [_target_entities(s) for s in doc_h],
                                ref_report, [_target_entities(s) for s in doc_r]))
        pairs = [p for hyp, _, ref, _ in reports for p in product(hyp, ref)]
        flat = np.asarray(self.sentence_scorer([p[0] for p in pairs], [p[1] for p in pairs])
                          if pairs else [])
        sims, start = [], 0
        for hyp, _, ref, _ in reports:
            sims.append(flat[start:start + len(hyp) * len(ref)].reshape(len(hyp), len(ref)))
            start += len(hyp) * len(ref)

        # (sentence, its entities, the aligned sentence of the other report) per
        # direction and report, then one NLI call over every pair
        directed = []
        for (hyp, ents_h, ref, ents_r), f in zip(reports, sims):
            directed.append([(s, e, ref[int(np.argmax(row))]) for s, e, row in zip(hyp, ents_h, f)
                             if e])
            directed.append([(s, e, hyp[int(np.argmax(row))]) for s, e, row in zip(ref, ents_r, f.T)
                             if e])
        queries = [q for d in directed for q in d]
        labels = iter(self.nli.predict([q[0] for q in queries], [q[2] for q in queries])
                      if queries else [])

        def score(sentences, other_entities):
            match = total = 0
            for _, ents, _ in sentences:
                label = next(labels)
                if label == "entailment":
                    match += 1
                for e in ents:
                    total += 1
                    if label != "contradiction" and e in other_entities:
                        match += 1
            return match / total if total > 0 else 0.0

        scores_e = []
        for i, (_, ents_h, _, ents_r) in enumerate(reports):
            pr_e = score(directed[2 * i], list(chain.from_iterable(ents_r)))
            rc_e = score(directed[2 * i + 1], list(chain.from_iterable(ents_h)))
            scores_e.append(_harmonic(pr_e, rc_e))
        return float(np.mean(scores_e)) if scores_e else 0.0, scores_e
