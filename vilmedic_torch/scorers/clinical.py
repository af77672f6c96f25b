"""The clinical and neural scorers (port of ``scorers/clinical.py``):
:class:`F1CheXbert`, :class:`F1RadGraph`, :class:`BertScore`,
:class:`RadEvalBERTScorer`, :class:`RadEntityMatchExact`,
:class:`RadEntityNLI`, the :class:`GREEN` judge and the rule-based
:class:`StanfordCTAbdAcc`, with the JAX package's call contracts and
argument orders (``F1CheXbert`` takes ``(hyps, refs)``, the others
``(refs, hyps)``).

Weights are never fetched: a scorer whose weights are not on disk raises
``ScorerUnavailable``, which ``compute_scores`` turns into a ``None`` metric
with the error logged, as the JAX package does. The networks (CheXbert, the
RadNER token classifier, the BERTNLI pair classifier, the BERTScore
encoders) run in f32 on the card unless the caller names another device;
the GREEN judge runs in its checkpoint's dtype there.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np


class ScorerUnavailable(RuntimeError):
    pass


def _require(condition: bool, what: str):
    if not condition:
        raise ScorerUnavailable(
            f"{what} requires model weights that are not available in this "
            f"environment; place them under the HF cache or $VILMEDIC_TPU_CACHE.")


class F1CheXbert:
    """CheXbert's 14-label F1 (:mod:`.chexbert`): ``__call__(hyps, refs)``
    -> ``(accuracy, accuracy_per_sample, chexbert_all, chexbert_5)``."""

    def __init__(self, refs_filename=None, hyps_filename=None, labeler=None, device="cuda",
                 **kwargs):
        from .chexbert import F1CheXbertImpl

        self._impl = F1CheXbertImpl(refs_filename=refs_filename, hyps_filename=hyps_filename,
                                    labeler=labeler, device=device, **kwargs)

    def __call__(self, hyps: List[str], refs: List[str]):
        return self._impl(hyps, refs)


class F1RadGraph:
    """RadGraph's simple / partial / complete F1 (:mod:`.radgraph`):
    ``__call__(refs, hyps)`` -> ``(reward, reward_list, hyp_annotations,
    ref_annotations)``."""

    def __init__(self, reward_level: str = "all", model_type: str = "radgraph-xl",
                 annotator=None, device="cuda", **kwargs):
        from .radgraph import F1RadGraphImpl

        self._impl = F1RadGraphImpl(reward_level=reward_level, annotator=annotator,
                                    device=device, **kwargs)

    def __call__(self, refs: List[str], hyps: List[str]):
        return self._impl(refs=refs, hyps=hyps)


class BertScore:
    """BERTScore F1: distilbert-base-uncased, layer 5, idf off, rescaled
    with the baseline (the reference's configuration). ``BERTSCORE_MODEL``
    (or ``$VILMEDIC_WEIGHTS_DIR/bertscore/model``) names a local model
    directory in place of the model name; a name is looked up in the HF hub
    cache. Calls return ``(mean F1, per-pair F1)``."""

    def __init__(self, model_type: str = "distilbert-base-uncased", idf: bool = False,
                 rescale_with_baseline: bool = True, device="cuda", **kwargs):
        from ..models.base import local_hf_config_dir
        from .weights import resolve

        self.model_type = resolve("BERTSCORE_MODEL", model_type)
        self.idf = idf
        self.rescale_with_baseline = rescale_with_baseline
        self.device = device
        if not os.path.isdir(self.model_type):
            _require(local_hf_config_dir(self.model_type) is not None, "BertScore")

    def __call__(self, refs: List[str], hyps: List[str]) -> Tuple[float, List[float]]:
        from .bertscore_impl import bert_score_f1

        scores = bert_score_f1(self.model_type, refs, hyps, idf=self.idf,
                               rescale_with_baseline=self.rescale_with_baseline,
                               device=self.device)
        return float(np.mean(scores)), scores


class RadEvalBERTScorer:
    """BERTScore F1 at layer 22 of ``IAMJB/RadEvalModernBERT`` (a ModernBERT
    encoder, :mod:`.modernbert`), without baseline rescaling (the
    reference's ``radevalbertscore``). The name is looked up in the HF hub
    cache (``HF_HUB_CACHE`` / ``HF_HOME``), or ``model_type`` names a local
    directory; without its files ``ScorerUnavailable``."""

    def __init__(self, model_type: str = "IAMJB/RadEvalModernBERT", num_layers: int = 22,
                 device="cuda", **kwargs):
        from ..models.base import local_hf_config_dir

        self.model_type = model_type
        self.num_layers = num_layers
        self.device = device
        if not os.path.isdir(model_type):
            _require(local_hf_config_dir(model_type) is not None, "RadEvalBERTScorer")

    def score(self, refs: List[str], hyps: List[str]) -> float:
        from .bertscore_impl import bert_score_f1

        scores = bert_score_f1(self.model_type, refs, hyps, layer=self.num_layers,
                               rescale_with_baseline=False, device=self.device)
        return float(np.mean(scores))


class RadEntityMatchExact:
    """Exact radiology-entity F1 (:class:`.nli.RadEntityMatchExactImpl`):
    ``__call__(refs, hyps)`` -> ``(mean, per-report scores, hyp docs, ref
    docs)``."""

    def __init__(self, ner=None, device="cuda", **kwargs):
        from .nli import RadEntityMatchExactImpl

        self._impl = RadEntityMatchExactImpl(ner=ner, device=device)

    def __call__(self, refs, hyps):
        return self._impl(refs=refs, hyps=hyps)


class GREEN:
    """The LLM judge's clinical error count (:class:`.green.GREENImpl`):
    ``__call__(refs, hyps)`` -> ``(mean GREEN, per-pair scores)``, with the
    global pair -> reward memo."""

    def __init__(self, model_name: str = "StanfordAIMI/GREEN-radllama2-7b", judge_fn=None,
                 device="cuda", **kwargs):
        from .green import GREENImpl

        self._impl = GREENImpl(model_name=model_name, judge_fn=judge_fn, device=device,
                               **kwargs)

    def __call__(self, refs: List[str], hyps: List[str]):
        return self._impl(refs, hyps)


class RadEntityNLI:
    """Entity match gated by NLI (:class:`.nli.RadEntityNLIImpl`):
    ``__call__(refs, hyps)`` -> ``(mean, per-report scores)``."""

    def __init__(self, ner=None, nli=None, sentence_scorer=None, device="cuda", **kwargs):
        from .nli import RadEntityNLIImpl

        self._impl = RadEntityNLIImpl(ner=ner, nli=nli, sentence_scorer=sentence_scorer,
                                      device=device, **kwargs)

    def __call__(self, refs, hyps):
        return self._impl(refs=refs, hyps=hyps)


class StanfordCTAbdAcc:
    """Rule-based CT-abdomen findings accuracy: per report, the share of
    organ systems whose indicative phrases are present in both or neither
    of the reference and the hypothesis."""

    # organ -> indicative phrases (presence in a report = positive)
    LABELS = {
        "liver": ["hepatic steatosis", "liver lesion", "hepatomegaly", "cirrhosis"],
        "gallbladder": ["cholelithiasis", "gallstone", "cholecystitis"],
        "kidney": ["hydronephrosis", "renal calculus", "renal cyst", "nephrolithiasis"],
        "pancreas": ["pancreatitis", "pancreatic duct dilation", "pancreatic lesion"],
        "spleen": ["splenomegaly", "splenic lesion"],
        "bowel": ["obstruction", "ileus", "diverticulitis", "appendicitis"],
        "vasculature": ["aneurysm", "dissection", "thrombosis"],
        "ascites": ["ascites", "free fluid"],
    }

    def __call__(self, refs: List[str], hyps: List[str]):
        per_sample = []
        for r, h in zip(refs, hyps):
            r, h = r.lower(), h.lower()
            agree = sum(int(any(p in r for p in phrases) == any(p in h for p in phrases))
                        for phrases in self.LABELS.values())
            per_sample.append(agree / len(self.LABELS))
        return float(np.mean(per_sample)) if per_sample else 0.0, per_sample
