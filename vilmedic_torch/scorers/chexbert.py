"""The CheXbert labeler and the F1CheXbert metric, on the card (port of
``scorers/chexbert.py``).

CheXbert is a BERT-base encoder with 14 linear heads over the [CLS] state:
13 conditions x 4 classes {blank, positive, negative, uncertain} and "No
Finding" x 2. :class:`CheXbertModule` is :class:`.bert_encoder.BertEncoder`
(``bert``) plus ``linear_heads.{i}``, the checkpoint's names, so the
shipped ``chexbert.pth`` (a ``model_state_dict`` of DataParallel
``module.`` names) loads as it is.

The weights come from ``CHEXBERT_PTH`` (or ``$VILMEDIC_WEIGHTS_DIR``'s
``chexbert/chexbert.pth``), ``$VILMEDIC_TPU_CACHE/chexbert.pth``, or the HF
hub cache of ``StanfordAIMI/RRG_scorers``, read by hand; the vocabulary from
``CHEXBERT_VOCAB`` or the hub cache's ``bert-base-uncased``. Without them
the labeler raises ``ScorerUnavailable``. The loaded labeler is kept per
(checkpoint, device) and the tokenizer per vocabulary, so a Validator that
scores every epoch reads the checkpoint once.

:class:`CheXbert` labels reports in batches sorted by length, each padded
to its longest report (up to 512 tokens), in f32 on the card unless the
caller names another device; the class ids stay on the device until one
copy to the host at the end. :class:`F1CheXbertImpl` is the metric: the
top-5 exact-match accuracy and the multilabel reports over all 14 and the
top 5 conditions (:func:`.classification.multilabel_report`, scikit-learn's
``classification_report(output_dict=True, zero_division=0)``).
"""

from __future__ import annotations

import ast
import functools
import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

CONDITIONS = [
    "Enlarged Cardiomediastinum", "Cardiomegaly", "Lung Opacity", "Lung Lesion",
    "Edema", "Consolidation", "Pneumonia", "Atelectasis", "Pneumothorax",
    "Pleural Effusion", "Pleural Other", "Fracture", "Support Devices",
    "No Finding",
]
TOP5 = ["Cardiomegaly", "Edema", "Consolidation", "Atelectasis", "Pleural Effusion"]
TOP5_INDEX = [CONDITIONS.index(c) for c in TOP5]

# 13 four-way heads (blank/positive/negative/uncertain) + a two-way "No Finding"
HEAD_CLASSES = [4] * 13 + [2]

MAX_LENGTH = 512


class CheXbertModule(nn.Module):
    """BERT + 14 linear heads over [CLS] (the f1chexbert ``BertLabeler``)."""

    def __init__(self, cfg):
        super().__init__()
        from .bert_encoder import BertEncoder

        self.bert = BertEncoder(cfg)
        self.linear_heads = nn.ModuleList(nn.Linear(cfg["hidden_size"], n)
                                          for n in HEAD_CLASSES)

    def forward(self, input_ids, attention_mask) -> List[torch.Tensor]:
        cls = self.bert(input_ids, attention_mask)[-1][:, 0]
        return [head(cls) for head in self.linear_heads]

    def predict_classes(self, input_ids, attention_mask) -> torch.Tensor:
        """(B, 14) class ids: the 2-way head padded with -inf to 4 before
        the argmax."""
        logits = [F.pad(x, (0, 4 - x.shape[-1]), value=-float("inf"))
                  for x in self(input_ids, attention_mask)]
        return torch.stack(logits, dim=1).argmax(dim=-1)


def _resolve_chexbert_pth() -> Optional[str]:
    from ..models.base import hub_cached_file
    from .weights import resolve

    cand = resolve("CHEXBERT_PTH")
    if cand and os.path.exists(cand):
        return cand
    cache = os.environ.get("VILMEDIC_TPU_CACHE")
    if cache and os.path.exists(os.path.join(cache, "chexbert.pth")):
        return os.path.join(cache, "chexbert.pth")
    return hub_cached_file("StanfordAIMI/RRG_scorers", "chexbert.pth")


def bert_base_vocab(*env_keys: str) -> Optional[str]:
    """The first of ``env_keys`` that names a file, else the hub cache's
    ``bert-base-uncased`` ``vocab.txt``, else None."""
    from ..models.base import hub_cached_file
    from .weights import resolve

    for key in env_keys:
        vocab = resolve(key)
        if vocab and os.path.exists(vocab):
            return vocab
    return hub_cached_file("bert-base-uncased", "vocab.txt")


@functools.lru_cache(maxsize=4)
def vocab_tokenizer(vocab: str):
    """HF ``BertTokenizer(vocab_file=vocab)``: basic tokenization, lower
    case (the JAX package's CheXbert and NLI tokenizers)."""
    from ..data.auto_tokenizer import bert_vocab_tokenizer

    return bert_vocab_tokenizer(vocab)


@functools.lru_cache(maxsize=4)
def _load_labeler(pth: str, device: str) -> CheXbertModule:
    from .bert_encoder import bert_config_from_state_dict, load_scorer_state, read_pth

    state = read_pth(pth)
    module = CheXbertModule(bert_config_from_state_dict(state))
    load_scorer_state(module, state)
    return module.to(device).eval()


class CheXbert:
    """The batched CheXbert labeler over the resolved files (module doc)."""

    def __init__(self, batch_size: int = 64, device="cuda"):
        from ..models.base import resolve_device
        from .clinical import ScorerUnavailable

        self.batch_size = batch_size
        pth = _resolve_chexbert_pth()
        if pth is None:
            raise ScorerUnavailable(
                "CheXbert weights not found: set CHEXBERT_PTH or place chexbert.pth under "
                "$VILMEDIC_TPU_CACHE or the HF cache of StanfordAIMI/RRG_scorers.")
        vocab = bert_base_vocab("CHEXBERT_VOCAB")
        if vocab is None:
            raise ScorerUnavailable("bert-base-uncased tokenizer unavailable: set "
                                    "CHEXBERT_VOCAB to a vocab.txt or cache the HF tokenizer")
        self.module = _load_labeler(os.path.abspath(pth), str(resolve_device(device)))
        self.tokenizer = vocab_tokenizer(os.path.abspath(vocab))

    @torch.inference_mode()
    def predict_classes(self, reports: List[str]) -> np.ndarray:
        """(N, 14) class ids in {0 blank, 1 positive, 2 negative, 3
        uncertain} (the "No Finding" head: {0, 1})."""
        enc = [self.tokenizer.encode_truncated(r.strip(), max_length=MAX_LENGTH) for r in reports]
        order = np.argsort([len(e) for e in enc], kind="stable")
        dev = next(self.module.parameters()).device
        preds = []
        for start in range(0, len(order), self.batch_size):
            chunk = [enc[i] for i in order[start:start + self.batch_size]]
            t = max(len(c) for c in chunk)
            ids = torch.zeros((len(chunk), t), dtype=torch.long)
            mask = torch.zeros((len(chunk), t), dtype=torch.long)
            for j, c in enumerate(chunk):
                ids[j, :len(c)] = torch.tensor(c)
                mask[j, :len(c)] = 1
            preds.append(self.module.predict_classes(ids.to(dev), mask.to(dev)))
        out = np.zeros((len(reports), len(CONDITIONS)), np.int64)
        if preds:
            out[order] = torch.cat(preds).cpu().numpy()
        return out

    def get_label(self, report: str, mode: str = "rrg"):
        return self.get_labels([report], mode=mode)[0]

    def get_labels(self, reports: List[str], mode: str = "rrg") -> List[list]:
        """Class ids -> per-condition labels (f1chexbert's ``get_label``):
        ``rrg`` binary, uncertain counted negative; ``classification`` ''
        (blank) / 1 (positive) / 0 (negative) / -1 (uncertain)."""
        if mode not in ("rrg", "classification"):
            raise NotImplementedError(mode)
        rows = []
        for row in self.predict_classes(reports):
            v = [("", 1, 0, -1)[int(c)] for c in row]
            if mode == "rrg":
                v = [1 if (isinstance(x, int) and x > 0) else 0 for x in v]
            rows.append(v)
        return rows


class F1CheXbertImpl:
    """The ``f1chexbert.F1CheXbert`` contract: ``__call__(hyps, refs)`` ->
    ``(accuracy, accuracy_per_sample, chexbert_all, chexbert_5)``, the
    reports keyed by condition plus micro/macro/weighted/samples avg.
    ``refs_filename`` caches the references' labels (one ``repr``'d list per
    line, read back with ``ast.literal_eval``), ``hyps_filename`` keeps the
    hypotheses'."""

    def __init__(self, refs_filename=None, hyps_filename=None, labeler: Optional[CheXbert] = None,
                 device="cuda", **kwargs):
        self.refs_filename = refs_filename
        self.hyps_filename = hyps_filename
        self.labeler = labeler if labeler is not None else CheXbert(device=device)

    def __call__(self, hyps: List[str], refs: List[str]):
        from .classification import multilabel_report

        if self.refs_filename and os.path.exists(self.refs_filename):
            with open(self.refs_filename) as f:
                refs_chexbert = [ast.literal_eval(line.strip()) for line in f]
        else:
            refs_chexbert = self.labeler.get_labels([r.strip() for r in refs])
            if self.refs_filename:
                with open(self.refs_filename, "w") as f:
                    f.write("\n".join(map(str, refs_chexbert)))
        hyps_chexbert = self.labeler.get_labels([h.strip() for h in hyps])
        if self.hyps_filename:
            with open(self.hyps_filename, "w") as f:
                f.write("\n".join(map(str, hyps_chexbert)))

        refs_arr, hyps_arr = np.asarray(refs_chexbert), np.asarray(hyps_chexbert)
        refs_5, hyps_5 = refs_arr[:, TOP5_INDEX], hyps_arr[:, TOP5_INDEX]
        pe_accuracy = (refs_5 == hyps_5).all(axis=1).astype(np.float64)
        accuracy = float(pe_accuracy.mean())
        cr_all = multilabel_report(refs_arr, hyps_arr, CONDITIONS)
        cr_5 = multilabel_report(refs_5, hyps_5, TOP5)
        return accuracy, pe_accuracy, cr_all, cr_5
