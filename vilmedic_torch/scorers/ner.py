"""Radiology entity extraction with a BERT token classifier, on the card
(port of ``scorers/ner.py``).

:class:`TokenClassifier` is HF ``BertForTokenClassification``:
:class:`.bert_encoder.BertEncoder` (``bert``) plus ``classifier``, so the
checkpoint's state dict loads as it is. :class:`RadNER` reads an HF
directory (``RADNER_MODEL`` or ``$VILMEDIC_WEIGHTS_DIR/radner``):
``config.json`` (the widths and ``id2label``), ``vocab.txt`` and
``tokenizer_config.json`` (``data.auto_tokenizer.AutoTokenizer``) and the weights
(``model.safetensors`` or ``pytorch_model.bin``); without it,
``ScorerUnavailable``. The loaded model is kept per (directory, device).

Tagging is word-level: each word of a sentence becomes its WordPiece
pieces (``[UNK]`` for a word with none), between ``[CLS]`` and ``[SEP]``,
cut at ``max_len`` 128; a word's label is its first piece's argmax.
Sentences run in batches padded to their longest, in f32 on the card unless
the caller names another device; only word-start rows are read, so padded
rows never reach a label. :meth:`RadNER.extract` lowercases each report,
folds ``" ."`` into ``"."``, splits sentences after ``.!?`` and decodes
spans (``S-`` a single-word entity with its full tag, ``B-``/``I-`` spans,
bare labels one entity per word, ``O`` none).
"""

from __future__ import annotations

import functools
import json
import os
import re
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+")


def split_sentences(text: str) -> List[str]:
    return [s for s in _SENT_SPLIT.split(text.strip()) if s]


class TokenClassifier(nn.Module):
    """BERT + a per-token linear head (``BertForTokenClassification``)."""

    def __init__(self, cfg, num_labels: int):
        super().__init__()
        from .bert_encoder import BertEncoder

        self.bert = BertEncoder(cfg)
        self.classifier = nn.Linear(cfg["hidden_size"], num_labels)

    def forward(self, input_ids, attention_mask) -> torch.Tensor:
        """(B, T, labels) logits."""
        return self.classifier(self.bert(input_ids, attention_mask)[-1])


@functools.lru_cache(maxsize=4)
def _load_radner(folder: str, device: str):
    from ..data.auto_tokenizer import AutoTokenizer
    from .bert_encoder import load_scorer_state, load_weights
    from .clinical import _require

    with open(os.path.join(folder, "config.json")) as f:
        cfg = json.load(f)
    id2label = {int(k): v for k, v in cfg["id2label"].items()}
    weights = load_weights(folder)
    _require(weights is not None, "RadNER")
    module = TokenClassifier(cfg, len(id2label))
    load_scorer_state(module, weights)
    return module.to(device).eval(), AutoTokenizer.from_pretrained(folder), id2label


class RadNER:
    """Batched radiology NER over sentences (module doc). ``extract``
    gives, per report, ``[{"text": sentence, "entities": [(text, label),
    ...]}, ...]``, what RadEntityMatchExact and the RadGraph annotations
    read."""

    def __init__(self, model_dir: Optional[str] = None, batch_size: int = 64, max_len: int = 128,
                 device="cuda"):
        from ..models.base import resolve_device
        from .clinical import ScorerUnavailable
        from .weights import resolve

        self.batch_size = batch_size
        self.max_len = max_len
        model_dir = model_dir or resolve("RADNER_MODEL")
        if not model_dir or not os.path.isdir(model_dir):
            raise ScorerUnavailable("radiology NER weights unavailable: set RADNER_MODEL to a "
                                    "local HF BertForTokenClassification directory")
        self.module, self.tokenizer, self.id2label = _load_radner(os.path.abspath(model_dir),
                                                                  str(resolve_device(device)))

    @torch.inference_mode()
    def _tag_sentences(self, sentences: List[str]) -> List[List[Tuple[str, str]]]:
        """(word, label) per word of each sentence."""
        tok = self.tokenizer
        encoded = []
        for s in sentences:
            words = s.split()
            ids, starts = [tok.cls_token_id], []
            for w in words:
                pieces = tok.encode(w, add_special_tokens=False) or [tok.unk_token_id]
                starts.append(len(ids))
                ids.extend(pieces)
            ids.append(tok.sep_token_id)
            encoded.append((ids[:self.max_len], [i for i in starts if i < self.max_len], words))
        dev = next(self.module.parameters()).device
        preds = []
        for start in range(0, len(encoded), self.batch_size):
            chunk = encoded[start:start + self.batch_size]
            t = max(len(c[0]) for c in chunk)
            ids = torch.zeros((len(chunk), t), dtype=torch.long)
            mask = torch.zeros((len(chunk), t), dtype=torch.long)
            for j, (c, _, _) in enumerate(chunk):
                ids[j, :len(c)] = torch.tensor(c)
                mask[j, :len(c)] = 1
            preds.append(self.module(ids.to(dev), mask.to(dev)).argmax(dim=-1))
        rows = [row for p in preds for row in p.cpu().tolist()]
        return [[(w, self.id2label[row[s]]) for w, s in zip(words, starts)]
                for row, (_, starts, words) in zip(rows, encoded)]

    @staticmethod
    def _decode_entities(tagged: List[Tuple[str, str]]) -> List[Tuple[str, str]]:
        entities, cur_words, cur_label = [], [], None

        def flush():
            nonlocal cur_words, cur_label
            if cur_words:
                entities.append((" ".join(cur_words), cur_label))
            cur_words, cur_label = [], None

        for word, label in tagged:
            if label in ("O", "0") or label.startswith("O-"):
                flush()
            elif label.startswith("S-"):  # a single-word entity keeps its full tag
                flush()
                entities.append((word, label))
            elif label.startswith("B-"):
                flush()
                cur_words, cur_label = [word], label[2:]
            elif label.startswith("I-"):
                if cur_words and cur_label == label[2:]:
                    cur_words.append(word)
                else:
                    flush()
                    cur_words, cur_label = [word], label[2:]
            else:  # a bare label (RadGraph's): each word its own entity
                flush()
                entities.append((word, label))
        flush()
        return entities

    def extract(self, reports: List[str]) -> List[List[Dict]]:
        """Per report: ``[{"text": sentence, "entities": [(text, label)]}]``."""
        sent_lists = [split_sentences(r.lower().replace(" .", ".")) for r in reports]
        flat = [s for sents in sent_lists for s in sents]
        tagged = iter(self._tag_sentences(flat) if flat else [])
        return [[{"text": s, "entities": self._decode_entities(next(tagged))} for s in sents]
                for sents in sent_lists]
