"""Data-layer helpers: line files, the corpus vocabulary, the label
vocabulary, length rounding (a copy of part of ``data/utils.py`` of the JAX
package)."""

from __future__ import annotations

import itertools
from typing import List, Optional


def load_file(path: str) -> List[str]:
    """The n-th sentence from line n."""
    with open(path, "r") as f:
        content = f.read().strip()
    return content.split("\n")


class Vocab:
    """Vocabulary built from tokenized train sentences, dumped one word per
    line: the special tokens first (``[CLS]`` 0, ``[PAD]`` 1, ``[SEP]`` 2,
    ``[UNK]`` 3, ``[MASK]`` 4), then every distinct word, sorted, with no
    count threshold."""

    def __init__(self, sentences=None, pad_token="[PAD]", eos_token="[SEP]",
                 bos_token="[CLS]", unk_token="[UNK]", mask_token="[MASK]"):
        tokens = list(itertools.chain(*(sentences or [])))
        self.words = [bos_token, pad_token, eos_token, unk_token, mask_token] + sorted(
            set(tokens))

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("\n".join(str(w) for w in self.words))


def pad_to_multiple(length: int, multiple: int = 8) -> int:
    """Round a sequence length up to a multiple (at least ``multiple``)."""
    return max(multiple, ((length + multiple - 1) // multiple) * multiple)


class Labels:
    """Label vocabulary with single / multi-label detection: the sorted set
    of the comma-separated labels; ``dump`` writes ``multi-label:{flag}``
    then one label per line, and ``load`` reads that back."""

    def __init__(self, labels: Optional[List[str]] = None):
        self.labels: List[str] = []
        self.multi_label = False
        self.label2idx = {}
        self.idx2label = {}
        if labels is not None:
            self.labels = sorted(set(l for label in labels for l in label.split(",")))
            self.multi_label = max(len(label.split(",")) for label in labels) > 1
            self._index()

    def _index(self):
        self.label2idx = {l: i for i, l in enumerate(self.labels)}
        self.idx2label = {i: l for i, l in enumerate(self.labels)}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("\n".join([f"multi-label:{self.multi_label}"] + self.labels))

    def load(self, path: str) -> "Labels":
        with open(path, "r") as f:
            lines = [w.strip() for w in f.readlines()]
        flag = lines.pop(0).split(":")[-1].strip().lower()
        if flag not in ("true", "false"):
            raise ValueError(f"{path}: bad multi-label flag {flag!r}")
        self.multi_label = flag == "true"
        self.labels = lines
        self._index()
        return self

    def __len__(self):
        return len(self.labels)
