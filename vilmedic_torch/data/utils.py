"""Data-layer helpers: line files, the corpus vocabulary, length rounding
(a copy of part of ``data/utils.py`` of the JAX package)."""

from __future__ import annotations

import itertools
from typing import List


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
