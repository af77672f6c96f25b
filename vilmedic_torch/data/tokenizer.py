"""WordPiece tokenizer over a vocabulary file, without basic tokenization,
and :class:`BertTokenizer`, the same with BERT's basic tokenization.

The JAX package builds ``transformers.BertTokenizer(vocab_file,
do_basic_tokenize=False)`` over the corpus-built vocabulary
(``data/text.py``). The port needs no ``transformers``: this class gives the
same ids, masks, truncation, padding and decoding for what the collate and
the evaluation loop ask of it:

- the special tokens ``[CLS]``, ``[SEP]``, ``[PAD]``, ``[UNK]``, ``[MASK]``
  are split out of the text wherever they occur;
- the rest splits on whitespace only, with no lower-casing and no
  punctuation split (basic tokenization is off); each word becomes its
  greedy longest-match WordPiece pieces (later pieces prefixed ``##``), or
  ``[UNK]`` if a part of it has no piece or it is longer than 100
  characters;
- ``encode_batch`` adds ``[CLS] ... [SEP]``, truncates the words from the
  end to fit ``max_length``, and pads on the right with ``[PAD]`` to
  ``max_length`` (or to the longest row);
- ``decode`` joins the tokens with spaces and glues ``##`` pieces back;
  ``skip_special_tokens`` drops the five special tokens (``[UNK]`` too).
"""

from __future__ import annotations

import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SPECIAL_TOKENS = ("[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]")


def load_vocab(vocab_file: str) -> Dict[str, int]:
    """Token -> id from one token per line; a repeated token keeps its last
    line."""
    with open(vocab_file, "r", encoding="utf-8") as f:
        return {line.rstrip("\n"): i for i, line in enumerate(f.readlines())}


class WordPieceTokenizer:
    def __init__(self, vocab_file: str, max_input_chars_per_word: int = 100):
        self.vocab_file = vocab_file
        self.vocab = load_vocab(vocab_file)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.max_input_chars_per_word = max_input_chars_per_word
        self.unk_token, self.sep_token, self.pad_token, self.cls_token, self.mask_token = (
            SPECIAL_TOKENS)
        self.all_special_tokens = list(SPECIAL_TOKENS)
        self._special_split = re.compile(
            "(" + "|".join(re.escape(t) for t in SPECIAL_TOKENS) + ")")

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        unk = self.vocab.get(self.unk_token)
        return [self.vocab.get(t, unk) for t in tokens]

    @property
    def unk_token_id(self) -> int:
        return self.vocab.get(self.unk_token)

    @property
    def cls_token_id(self) -> int:
        return self.convert_tokens_to_ids([self.cls_token])[0]

    @property
    def sep_token_id(self) -> int:
        return self.convert_tokens_to_ids([self.sep_token])[0]

    @property
    def pad_token_id(self) -> int:
        return self.convert_tokens_to_ids([self.pad_token])[0]

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_token]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = word[start:end] if start == 0 else "##" + word[start:end]
                if piece in self.vocab:
                    break
                end -= 1
            if end == start:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    def _words(self, chunk: str) -> List[str]:
        return chunk.split()

    def tokenize(self, text: str) -> List[str]:
        tokens = []
        for chunk in self._special_split.split(text):
            if chunk in SPECIAL_TOKENS:
                tokens.append(chunk)
            else:
                for word in self._words(chunk):
                    tokens.extend(self._wordpiece(word))
        return tokens

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        """One text's ids, with ``[CLS]`` ... ``[SEP]`` around them when
        ``add_special_tokens``."""
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        return [self.cls_token_id] + ids + [self.sep_token_id] if add_special_tokens else ids

    def encode_batch(self, texts: Sequence[str], max_length: Optional[int] = None,
                     add_special_tokens: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """``(input_ids, attention_mask)`` int64 arrays (B, L): ``L`` is
        ``max_length`` when given (rows truncated to it), else the longest
        row."""
        rows = []
        n_special = 2 if add_special_tokens else 0
        for text in texts:
            ids = self.convert_tokens_to_ids(self.tokenize(text))
            if max_length is not None and len(ids) + n_special > max_length:
                ids = ids[:max(max_length - n_special, 0)]
            if add_special_tokens:
                ids = [self.cls_token_id] + ids + [self.sep_token_id]
            rows.append(ids)
        width = max_length if max_length is not None else max(len(r) for r in rows)
        input_ids = np.full((len(rows), width), self.pad_token_id, dtype=np.int64)
        mask = np.zeros((len(rows), width), dtype=np.int64)
        for i, ids in enumerate(rows):
            input_ids[i, :len(ids)] = ids
            mask[i, :len(ids)] = 1
        return input_ids, mask

    def decode(self, ids, skip_special_tokens: bool = False,
               clean_up_tokenization_spaces: bool = False) -> str:
        """Tokens joined by spaces with ``##`` pieces glued back; an id
        outside the vocabulary reads as ``[UNK]``. The clean-up of spaces
        before punctuation, which the callers turn off, is not ported."""
        if clean_up_tokenization_spaces:
            raise NotImplementedError("clean_up_tokenization_spaces is not ported")
        tokens = [self.ids_to_tokens.get(int(i), self.unk_token) for i in ids]
        if skip_special_tokens:
            tokens = [t for t in tokens if t not in SPECIAL_TOKENS]
        return " ".join(tokens).replace(" ##", "").strip()


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in (
        (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F)))


class BertTokenizer(WordPieceTokenizer):
    """HF ``BertTokenizer`` with its basic tokenization on, in front of the
    WordPiece above: control characters dropped and whitespace made spaces,
    spaces around CJK characters, NFC, lower case and accents stripped (NFD,
    combining marks dropped) when ``do_lower_case`` (or ``strip_accents``
    says so), then every punctuation character split off as a word.
    ``from_pretrained(folder)`` reads ``vocab.txt`` and
    ``tokenizer_config.json`` (``do_lower_case``, ``strip_accents``,
    ``tokenize_chinese_chars``, ``model_max_length``)."""

    def __init__(self, vocab_file: str, do_lower_case: bool = True, strip_accents=None,
                 tokenize_chinese_chars: bool = True, model_max_length: Optional[int] = None):
        super().__init__(vocab_file)
        self.do_lower_case = do_lower_case
        self.strip_accents = strip_accents
        self.tokenize_chinese_chars = tokenize_chinese_chars
        self.model_max_length = model_max_length

    @classmethod
    def from_pretrained(cls, folder: str) -> "BertTokenizer":
        import json
        import os

        path = os.path.join(folder, "tokenizer_config.json")
        cfg = {}
        if os.path.isfile(path):
            with open(path) as f:
                cfg = json.load(f)
        max_len = cfg.get("model_max_length")
        return cls(os.path.join(folder, "vocab.txt"), cfg.get("do_lower_case", True),
                   cfg.get("strip_accents"), cfg.get("tokenize_chinese_chars", True),
                   int(max_len) if max_len is not None and max_len < 1e29 else None)

    def _words(self, chunk: str) -> List[str]:
        chars = []
        for ch in chunk:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or (ch not in "\t\n\r"
                                           and unicodedata.category(ch).startswith("C")):
                continue
            if ch in " \t\n\r" or unicodedata.category(ch) == "Zs":
                chars.append(" ")
            elif self.tokenize_chinese_chars and _is_cjk(cp):
                chars.append(f" {ch} ")
            else:
                chars.append(ch)
        words = []
        for word in unicodedata.normalize("NFC", "".join(chars)).split():
            if self.do_lower_case:
                word = word.lower()
            if self.strip_accents or (self.strip_accents is None and self.do_lower_case):
                word = "".join(c for c in unicodedata.normalize("NFD", word)
                               if unicodedata.category(c) != "Mn")
            piece = ""
            for ch in word:
                if _is_punctuation(ch):
                    words.extend([piece, ch] if piece else [ch])
                    piece = ""
                else:
                    piece += ch
            if piece:
                words.append(piece)
        return words

    def encode_truncated(self, text: str, max_length: Optional[int] = None) -> List[int]:
        """``[CLS] ids [SEP]``, the ids cut to fit ``max_length``, else
        ``model_max_length`` (HF's ``truncation=True``)."""
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        max_length = max_length if max_length is not None else self.model_max_length
        if max_length is not None:
            ids = ids[:max(max_length - 2, 0)]
        return [self.cls_token_id] + ids + [self.sep_token_id]
