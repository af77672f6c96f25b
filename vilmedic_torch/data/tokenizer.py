"""The port's tokenizer interface (:class:`Tokenizer`) and the WordPiece
tokenizer over a vocabulary file without basic tokenization. The
pretrained tokenizers (``tokenizer.json``, byte-level BPE, BERT's
``vocab.txt`` with its basic tokenization) are in :mod:`.tokenizer_json`
and :mod:`.bpe`, and :mod:`.auto_tokenizer` picks one from a directory.

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
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SPECIAL_TOKENS = ("[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]")


def load_vocab(vocab_file: str) -> Dict[str, int]:
    """Token -> id from one token per line; a repeated token keeps its last
    line."""
    with open(vocab_file, "r", encoding="utf-8") as f:
        return {line.rstrip("\n"): i for i, line in enumerate(f.readlines())}


class Tokenizer:
    """The interface every tokenizer of the port gives its callers, in the
    meaning ``transformers`` gives it:

    - ``encode`` / ``encode_batch`` / ``encode_truncated``: ids with the
      special tokens of the tokenizer's template around them
      (``add_special_tokens``), truncated so that the whole row fits
      ``max_length``, and batches padded with ``pad_token_id`` on
      ``padding_side`` (``"right"`` or ``"left"``);
    - ``tokenize``: the tokens without special tokens;
    - ``decode`` / ``batch_decode``: ``skip_special_tokens`` drops the
      special tokens' ids;
    - ``vocab`` (token -> id, added tokens included), ``vocab_size`` (the
      model's vocabulary **without** added tokens), ``len()`` (with them);
    - the special tokens ``{unk,sep,pad,cls,mask,bos,eos}_token`` (None
      where the tokenizer has none) and their ``_id`` properties: a token
      missing from the vocabulary reads as ``unk_token_id``.

    Subclasses give ``tokenize``, ``convert_tokens_to_ids``,
    ``convert_ids_to_tokens`` (dropping the special tokens under
    ``skip_special_tokens``), ``convert_tokens_to_string`` and
    ``special_tokens_around``.
    """

    padding_side = "right"
    model_max_length: Optional[int] = None
    unk_token = sep_token = pad_token = cls_token = mask_token = bos_token = eos_token = None

    # -- what a subclass gives -------------------------------------------
    def tokenize(self, text: str) -> List[str]:
        raise NotImplementedError

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        raise NotImplementedError

    def convert_ids_to_tokens(self, ids: Sequence[int], skip_special_tokens: bool = False
                              ) -> List[str]:
        raise NotImplementedError

    def convert_tokens_to_string(self, tokens: Sequence[str]) -> str:
        raise NotImplementedError

    def special_tokens_around(self) -> Tuple[List[int], List[int]]:
        """The ids the template puts before and after one sequence."""
        raise NotImplementedError

    # -- shared ------------------------------------------------------------
    def text_to_ids(self, text: str) -> List[int]:
        return self.convert_tokens_to_ids(self.tokenize(text))

    def _token_id(self, token: Optional[str]) -> Optional[int]:
        if token is None:
            return None
        i = self.vocab.get(token)
        return i if i is not None else (self.vocab.get(self.unk_token)
                                        if self.unk_token is not None else None)

    unk_token_id = property(lambda self: self._token_id(self.unk_token))
    sep_token_id = property(lambda self: self._token_id(self.sep_token))
    pad_token_id = property(lambda self: self._token_id(self.pad_token))
    cls_token_id = property(lambda self: self._token_id(self.cls_token))
    mask_token_id = property(lambda self: self._token_id(self.mask_token))
    bos_token_id = property(lambda self: self._token_id(self.bos_token))
    eos_token_id = property(lambda self: self._token_id(self.eos_token))

    def num_special_tokens_to_add(self) -> int:
        before, after = self.special_tokens_around()
        return len(before) + len(after)

    def encode(self, text: str, add_special_tokens: bool = True,
               max_length: Optional[int] = None) -> List[int]:
        """One text's ids, cut (from the end) so that the row fits
        ``max_length`` when it is given."""
        ids = self.text_to_ids(text)
        n_special = self.num_special_tokens_to_add() if add_special_tokens else 0
        if max_length is not None and len(ids) + n_special > max_length:
            ids = ids[:max(max_length - n_special, 0)]
        if add_special_tokens:
            before, after = self.special_tokens_around()
            ids = before + ids + after
        return ids

    def encode_truncated(self, text: str, max_length: Optional[int] = None) -> List[int]:
        """HF's ``encode(text, truncation=True)``: the row cut to fit
        ``max_length``, else ``model_max_length``."""
        return self.encode(text, True, max_length if max_length is not None
                           else self.model_max_length)

    def encode_batch(self, texts: Sequence[str], max_length: Optional[int] = None,
                     add_special_tokens: bool = True, padding: Optional[str] = None,
                     padding_side: Optional[str] = None) -> Tuple[np.ndarray, np.ndarray]:
        """``(input_ids, attention_mask)`` int64 arrays (B, L), each row cut to
        ``max_length`` when it is given. ``padding`` ``"max_length"`` (the
        default when ``max_length`` is given) pads to ``max_length``,
        ``"longest"`` (the default otherwise) to the longest row."""
        rows = [self.encode(t, add_special_tokens, max_length) for t in texts]
        padding = padding or ("max_length" if max_length is not None else "longest")
        if padding == "max_length":
            if max_length is None:
                raise ValueError("padding='max_length' needs max_length")
            width = max_length
        elif padding == "longest":
            width = max(len(r) for r in rows)
        else:
            raise ValueError(f"padding {padding!r}: 'longest' or 'max_length'")
        side = padding_side or self.padding_side
        if side not in ("left", "right"):
            raise ValueError(f"padding_side {side!r}: 'left' or 'right'")
        pad = self.pad_token_id
        if pad is None and any(len(r) < width for r in rows):
            raise ValueError("the tokenizer has no pad token to pad the batch with")
        input_ids = np.full((len(rows), width), pad if pad is not None else 0, dtype=np.int64)
        mask = np.zeros((len(rows), width), dtype=np.int64)
        for i, ids in enumerate(rows):
            cols = slice(width - len(ids), width) if side == "left" else slice(0, len(ids))
            input_ids[i, cols] = ids
            mask[i, cols] = 1
        return input_ids, mask

    def decode(self, ids, skip_special_tokens: bool = False,
               clean_up_tokenization_spaces: bool = False) -> str:
        """The text of ``ids``. The clean-up of spaces before punctuation,
        which the callers turn off, is not ported."""
        if clean_up_tokenization_spaces:
            raise NotImplementedError("clean_up_tokenization_spaces is not ported")
        ids = [int(i) for i in np.asarray(ids).reshape(-1)]
        return self.convert_tokens_to_string(self.convert_ids_to_tokens(ids, skip_special_tokens))

    def batch_decode(self, sequences, skip_special_tokens: bool = False,
                     clean_up_tokenization_spaces: bool = False) -> List[str]:
        return [self.decode(s, skip_special_tokens, clean_up_tokenization_spaces)
                for s in sequences]

    def __len__(self) -> int:
        return len(self.vocab)


class WordPieceModel:
    """``tokenizers``' WordPiece: greedy longest match, later pieces with
    ``continuing_subword_prefix``; a word with no split, or longer than
    ``max_input_chars_per_word``, is ``unk_token``."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 continuing_subword_prefix: str = "##", max_input_chars_per_word: int = 100):
        self.vocab = dict(vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.unk_token = unk_token
        self.prefix = continuing_subword_prefix
        self.max_chars = max_input_chars_per_word

    def tokenize(self, word: str) -> List[str]:
        if len(word) > self.max_chars:
            return [self.unk_token]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = word[start:end] if start == 0 else self.prefix + word[start:end]
                if piece in self.vocab:
                    break
                end -= 1
            if end == start:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces


class WordPieceTokenizer(Tokenizer):
    def __init__(self, vocab_file: str, max_input_chars_per_word: int = 100):
        self.vocab_file = vocab_file
        self.vocab = load_vocab(vocab_file)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.model = WordPieceModel(self.vocab, SPECIAL_TOKENS[0],
                                    max_input_chars_per_word=max_input_chars_per_word)
        self.unk_token, self.sep_token, self.pad_token, self.cls_token, self.mask_token = (
            SPECIAL_TOKENS)
        self._special_split = re.compile(
            "(" + "|".join(re.escape(t) for t in SPECIAL_TOKENS) + ")")

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        unk = self.vocab.get(self.unk_token)
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids: Sequence[int], skip_special_tokens: bool = False
                              ) -> List[str]:
        """An id outside the vocabulary reads as ``[UNK]``."""
        tokens = [self.ids_to_tokens.get(int(i), self.unk_token) for i in ids]
        if skip_special_tokens:
            tokens = [t for t in tokens if t not in SPECIAL_TOKENS]
        return tokens

    def convert_tokens_to_string(self, tokens: Sequence[str]) -> str:
        """Tokens joined by spaces with ``##`` pieces glued back."""
        return " ".join(tokens).replace(" ##", "").strip()

    def special_tokens_around(self) -> Tuple[List[int], List[int]]:
        return [self.cls_token_id], [self.sep_token_id]

    def tokenize(self, text: str) -> List[str]:
        tokens = []
        for chunk in self._special_split.split(text):
            if chunk in SPECIAL_TOKENS:
                tokens.append(chunk)
            else:
                for word in chunk.split():
                    tokens.extend(self.model.tokenize(word))
        return tokens
