"""Byte-level BPE, as GPT-2 and RoBERTa tokenize, without ``tokenizers`` or
``regex``.

- :func:`bytes_to_unicode`: GPT-2's table that gives each byte a printable
  character (the printable Latin-1 bytes map to themselves, the rest to
  U+0100 onwards), and its inverse for decoding;
- :func:`translate_pattern`: a pattern written for Oniguruma (the engine
  ``tokenizers`` uses) as a Python ``re`` pattern. Python's ``re`` has no
  ``\\p{...}``: each Unicode general-category class is built from
  ``unicodedata`` as explicit code point ranges, and ``\\s`` / ``\\S``
  become Unicode's White_Space set (Python's own ``\\s`` also takes
  U+001C..U+001F, which Oniguruma's does not);
- :data:`GPT2_PATTERN`: the ByteLevel pre-tokenizer's split
  (``'s|'t|...| ?\\p{L}+| ?\\p{N}+|...``);
- :class:`BPE`: merges applied by rank over a word's characters (a heap of
  adjacent pairs, as ``tokenizers`` runs it), each word's pieces kept in a
  cache, with the ``byte_fallback``, ``fuse_unk``,
  ``ignore_merges``, ``continuing_subword_prefix`` and
  ``end_of_word_suffix`` options of ``tokenizers``' BPE model;
- :func:`roberta_pipeline`: the RoBERTa route over ``vocab.json`` and
  ``merges.txt`` as ``transformers`` converts it: ByteLevel
  pre-tokenization (``add_prefix_space`` false), ``<s> A </s>``, the
  byte-level decoder.
"""

from __future__ import annotations

import functools
import heapq
import json
import re
import sys
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")

#: Unicode's White_Space property: Oniguruma's ``\s`` and Rust's
#: ``char::is_whitespace``.
WHITE_SPACE = ("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005\u2006"
               "\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000")


def is_whitespace(ch: str) -> bool:
    return ch in WHITE_SPACE


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character table."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


@functools.lru_cache(maxsize=None)
def unicode_to_bytes() -> Dict[str, int]:
    return {c: b for b, c in bytes_to_unicode().items()}


@functools.lru_cache(maxsize=None)
def _category_ranges() -> Dict[str, List[Tuple[int, int]]]:
    """Two-letter general category -> sorted code point ranges."""
    ranges: Dict[str, List[Tuple[int, int]]] = {}
    prev_cat, start = None, 0
    for cp in range(sys.maxunicode + 2):
        cat = unicodedata.category(chr(cp)) if cp <= sys.maxunicode else None
        if cat != prev_cat:
            if prev_cat is not None:
                ranges.setdefault(prev_cat, []).append((start, cp - 1))
            prev_cat, start = cat, cp
    return ranges


def _ranges(ranges: Sequence[Tuple[int, int]]) -> str:
    out = []
    for lo, hi in ranges:
        out.append("\\U%08x" % lo if lo == hi else "\\U%08x-\\U%08x" % (lo, hi))
    return "".join(out)


@functools.lru_cache(maxsize=None)
def unicode_class(name: str) -> str:
    """The inside of a character class for ``\\p{name}``: a general
    category (``Lu``) or its group (``L``), code points as ranges."""
    table = _category_ranges()
    cats = [c for c in table if c == name or (len(name) == 1 and c[0] == name)]
    if not cats:
        raise NotImplementedError(f"Unicode class \\p{{{name}}} is not supported")
    merged = sorted(r for c in cats for r in table[c])
    return _ranges(merged)


_WS_CLASS = "".join("\\U%08x" % ord(c) for c in WHITE_SPACE)
_PROP = re.compile(r"\\([pP])\{(\^?)([A-Za-z_]+)\}")


@functools.lru_cache(maxsize=None)
def translate_pattern(pattern: str) -> str:
    """An Oniguruma pattern as a Python ``re`` pattern (``\\p{..}``,
    ``\\P{..}``, ``\\s``, ``\\S``)."""
    out, i, in_class = [], 0, False
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\" and i + 1 < len(pattern):
            nxt = pattern[i + 1]
            m = _PROP.match(pattern, i)
            if m:
                negate = (m.group(1) == "P") != bool(m.group(2))
                body = unicode_class(m.group(3))
                if in_class:
                    if negate:
                        raise NotImplementedError(f"negated class {m.group(0)} inside [...]")
                    out.append(body)
                else:
                    out.append(("[^%s]" if negate else "[%s]") % body)
                i = m.end()
                continue
            if nxt in "sS":
                if in_class:
                    if nxt == "S":
                        raise NotImplementedError("\\S inside [...]")
                    out.append(_WS_CLASS)
                else:
                    out.append(("[%s]" if nxt == "s" else "[^%s]") % _WS_CLASS)
                i += 2
                continue
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if ch == "[" and not in_class:
            in_class = True
            out.append(ch)
            if pattern[i + 1:i + 2] == "^":
                out.append("^")
                i += 1
            if pattern[i + 1:i + 2] == "]":  # a leading ']' is literal
                out.append("\\]")
                i += 1
        elif ch == "]" and in_class:
            in_class = False
            out.append(ch)
        elif ch == "[" and in_class:
            out.append("\\[")
        else:
            out.append(ch)
        i += 1
    return "".join(out)


@functools.lru_cache(maxsize=None)
def compile_pattern(pattern: str) -> "re.Pattern":
    return re.compile(translate_pattern(pattern))


def byte_fallback_token(b: int) -> str:
    return "<0x%02X>" % b


class BPE:
    """``tokenizers``' BPE model: a word's characters (byte-level words are
    already mapped to printable characters) become vocabulary entries, then
    the adjacent pair of lowest merge rank (the leftmost among equals) is
    merged, until no pair has a rank. A character missing from the
    vocabulary becomes its UTF-8 bytes as ``<0xXX>`` tokens
    (``byte_fallback``, when all of them exist), else ``unk_token``
    (consecutive ones fused into one with ``fuse_unk``), else is dropped."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                 unk_token: Optional[str] = None, byte_fallback: bool = False,
                 fuse_unk: bool = False, ignore_merges: bool = False,
                 continuing_subword_prefix: Optional[str] = None,
                 end_of_word_suffix: Optional[str] = None, dropout=None):
        if dropout:
            raise NotImplementedError("BPE dropout is not supported")
        self.vocab = dict(vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.ranks = {tuple(pair): r for r, pair in enumerate(merges)}
        self.unk_token = unk_token
        self.byte_fallback = byte_fallback
        self.fuse_unk = fuse_unk
        self.ignore_merges = ignore_merges
        self.prefix = continuing_subword_prefix or ""
        self.suffix = end_of_word_suffix or ""
        self.cache: Dict[str, List[str]] = {}

    def _symbols(self, word: str) -> List[str]:
        symbols: List[str] = []
        unk_run = False
        for i, ch in enumerate(word):
            piece = (self.prefix if i else "") + ch + (self.suffix if i == len(word) - 1 else "")
            if piece in self.vocab:
                symbols.append(piece)
                unk_run = False
                continue
            if self.byte_fallback:
                pieces = [byte_fallback_token(b) for b in ch.encode("utf-8")]
                if all(p in self.vocab for p in pieces):
                    symbols.extend(pieces)
                    unk_run = False
                    continue
            if self.unk_token is not None:
                if not (self.fuse_unk and unk_run):
                    symbols.append(self.unk_token)
                unk_run = True
        return symbols

    def tokenize(self, word: str) -> List[str]:
        hit = self.cache.get(word)
        if hit is not None:
            return hit
        if self.ignore_merges and word in self.vocab:
            pieces = [word]
        else:
            pieces = self._merge(self._symbols(word))
        if len(self.cache) < 100_000:
            self.cache[word] = pieces
        return pieces

    def _merge(self, toks: List[str]) -> List[str]:
        """``tokenizers``' merge loop: a heap of (rank, position) over the
        adjacent pairs; the least rank, then the leftmost, merges first; a
        popped pair that no longer stands there is skipped."""
        n = len(toks)
        if n < 2:
            return toks
        toks = list(toks)
        nxt = list(range(1, n)) + [-1]
        prev = list(range(-1, n - 1))
        ranks = self.ranks
        heap = [(r, i, toks[i], toks[i + 1]) for i in range(n - 1)
                for r in (ranks.get((toks[i], toks[i + 1])),) if r is not None]
        heapq.heapify(heap)
        alive = [True] * n
        while heap:
            _, i, a, b = heapq.heappop(heap)
            j = nxt[i]
            if not alive[i] or j < 0 or toks[i] != a or toks[j] != b:
                continue
            toks[i] = a + b
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] >= 0:
                prev[nxt[j]] = i
            p, q = prev[i], nxt[i]
            if p >= 0:
                r = ranks.get((toks[p], toks[i]))
                if r is not None:
                    heapq.heappush(heap, (r, p, toks[p], toks[i]))
            if q >= 0:
                r = ranks.get((toks[i], toks[q]))
                if r is not None:
                    heapq.heappush(heap, (r, i, toks[i], toks[q]))
        return [t for t, keep in zip(toks, alive) if keep]


def read_merges(merges_file: str) -> List[Tuple[str, str]]:
    """``merges.txt``: one ``a b`` pair per line after the ``#version``
    header."""
    merges = []
    with open(merges_file, encoding="utf-8") as f:
        for i, line in enumerate(f.read().split("\n")):
            if (i == 0 and line.startswith("#version")) or not line:
                continue
            a, b = line.split(" ")
            merges.append((a, b))
    return merges


def roberta_pipeline(vocab_file: str, merges_file: str, cls: str, sep: str,
                     add_prefix_space: bool = False, trim_offsets: bool = True) -> dict:
    """The ``tokenizer.json`` body ``transformers``' RobertaConverter builds
    from ``vocab.json`` + ``merges.txt``, ``cls`` and ``sep`` around a
    sequence (the added tokens are the caller's to add)."""
    with open(vocab_file, encoding="utf-8") as f:
        vocab = json.load(f)
    return {
        "model": {"type": "BPE", "vocab": vocab, "merges": read_merges(merges_file),
                  "dropout": None, "unk_token": None, "continuing_subword_prefix": "",
                  "end_of_word_suffix": "", "fuse_unk": False},
        "normalizer": None,
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": add_prefix_space,
                          "trim_offsets": trim_offsets, "use_regex": True},
        "post_processor": {"type": "RobertaProcessing", "sep": [sep, vocab.get(sep)],
                           "cls": [cls, vocab.get(cls)], "trim_offsets": trim_offsets,
                           "add_prefix_space": add_prefix_space},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                    "use_regex": True},
        "added_tokens": [],
    }
