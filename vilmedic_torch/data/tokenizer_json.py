"""A reader of Hugging Face ``tokenizer.json`` files, without ``tokenizers``.

:class:`PipelineTokenizer` runs the pipeline of ``tokenizers``' ``encode``:

1. the added tokens split the text first: those with ``normalized`` false
   are found in the raw text, the others in the normalized rest (leftmost,
   then longest match), each widened over the whitespace to its left
   (``lstrip``) or right (``rstrip``);
2. the normalizer runs on each piece between them;
3. the pre-tokenizer splits each piece into words;
4. the model (``BPE`` or ``WordPiece``) turns each word into tokens;
5. the post-processor puts the special tokens around the sequence; the ids
   are cut first so that the whole row fits ``max_length``.

Decoding maps ids to tokens (added tokens included; special ones dropped
under ``skip_special_tokens``) and runs the decoder over the token list.

The component types read are those of the byte-level BPE tokenizers
(GPT-2, RoBERTa, ModernBERT), Llama-2's BPE with byte fallback and
BERT's WordPiece:

- models: ``BPE`` (``byte_fallback``, ``fuse_unk``, ``ignore_merges``;
  ``dropout`` null only), ``WordPiece``;
- normalizers: ``Sequence``, ``NFC``, ``NFKC``, ``Lowercase``,
  ``Prepend``, ``Replace``, ``Strip``, ``BertNormalizer``;
- pre-tokenizers: ``Sequence``, ``ByteLevel``, ``Metaspace``, ``Split``,
  ``BertPreTokenizer``, ``Whitespace``;
- post-processors: ``TemplateProcessing``, ``RobertaProcessing``,
  ``BertProcessing``, ``ByteLevel``;
- decoders: ``Sequence``, ``ByteLevel``, ``Metaspace``, ``Replace``,
  ``ByteFallback``, ``Fuse``, ``Strip``, ``WordPiece``.

Any other type raises ``NotImplementedError`` with its name. A ``Split``
or ``Replace`` regex with ``\\p{...}`` goes through
:func:`.bpe.translate_pattern`.
"""

from __future__ import annotations

import json
import re
import unicodedata
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .bpe import (BPE, GPT2_PATTERN, WHITE_SPACE, bytes_to_unicode, compile_pattern, is_whitespace,
                  unicode_to_bytes)
from .tokenizer import Tokenizer, WordPieceModel


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in (
        (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F)))


def _unsupported(kind: str, spec: dict):
    raise NotImplementedError(f"tokenizer.json {kind} type {spec.get('type')!r} is not supported")


def _lower(text: str) -> str:
    # per character, as Rust's char::to_lowercase (no final-sigma rule)
    return "".join(c.lower() for c in text)


def _pattern(spec) -> Tuple[Optional[str], Optional["re.Pattern"]]:
    """``{"String": s}`` or ``{"Regex": r}``: the literal, or the compiled
    regex."""
    if "String" in spec:
        return spec["String"], None
    if "Regex" in spec:
        return None, compile_pattern(spec["Regex"])
    raise NotImplementedError(f"pattern {spec!r}")


def _replace(spec: dict) -> Callable[[str], str]:
    literal, regex = _pattern(spec["pattern"])
    content = spec["content"]
    if regex is None:
        return lambda s: s.replace(literal, content)
    return lambda s: regex.sub(lambda _m: content, s)


# -- normalizers ---------------------------------------------------------------

def _bert_normalizer(spec: dict) -> Callable[[str], str]:
    clean, chinese = spec.get("clean_text", True), spec.get("handle_chinese_chars", True)
    lowercase = spec.get("lowercase", True)
    strip = spec.get("strip_accents")
    strip = lowercase if strip is None else strip

    def run(text: str) -> str:
        if clean:
            text = "".join(" " if (c in "\t\n\r" or is_whitespace(c)) else c for c in text
                           if not (c in ("\0", "�") or (
                               c not in "\t\n\r" and unicodedata.category(c)[0] == "C")))
        if chinese:
            text = "".join(f" {c} " if _is_cjk(ord(c)) else c for c in text)
        if strip:
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        if lowercase:
            text = _lower(text)
        return text

    return run


def build_normalizer(spec: Optional[dict]) -> Callable[[str], str]:
    if spec is None:
        return lambda s: s
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [build_normalizer(n) for n in spec["normalizers"]]

        def run(text: str) -> str:
            for p in parts:
                text = p(text)
            return text

        return run
    if kind in ("NFC", "NFKC"):
        return lambda s: unicodedata.normalize(kind, s)
    if kind == "Lowercase":
        return _lower
    if kind == "Prepend":
        prefix = spec["prepend"]
        return lambda s: prefix + s if s else s
    if kind == "Replace":
        return _replace(spec)
    if kind == "Strip":
        left, right = spec.get("strip_left", True), spec.get("strip_right", True)

        def strip(s: str) -> str:
            if left:
                s = s.lstrip(WHITE_SPACE)
            if right:
                s = s.rstrip(WHITE_SPACE)
            return s

        return strip
    if kind == "BertNormalizer":
        return _bert_normalizer(spec)
    _unsupported("normalizer", spec)


# -- pre-tokenizers --------------------------------------------------------------
# A pre-tokenizer maps (piece, starts the text) to its words, each with
# whether it starts the text.

Words = List[Tuple[str, bool]]


def _split_spans(text: str, spans: List[Tuple[int, int]], behavior: str,
                 invert: bool = False) -> List[str]:
    """``tokenizers``' ``split`` with the delimiters at ``spans``."""
    marks, pos = [], 0  # (start, end, is_delimiter)
    for s, e in spans:
        if s > pos:
            marks.append((pos, s, False))
        marks.append((s, e, True))
        pos = e
    if pos < len(text):
        marks.append((pos, len(text), False))
    if invert:
        marks = [(s, e, not d) for s, e, d in marks]
    out: List[List[int]] = []
    if behavior == "Removed":
        out = [[s, e] for s, e, d in marks if not d]
    elif behavior == "Isolated":
        out = [[s, e] for s, e, _ in marks]
    elif behavior == "MergedWithPrevious":
        prev_delim = False
        for s, e, d in marks:
            if d and out and not prev_delim:
                out[-1][1] = e
            else:
                out.append([s, e])
            prev_delim = d
    elif behavior == "MergedWithNext":
        carry = None
        for s, e, d in marks:
            if d:
                if carry is not None:
                    out.append([carry, s])
                carry = s
            else:
                out.append([carry if carry is not None else s, e])
                carry = None
        if carry is not None:
            out.append([carry, len(text)])
    elif behavior == "Contiguous":
        prev_delim = False
        for s, e, d in marks:
            if d and prev_delim and out:
                out[-1][1] = e
            else:
                out.append([s, e])
            prev_delim = d
    else:
        raise NotImplementedError(f"split behavior {behavior!r}")
    return [text[s:e] for s, e in out if e > s]


def _with_first(pieces: List[str], first: bool) -> Words:
    return [(p, first and i == 0) for i, p in enumerate(pieces)]


def build_pre_tokenizer(spec: Optional[dict]) -> Callable[[str, bool], Words]:
    if spec is None:
        return lambda text, first: [(text, first)]
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [build_pre_tokenizer(p) for p in spec["pretokenizers"]]

        def run(text: str, first: bool) -> Words:
            words = [(text, first)]
            for p in parts:
                words = [w for piece, f in words for w in p(piece, f)]
            return words

        return run
    if kind == "ByteLevel":
        prefix_space = spec.get("add_prefix_space", True)
        use_regex = spec.get("use_regex", True)
        table = bytes_to_unicode()

        def run(text: str, first: bool) -> Words:
            if prefix_space and not text.startswith(" "):
                text = " " + text
            pieces = ([m.group(0) for m in compile_pattern(GPT2_PATTERN).finditer(text)]
                      if use_regex else [text])
            return _with_first(["".join(table[b] for b in p.encode("utf-8")) for p in pieces],
                               first)

        return run
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        split = spec.get("split", True)

        def run(text: str, first: bool) -> Words:
            text = text.replace(" ", rep)
            if not text.startswith(rep) and (scheme == "always" or (scheme == "first" and first)):
                text = rep + text
            if not split:
                return [(text, first)]
            spans = [(m.start(), m.end()) for m in re.finditer(re.escape(rep), text)]
            return _with_first(_split_spans(text, spans, "MergedWithNext"), first)

        return run
    if kind == "Split":
        literal, regex = _pattern(spec["pattern"])
        behavior, invert = spec.get("behavior", "Isolated"), spec.get("invert", False)
        regex = regex or re.compile(re.escape(literal))

        def run(text: str, first: bool) -> Words:
            spans = [(m.start(), m.end()) for m in regex.finditer(text) if m.end() > m.start()]
            return _with_first(_split_spans(text, spans, behavior, invert), first)

        return run
    if kind == "BertPreTokenizer":
        def run(text: str, first: bool) -> Words:
            words = []
            for word in "".join(" " if is_whitespace(c) else c for c in text).split(" "):
                piece = ""
                for ch in word:
                    if _is_punctuation(ch):
                        words.extend([piece, ch] if piece else [ch])
                        piece = ""
                    else:
                        piece += ch
                if piece:
                    words.append(piece)
            return _with_first(words, first)

        return run
    if kind == "Whitespace":
        pattern = re.compile(r"\w+|[^\w\s]+")
        return lambda text, first: _with_first(pattern.findall(text), first)
    _unsupported("pre-tokenizer", spec)


# -- models ----------------------------------------------------------------------

def build_model(spec: dict):
    kind = spec.get("type")
    if kind == "BPE" or (kind is None and "merges" in spec):
        merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
                  for m in spec.get("merges", [])]
        return BPE(spec["vocab"], merges, unk_token=spec.get("unk_token"),
                   byte_fallback=spec.get("byte_fallback", False),
                   fuse_unk=spec.get("fuse_unk", False),
                   ignore_merges=spec.get("ignore_merges", False),
                   continuing_subword_prefix=spec.get("continuing_subword_prefix"),
                   end_of_word_suffix=spec.get("end_of_word_suffix"),
                   dropout=spec.get("dropout"))
    if kind == "WordPiece":
        return WordPieceModel(spec["vocab"], spec.get("unk_token", "[UNK]"),
                              spec.get("continuing_subword_prefix", "##"),
                              spec.get("max_input_chars_per_word", 100))
    _unsupported("model", spec)


# -- post-processors -------------------------------------------------------------

def build_post_processor(spec: Optional[dict]) -> Tuple[List[int], List[int]]:
    """The ids a single sequence gets before and after it."""
    if spec is None:
        return [], []
    kind = spec.get("type")
    if kind in ("RobertaProcessing", "BertProcessing"):
        return [int(spec["cls"][1])], [int(spec["sep"][1])]
    if kind == "ByteLevel":
        return [], []
    if kind == "TemplateProcessing":
        before, after, seen = [], [], False
        for item in spec["single"]:
            if "Sequence" in item:
                seen = True
            else:
                ids = spec["special_tokens"][item["SpecialToken"]["id"]]["ids"]
                (after if seen else before).extend(int(i) for i in ids)
        return before, after
    _unsupported("post-processor", spec)


# -- decoders --------------------------------------------------------------------

_CLEANUP = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"), (" n't", "n't"),
            (" 'm", "'m"), (" do not", " don't"), (" 's", "'s"), (" 've", "'ve"),
            (" 're", "'re"))


def _byte_level_decode(tokens: List[str]) -> List[str]:
    table = unicode_to_bytes()
    out = bytearray()
    for t in tokens:
        if all(c in table for c in t):
            out.extend(table[c] for c in t)
        else:
            out.extend(t.encode("utf-8"))
    return [out.decode("utf-8", errors="replace")]


def _byte_fallback_decode(tokens: List[str]) -> List[str]:
    out, pending = [], bytearray()

    def flush():
        if pending:
            try:
                out.append(pending.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend(["�"] * len(pending))
            pending.clear()

    for t in tokens:
        if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
            try:
                pending.append(int(t[3:5], 16))
                continue
            except ValueError:
                pass
        flush()
        out.append(t)
    flush()
    return out


def build_decoder(spec: Optional[dict]) -> Callable[[List[str]], List[str]]:
    if spec is None:
        return lambda tokens: [" ".join(tokens)]
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [build_decoder(d) for d in spec["decoders"]]

        def run(tokens: List[str]) -> List[str]:
            for p in parts:
                tokens = p(tokens)
            return tokens

        return run
    if kind == "ByteLevel":
        return _byte_level_decode
    if kind == "ByteFallback":
        return _byte_fallback_decode
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Replace":
        f = _replace(spec)
        return lambda tokens: [f(t) for t in tokens]
    if kind == "Strip":
        content, start, stop = spec["content"], spec.get("start", 0), spec.get("stop", 0)

        def strip(t: str) -> str:
            lo, hi = 0, len(t)
            while lo < min(start, len(t)) and t[lo] == content:
                lo += 1
            n = 0
            while n < stop and hi - 1 >= lo and t[hi - 1] == content:
                hi -= 1
                n += 1
            return t[lo:hi]

        return lambda tokens: [strip(t) for t in tokens]
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"

        def run(tokens: List[str]) -> List[str]:
            out = []
            for i, t in enumerate(tokens):
                t = t.replace(rep, " ")
                if i == 0 and scheme != "never" and t.startswith(" "):
                    t = t[1:]
                out.append(t)
            return out

        return run
    if kind == "WordPiece":
        prefix, cleanup = spec.get("prefix", "##"), spec.get("cleanup", True)

        def run(tokens: List[str]) -> List[str]:
            out = []
            for i, t in enumerate(tokens):
                if i:
                    t = t.replace(prefix, "", 1) if t.startswith(prefix) else " " + t
                if cleanup:
                    for a, b in _CLEANUP:
                        t = t.replace(a, b)
                out.append(t)
            return out

        return run
    _unsupported("decoder", spec)


# -- the tokenizer ---------------------------------------------------------------

@dataclass
class AddedToken:
    content: str
    id: int
    special: bool = False
    single_word: bool = False
    lstrip: bool = False
    rstrip: bool = False
    normalized: bool = True


class PipelineTokenizer(Tokenizer):
    """A ``tokenizer.json`` body run as ``tokenizers`` runs it, with the
    special-token attributes of :class:`.tokenizer.Tokenizer` set by the
    caller (:mod:`.auto_tokenizer`)."""

    def __init__(self, spec: dict):
        if spec.get("truncation") or spec.get("padding"):
            raise NotImplementedError("tokenizer.json truncation / padding settings are not "
                                      "supported")
        self.spec = spec
        self.model = build_model(spec["model"])
        self.normalize = build_normalizer(spec.get("normalizer"))
        self.pre_tokenize = build_pre_tokenizer(spec.get("pre_tokenizer"))
        self.set_post_processor(spec.get("post_processor"))
        self.decoder = build_decoder(spec.get("decoder"))
        self.added: Dict[str, AddedToken] = {}
        for tok in spec.get("added_tokens", []):
            self.add_token(AddedToken(tok["content"], int(tok["id"]), tok.get("special", False),
                                      tok.get("single_word", False), tok.get("lstrip", False),
                                      tok.get("rstrip", False), tok.get("normalized", True)))

    @classmethod
    def from_file(cls, path: str) -> "PipelineTokenizer":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    def set_post_processor(self, spec: Optional[dict]):
        self.post_processor_spec = spec
        self._around = build_post_processor(spec)

    # -- vocabulary
    def add_token(self, token: AddedToken):
        """Add (or replace) an added token, as ``tokenizers`` does: its id
        is the model's where the model has the token, else the given one."""
        self.added[token.content] = token
        self._refresh()

    def next_added_id(self) -> int:
        """The id ``tokenizers`` gives a new added token that the model
        lacks."""
        size = len(self.model.vocab)
        ids = [t.id for t in self.added.values()]
        if not ids:
            return size
        top = max(ids)
        return top + 1 if top >= size or size == 0 else size

    def _refresh(self):
        self.added_ids = {t.id: t for t in self.added.values()}
        self.vocab = dict(self.model.vocab)
        self.vocab.update({t.content: t.id for t in self.added.values()})
        self._matchers = {}

    @property
    def vocab_size(self) -> int:
        return len(self.model.vocab)

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        unk = self._token_id(self.unk_token) if self.unk_token is not None else None
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids: Sequence[int], skip_special_tokens: bool = False
                              ) -> List[str]:
        tokens = []
        for i in ids:
            added = self.added_ids.get(int(i))
            if added is not None:
                if not (skip_special_tokens and added.special):
                    tokens.append(added.content)
                continue
            t = self.model.ids_to_tokens.get(int(i))
            if t is not None:  # an id outside the vocabulary is dropped
                tokens.append(t)
        return tokens

    def convert_tokens_to_string(self, tokens: Sequence[str]) -> str:
        return "".join(self.decoder(list(tokens)))

    def special_tokens_around(self) -> Tuple[List[int], List[int]]:
        return list(self._around[0]), list(self._around[1])

    # -- encoding
    def _matcher(self, normalized: bool):
        m = self._matchers.get(normalized)
        if m is None:
            toks = [t for t in self.added.values() if t.normalized == normalized]
            table = {}
            for t in toks:
                key = self.normalize(t.content) if normalized else t.content
                if key:
                    table.setdefault(key, t)
            keys = sorted(table, key=len, reverse=True)
            regex = re.compile("|".join(re.escape(k) for k in keys)) if keys else None
            m = self._matchers[normalized] = (regex, table)
        return m

    def _split_added(self, text: str, normalized: bool) -> List[Tuple[str, Optional[int]]]:
        """``text`` cut at the added tokens of one kind: (piece, None) or
        (token's text, id)."""
        regex, table = self._matcher(normalized)
        if regex is None:
            return [(text, None)]
        out, pos = [], 0
        for m in regex.finditer(text):
            tok = table[m.group(0)]
            start, end = m.start(), m.end()
            if start < pos:
                continue
            if tok.single_word and ((start > 0 and _word_char(text[start - 1]))
                                    or (end < len(text) and _word_char(text[end]))):
                continue
            if tok.lstrip:
                while start > pos and is_whitespace(text[start - 1]):
                    start -= 1
            if tok.rstrip:
                while end < len(text) and is_whitespace(text[end]):
                    end += 1
            if start > pos:
                out.append((text[pos:start], None))
            out.append((text[start:end], tok.id))
            pos = end
        if pos < len(text):
            out.append((text[pos:], None))
        return out

    def tokenize(self, text: str) -> List[str]:
        return [t for t, _ in self._encode(text)]

    def text_to_ids(self, text: str) -> List[int]:
        return [i for _, i in self._encode(text)]

    def _encode(self, text: str) -> List[Tuple[str, int]]:
        out, offset = [], 0
        for raw, raw_id in self._split_added(text, normalized=False):
            first = offset == 0
            offset += len(raw)
            if raw_id is not None:
                out.append((raw, raw_id))  # the matched text, stripped spaces included
                continue
            for piece, piece_id in self._split_added(self.normalize(raw), normalized=True):
                if piece_id is not None:
                    out.append((piece, piece_id))
                    first = False
                    continue
                for word, _ in self.pre_tokenize(piece, first):
                    for tok in self.model.tokenize(word):
                        out.append((tok, self.vocab.get(tok)))
                first = False
        return [(t, i) for t, i in out if i is not None]


def _word_char(ch: str) -> bool:
    return ch.isalnum() or ch == "_"
