"""``AutoTokenizer.from_pretrained`` over local files, as ``transformers``
builds its fast tokenizers, without ``transformers`` or ``tokenizers``.

Where it looks: ``name_or_dir`` itself when it is a directory, else the hub
cache's snapshot of the model ``name_or_dir``
(:func:`..models.base.hub_cached_file`, which honours ``HF_HUB_CACHE`` /
``HF_HOME``). The port never reaches the network: a tokenizer that is not
on disk raises ``FileNotFoundError`` listing the paths that were tried.

Which file it reads, in ``transformers``' order:

1. ``tokenizer.json`` (:class:`.tokenizer_json.PipelineTokenizer`);
2. ``vocab.json`` + ``merges.txt``: RoBERTa's byte-level BPE as
   ``transformers``' converter builds it (:func:`.bpe.roberta_pipeline`);
3. ``vocab.txt``: BERT's WordPiece as its converter builds it
   (``BertNormalizer`` with ``do_lower_case``, ``BertPreTokenizer``,
   ``[CLS] $A [SEP]``, the WordPiece decoder, whose clean-up of spaces
   before punctuation is on).

Which class: ``tokenizer_config.json``'s ``tokenizer_class``, else
``config.json``'s ``model_type``. The class gives the default special
tokens (BERT's ``[CLS]`` ..., RoBERTa's ``<s>`` ... with ``<mask>``
``lstrip``, Llama's ``<s>`` ``</s>`` ``<unk>``) and the adjustments its
``__init__`` makes: BERT's ``do_lower_case`` / ``strip_accents`` /
``tokenize_chinese_chars`` rewrite the ``BertNormalizer``, Llama's
``add_bos_token`` / ``add_eos_token`` rebuild the template, and a
pre-tokenizer with an ``add_prefix_space`` key takes the config's value
(default false). Llama's tokenizer pads on the left unless told otherwise.

Special tokens and settings come from ``tokenizer_config.json``
(``added_tokens_decoder``, ``model_max_length``, ``padding_side``, the
``*_token`` keys), then ``special_tokens_map.json`` over it. A special
token that is not yet an added token becomes one (special,
``normalized`` false): its id is the model's when the model has it, else
the next id after the vocabulary, as ``tokenizers`` numbers them.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

from .bpe import roberta_pipeline
from .tokenizer import load_vocab
from .tokenizer_json import AddedToken, PipelineTokenizer

_BERT = dict(unk_token="[UNK]", sep_token="[SEP]", pad_token="[PAD]", cls_token="[CLS]",
             mask_token="[MASK]")
_ROBERTA = dict(bos_token="<s>", eos_token="</s>", sep_token="</s>", cls_token="<s>",
                unk_token="<unk>", pad_token="<pad>",
                mask_token={"content": "<mask>", "lstrip": True, "normalized": False})
_LLAMA = dict(unk_token="<unk>", bos_token="<s>", eos_token="</s>")

#: tokenizer class (without ``Fast``) -> (family, default special tokens)
CLASSES = {
    "BertTokenizer": ("bert", _BERT),
    "DistilBertTokenizer": ("bert", _BERT),
    "RobertaTokenizer": ("roberta", _ROBERTA),
    "LlamaTokenizer": ("llama", _LLAMA),
    "PreTrainedTokenizer": ("generic", {}),
}
#: ``config.json`` model_type -> tokenizer class, as ``AutoTokenizer`` maps it
MODEL_TYPES = {"bert": "BertTokenizer", "distilbert": "DistilBertTokenizer",
               "roberta": "RobertaTokenizer", "llama": "LlamaTokenizer",
               "modernbert": "PreTrainedTokenizer"}
SPECIAL_KEYS = ("unk_token", "sep_token", "pad_token", "cls_token", "mask_token", "bos_token",
                "eos_token")
FILES = ("tokenizer.json", "vocab.json", "merges.txt", "vocab.txt", "tokenizer_config.json",
         "special_tokens_map.json", "config.json")


def find_files(name_or_dir: str):
    """``{file name: path}`` of the tokenizer files found, and the paths
    that were tried."""
    from ..models.base import hf_hub_cache, hub_cached_file

    if os.path.isdir(name_or_dir):
        paths = {f: os.path.join(name_or_dir, f) for f in FILES}
        found = {f: p for f, p in paths.items() if os.path.isfile(p)}
        return found, [name_or_dir]
    found = {}
    for f in FILES:
        p = hub_cached_file(name_or_dir, f)
        if p is not None:
            found[f] = p
    tried = os.path.join(hf_hub_cache(), "models--" + name_or_dir.replace("/", "--"))
    return found, [os.path.abspath(name_or_dir), tried]


def _read_json(path: Optional[str]) -> dict:
    if path is None:
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _token_spec(value) -> Optional[dict]:
    """A ``*_token`` value of the config: a string or an AddedToken dict."""
    if value is None:
        return None
    if isinstance(value, str):
        return {"content": value}
    return {k: v for k, v in value.items() if k != "__type"}


def _bert_pipeline(vocab_file: str, do_lower_case: bool, strip_accents, chinese: bool,
                   unk: str, cls: str, sep: str) -> dict:
    vocab = load_vocab(vocab_file)
    return {
        "model": {"type": "WordPiece", "vocab": vocab, "unk_token": unk,
                  "continuing_subword_prefix": "##", "max_input_chars_per_word": 100},
        "normalizer": {"type": "BertNormalizer", "clean_text": True,
                       "handle_chinese_chars": chinese, "strip_accents": strip_accents,
                       "lowercase": do_lower_case},
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "post_processor": {"type": "TemplateProcessing",
                           "single": [{"SpecialToken": {"id": cls, "type_id": 0}},
                                      {"Sequence": {"id": "A", "type_id": 0}},
                                      {"SpecialToken": {"id": sep, "type_id": 0}}],
                           "special_tokens": {cls: {"id": cls, "ids": [vocab.get(cls)],
                                                    "tokens": [cls]},
                                              sep: {"id": sep, "ids": [vocab.get(sep)],
                                                    "tokens": [sep]}}},
        "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": True},
        "added_tokens": [],
    }


class AutoTokenizer:
    @staticmethod
    def from_pretrained(name_or_dir: str, padding_side: Optional[str] = None
                        ) -> PipelineTokenizer:
        found, tried = find_files(name_or_dir)
        return from_files(found, name_or_dir, tried, padding_side)


def bert_vocab_tokenizer(vocab_file: str) -> PipelineTokenizer:
    """HF ``BertTokenizer(vocab_file=vocab_file)``: the ``vocab.txt`` route
    with BERT's defaults (lower case, accents stripped)."""
    return from_files({"vocab.txt": vocab_file}, vocab_file, [vocab_file])


def from_files(found: dict, name_or_dir: str, tried: List[str],
               padding_side: Optional[str] = None) -> PipelineTokenizer:
    """The tokenizer of the files ``found`` (``{file name: path}``), as
    :meth:`AutoTokenizer.from_pretrained` reads them (module doc)."""
    cfg = _read_json(found.get("tokenizer_config.json"))
    for key, value in _read_json(found.get("special_tokens_map.json")).items():
        cfg[key] = value
    cls_name = cfg.get("tokenizer_class")
    if cls_name is None:
        model_type = _read_json(found.get("config.json")).get("model_type")
        cls_name = MODEL_TYPES.get(model_type)
        if cls_name is None and model_type is not None:
            raise NotImplementedError(f"tokenizer of model_type {model_type!r} is not ported")
    if cls_name is not None:
        cls_name = cls_name[:-4] if cls_name.endswith("Fast") else cls_name
        if cls_name not in CLASSES:
            raise NotImplementedError(f"tokenizer class {cls_name!r} is not ported")
    family, defaults = CLASSES.get(cls_name, ("generic", {}))
    specials = {k: _token_spec(cfg.get(k, defaults.get(k))) for k in SPECIAL_KEYS}
    content = {k: (v["content"] if v else None) for k, v in specials.items()}
    do_lower = cfg.get("do_lower_case", True)

    if "tokenizer.json" in found:
        spec = _read_json(found["tokenizer.json"])
    elif "vocab.json" in found and "merges.txt" in found:
        if family != "roberta":
            raise NotImplementedError(f"vocab.json + merges.txt for tokenizer class "
                                      f"{cls_name!r}: RoBERTa only")
        spec = roberta_pipeline(found["vocab.json"], found["merges.txt"],
                                content["cls_token"], content["sep_token"],
                                cfg.get("add_prefix_space", False))
    elif "vocab.txt" in found:
        if family not in ("bert", "generic"):
            raise NotImplementedError(f"vocab.txt for tokenizer class {cls_name!r}")
        family = "bert"
        for k, v in _BERT.items():
            if specials[k] is None:
                specials[k], content[k] = {"content": v}, v
        spec = _bert_pipeline(found["vocab.txt"], do_lower, cfg.get("strip_accents"),
                              cfg.get("tokenize_chinese_chars", True), content["unk_token"],
                              content["cls_token"], content["sep_token"])
    else:
        raise FileNotFoundError(
            f"tokenizer {name_or_dir!r}: no tokenizer.json, vocab.json + merges.txt or "
            f"vocab.txt on disk (tried {', '.join(tried)}); the port reads local files only")

    pre = spec.get("pre_tokenizer")
    if pre is not None and "add_prefix_space" in pre:
        if family == "llama" and "add_prefix_space" in cfg:
            raise NotImplementedError("Llama's add_prefix_space rebuilds the tokenizer from "
                                      "its SentencePiece model, which is not ported")
        spec["pre_tokenizer"] = dict(pre, add_prefix_space=cfg.get("add_prefix_space", False))
    norm = spec.get("normalizer")
    if family == "bert" and norm is not None and norm.get("type") == "BertNormalizer":
        spec["normalizer"] = dict(norm, lowercase=do_lower,
                                  strip_accents=cfg.get("strip_accents"),
                                  handle_chinese_chars=cfg.get("tokenize_chinese_chars", True))

    tok = PipelineTokenizer(spec)
    tok.name_or_path = name_or_dir
    tok.tokenizer_class = cls_name
    for k in SPECIAL_KEYS:
        setattr(tok, k, content[k])
    max_len = cfg.get("model_max_length")
    tok.model_max_length = int(max_len) if max_len is not None and max_len < 1e29 else None
    tok.padding_side = padding_side or cfg.get(
        "padding_side", "left" if family == "llama" else "right")

    # the added tokens transformers adds on top of the file's
    added: List[dict] = [dict(v) for _, v in sorted(
        cfg.get("added_tokens_decoder", {}).items(), key=lambda kv: int(kv[0]))]
    special_contents = {c for c in content.values() if c is not None}
    for d in added:
        d["special"] = d.get("special", False) or d["content"] in special_contents
    added += [dict(v, special=True, normalized=v.get("normalized", False))
              for v in specials.values() if v is not None]
    for d in added:
        if d["content"] in tok.added:
            continue
        new_id = tok.model.vocab.get(d["content"])
        tok.add_token(AddedToken(
            d["content"], tok.next_added_id() if new_id is None else new_id,
            d.get("special", False), d.get("single_word", False), d.get("lstrip", False),
            d.get("rstrip", False), d.get("normalized", not d.get("special", False))))

    if family == "llama":
        add_bos, add_eos = cfg.get("add_bos_token", True), cfg.get("add_eos_token", False)
        items, special = [], {}
        for flag, key in ((add_bos, "bos_token"), (add_eos, "eos_token")):
            if flag:
                if content[key] is None:
                    raise ValueError(f"add_{key} = True but {key} = None")
                special[content[key]] = {"id": content[key], "ids": [tok.vocab[content[key]]],
                                         "tokens": [content[key]]}
        if add_bos:
            items.append({"SpecialToken": {"id": content["bos_token"], "type_id": 0}})
        items.append({"Sequence": {"id": "A", "type_id": 0}})
        if add_eos:
            items.append({"SpecialToken": {"id": content["eos_token"], "type_id": 0}})
        tok.set_post_processor({"type": "TemplateProcessing", "single": items,
                                "special_tokens": special})
    return tok
