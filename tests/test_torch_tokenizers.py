"""The port's pretrained tokenizers (``data/auto_tokenizer``,
``data/tokenizer_json``, ``data/bpe``) against ``transformers.AutoTokenizer``
over the same directories, which the tests write with ``tokenizers``:

- a WordPiece ``vocab.txt``, cased and uncased (``bert``);
- RoBERTa's ``vocab.json`` + ``merges.txt`` (byte-level BPE, ``<mask>``
  with ``lstrip``);
- a ModernBERT-style ``tokenizer.json``: byte-level BPE whose ``[CLS]`` /
  ``[SEP]`` / ``[PAD]`` ... are added tokens beyond the model vocabulary;
- Llama-2-style ``tokenizer.json`` files with byte fallback: the
  ``Prepend`` + ``Replace`` normalizer, and the ``Metaspace``
  pre-tokenizer;
- a WordPiece ``tokenizer.json`` (``BertNormalizer``, ``BertPreTokenizer``).

For each: ids and masks (with and without special tokens, truncated, left
padded), ``decode`` / ``batch_decode`` with ``skip_special_tokens``,
``vocab_size``, ``len`` and the special ids, over 200 strings that
``hypothesis`` draws (letters of any script, digits such as ``²``,
punctuation, runs of spaces and newlines). Then the ``TextDataset`` collate
against the JAX package's on each, the hub-cache route by name, the
missing-tokenizer error, and the added-token vocabulary case of the VL
model (a reference defect: the JAX VL embedding is sized by ``vocab_size``
and reads NaN at the special ids beyond it).
"""

import json
import os

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

tr = pytest.importorskip("transformers")
tk = pytest.importorskip("tokenizers")

from vilmedic_torch.data.auto_tokenizer import AutoTokenizer as PortAutoTokenizer  # noqa: E402
from vilmedic_torch.data.bpe import bytes_to_unicode, translate_pattern  # noqa: E402

@pytest.fixture(autouse=True)
def offline(monkeypatch):
    """Hold ``transformers`` and the hub client offline: every file is local."""
    import huggingface_hub.constants as hub_constants
    import transformers.utils.hub as hf_hub

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(hub_constants, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(hf_hub, "_is_offline_mode", True)


CORPUS = [
    "The heart size is normal. No focal consolidation, pleural effusion or pneumothorax.",
    "Mild cardiomegaly with small bilateral effusions; lungs are otherwise clear.",
    "Interval placement of a right-sided PICC line, tip at the cavoatrial junction.",
    "Comparison: 12/03/2019. Findings: 3 mm nodule (RUL), unchanged since 2018!",
    "Patient's x-ray shows no acute cardiopulmonary process. Don't re-image?",
    "Café résumé naïve coöperate — São Paulo, Zürich, Ærøskøbing. m² and 10³ cm³.",
    "Пневмония справа. 肺炎 右下葉. Λοίμωξη πνεύμονα. التهاب رئوي.",
    "   leading spaces\tand tabs\nand newlines\n\nand  double  spaces   ",
    "it’s the patient’s “second” study… (see #4) @ 50% & $3 + 2 = 5 <tag> [note] {x}",
]


def _corpus(n=30):
    return [line for _ in range(n) for line in CORPUS]


def _save(path, obj):
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, ensure_ascii=False)


def write_wordpiece_vocab(d, lower: bool):
    """A ``vocab.txt`` directory: specials, the corpus's WordPiece pieces."""
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers, trainers

    t = Tokenizer(models.WordPiece(unk_token="[UNK]"))
    t.normalizer = normalizers.BertNormalizer(lowercase=lower)
    t.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    t.train_from_iterator(_corpus(), trainers.WordPieceTrainer(
        vocab_size=300, special_tokens=["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]))
    vocab = sorted(t.get_vocab().items(), key=lambda kv: kv[1])
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("".join(tok + "\n" for tok, _ in vocab))
    _save(os.path.join(d, "config.json"), {"model_type": "bert"})
    _save(os.path.join(d, "tokenizer_config.json"),
          {"do_lower_case": lower, "model_max_length": 512})
    return d


def _byte_level_bpe(vocab_size, specials):
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    t = Tokenizer(models.BPE())
    t.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    t.decoder = decoders.ByteLevel()
    t.train_from_iterator(_corpus(), trainers.BpeTrainer(
        vocab_size=vocab_size, special_tokens=specials,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    return json.loads(t.to_str())


def write_roberta_files(d, vocab_size=400):
    """``vocab.json`` + ``merges.txt`` + ``config.json`` (no tokenizer
    config), as ``allenai/biomed_roberta_base`` ships them; ``<mask>`` last."""
    spec = _byte_level_bpe(vocab_size, ["<s>", "<pad>", "</s>", "<unk>"])
    vocab = dict(spec["model"]["vocab"])
    vocab["<mask>"] = len(vocab)
    os.makedirs(d, exist_ok=True)
    _save(os.path.join(d, "vocab.json"), vocab)
    merges = [m if isinstance(m, str) else " ".join(m) for m in spec["model"]["merges"]]
    with open(os.path.join(d, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    _save(os.path.join(d, "config.json"), {"model_type": "roberta"})
    return d


MODERNBERT_SPECIALS = ["[UNK]", "[CLS]", "[SEP]", "[PAD]", "[MASK]"]


def modernbert_tokenizer_spec(vocab_size=299, extra=()):
    """A ModernBERT-style ``tokenizer.json`` body: byte-level BPE with
    ``[CLS] $A [SEP]``, the five specials added after the model vocabulary
    (``[MASK]`` with ``lstrip``) and a non-special added token."""
    spec = _byte_level_bpe(vocab_size, [])
    vocab = dict(spec["model"]["vocab"])
    for w in extra:
        vocab.setdefault(w, len(vocab))
    spec["model"]["vocab"] = vocab
    n = len(vocab)
    added = [{"id": n, "content": "|||IP_ADDRESS|||", "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": True, "special": False}]
    for i, tok in enumerate(MODERNBERT_SPECIALS):
        added.append({"id": n + 1 + i, "content": tok, "single_word": False,
                      "lstrip": tok == "[MASK]", "rstrip": False, "normalized": False,
                      "special": True})
    ids = {a["content"]: a["id"] for a in added}
    spec["added_tokens"] = added
    spec["normalizer"] = None
    spec["pre_tokenizer"] = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
                             "use_regex": True}
    spec["post_processor"] = {
        "type": "TemplateProcessing",
        "single": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                   {"Sequence": {"id": "A", "type_id": 0}},
                   {"SpecialToken": {"id": "[SEP]", "type_id": 0}}],
        "pair": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                 {"Sequence": {"id": "A", "type_id": 0}},
                 {"SpecialToken": {"id": "[SEP]", "type_id": 0}},
                 {"Sequence": {"id": "B", "type_id": 1}},
                 {"SpecialToken": {"id": "[SEP]", "type_id": 1}}],
        "special_tokens": {t: {"id": t, "ids": [ids[t]], "tokens": [t]}
                           for t in ("[CLS]", "[SEP]")}}
    spec["decoder"] = {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                       "use_regex": True}
    return spec


def write_modernbert_tokenizer(d, vocab_size=299, extra=()):
    spec = modernbert_tokenizer_spec(vocab_size, extra)
    os.makedirs(d, exist_ok=True)
    _save(os.path.join(d, "tokenizer.json"), spec)
    cfg = {"tokenizer_class": "PreTrainedTokenizerFast", "model_max_length": 8192,
           "clean_up_tokenization_spaces": True,
           "model_input_names": ["input_ids", "attention_mask"],
           "added_tokens_decoder": {str(a["id"]): {k: v for k, v in a.items() if k != "id"}
                                    for a in spec["added_tokens"]}}
    for name, tok in zip(("unk", "cls", "sep", "pad", "mask"), MODERNBERT_SPECIALS):
        cfg[f"{name}_token"] = tok
    _save(os.path.join(d, "tokenizer_config.json"), cfg)
    _save(os.path.join(d, "config.json"), {"model_type": "modernbert"})
    return d


def llama_tokenizer_spec(metaspace: bool, vocab_size=400):
    """A Llama-2-style ``tokenizer.json`` body: ``<unk>`` ``<s>`` ``</s>``,
    the 256 ``<0xXX>`` byte tokens, then BPE pieces over ``▁`` words;
    ``byte_fallback`` and ``fuse_unk``."""
    from tokenizers import Tokenizer, models, normalizers, trainers

    t = Tokenizer(models.BPE(unk_token="<unk>"))
    t.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                         normalizers.Replace(" ", "▁")])
    t.train_from_iterator([s for s in _corpus() if not any(ord(c) > 0x2000 for c in s)],
                          trainers.BpeTrainer(vocab_size=vocab_size, special_tokens=["<unk>"]))
    trained = json.loads(t.to_str())["model"]
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for b in range(256):
        vocab["<0x%02X>" % b] = len(vocab)
    for tok, _ in sorted(trained["vocab"].items(), key=lambda kv: kv[1]):
        vocab.setdefault(tok, len(vocab))
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": c, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True}
                         for i, c in enumerate(["<unk>", "<s>", "</s>"])],
        "normalizer": None if metaspace else {
            "type": "Sequence", "normalizers": [
                {"type": "Prepend", "prepend": "▁"},
                {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]},
        "pre_tokenizer": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first",
                          "split": False} if metaspace else None,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "<s>", "type_id": 1}},
                     {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {"<s>": {"id": "<s>", "ids": [1], "tokens": ["<s>"]}}},
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": trained["merges"]},
    }
    return spec


def write_llama_tokenizer(d, metaspace=False, vocab_size=400, spec=None):
    spec = spec or llama_tokenizer_spec(metaspace, vocab_size)
    os.makedirs(d, exist_ok=True)
    _save(os.path.join(d, "tokenizer.json"), spec)
    tok = lambda c: {"__type": "AddedToken", "content": c, "lstrip": False,  # noqa: E731
                     "normalized": False, "rstrip": False, "single_word": False}
    _save(os.path.join(d, "tokenizer_config.json"), {
        "tokenizer_class": "LlamaTokenizer", "add_bos_token": True, "add_eos_token": False,
        "bos_token": tok("<s>"), "eos_token": tok("</s>"), "unk_token": tok("<unk>"),
        "pad_token": None, "legacy": False, "model_max_length": 1000000000000000019884624838656,
        "clean_up_tokenization_spaces": False, "sp_model_kwargs": {}})
    _save(os.path.join(d, "config.json"), {"model_type": "llama"})
    return d


def write_wordpiece_json(d):
    """A WordPiece ``tokenizer.json`` (BERT's fast serialization)."""
    from tokenizers import Tokenizer, decoders, models, normalizers, pre_tokenizers, processors
    from tokenizers import trainers

    t = Tokenizer(models.WordPiece(unk_token="[UNK]"))
    t.normalizer = normalizers.BertNormalizer(lowercase=True)
    t.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    t.train_from_iterator(_corpus(), trainers.WordPieceTrainer(
        vocab_size=300, special_tokens=["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]))
    t.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B:1 [SEP]:1",
        special_tokens=[("[CLS]", t.token_to_id("[CLS]")), ("[SEP]", t.token_to_id("[SEP]"))])
    t.decoder = decoders.WordPiece(prefix="##")
    os.makedirs(d, exist_ok=True)
    t.save(os.path.join(d, "tokenizer.json"))
    _save(os.path.join(d, "tokenizer_config.json"),
          {"tokenizer_class": "BertTokenizer", "do_lower_case": True, "model_max_length": 512})
    return d


KINDS = {
    "wordpiece_cased": lambda d: write_wordpiece_vocab(d, lower=False),
    "wordpiece_uncased": lambda d: write_wordpiece_vocab(d, lower=True),
    "roberta": write_roberta_files,
    "modernbert": write_modernbert_tokenizer,
    "llama_prepend": lambda d: write_llama_tokenizer(d, metaspace=False),
    "llama_metaspace": lambda d: write_llama_tokenizer(d, metaspace=True),
    "wordpiece_json": write_wordpiece_json,
}


@pytest.fixture(scope="module")
def tokenizer_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tokenizers")
    return {k: make(str(root / k)) for k, make in KINDS.items()}


def _pair(d, padding_side=None):
    kw = {} if padding_side is None else {"padding_side": padding_side}
    theirs = tr.AutoTokenizer.from_pretrained(d, local_files_only=True, **kw)
    ours = PortAutoTokenizer.from_pretrained(d, **kw)
    if theirs.pad_token is None:
        theirs.pad_token = theirs.eos_token
        ours.pad_token = ours.eos_token
    return theirs, ours


EXTRA_CHARS = [" ", "  ", "   ", "\n", "\n\n", "\t", " \n ", "²", "³", "½", "é", "ß", "’", "…",
               "—", "İ", "Σ", "ς", " ", " ", "　", "​", "😀", "🫁", "ﬁ",
               "<mask>", " <mask>", "[MASK]", " [MASK] ", "[CLS]", "<s>", "</s>", "|||IP_ADDRESS|||",
               "'s", "'ll", "n't", "##", "a.", "?!", "()"]
WORDS = sorted({w for line in CORPUS for w in line.split()})

TEXT = st.lists(st.one_of(
    st.sampled_from(WORDS),
    st.sampled_from(EXTRA_CHARS),
    st.text(st.characters(categories=["Lu", "Ll", "Lo", "Nd", "No", "Po", "Ps", "Pe", "Pd",
                                      "Sm", "Sc", "Zs", "Mn"]), max_size=6),
), max_size=14).map("".join)


@pytest.mark.parametrize("kind", list(KINDS))
def test_vocabulary_and_special_ids(tokenizer_dirs, kind):
    theirs, ours = _pair(tokenizer_dirs[kind])
    assert ours.vocab_size == theirs.vocab_size
    assert len(ours) == len(theirs)
    assert ours.vocab == theirs.get_vocab()
    for name in ("unk", "sep", "pad", "cls", "mask", "bos", "eos"):
        assert getattr(ours, f"{name}_token") == getattr(theirs, f"{name}_token"), name
        assert getattr(ours, f"{name}_token_id") == getattr(theirs, f"{name}_token_id"), name
    assert sorted(t.id for t in ours.added.values() if t.special) == sorted(
        i for i, t in theirs.added_tokens_decoder.items() if t.special)


@pytest.mark.parametrize("kind", list(KINDS))
def test_encode_decode_match_transformers(tokenizer_dirs, kind):
    theirs, ours = _pair(tokenizer_dirs[kind])
    rng = np.random.default_rng(0)

    @settings(max_examples=200, deadline=None, derandomize=True,
              suppress_health_check=list(HealthCheck))
    @given(TEXT)
    def check(text):
        for special in (True, False):
            want = theirs(text, add_special_tokens=special)["input_ids"]
            assert ours.encode(text, add_special_tokens=special) == want, (text, special)
        assert ours.tokenize(text) == theirs.tokenize(text), text
        ids = theirs(text)["input_ids"]
        for skip in (False, True):
            assert ours.decode(ids, skip_special_tokens=skip) == theirs.decode(
                ids, skip_special_tokens=skip, clean_up_tokenization_spaces=False), (text, skip)
        noisy = rng.integers(0, len(theirs), 12).tolist()
        for skip in (False, True):
            assert ours.decode(noisy, skip_special_tokens=skip) == theirs.decode(
                noisy, skip_special_tokens=skip, clean_up_tokenization_spaces=False), noisy

    check()


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("side", ["right", "left"])
def test_batches_match_transformers(tokenizer_dirs, kind, side):
    """Truncation to ``max_length``, padding to it or to the longest row,
    on either side; ``batch_decode``."""
    theirs, ours = _pair(tokenizer_dirs[kind], padding_side=side)
    texts = CORPUS + ["", " ", "a"]
    for special in (True, False):
        for max_length, padding in ((None, True), (12, "max_length"), (9, True)):
            kw = dict(add_special_tokens=special, padding=padding, return_tensors="np")
            if max_length is not None:
                kw.update(truncation=True, max_length=max_length)
            want = theirs(texts, **kw)
            ids, mask = ours.encode_batch(texts, max_length=max_length,
                                          add_special_tokens=special,
                                          padding="longest" if padding is True else padding)
            np.testing.assert_array_equal(ids, want["input_ids"])
            np.testing.assert_array_equal(mask, want["attention_mask"])
            for skip in (False, True):
                assert ours.batch_decode(ids, skip_special_tokens=skip) == theirs.batch_decode(
                    ids, skip_special_tokens=skip, clean_up_tokenization_spaces=False)
    assert ours.encode_truncated(" ".join(CORPUS), 16) == theirs.encode(
        " ".join(CORPUS), truncation=True, max_length=16)


def test_pre_tokenizer_regex_classes():
    """``\\p{L}`` / ``\\p{N}`` built from ``unicodedata``, and ``\\s`` as
    Unicode's White_Space (not Python's, which takes U+001C..U+001F)."""
    import re

    from tokenizers import pre_tokenizers

    gpt2 = pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True)
    from vilmedic_torch.data.bpe import GPT2_PATTERN, compile_pattern

    table = bytes_to_unicode()
    samples = ["x²+y³ = z½", "naïve 東京 Ünïcödé", "a  \n\n  b\t\tc   ", "don't I'll we've",
               "\x1c\x1d a\x1fb", "٣٤٥ ١٢", "ǅemal ᾈ", "é   　x", "😀a😀 1😀"]
    for s in samples:
        want = [w for w, _ in gpt2.pre_tokenize_str(s)]
        got = ["".join(table[b] for b in m.group(0).encode()) for m in
               compile_pattern(GPT2_PATTERN).finditer(s)]
        assert got == want, s
    assert re.fullmatch(translate_pattern(r"\p{N}+"), "²³½٣")
    assert not re.fullmatch(translate_pattern(r"\s"), "\x1c")


def test_byte_fallback_fuses_back(tokenizer_dirs):
    """A character outside the vocabulary becomes its ``<0xXX>`` bytes and
    decodes back to one character; a broken byte run reads as U+FFFD each."""
    theirs, ours = _pair(tokenizer_dirs["llama_prepend"])
    ids = ours.encode("it’s ok", add_special_tokens=False)
    toks = ours.convert_ids_to_tokens(ids)
    assert "<0xE2>" in toks and "<0x80>" in toks and "<0x99>" in toks
    assert ours.decode(ids) == "it’s ok" == theirs.decode(ids)
    broken = [ours.vocab["<0xE2>"], ours.vocab["<0x80>"]] + ids[-2:]
    assert ours.decode(broken) == theirs.decode(broken)
    assert ours.decode(broken).startswith("��")


def test_hub_cache_by_name(tmp_path, monkeypatch):
    """A name resolves through the hub cache under ``HF_HUB_CACHE``; a name
    that is not on disk raises, listing the paths tried."""
    snap = tmp_path / "hub" / "models--answerdotai--ModernBERT-base" / "snapshots" / "abc"
    write_modernbert_tokenizer(str(snap))
    (snap.parent.parent / "refs").mkdir()
    (snap.parent.parent / "refs" / "main").write_text("abc")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    ours = PortAutoTokenizer.from_pretrained("answerdotai/ModernBERT-base")
    theirs = tr.AutoTokenizer.from_pretrained(str(snap))
    assert ours.encode(CORPUS[0]) == theirs(CORPUS[0])["input_ids"]
    with pytest.raises(FileNotFoundError, match="models--allenai--biomed_roberta_base"):
        PortAutoTokenizer.from_pretrained("allenai/biomed_roberta_base")


def test_unsupported_component_raises(tmp_path):
    spec = modernbert_tokenizer_spec(280)
    spec["decoder"] = {"type": "CTC", "pad_token": "<pad>"}
    d = tmp_path / "ctc"
    d.mkdir()
    _save(str(d / "tokenizer.json"), spec)
    with pytest.raises(NotImplementedError, match="'CTC'"):
        PortAutoTokenizer.from_pretrained(str(d))


COLLATE_KINDS = ["wordpiece_uncased", "roberta", "modernbert", "llama_prepend"]


@pytest.mark.parametrize("kind", COLLATE_KINDS)
@pytest.mark.parametrize("source,max_len", [("src", None), ("tgt", 16), ("src", 11)])
def test_text_dataset_collate_matches_jax(tokenizer_dirs, tmp_path, kind, source, max_len):
    """``TextDataset(tokenizer=<dir>)``: special tokens on ``tgt`` only;
    ``tokenizer_max_len`` pads to it with truncation, else the longest row
    rounded up to a multiple of 8 with ``pad_token_id or 0``."""
    from vilmedic_torch.data.text import TextDataset as TText
    from vilmedic_tpu.data.text import TextDataset as JText

    (tmp_path / "train.report.tok").write_text("\n".join(CORPUS) + "\n", encoding="utf-8")
    kw = dict(root=str(tmp_path), file="report.tok", split="train", ckpt_dir=str(tmp_path),
              processing=None, tokenizer=tokenizer_dirs[kind], tokenizer_max_len=max_len,
              source=source)
    ours, theirs = TText(**kw), JText(**kw)
    assert ours.tokenizer.vocab_size == theirs.tokenizer.vocab_size
    items = [ours[i] for i in range(len(ours))]
    assert items == [theirs[i] for i in range(len(theirs))]
    if theirs.tokenizer.pad_token is None:  # Llama's: neither package pads without one
        for collate in (ours.get_collate_fn(), theirs.get_collate_fn()):
            with pytest.raises(ValueError, match="pad"):
                collate(items)
        ours.tokenizer.pad_token = ours.tokenizer.eos_token
        theirs.tokenizer.pad_token = theirs.tokenizer.eos_token
    for rows in (items, items[:3], items[5:7]):
        got, want = ours.get_collate_fn()(rows), theirs.get_collate_fn()(rows)
        for key in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(got[key].numpy(), want[key])


def test_added_specials_beyond_vocab_size(tokenizer_dirs):
    """The ModernBERT-style tokenizer's ``[CLS]`` / ``[SEP]`` / ``[PAD]`` are
    added after its model vocabulary, so their ids are at or past
    ``vocab_size``. The JAX VisionLanguage sizes its embedding by
    ``vocab_size`` and its loss is NaN on such ids (``jnp.take`` fills
    out-of-range rows with NaN): a reference defect. The port raises a
    ``ValueError`` naming ``vocab_size`` and the ids instead."""
    import jax
    import jax.numpy as jnp

    from vilmedic_torch.models.vision_language import VisionLanguage as TVL
    from vilmedic_tpu.models import hf_compat
    from vilmedic_tpu.models.vision_language import VisionLanguage as JVL

    theirs, ours = _pair(tokenizer_dirs["modernbert"])
    assert ours.cls_token_id >= ours.vocab_size and ours.pad_token_id >= ours.vocab_size
    dino = dict(model_type="dinov2", hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                mlp_ratio=2.0, patch_size=8, image_size=16, layer_norm_eps=1e-6,
                use_swiglu_ffn=False, hidden_act="gelu")
    decoder = dict(proto=None, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                   intermediate_size=48, max_position_embeddings=32, layer_norm_eps=1e-5,
                   hidden_act="gelu", hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    vision = {"vision_model_name": "tiny/dinov2", "image_size": 16}

    def dl(tok):
        return type("DL", (), {"dataset": type("D", (), {"tokenizer": tok})})()

    orig = hf_compat._resolve_hf_config
    hf_compat._resolve_hf_config = lambda name: dict(dino)
    try:
        jmodel = JVL(decoder=dict(decoder), vision=dict(vision), dl=dl(theirs), dtype="float32")
        ids, mask = ours.encode_batch(["the heart is normal", "no effusion"], max_length=10,
                                      add_special_tokens=True)
        batch = {"images": np.zeros((2, 16, 16, 3), np.float32),
                 "input_ids": ids.astype(np.int32), "attention_mask": mask.astype(np.int32)}
        variables = jax.jit(jmodel.init_variables)(
            jax.random.key(0), {k: jnp.asarray(v) for k, v in batch.items()})
        out, _ = jmodel.apply_train(variables, batch, jax.random.key(1), train=False)
        assert np.isnan(float(out["loss"]))
    finally:
        hf_compat._resolve_hf_config = orig
    with pytest.raises(ValueError, match=r"vocab_size %d" % ours.vocab_size):
        TVL(decoder=dict(decoder), vision=dict(vision), vision_hf_config=dino, dl=dl(ours),
            device="cpu")
    TVL(decoder=dict(decoder), vision=dict(vision), vision_hf_config=dino, dl=dl(ours),
        vocab_size=len(ours), device="cpu")
