"""The port's BERTScore (its own BERT / DistilBERT encoder, tokenizer and
weight readers) against the JAX package's ``bert_score_prf``, which runs
``transformers`` on the CPU.

Two tiny encoders with random weights are written by ``transformers``: a
BERT (the fixture of ``tests/test_bertscore.py``, ``model.safetensors``)
and a DistilBERT (``pytorch_model.bin``), each with its ``vocab.txt`` and
``tokenizer_config.json``. P / R / F agree within 1e-5 (f32 sums in
another order), with idf off and on, at the default and an explicit layer,
and rescaled by a tsv baseline and by the ``BERTSCORE_BASELINE`` variable.
A tiny RoBERTa (``RobertaModel`` weights behind the byte-level BPE files of
``tests/test_torch_tokenizers.py``) agrees within 1e-5 on right-padded
batches of unequal lengths; a file holding only the layers up to the one
read scores as the whole model; ``roberta-large`` by name reads layer 17.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from vilmedic_torch.scorers import bertscore_impl as tbs
from vilmedic_torch.scorers.bert_encoder import read_safetensors
from vilmedic_torch.scorers.scores import compute_scores
from vilmedic_tpu.scorers import bertscore_impl as jbs

TOL = 1e-5
WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "lungs", "are", "clear",
         "cardiomegaly", "effusion", "no", "acute", "disease", "edema", "mild", ",", ".",
         "##s", "with"]
REFS = ["the lungs are clear", "mild cardiomegaly, no effusion.", "No acute disease",
        "edema with effusions"]
HYPS = ["lungs are clear no disease", "cardiomegaly with effusion", "the lungs are clear.",
        "mild edema"]


def _write(d, kind):
    from transformers import (
        BertConfig, BertModel, BertTokenizer, DistilBertConfig, DistilBertModel,
        DistilBertTokenizer,
    )

    (d / "vocab.txt").write_text("\n".join(WORDS))
    tokenizer = BertTokenizer if kind == "bert" else DistilBertTokenizer
    tokenizer(vocab_file=str(d / "vocab.txt")).save_pretrained(d)
    torch.manual_seed(0)
    if kind == "bert":
        cfg = BertConfig(vocab_size=len(WORDS), hidden_size=16, num_hidden_layers=3,
                         num_attention_heads=2, intermediate_size=32, max_position_embeddings=32)
        BertModel(cfg).save_pretrained(d)
        assert (d / "model.safetensors").exists()
    else:
        cfg = DistilBertConfig(vocab_size=len(WORDS), dim=16, n_layers=3, n_heads=2,
                               hidden_dim=32, max_position_embeddings=32)
        DistilBertModel(cfg).save_pretrained(d, safe_serialization=False)
        assert (d / "pytorch_model.bin").exists()
    return str(d)


@pytest.fixture(scope="module", params=["bert", "distilbert"])
def model_dir(request, tmp_path_factory):
    return _write(tmp_path_factory.mktemp(request.param), request.param)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("idf", [False, True], ids=["idf_off", "idf_on"])
@pytest.mark.parametrize("layer", [None, 1], ids=["last_layer", "layer_1"])
def test_prf_matches_jax(model_dir, idf, layer):
    want = jbs.bert_score_prf(model_dir, REFS, HYPS, layer=layer, idf=idf,
                              rescale_with_baseline=False)
    got = tbs.bert_score_prf(model_dir, REFS, HYPS, layer=layer, idf=idf,
                             rescale_with_baseline=False, device="cpu")
    for g, w in zip(got, want):
        _close(g, w)


def test_idf_dict_matches_jax(model_dir):
    from transformers import AutoTokenizer

    jtok = AutoTokenizer.from_pretrained(model_dir, local_files_only=True)
    ttok, _ = tbs.load_scorer(model_dir, "cpu")
    assert tbs.compute_idf_dict(REFS, ttok) == jbs.compute_idf_dict(REFS, jtok)
    for text in REFS + HYPS:
        assert ttok.encode_truncated(text) == jtok(text, truncation=True)["input_ids"]


@pytest.mark.parametrize("source", ["tsv", "env"])
def test_baselines_match_jax(model_dir, tmp_path, monkeypatch, source):
    monkeypatch.delenv("BERTSCORE_BASELINE", raising=False)
    monkeypatch.delenv("VILMEDIC_WEIGHTS_DIR", raising=False)
    if source == "tsv":
        tsv = tmp_path / "baseline.tsv"
        tsv.write_text("LAYER,P,R,F\n2,0.1,0.2,0.3\n3,0.3,0.4,0.5\n")
        monkeypatch.setenv("BERTSCORE_BASELINE_TSV", str(tsv))
    else:
        monkeypatch.setenv("BERTSCORE_BASELINE", "0.25,0.35,0.45")
    want = jbs.bert_score_prf(model_dir, REFS, HYPS, layer=3)
    got = tbs.bert_score_prf(model_dir, REFS, HYPS, layer=3, device="cpu")
    raw = tbs.bert_score_prf(model_dir, REFS, HYPS, layer=3, rescale_with_baseline=False,
                             device="cpu")
    base = (0.3, 0.4, 0.5) if source == "tsv" else (0.25, 0.35, 0.45)
    for g, w, r, b in zip(got, want, raw, base):
        _close(g, w)
        _close(g, [(x - b) / (1 - b) for x in r])


def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors.torch import load_file, save_file

    gen = torch.Generator().manual_seed(0)
    tensors = {"f32": torch.randn(3, 5, generator=gen),
               "bf16": torch.randn(4, generator=gen).to(torch.bfloat16),
               "f16": torch.randn(2, 2, generator=gen).half(),
               "i64": torch.arange(6).reshape(2, 3), "empty": torch.zeros(0, 4)}
    save_file(tensors, str(tmp_path / "t.safetensors"))
    want = load_file(str(tmp_path / "t.safetensors"))
    got = read_safetensors(str(tmp_path / "t.safetensors"))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and got[name].shape == w.shape
        assert torch.equal(got[name], w)


def test_missing_weights_read_none_with_the_error_logged(model_dir, tmp_path, monkeypatch,
                                                        caplog):
    folder = tmp_path / "no_weights"
    folder.mkdir()
    for name in ("config.json", "vocab.txt", "tokenizer_config.json"):
        (folder / name).write_bytes(open(os.path.join(model_dir, name), "rb").read())
    monkeypatch.setenv("BERTSCORE_MODEL", str(folder))
    logger = logging.getLogger("bertscore_test")
    logger.propagate = True
    with caplog.at_level(logging.ERROR, logger="bertscore_test"):
        scores = compute_scores(["bertscore", "BLEU"], REFS, HYPS, split="validate", seed=0,
                                config={}, epoch=0, logger=logger, dump=False, device="cpu")
    assert scores["bertscore"] is None and scores["BLEU"] is not None
    assert "requires model weights" in caplog.text
    monkeypatch.setenv("BERTSCORE_MODEL", model_dir)
    monkeypatch.setenv("BERTSCORE_BASELINE", "0.1,0.1,0.1")
    scores = compute_scores(["bertscore"], REFS, HYPS, split="validate", seed=0, config={},
                            epoch=0, logger=logger, dump=False, device="cpu")
    want = np.mean(jbs.bert_score_prf(model_dir, REFS, HYPS)[2])
    _close(scores["bertscore"], want)


def test_other_encoders_raise(tmp_path):
    from vilmedic_torch.scorers.bert_encoder import BertEncoder

    with pytest.raises(NotImplementedError, match="modernbert"):
        BertEncoder({"model_type": "modernbert"})
    with pytest.raises(NotImplementedError, match="relu"):
        BertEncoder(dict(model_type="distilbert", vocab_size=8, dim=8, n_layers=1, n_heads=2,
                         hidden_dim=16, max_position_embeddings=8, activation="relu"))


def test_weights_dir_resolution_matches_jax(tmp_path, monkeypatch):
    """An explicit variable, else the ``VILMEDIC_WEIGHTS_DIR`` entry on disk,
    else the default, as the JAX package's ``scorers.weights.resolve``."""
    from vilmedic_torch.scorers import weights as tweights
    from vilmedic_tpu.scorers import weights as jweights

    (tmp_path / "bertscore" / "model").mkdir(parents=True)
    monkeypatch.delenv("BERTSCORE_MODEL", raising=False)
    monkeypatch.delenv("BERTSCORE_BASELINE_TSV", raising=False)
    monkeypatch.setenv("VILMEDIC_WEIGHTS_DIR", str(tmp_path))
    for key in ("BERTSCORE_MODEL", "BERTSCORE_BASELINE_TSV"):
        assert tweights.resolve(key, "d") == jweights.resolve(key, "d")
    assert tweights.resolve("BERTSCORE_MODEL") == str(tmp_path / "bertscore" / "model")
    monkeypatch.setenv("BERTSCORE_MODEL", "explicit")
    assert tweights.resolve("BERTSCORE_MODEL") == jweights.resolve("BERTSCORE_MODEL")


def test_encoder_is_loaded_once_per_directory_and_device(model_dir):
    """A Validator scores every epoch: the directory's encoder is read once
    and kept, whatever spelling of the directory names it."""
    first = tbs.load_scorer(model_dir, "cpu")
    assert tbs.load_scorer(model_dir + os.sep, torch.device("cpu")) is first
    assert tbs.bert_score_prf(model_dir, REFS, HYPS, rescale_with_baseline=False,
                              device="cpu") == tbs.bert_score_prf(
        model_dir, REFS, HYPS, rescale_with_baseline=False, device="cpu")


def _write_roberta(d, layers=3):
    """A tiny RoBERTa (``RobertaModel`` weights by ``transformers``) behind
    the byte-level BPE files of ``tests/test_torch_tokenizers.py``."""
    from test_torch_tokenizers import write_roberta_files
    from transformers import RobertaConfig, RobertaModel

    write_roberta_files(str(d))
    vocab = len(json.load(open(d / "vocab.json")))
    torch.manual_seed(0)
    cfg = RobertaConfig(vocab_size=vocab, hidden_size=16, num_hidden_layers=layers,
                        num_attention_heads=2, intermediate_size=32,
                        max_position_embeddings=130, type_vocab_size=1, pad_token_id=1,
                        bos_token_id=0, eos_token_id=2)
    RobertaModel(cfg).save_pretrained(d)
    return str(d)


@pytest.fixture(scope="module")
def roberta_dir(tmp_path_factory):
    return _write_roberta(tmp_path_factory.mktemp("roberta"))


# right-padded batches of unequal lengths (one long sentence pads the rest)
LONG = "the lungs are clear, no acute disease with mild cardiomegaly and no effusion."


@pytest.mark.parametrize("idf", [False, True], ids=["idf_off", "idf_on"])
@pytest.mark.parametrize("layer", [None, 1], ids=["last_layer", "layer_1"])
def test_roberta_prf_matches_jax(roberta_dir, idf, layer):
    """RoBERTa's encoder (positions from the padding id, a one-row
    token-type table, ``roberta.``-less names) and byte-level BPE against
    ``transformers``' ``RobertaModel`` through JAX's ``bert_score_prf``."""
    refs, hyps = REFS + [LONG], HYPS + ["clear"]
    want = jbs.bert_score_prf(roberta_dir, refs, hyps, layer=layer, idf=idf,
                              rescale_with_baseline=False, batch_size=3)
    got = tbs.bert_score_prf(roberta_dir, refs, hyps, layer=layer, idf=idf,
                             rescale_with_baseline=False, batch_size=3, device="cpu")
    for g, w in zip(got, want):
        _close(g, w)


def test_roberta_reads_only_the_layers_below_the_one_scored(roberta_dir, tmp_path):
    """A file that holds only the layers up to the one read scores as the
    whole model does; the whole model needs every layer."""
    from vilmedic_torch.scorers.bert_encoder import load_weights

    cut = tmp_path / "cut"
    cut.mkdir()
    for name in os.listdir(roberta_dir):
        if name != "model.safetensors":
            (cut / name).write_bytes(open(os.path.join(roberta_dir, name), "rb").read())
    state = {k: v for k, v in load_weights(roberta_dir).items() if "layer.2." not in k}
    torch.save(state, cut / "pytorch_model.bin")
    want = tbs.bert_score_prf(roberta_dir, REFS, HYPS, layer=2, rescale_with_baseline=False,
                              device="cpu")
    got = tbs.bert_score_prf(str(cut), REFS, HYPS, layer=2, rescale_with_baseline=False,
                             device="cpu")
    assert got == want
    with pytest.raises(ValueError, match="lacks"):
        tbs.bert_score_prf(str(cut), REFS, HYPS, rescale_with_baseline=False, device="cpu")


def test_roberta_large_by_name_reads_layer_17(tmp_path, monkeypatch):
    """``BERTSCORE_MODEL=roberta-large`` resolves in the hub cache and reads
    bert_score's layer 17 (``DEFAULT_LAYERS``)."""
    snap = tmp_path / "hub" / "models--roberta-large" / "snapshots" / "r0"
    snap.mkdir(parents=True)
    (tmp_path / "hub" / "models--roberta-large" / "refs").mkdir()
    (tmp_path / "hub" / "models--roberta-large" / "refs" / "main").write_text("r0")
    _write_roberta(snap, layers=18)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    assert tbs.DEFAULT_LAYERS["roberta-large"] == 17
    got = tbs.bert_score_prf("roberta-large", REFS, HYPS, rescale_with_baseline=False,
                             device="cpu")
    assert got == tbs.bert_score_prf(str(snap), REFS, HYPS, layer=17,
                                     rescale_with_baseline=False, device="cpu")
    assert got != tbs.bert_score_prf(str(snap), REFS, HYPS, layer=18,
                                     rescale_with_baseline=False, device="cpu")
