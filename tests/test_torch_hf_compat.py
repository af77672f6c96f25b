"""The HF-surface protos ``RRG_HF`` / ``RRS_HF`` and ``ImSeq2Seq``, the port
against the JAX package on the CPU, float32.

- ``_resolve_hf_config`` / ``_config_args``: a local directory, a fake HF
  hub cache under ``tmp_path`` and nested ``vision-encoder-decoder`` /
  ``encoder-decoder`` files resolve to JAX's ViT and decoder fields (JAX
  goes through ``transformers.AutoConfig``), exactly; a dict section gives
  its ``proto_config_args``; a missing name raises JAX's offline text;
  weights beside the config resolve as without them, and a model type
  without class defaults raises;
  both protos build on the card unless asked for the CPU.
- ``RRG_HF`` (a 2-layer post-LN ViT of 32 projected to a 2-layer
  ``bert-generation`` decoder of 64, the tokenizer's ids injected), weights
  carried by ``rrg_hf_state_dict_from_jax``: the loss within 1e-5 and equal
  beam-4 sequences at vocab 4500 (the blocked-stats head) for a 4-D batch
  and a multi-image batch with one image masked.
- ``RRS_HF`` from a tiny RoBERTa-type ``config.json`` (encoder and decoder
  names, the LM-head transform): the loss within 1e-5 and equal beam-2
  sequences (the HF config's beam).
- ``ImSeq2Seq``: collated batches and ``inference`` batches equal to JAX's.
- One train-CLI step of ``config/RRG/baseline-mimic-HF.yml`` with
  ``multi_image`` 2, cut to a tiny ViT and decoder, against
  ``bin_tpu/train.py``'s Trainor on the JPEG lines of
  tests/test_models_families.py's multi-image case: the loss within 1e-5
  relative, equal hypotheses.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers.utils.hub as hf_hub
import yaml
from PIL import Image

import vilmedic_torch.bin.train as tcli
from vilmedic_torch.blocks import transformer as tt
from vilmedic_torch.data.composites import ImSeq2Seq as TImSeq2Seq
from vilmedic_torch.executors import Trainor as TTrainor
from vilmedic_torch.models import evaluation_nlg as teval
from vilmedic_torch.models import hf_compat as thf
from vilmedic_torch.zoo.from_jax import rrg_hf_state_dict_from_jax, rrs_hf_state_dict_from_jax
from vilmedic_tpu.blocks import transformer as jt
from vilmedic_tpu.config.config import executor_config, load_config
from vilmedic_tpu.data.composites import ImSeq2Seq as JImSeq2Seq
from vilmedic_tpu.decoding import decode as jdecode
from vilmedic_tpu.executors import Trainor as JTrainor
from vilmedic_tpu.executors import Validator as JValidator
from vilmedic_tpu.models import evaluation_nlg as jeval
from vilmedic_tpu.models import hf_compat as jhf
from vilmedic_tpu.utils import set_logger as jset_logger

TOL = 1e-5
FIELDS = [f.name for f in dataclasses.fields(tt.TransformerConfig) if f.name != "dtype"]
# partial config.json files: the class defaults fill the rest in both packages
DEIT = {"model_type": "deit", "hidden_size": 192, "num_attention_heads": 3,
        "intermediate_size": 768}
VIT = {"model_type": "vit", "num_hidden_layers": 6, "image_size": 384, "patch_size": 32,
       "hidden_act": "gelu_new", "layer_norm_eps": 1e-6}
ROBERTA = {"model_type": "roberta", "num_hidden_layers": 6, "max_position_embeddings": 514,
           "layer_norm_eps": 1e-5}
BERT_GENERATION = {"model_type": "bert-generation", "num_hidden_layers": 2, "hidden_size": 768,
                   "num_attention_heads": 12, "intermediate_size": 3072}


def _write(folder, config, weights=None):
    folder.mkdir(parents=True, exist_ok=True)
    (folder / "config.json").write_text(json.dumps(config))
    if weights:
        (folder / weights).write_bytes(b"\0")
    return folder


def _vision_fields(args):
    return {k: args.get(k) for k in thf.VISION_KEYS + ("model_type",)}


def _decoder_fields(t_args, j_args):
    tcfg = tt.TransformerConfig.from_dict(t_args, dtype=torch.float32)
    jcfg = jt.TransformerConfig.from_dict(j_args, dtype=jnp.float32)
    return ({n: getattr(tcfg, n) for n in FIELDS}, {n: getattr(jcfg, n) for n in FIELDS})


# ---------------------------------------------------------------- resolution

@pytest.mark.parametrize("config", [DEIT, VIT], ids=["deit", "vit"])
def test_resolve_vision_directory_matches_jax(tmp_path, config):
    folder = str(_write(tmp_path / "tower", config))
    got, want = thf._resolve_hf_config(folder), jhf._resolve_hf_config(folder)
    assert _vision_fields(got) == _vision_fields(want)
    assert thf._config_args(folder)["hidden_act"] == want["hidden_act"] == config.get(
        "hidden_act", "gelu")


@pytest.mark.parametrize("config", [ROBERTA, BERT_GENERATION], ids=["roberta", "bert-generation"])
def test_resolve_decoder_hub_cache_matches_jax(tmp_path, monkeypatch, config):
    cache = tmp_path / "hub"
    repo = cache / "models--org--tiny"
    _write(repo / "snapshots" / "c0ffee", config)
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("c0ffee")
    monkeypatch.setenv("HF_HUB_CACHE", str(cache))
    monkeypatch.setattr(hf_hub, "TRANSFORMERS_CACHE", str(cache))
    got, want = thf._resolve_hf_config("org/tiny"), jhf._resolve_hf_config("org/tiny")
    t_fields, j_fields = _decoder_fields(got, want)
    assert t_fields == j_fields
    assert t_fields["lm_head_transform"] == (config["model_type"] == "roberta")


@pytest.mark.parametrize("kind,encoder,decoder", [
    ("vision-encoder-decoder", DEIT, BERT_GENERATION),
    ("vision-encoder-decoder", VIT, ROBERTA),
    ("encoder-decoder", ROBERTA, dict(ROBERTA, num_hidden_layers=3)),
])
def test_resolve_nested_file_matches_jax(tmp_path, kind, encoder, decoder):
    folder = str(_write(tmp_path / "pair", {"model_type": kind, "encoder": encoder,
                                            "decoder": decoder}))
    got, want = thf._resolve_hf_config(folder), jhf._resolve_hf_config(folder)
    if kind == "vision-encoder-decoder":
        assert _vision_fields(got["encoder"]) == _vision_fields(want["encoder"])
    else:
        assert _decoder_fields(got["encoder"], want["encoder"])[0] == _decoder_fields(
            got["encoder"], want["encoder"])[1]
    t_fields, j_fields = _decoder_fields(got["decoder"], want["decoder"])
    assert t_fields == j_fields


def test_dict_section_gives_its_proto_config_args():
    section = {"proto_model": "deit", "proto_config": "deit",
               "proto_config_args": {"hidden_size": 768, "num_hidden_layers": 12}}
    assert thf._config_args(section) == jhf._config_args(section) == section[
        "proto_config_args"]
    assert thf._config_args({"proto_model": "x"}) == jhf._config_args({"proto_model": "x"}) == {}


def test_missing_name_raises_jax_offline_text(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    monkeypatch.setattr(hf_hub, "TRANSFORMERS_CACHE", str(tmp_path))
    monkeypatch.setenv("VILMEDIC_OFFLINE", "1")
    with pytest.raises(RuntimeError) as want:
        jhf._resolve_hf_config("org/not-cached")
    with pytest.raises(RuntimeError) as got:
        thf._resolve_hf_config("org/not-cached")
    assert str(got.value) == str(want.value)


def test_weights_and_unknown_model_types_raise(tmp_path):
    """Weights beside a config resolve as in JAX (the zoo loads them); a
    model type without class defaults raises."""
    folder = str(_write(tmp_path / "w", DEIT, weights="model.safetensors"))
    assert _vision_fields(thf._resolve_hf_config(folder)) == _vision_fields(
        jhf._resolve_hf_config(folder))
    folder = _write(tmp_path / "gpt2", {"model_type": "gpt2"})
    with pytest.raises(NotImplementedError, match="class defaults"):
        thf._resolve_hf_config(str(folder))


def test_rrg_hf_needs_a_pair_or_a_proto():
    with pytest.raises(ValueError, match="Either proto"):
        thf.RRG_HF(decoder={}, device="cpu")
    with pytest.raises(AssertionError, match="Either proto"):
        jhf.RRG_HF(decoder={})


def test_hf_protos_build_on_the_card(monkeypatch):
    """Entry points: without a card RRG_HF and RRS_HF raise unless the
    caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    block = {"proto_config_args": {"hidden_size": 32, "num_hidden_layers": 1,
                                   "num_attention_heads": 4, "intermediate_size": 64,
                                   "image_size": 32, "vocab_size": 50}}
    builds = {"RRG_HF": lambda **kw: thf.RRG_HF(vision=block, decoder=block, **kw),
              "RRS_HF": lambda **kw: thf.RRS_HF(encoder=block, decoder=block, **kw)}
    for name, build in builds.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
        assert next(build(device="cpu").module.parameters()).device.type == "cpu", name


# ---------------------------------------------------------------- RRG_HF

VOCAB, BOS, EOS, PAD = 4500, 2, 3, 0
EOS_BIAS = 6.0  # on EOS's logit in the beam checks: some hypotheses end early
BEAM, MAX_LEN = 4, 10
VISION = {"proto_model": "deit", "proto_config": "deit",
          "proto_config_args": {"hidden_size": 32, "num_hidden_layers": 2,
                                "num_attention_heads": 4, "intermediate_size": 64,
                                "patch_size": 16, "image_size": 32, "hidden_act": "relu"}}
DECODER = {"proto_model": "bert-generation", "proto_config": "bert-generation",
           "proto_config_args": {"hidden_size": 64, "num_hidden_layers": 2,
                                 "num_attention_heads": 2, "intermediate_size": 128,
                                 "max_position_embeddings": 32, "hidden_dropout_prob": 0.0}}


class _DL:
    class dataset:
        class tokenizer:
            vocab_size = VOCAB
            cls_token_id = BOS
            sep_token_id = EOS
            pad_token_id = PAD


def _beam_search_with_scores(*args, **kwargs):
    r = jdecode.beam_search(*args, **kwargs)
    return jdecode.BeamResult((r.sequences, r.scores), r.scores)


def _perturbed(params, rng, scale):
    """Initial weights plus N(0, scale). The beam checks take a large
    perturbation and a head scaled up so that some hypotheses finish early;
    the forward checks take weights at the scale of a trained model, where
    f32 sums stay within their tolerance."""
    params = jax.tree.map(lambda x: np.asarray(x) + scale * rng.normal(size=x.shape)
                          .astype(np.float32), params)
    if scale > 0.1:
        params["dec"]["lm_head"]["kernel"] *= 2.0
        params["dec"]["lm_head"]["kernel"][:, EOS] *= 3.0
        params["dec"]["lm_head"]["bias"][EOS] += EOS_BIAS
    return params


@pytest.fixture(scope="module")
def rrg_hf():
    """JAX's RRG_HF and, per weight scale ("beam" 0.3, "forward" 0.05), its
    variables and the port's RRG_HF carrying them."""
    rng = np.random.default_rng(0)
    jmodel = jhf.RRG_HF(vision=dict(VISION), decoder=dict(DECODER), dl=_DL(), dtype="float32")
    batch = {"images": jnp.zeros((2, 32, 32, 3)), "input_ids": jnp.zeros((2, 4), jnp.int32),
             "attention_mask": jnp.ones((2, 4), jnp.int32)}
    params = jax.jit(jmodel.init_variables)(jax.random.key(0), batch)["params"]
    out = {"jmodel": jmodel}
    for name, scale in (("beam", 0.3), ("forward", 0.05)):
        variables = {"params": _perturbed(params, rng, scale)}
        tmodel = thf.RRG_HF(vision=dict(VISION), decoder=dict(DECODER), dl=_DL(),
                            dtype="float32", device="cpu")
        tmodel.module.load_state_dict(rrg_hf_state_dict_from_jax(variables), strict=True)
        out[name] = (variables, tmodel)
    return out


def test_rrg_hf_builds_like_jax(rrg_hf):
    jmodel, (_, tmodel) = rrg_hf["jmodel"], rrg_hf["beam"]
    vit = tmodel.module.enc.model
    assert not vit.pre_ln and vit.config.hidden_act == "gelu"  # dict section: post-LN, gelu
    assert tmodel.module.enc.visual_projection.weight.shape == (64, 32)
    assert not tmodel.dec_config.lm_head_transform
    assert (tmodel.dec_config.vocab_size, tmodel.dec_config.bos_token_id,
            tmodel.dec_config.eos_token_id, tmodel.dec_config.pad_token_id) == (
        VOCAB, BOS, EOS, PAD)
    for n in FIELDS:
        assert getattr(tmodel.dec_config, n) == getattr(jmodel.dec_config, n), n


def _images(rng, multi):
    if not multi:
        return rng.normal(size=(2, 32, 32, 3)).astype(np.float32), None
    x = rng.normal(size=(2, 2, 32, 32, 3)).astype(np.float32)
    x[1, 1] = 0.0
    return x, np.asarray([[True, True], [True, False]])


def _port_images(x, mask):
    t = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, x.ndim - 3)))
    return t, None if mask is None else torch.from_numpy(mask)


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi-image"])
def test_rrg_hf_loss_matches_jax(rrg_hf, multi):
    jmodel, (variables, tmodel) = rrg_hf["jmodel"], rrg_hf["forward"]
    rng = np.random.default_rng(1 + multi)
    x, mask = _images(rng, multi)
    ids = rng.integers(5, VOCAB, (2, 9)).astype(np.int32)
    ids[:, 0] = BOS
    att = np.ones((2, 9), np.int32)
    att[1, 6:] = 0
    want = jmodel.module.apply(variables, jnp.asarray(x), jnp.asarray(ids), jnp.asarray(att),
                               images_mask=None if mask is None else jnp.asarray(mask))
    timages, tmask = _port_images(x, mask)
    with torch.no_grad():
        got = tmodel.module(timages, torch.from_numpy(ids).long(), torch.from_numpy(att),
                            images_mask=tmask)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=TOL)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), rtol=0,
                               atol=TOL * np.abs(np.asarray(want["logits"])).max())


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi-image"])
def test_rrg_hf_beams_match_jax(rrg_hf, monkeypatch, multi):
    jmodel, (variables, tmodel) = rrg_hf["jmodel"], rrg_hf["beam"]
    monkeypatch.setattr(jeval, "beam_search", _beam_search_with_scores)
    monkeypatch.setenv("VILMEDIC_LMHEAD_KERNEL", "1")
    x, mask = _images(np.random.default_rng(3 + multi), multi)
    seqs, scores = jeval.make_generate_fn([jmodel], BEAM, MAX_LEN, BOS, EOS, PAD, 1.0)(
        [variables], jmodel.encoder_inputs(
            {"images": jnp.asarray(x), "images_mask": None if mask is None else jnp.asarray(mask)}))
    timages, tmask = _port_images(x, mask)
    batch = {"images": timages} if tmask is None else {"images": timages, "images_mask": tmask}
    got = teval.make_generate_fn([tmodel], BEAM, MAX_LEN, BOS, EOS, PAD, 1.0)(
        tmodel.encoder_inputs(batch))
    np.testing.assert_array_equal(got.sequences.numpy(), np.asarray(seqs))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(scores), rtol=1e-4, atol=1e-4)
    assert (np.asarray(seqs)[:, 1:-1] == EOS).any()  # a hypothesis ended early


# ---------------------------------------------------------------- RRS_HF

RRS_VOCAB = 4500
TINY_ROBERTA = {"model_type": "roberta", "vocab_size": RRS_VOCAB, "hidden_size": 64,
                "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 128,
                "max_position_embeddings": 40, "layer_norm_eps": 1e-5,
                "hidden_dropout_prob": 0.0, "bos_token_id": 0, "eos_token_id": 2,
                "pad_token_id": 1}


@pytest.fixture(scope="module")
def rrs_hf(tmp_path_factory):
    """As ``rrg_hf``, for RRS_HF from a tiny RoBERTa-type ``config.json``."""
    folder = str(_write(tmp_path_factory.mktemp("rrs_hf") / "roberta", TINY_ROBERTA))
    rng = np.random.default_rng(5)
    jmodel = jhf.RRS_HF(encoder=folder, decoder=folder, dtype="float32")
    ids = jnp.ones((2, 6), jnp.int32)
    params = jax.jit(lambda k: jmodel.module.init(k, ids, ids, ids, ids))(
        jax.random.key(0))["params"]
    out = {"folder": folder, "jmodel": jmodel}
    for name, scale in (("beam", 0.3), ("forward", 0.05)):
        variables = {"params": _perturbed(params, rng, scale)}
        tmodel = thf.RRS_HF(encoder=folder, decoder=folder, dtype="float32", device="cpu")
        tmodel.module.load_state_dict(rrs_hf_state_dict_from_jax(variables), strict=True)
        out[name] = (variables, tmodel)
    return out


def _src(rng, b, t):
    ids = rng.integers(5, RRS_VOCAB, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    mask[1, t - 3:] = 0
    ids[1, t - 3:] = TINY_ROBERTA["pad_token_id"]
    return ids, mask


def test_rrs_hf_builds_like_jax(rrs_hf, tmp_path):
    jmodel, (_, tmodel) = rrs_hf["jmodel"], rrs_hf["beam"]
    for side in ("enc_config", "dec_config"):
        for n in FIELDS:
            assert getattr(getattr(tmodel, side), n) == getattr(getattr(jmodel, side), n), n
    assert tmodel.dec_config.lm_head_transform and hasattr(tmodel.module.dec, "lm_transform_ln")
    pair = str(_write(tmp_path / "pair", {"model_type": "encoder-decoder",
                                          "encoder": TINY_ROBERTA, "decoder": TINY_ROBERTA}))
    tpair = thf.RRS_HF(encoderdecoder=pair, dtype="float32", device="cpu")
    jpair = jhf.RRS_HF(encoderdecoder=pair, dtype="float32")
    for n in FIELDS:
        assert getattr(tpair.dec_config, n) == getattr(jpair.dec_config, n), n
    assert sorted(tpair.module.state_dict()) == sorted(tmodel.module.state_dict())


def test_rrs_hf_loss_matches_jax(rrs_hf):
    jmodel, (variables, tmodel) = rrs_hf["jmodel"], rrs_hf["forward"]
    rng = np.random.default_rng(7)
    ids, mask = _src(rng, 2, 11)
    dec_ids = rng.integers(5, RRS_VOCAB, (2, 7)).astype(np.int32)
    dec_ids[:, 0] = 0
    dec_mask = np.ones((2, 7), np.int32)
    dec_mask[0, 5:] = 0
    want = jmodel.module.apply(variables, *(jnp.asarray(a) for a in (ids, mask, dec_ids,
                                                                     dec_mask)))
    with torch.no_grad():
        got = tmodel.module(*(torch.from_numpy(a).long() for a in (ids, mask, dec_ids,
                                                                    dec_mask)))
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=TOL)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), rtol=0,
                               atol=TOL * np.abs(np.asarray(want["logits"])).max())


def test_rrs_hf_beam2_matches_jax(rrs_hf, monkeypatch):
    jmodel, (variables, tmodel) = rrs_hf["jmodel"], rrs_hf["beam"]
    monkeypatch.setattr(jeval, "beam_search", _beam_search_with_scores)
    monkeypatch.setenv("VILMEDIC_LMHEAD_KERNEL", "1")
    ids, mask = _src(np.random.default_rng(6), 3, 9)
    bos, eos, pad = 0, 2, 1
    seqs, scores = jeval.make_generate_fn([jmodel], 2, MAX_LEN, bos, eos, pad, 1.0)(
        [variables], {"input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask)})
    got = teval.make_generate_fn([tmodel], 2, MAX_LEN, bos, eos, pad, 1.0)(
        tmodel.encoder_inputs({"input_ids": torch.from_numpy(ids).long(),
                               "attention_mask": torch.from_numpy(mask).long()}))
    np.testing.assert_array_equal(got.sequences.numpy(), np.asarray(seqs))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(scores), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- data and the CLI

FINDINGS = ["the lungs are clear .", "heart size is mildly enlarged .",
            "small left pleural effusion .", "no pneumothorax is seen ."]
IMPRESSIONS = ["no acute disease .", "cardiomegaly .", "small left effusion .",
               "no pneumothorax ."]
REPORTS = ["no acute disease .", "heart size is normal .", "small pleural effusion ."]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf_corpus")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(4):
        p = root / f"im{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (48, 48, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    lines = [",".join(paths[:2]), paths[0], ",".join(paths[:3]), paths[3]]
    for split in ("train", "validate"):
        (root / f"{split}.findings.tok").write_text("\n".join(FINDINGS))
        (root / f"{split}.impression.tok").write_text("\n".join(IMPRESSIONS))
        (root / f"{split}.image.tok").write_text("\n".join(lines))
        # tests/test_models_families.py's multi-image corpus: 3 lines of 2, 1, 3
        (root / f"{split}.report.tok").write_text("\n".join(REPORTS))
        (root / f"{split}.multi.tok").write_text("\n".join(lines[:3]))
    return root


def test_imseq2seq_batches_match_jax(corpus, tmp_path):
    kw = dict(src={"root": str(corpus), "file": "findings.tok", "tokenizer_max_len": 12},
              tgt={"root": str(corpus), "file": "impression.tok", "tokenizer_max_len": 8},
              image={"root": str(corpus), "file": "image.tok", "resize": 40, "crop": 32,
                     "multi_image": 2})
    datasets = {}
    for name, cls in (("j", JImSeq2Seq), ("t", TImSeq2Seq)):
        (tmp_path / name).mkdir()
        cls(split="train", ckpt_dir=str(tmp_path / name), **kw)  # builds the vocabularies
        datasets[name] = cls(split="validate", ckpt_dir=str(tmp_path / name), **kw)
    jds, tds = datasets["j"], datasets["t"]
    assert len(tds) == len(jds) == 4 and tds.tgt_tokenizer_max_len == 8
    want = jds.get_collate_fn()([jds[i] for i in range(4)])
    got = tds.get_collate_fn()([tds[i] for i in range(4)])
    assert sorted(got) == sorted(want) == ["attention_mask", "decoder_attention_mask",
                                           "decoder_input_ids", "images", "images_mask",
                                           "input_ids"]
    for key in ("attention_mask", "decoder_attention_mask", "decoder_input_ids", "input_ids",
                "images_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    np.testing.assert_allclose(got["images"].numpy(), np.moveaxis(want["images"], -1, 2),
                               rtol=0, atol=1e-6)
    src, tgt = FINDINGS[1:3], IMPRESSIONS[1:3]
    images = [jds.image.images[1], jds.image.images[2]]
    want = jds.inference(src=src, tgt=tgt, image=images)
    got = tds.inference(src=src, tgt=tgt, image=images)
    assert sorted(got) == sorted(want)
    for key in ("attention_mask", "decoder_attention_mask", "decoder_input_ids", "input_ids",
                "images_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    with pytest.raises(ValueError, match="same size"):
        tds.inference(src=src, image=images[:1])


SEED = 515156


def _cli_config(root, ckpt_dir, path):
    config, _ = load_config("config/RRG/baseline-mimic-HF.yml", [
        f"ckpt_dir={ckpt_dir}", "name=hf", f"seed={SEED}", "model.dtype=float32",
        f"dataset.image.root={root}", "dataset.image.file=multi.tok", "dataset.image.resize=40",
        "dataset.image.crop=32", "dataset.image.multi_image=2", f"dataset.seq.root={root}",
        "dataset.seq.file=report.tok", "dataset.seq.tokenizer_max_len=12",
        "dataset.num_workers=0",
        "model.vision.proto_config_args.hidden_size=32",
        "model.vision.proto_config_args.num_hidden_layers=1",
        "model.vision.proto_config_args.num_attention_heads=4",
        "model.vision.proto_config_args.intermediate_size=64",
        "model.vision.proto_config_args.image_size=32",
        "model.decoder.proto_config_args.hidden_size=32",
        "model.decoder.proto_config_args.num_attention_heads=4",
        "model.decoder.proto_config_args.intermediate_size=64",
        "model.decoder.proto_config_args.max_position_embeddings=64",
        "model.decoder.proto_config_args.hidden_dropout_prob=0.0",
        "trainor.batch_size=3", "trainor.epochs=0", "trainor.early_stop_metric=BLEU",
        "validator.batch_size=3", "validator.beam_width=2", "validator.metrics=[BLEU]",
    ])
    config = config.to_dict()
    del config["trainor"]["optim_params"]["weight_decay"]  # optax.radam rejects it
    path.write_text(yaml.safe_dump(config))
    return str(path)


@pytest.fixture(scope="module")
def cli_runs(corpus, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        jdir = tmp_path_factory.mktemp("jax_ckpt")
        config, _ = load_config(_cli_config(corpus, jdir, jdir / "config.yml"))
        train_config = executor_config(config, "trainor")
        val_config = executor_config(config, "validator")
        ckpt_dir = os.path.join(config.ckpt_dir, config.name)
        os.makedirs(ckpt_dir)
        train_config.ckpt_dir = val_config.ckpt_dir = ckpt_dir
        jset_logger(ckpt_dir, SEED)
        jtrainor = JTrainor(config=train_config, seed=SEED)
        jtrainor.dl.dataset.image.transform.rng = np.random.default_rng(SEED)
        jtrainor.evaluator = JValidator(config=val_config, models=[jtrainor.model],
                                        train_dl=jtrainor.dl, seed=SEED, from_training=True)
        initial = {k: v.numpy().copy() for k, v in rrg_hf_state_dict_from_jax(
            jax.tree.map(np.asarray, dict(jtrainor.model.variables))).items()}
        jtrainor.start()
        jhyps = open(os.path.join(ckpt_dir, f"validate_{SEED}_hyps.txt")).read()

        class Seeded(TTrainor):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                self.model.module.load_state_dict(
                    {k: torch.from_numpy(v) for k, v in initial.items()}, strict=True)

        tdir = tmp_path_factory.mktemp("torch_ckpt")
        mp.setattr(tcli, "Trainor", Seeded)
        ttrainor = tcli.main([_cli_config(corpus, tdir, tdir / "config.yml"), "device=cpu"])
        thyps = open(os.path.join(str(tdir), "hf", f"validate_{SEED}_hyps.txt")).read()
        yield dict(j=jtrainor, t=ttrainor, jhyps=jhyps, thyps=thyps)


def test_cli_multi_image_step_matches_jax(cli_runs):
    j, t = cli_runs["j"], cli_runs["t"]
    assert type(t.model).__name__ == "RRG_HF" and t.dl.dataset.image.multi_image == 2
    assert len(t.epoch_losses) == len(j.epoch_losses) == 1
    np.testing.assert_allclose(t.epoch_losses, j.epoch_losses, rtol=TOL)
    assert cli_runs["thyps"] == cli_runs["jhyps"]
