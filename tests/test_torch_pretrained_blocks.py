"""Pretrained block names and the BERT/RoBERTa LM-head transform, the port
against the JAX package on the CPU, float32.

- ``models.base.resolve_block``: a directory holding ``config.json``, a
  fake HF hub cache under ``tmp_path`` (``HF_HUB_CACHE``) and a missing
  name build the same ``TransformerConfig`` fields as JAX's resolution
  through ``transformers.AutoConfig`` (exactly); the missing name logs
  JAX's warning; weights beside a config resolve as without them (the
  zoo loads them); the port's table of model class defaults equals
  ``transformers``' own.
- The LM-head transform (dense, exact GELU, LayerNorm before the head) on a
  tiny RoBERTa-type decoder: teacher-forced logits, the blocked head and the
  blocked-stats head (the plain version of K2 here, JAX's Pallas kernel in
  interpret mode) within 1e-5 of the largest logit; a tiny RRG built from a
  RoBERTa ``config.json`` gives JAX's beam sequences on the three head
  routes (blocked stats at vocab 4500, the ensemble's blocked head, the
  plain head at vocab 300), with weights carried by ``zoo/from_jax.py``.
"""

import dataclasses
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers.utils.hub as hf_hub

import vilmedic_torch.blocks.vision.densenet as tdensenet
import vilmedic_tpu.blocks.vision.densenet as jdensenet
from vilmedic_torch.blocks import transformer as tt
from vilmedic_torch.data.image import finalize_device_preproc
from vilmedic_torch.models import base as tbase
from vilmedic_torch.models import evaluation_nlg as teval
from vilmedic_torch.models.rrg import RRG as TRRG
from vilmedic_torch.zoo.from_jax import rrg_state_dict_from_jax
from vilmedic_tpu.blocks import transformer as jt
from vilmedic_tpu.decoding import decode as jdecode
from vilmedic_tpu.models import base as jbase
from vilmedic_tpu.models import evaluation_nlg as jeval
from vilmedic_tpu.models.rrg import RRG as JRRG
from vilmedic_tpu.ops import blocked_lm_head as jlm
from vilmedic_tpu.ops.image_preproc import crop_normalize as jax_crop_normalize

REL = 1e-5
FIELDS = [f.name for f in dataclasses.fields(tt.TransformerConfig) if f.name != "dtype"]
# a roberta-base config.json as published, less the keys the class defaults fill
ROBERTA = {"model_type": "roberta", "architectures": ["RobertaForMaskedLM"],
           "hidden_size": 768, "num_hidden_layers": 12, "num_attention_heads": 12,
           "intermediate_size": 3072, "max_position_embeddings": 514, "layer_norm_eps": 1e-5,
           "vocab_size": 50265, "type_vocab_size": 1}
BERT = {"model_type": "bert", "hidden_size": 768, "num_hidden_layers": 12,
        "num_attention_heads": 12, "vocab_size": 28996}


def _fields(cfg):
    return {name: getattr(cfg, name) for name in FIELDS}


def _both(block):
    """The port's and JAX's (TransformerConfig fields, pretrained name) of
    one block config, resolved and built the same way (f32)."""
    targs, tname = tbase.resolve_block(dict(block))
    jargs, jname = jbase.resolve_block(dict(block))
    tcfg = tt.TransformerConfig.from_dict(targs, dtype=torch.float32)
    jcfg = jt.TransformerConfig.from_dict(jargs, dtype=jnp.float32)
    return (_fields(tcfg), tname), ({n: getattr(jcfg, n) for n in FIELDS}, jname)


def _write(folder, config, weights=None):
    folder.mkdir(parents=True, exist_ok=True)
    (folder / "config.json").write_text(json.dumps(config))
    if weights:
        (folder / weights).write_bytes(b"\0")
    return folder


@pytest.mark.parametrize("config", [ROBERTA, BERT], ids=["roberta", "bert"])
@pytest.mark.parametrize("explicit", [{}, {"num_hidden_layers": 2, "pad_token_id": 5}],
                         ids=["file", "explicit-wins"])
def test_resolve_block_directory_matches_jax(tmp_path, config, explicit):
    folder = _write(tmp_path / "model", config)
    got, want = _both({"proto": str(folder), **explicit})
    assert got == want
    assert got[1] == str(folder)
    assert got[0]["lm_head_transform"] is True
    for key, value in explicit.items():
        assert got[0][key] == value


def test_resolve_block_hub_cache_matches_jax(tmp_path, monkeypatch):
    """``models--{org}--{name}/refs/main`` names the snapshot whose
    ``config.json`` both packages read."""
    cache = tmp_path / "hub"
    repo = cache / "models--allenai--biomed_roberta_base"
    _write(repo / "snapshots" / "0123abcd", ROBERTA)
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("0123abcd")
    monkeypatch.setenv("HF_HUB_CACHE", str(cache))
    monkeypatch.setattr(hf_hub, "TRANSFORMERS_CACHE", str(cache))  # read at import by JAX's side
    got, want = _both({"proto": "allenai/biomed_roberta_base", "add_cross_attention": True})
    assert got == want
    assert got[1] == "allenai/biomed_roberta_base"
    assert got[0]["pad_token_id"] == 1 and got[0]["max_position_embeddings"] == 514


def test_hub_cache_location(tmp_path, monkeypatch):
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    assert tbase.hf_hub_cache() == str(tmp_path / "hub")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "other"))
    assert tbase.hf_hub_cache() == str(tmp_path / "other")


def test_resolve_block_missing_name_warns_like_jax(tmp_path, monkeypatch, caplog):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    monkeypatch.setattr(hf_hub, "TRANSFORMERS_CACHE", str(tmp_path))
    block = {"proto": "emilyalsentzer/Bio_ClinicalBERT", "hidden_size": 64}
    with caplog.at_level(logging.WARNING):
        got, want = _both(block)
    assert got == want and got[1] is None
    assert got[0]["hidden_size"] == 64 and got[0]["lm_head_transform"] is False
    text = "Pretrained config 'emilyalsentzer/Bio_ClinicalBERT' not in local cache"
    warned = [r.name for r in caplog.records if text in r.getMessage()]
    assert sorted(warned) == ["vilmedic_torch.models.base", "vilmedic_tpu.models.base"]


@pytest.mark.parametrize("weights", ["model.safetensors", "pytorch_model.bin"])
def test_weights_beside_the_config_raise(tmp_path, weights):
    """Weights beside a config no longer raise: the config resolves as in
    JAX and the name comes back, so that the model records the block and
    ``load_pretrained`` reads the weights (``tests/test_torch_zoo.py``)."""
    folder = _write(tmp_path / "model", ROBERTA, weights)
    got, want = _both({"proto": str(folder)})
    assert got == want and got[1] == str(folder)


@pytest.mark.parametrize("model_type", sorted(tbase.HF_CONFIG_DEFAULTS))
def test_class_defaults_match_transformers(model_type):
    from transformers import AutoConfig

    hf = AutoConfig.for_model(model_type).to_dict()
    table = tbase.HF_CONFIG_DEFAULTS[model_type]
    assert table == {k: hf[k] for k in table}


# ---------------------------------------------------------------- the transform

def _tiny(model_type="roberta", vocab=300):
    return dict(model_type=model_type, vocab_size=vocab, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=128, max_position_embeddings=32,
                layer_norm_eps=1e-5, hidden_dropout_prob=0.0, add_cross_attention=True)


def _close(got, want, rel=REL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()), 1e-30))


@pytest.fixture(scope="module")
def decoders():
    """A JAX and a port decoder with the transform, the same perturbed
    weights, and a batch."""
    rng = np.random.default_rng(0)
    jcfg = jt.TransformerConfig.from_dict(_tiny(), dtype=jnp.float32)
    assert jcfg.lm_head_transform
    jdec = jt.TransformerDecoder(jcfg)
    ids = rng.integers(3, 300, (2, 7)).astype(np.int32)
    mask = np.ones((2, 7), np.int32)
    mask[1, 5:] = 0
    enc = rng.normal(size=(2, 5, 64)).astype(np.float32)
    variables = jax.jit(jdec.init)(jax.random.key(0), jnp.asarray(ids), jnp.asarray(mask),
                                   jnp.asarray(enc))
    params = jax.tree.map(lambda x: np.asarray(x) + 0.1 * rng.normal(size=x.shape)
                          .astype(np.float32), variables["params"])
    tdec = tt.TransformerDecoder(tt.TransformerConfig.from_dict(_tiny(), dtype=torch.float32))
    tdec.load_state_dict(rrg_state_dict_from_jax({"params": params}), strict=True)
    assert tdec.config.lm_head_transform and hasattr(tdec, "lm_transform_ln")
    return jdec, {"params": params}, tdec, ids, mask, enc, rng


def test_decoder_logits_with_transform_match_jax(decoders):
    jdec, variables, tdec, ids, mask, enc, _ = decoders
    want = jdec.apply(variables, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(enc))
    with torch.no_grad():
        got = tdec(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                   encoder_hidden_states=torch.from_numpy(enc))
    _close(got.numpy(), want)


def test_blocked_heads_with_transform_match_jax(decoders):
    jdec, variables, tdec, _, _, _, rng = decoders
    h = rng.normal(size=(6, 64)).astype(np.float32)
    kb, bb = jt.make_blocked_head_weights(variables["params"], jnp.float32)
    with torch.no_grad():
        blocked = tt.make_blocked_head_weights(tdec)
        got = tdec._head_blocked(torch.from_numpy(h), blocked)
        got_stats = tdec._head_blocked_stats(torch.from_numpy(h), blocked)
    want = jdec.apply(variables, jnp.asarray(h), (kb, bb),
                      method=lambda m, x, w: m._head_blocked(x, w))
    _close(got.numpy(), want)
    # the plain head's logits, transformed the same way
    plain = jdec.apply(variables, jnp.asarray(h), method=lambda m, x: m._head(x))
    _close(got.reshape(6, -1)[:, :300].numpy(), plain)
    logits, bmax, bsum = jdec.apply(variables, jnp.asarray(h), (kb, bb),
                                    method=lambda m, x, w: m._head_blocked_stats(x, w))
    nb = got_stats[0].shape[1]
    _close(got_stats[0].numpy(), np.asarray(logits).transpose(1, 0, 2)[:, :nb])
    _close(got_stats[1].numpy(), np.asarray(bmax)[:, :nb])
    _close(got_stats[2].numpy(), np.asarray(bsum)[:, :nb])
    assert jlm.lm_head_blocked_stats is not None  # JAX's stats route: its Pallas kernel


def test_encoder_ignores_the_transform():
    cfg = tt.TransformerConfig.from_dict(_tiny("bert"), dtype=torch.float32)
    assert cfg.lm_head_transform
    names = [n for n, _ in tt.TransformerEncoder(cfg).named_parameters()]
    assert not any("lm_transform" in n for n in names)
    assert not tt.TransformerConfig.from_dict(dict(_tiny(), lm_head_transform=False)) \
        .lm_head_transform


# ---------------------------------------------------------------- RRG from a RoBERTa config

TINY_DENSENET = (8, (2, 2), 16)
BEAM, MAX_LEN, BOS, EOS, PAD = 4, 12, 0, 2, 1
CNN = dict(proto="VisualEncoder", backbone="densenet_tiny", output_layer="features",
           dropout_out=0.0, permute="batch_first",
           visual_projection={"in_features": 32, "out_features": 128}, freeze=False)


def _rrg_variables(jmodel, rng):
    batch = {"images": jnp.zeros((2, 32, 32, 3)), "input_ids": jnp.zeros((2, 4), jnp.int32),
             "attention_mask": jnp.ones((2, 4), jnp.int32)}
    variables = jax.jit(jmodel.init_variables)(jax.random.key(0), batch)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.3 * rng.normal(size=x.shape)
                          .astype(np.float32), variables["params"])
    params["dec"]["lm_head"]["kernel"] *= 2.0
    params["dec"]["lm_head"]["kernel"][:, EOS] *= 3.0  # hypotheses finish early
    stats = jax.tree.map(lambda x: rng.uniform(0.5, 1.5, size=x.shape).astype(np.float32),
                         variables["batch_stats"])
    return {"params": params, "batch_stats": stats}


def _beam_search_with_scores(*args, **kwargs):
    r = jdecode.beam_search(*args, **kwargs)
    return jdecode.BeamResult((r.sequences, r.scores), r.scores)


@pytest.mark.parametrize("vocab,members", [(4500, 1), (4500, 2), (300, 1)],
                         ids=["blocked-stats", "ensemble", "plain-head"])
def test_roberta_rrg_beams_match_jax(tmp_path, monkeypatch, vocab, members):
    monkeypatch.setitem(jdensenet.CONFIGS, "densenet_tiny", TINY_DENSENET)
    monkeypatch.setitem(tdensenet.CONFIGS, "densenet_tiny", TINY_DENSENET)
    monkeypatch.setattr(jeval, "beam_search", _beam_search_with_scores)
    folder = _write(tmp_path / "roberta", dict(_tiny(vocab=vocab), hidden_size=128,
                                               intermediate_size=256, bos_token_id=BOS,
                                               eos_token_id=EOS, pad_token_id=PAD))
    decoder = {"proto": str(folder)}
    rng = np.random.default_rng(1)
    jmodel = JRRG(decoder=dict(decoder), cnn=dict(CNN), dtype="float32")
    assert jmodel.dec_config.lm_head_transform
    variables = [_rrg_variables(jmodel, rng) for _ in range(members)]
    tmodels = []
    for v in variables:
        tm = TRRG(decoder=dict(decoder), cnn=dict(CNN), dtype="float32", device="cpu")
        tm.module.load_state_dict(rrg_state_dict_from_jax(v), strict=True)
        tmodels.append(tm)
    assert tmodels[0].dec_config.lm_head_transform
    assert tbase.get_special_token_ids(tmodels[0].dec_config) == (BOS, EOS, PAD)

    images = rng.integers(0, 256, (2, 40, 40, 3), dtype=np.uint8)
    tops, lefts = np.array([3, 8], np.int32), np.array([0, 5], np.int32)
    jimages = jax_crop_normalize(jnp.asarray(images), jnp.asarray(tops), jnp.asarray(lefts), 32,
                                 use_pallas=False)
    generate = jeval.make_generate_fn([jmodel] * members, BEAM, MAX_LEN, BOS, EOS, PAD, 1.0)
    seqs, scores = generate(variables, {"images": jimages, "images_mask": None})
    batch = finalize_device_preproc({"images_u8": torch.from_numpy(images),
                                     "preproc_tops": torch.from_numpy(tops),
                                     "preproc_lefts": torch.from_numpy(lefts)}, 32)
    got = teval.make_generate_fn(tmodels, BEAM, MAX_LEN, BOS, EOS, PAD, 1.0)(
        tmodels[0].encoder_inputs(batch))
    np.testing.assert_array_equal(got.sequences.numpy(), np.asarray(seqs))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(scores), rtol=1e-4, atol=1e-4)
