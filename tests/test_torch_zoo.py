"""The port's zoo (``zoo/convert.py``, ``zoo/convert_vision.py``,
``models/base.load_pretrained``, ``zoo/modeling_auto.AutoModel``,
``bin/convert_checkpoint``, the datasets' ``inference_only`` and the
composites' ``inference``) against the JAX package on the CPU, float32.

- Converters: the same random state dict (a reference RRG ``.pth`` with a
  DenseNet and with a ResNet tower; BertGeneration, RoBERTa-with-LM-head and
  BERT ``cls.predictions`` causal LMs, tied and untied; BERT-family text
  encoders; a ViT; a DINOv2, SwiGLU too) through the port's converter and
  through ``zoo/from_jax.py`` of the JAX converter: equal tensor for tensor,
  bitwise; DINOv2's re-gridded positions within 1e-6.
- ``create_model`` on configs naming tiny local folders written by
  ``transformers`` (a RoBERTa causal LM, a ViT, a DINOv2 whose
  ``config.json`` has no ``image_size``): the file's tensors are loaded, as
  JAX's ``load_pretrained`` loads them (bitwise; DINOv2's grid 1e-6), and the
  other tensors keep the seeded init; a RoBERTa RRS encoder's hidden states
  equal ``transformers``' ``RobertaModel`` (1e-5); ConVIRT and GLoRIA ignore
  the weights, as in JAX; a vocabulary that differs keeps the init with a
  warning.
- ``AutoModel.from_pretrained`` on a checkpoint directory the JAX package
  wrote and on one the port wrote: JAX's ``AutoModel``'s beam-2 sequences;
  the same reference ``.pth`` through both ``convert_checkpoint`` CLIs: equal
  model states.
- ``ImSeq``, ``Seq2Seq``, ``ImSeq2Seq`` and ``ImLabel`` in zoo mode: their
  ``inference`` batches equal JAX's.
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vilmedic_torch.config.config import Config as TConfig
from vilmedic_torch.executors.checkpoint import load_checkpoint, save_checkpoint
from vilmedic_torch.executors.utils import create_model
from vilmedic_torch.models import base as tbase
from vilmedic_torch.zoo import convert as tconv
from vilmedic_torch.zoo import convert_vision as tconvv
from vilmedic_torch.zoo.from_jax import rrg_state_dict_from_jax
from vilmedic_tpu.zoo import convert as jconv
from vilmedic_tpu.zoo import convert_vision as jconvv

V, H, L, HEADS, INTER = 60, 16, 2, 2, 32


def _np(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


def _from_jax(params, batch_stats=None):
    return rrg_state_dict_from_jax({"params": params, "batch_stats": batch_stats or {}})


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k


def _randomize(sd, seed=0):
    """Every float tensor drawn anew (biases, norms and statistics too), so
    that a swapped or missed tensor shows."""
    gen = torch.Generator().manual_seed(seed)
    return {k: (torch.randn(v.shape, generator=gen) if v.is_floating_point() else v)
            for k, v in sd.items()}


# ---------------------------------------------------------------- converters

def _tiny_rrg(backbone, decoder=None, device="cpu", **kw):
    from vilmedic_torch.models.rrg import RRG

    dense = backbone.startswith("densenet")
    decoder = decoder or dict(proto=None, hidden_size=H, num_hidden_layers=L,
                              num_attention_heads=HEADS, intermediate_size=INTER,
                              max_position_embeddings=40, vocab_size=V)
    cnn = dict(proto="VisualEncoder", backbone=backbone, permute="batch_first",
               output_layer="features" if dense else "layer4",
               visual_projection=dict(in_features=1024 if dense else 512, out_features=H))
    return RRG(decoder=decoder, cnn=cnn, device=device, **kw)


@pytest.mark.parametrize("backbone", ["densenet121", "resnet18"])
def test_reference_rrg_matches_jax(backbone):
    model = _tiny_rrg(backbone)
    reference = tconv.reference_rrg_state_dict(_randomize(model.module.state_dict()))
    assert any(k.startswith("enc.model.0.") for k in reference)
    got = tconv.convert_reference_rrg(reference, L, backbone)
    _equal(got, _from_jax(**jconv.convert_reference_rrg(_np(reference), L, backbone)))
    model.module.load_state_dict(got)  # strict: every name of the port's module


def _hf_lm(kind, vocab=V, layers=L, seed=0, cross=True):
    import transformers as tr

    torch.manual_seed(seed)
    common = dict(vocab_size=vocab, hidden_size=H, num_hidden_layers=layers,
                  num_attention_heads=HEADS, intermediate_size=INTER,
                  max_position_embeddings=40, is_decoder=True, add_cross_attention=cross)
    if kind == "bert-generation":
        return tr.BertGenerationDecoder(tr.BertGenerationConfig(**common))
    if kind == "roberta":
        return tr.RobertaForCausalLM(tr.RobertaConfig(**common, type_vocab_size=1,
                                                      pad_token_id=1))
    return tr.BertLMHeadModel(tr.BertConfig(**common))


LM_KINDS = ["bert-generation", "roberta", "bert"]


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("kind", LM_KINDS)
def test_causal_lm_matches_jax(kind, tied):
    """The token-type row folded into the word table, RoBERTa's shifted
    positions, the LM-head transform, and the head from the unfolded word
    table where the file ties it (no ``decoder.weight``)."""
    sd = _randomize(_hf_lm(kind).state_dict())
    if tied:
        sd = {k: v for k, v in sd.items() if not k.endswith("decoder.weight")}
    got = tconv.convert_hf_causal_lm(sd)
    _equal(got, _from_jax(jconv.convert_hf_causal_lm(_np(sd))))
    assert ("lm_transform.weight" in got) == (kind != "bert-generation")
    if tied and kind != "bert-generation":
        word = sd[f"{kind}.embeddings.word_embeddings.weight"]
        assert torch.equal(got["lm_head.weight"], word)
        assert not torch.equal(got["embeddings.word_embeddings.weight"], word)
    if kind == "bert-generation":
        _equal(tconv.convert_bert_generation_decoder(sd, L), _from_jax(
            jconv.convert_bert_generation_decoder(_np(sd), L)))


@pytest.mark.parametrize("offset", [None, 2])
@pytest.mark.parametrize("kind", ["roberta", "bert", "bert-generation"])
def test_text_encoder_matches_jax(kind, offset):
    import transformers as tr

    torch.manual_seed(1)
    common = dict(vocab_size=V, hidden_size=H, num_hidden_layers=L, num_attention_heads=HEADS,
                  intermediate_size=INTER, max_position_embeddings=40)
    model = {"roberta": lambda: tr.RobertaModel(tr.RobertaConfig(**common)),
             "bert": lambda: tr.BertModel(tr.BertConfig(**common)),
             "bert-generation": lambda: tr.BertGenerationEncoder(
                 tr.BertGenerationConfig(**common))}[kind]()
    sd = _randomize(model.state_dict(), seed=1)
    got = tconv.convert_hf_text_encoder(sd, position_offset=offset)
    _equal(got, _from_jax(jconv.convert_hf_text_encoder(_np(sd), position_offset=offset)))
    if kind == "bert-generation":
        _equal(tconv.convert_bert_generation_encoder(sd, L), _from_jax(
            jconv.convert_bert_generation_encoder(_np(sd), L)))


def test_vit_matches_jax():
    from transformers import ViTConfig, ViTModel

    torch.manual_seed(2)
    sd = _randomize(ViTModel(ViTConfig(hidden_size=H, num_hidden_layers=L,
                                       num_attention_heads=HEADS, intermediate_size=INTER,
                                       image_size=32, patch_size=16)).state_dict(), seed=2)
    _equal(tconvv.convert_hf_vit(sd), _from_jax(jconvv.convert_hf_vit(_np(sd))))


def _dinov2(swiglu=False, seed=3, image_size=56, layers=L):
    from transformers import Dinov2Config, Dinov2Model

    torch.manual_seed(seed)
    return Dinov2Model(Dinov2Config(hidden_size=H, num_hidden_layers=layers,
                                    num_attention_heads=HEADS, image_size=image_size,
                                    patch_size=14, use_swiglu_ffn=swiglu))


@pytest.mark.parametrize("swiglu", [False, True], ids=["mlp", "swiglu"])
def test_dinov2_matches_jax(swiglu):
    """Bitwise at the file's grid (4 x 4); re-gridded to 6 x 6 (and by
    ``target_image_size``) within 1e-6 of JAX's, and within 1e-6 relative of
    ``F.interpolate(mode="bicubic")`` (values of ~3: a few ulps)."""
    sd = _randomize(_dinov2(swiglu).state_dict(), seed=3)
    _equal(tconvv.convert_hf_dinov2(sd), _from_jax(jconvv.convert_hf_dinov2(_np(sd))))
    for kw in (dict(target_tokens=37), dict(target_image_size=84)):
        got = tconvv.convert_hf_dinov2(sd, **kw)
        want = _from_jax(jconvv.convert_hf_dinov2(_np(sd), **kw))
        assert got["pos_embed"].shape == (1, 37, H)
        np.testing.assert_allclose(got["pos_embed"].numpy(), want["pos_embed"].numpy(),
                                   rtol=0, atol=1e-6)
        _equal({k: v for k, v in got.items() if k != "pos_embed"},
               {k: v for k, v in want.items() if k != "pos_embed"})
    grid = sd["embeddings.position_embeddings"][:, 1:].reshape(1, 4, 4, H).permute(0, 3, 1, 2)
    torch_grid = torch.nn.functional.interpolate(grid, size=(6, 6), mode="bicubic",
                                                 align_corners=False)
    np.testing.assert_allclose(
        tconvv.interpolate_pos_grid(sd["embeddings.position_embeddings"], 37)[0, 1:].numpy(),
        torch_grid.permute(0, 2, 3, 1).reshape(36, H).numpy(), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- create_model

def _write_lm(folder, kind="roberta", vocab=V, layers=L):
    """A published-style causal LM folder: no cross-attention in the file."""
    model = _hf_lm(kind, vocab=vocab, layers=layers, seed=4, cross=False)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0, 0.5)
    model.save_pretrained(folder)
    return str(folder)


def _config(model):
    return TConfig({"model": model})


def _file_keys_loaded(model, prefix, converted):
    state = model.module.state_dict()
    for k, v in converted.items():
        assert torch.equal(state[f"{prefix}{k}"], v), k


def _jax_loaded(jmodel, batch):
    variables = jmodel.init_variables(jax.random.key(0), batch)
    loaded = jmodel.load_pretrained(variables)
    return rrg_state_dict_from_jax(jax.tree.map(np.asarray, loaded))


def _jax_batch(image=32):
    return {"images": jnp.zeros((1, image, image, 3)), "input_ids": jnp.ones((1, 6), jnp.int32),
            "attention_mask": jnp.ones((1, 6), jnp.int32)}


VIT_CNN = {"proto": "VisualEncoder", "backbone": "vit", "permute": "no_permute",
           "hidden_size": H, "num_hidden_layers": 1, "num_attention_heads": HEADS,
           "intermediate_size": INTER, "patch_size": 16, "image_size": 32}


def test_rrg_decoder_loads_the_file_like_jax(tmp_path):
    from vilmedic_tpu import registry as jregistry

    folder = _write_lm(tmp_path / "roberta")
    config = {"proto": "RRG", "decoder": {"proto": folder}, "cnn": VIT_CNN}
    model = create_model(_config(config), device="cpu", seed=3)
    assert model.pretrained_blocks == {"dec": (folder, "causal")}
    converted = tconv.convert_hf_causal_lm(tbase.hf_weights(folder), position_offset=2)
    assert "lm_transform.weight" in converted and "layer_0.cross_attn.q.weight" not in converted
    _file_keys_loaded(model, "dec.", converted)
    # the keys the file lacks (cross-attention, the tower) keep the seeded init
    from vilmedic_torch.models.rrg import RRG

    init = RRG(decoder={"proto": folder}, cnn=VIT_CNN, device="cpu", seed=3).module.state_dict()
    state = model.module.state_dict()
    rest = [k for k in state if k[len("dec."):] not in converted or not k.startswith("dec.")]
    assert any(".cross_attn." in k for k in rest)
    for k in rest:
        assert torch.equal(state[k], init[k]), k
    assert not torch.equal(state["dec.layer_0.self_attn.q.weight"],
                           init["dec.layer_0.self_attn.q.weight"])
    want = _jax_loaded(jregistry.get("model", "RRG")(**{k: v for k, v in config.items()
                                                       if k != "proto"}), _jax_batch())
    for k in converted:
        assert torch.equal(state[f"dec.{k}"], want[f"dec.{k}"]), k


def test_rrg_hf_loads_the_vit_and_decoder_like_jax(tmp_path):
    from transformers import ViTConfig, ViTModel

    from vilmedic_tpu import registry as jregistry

    torch.manual_seed(5)
    vit = ViTModel(ViTConfig(hidden_size=H, num_hidden_layers=1, num_attention_heads=HEADS,
                             intermediate_size=INTER, image_size=32, patch_size=16))
    with torch.no_grad():
        for p in vit.parameters():
            p.normal_(0, 0.5)
    vit.save_pretrained(tmp_path / "vit")
    dec = _write_lm(tmp_path / "roberta")
    config = {"proto": "RRG_HF", "vision": str(tmp_path / "vit"), "decoder": dec}
    model = create_model(_config(config), device="cpu")
    assert model.pretrained_blocks == {"dec": (dec, "causal"),
                                       "enc": (str(tmp_path / "vit"), "vit")}
    tower = tconvv.convert_hf_vit(tbase.hf_weights(str(tmp_path / "vit")))
    _file_keys_loaded(model, "enc.model.", tower)
    want = _jax_loaded(jregistry.get("model", "RRG_HF")(vision=str(tmp_path / "vit"),
                                                        decoder=dec), _jax_batch())
    state = model.module.state_dict()
    for k in tower:
        assert torch.equal(state[f"enc.model.{k}"], want[f"enc.model.{k}"]), k


def test_vl_dinov2_tower_is_regridded_like_jax(tmp_path):
    """A ``config.json`` without ``image_size`` (Dinov2Config's 224: a 16 x
    16 grid) under a VL model whose vision block names 42 (3 x 3)."""
    from vilmedic_tpu import registry as jregistry

    tower = _dinov2(image_size=224, layers=1, seed=6)
    with torch.no_grad():
        for p in tower.parameters():
            p.normal_(0, 0.5)
    tower.save_pretrained(tmp_path / "dinov2")
    cfg = json.loads((tmp_path / "dinov2" / "config.json").read_text())
    cfg.pop("image_size")
    (tmp_path / "dinov2" / "config.json").write_text(json.dumps(cfg))
    decoder = dict(proto=None, hidden_size=H, num_hidden_layers=1, num_attention_heads=HEADS,
                   intermediate_size=INTER, max_position_embeddings=64)
    vision = {"vision_model_name": str(tmp_path / "dinov2"), "image_size": 42}
    config = {"proto": "VisionLanguage", "decoder": decoder, "vision": vision}
    model = create_model(_config(config), device="cpu", vocab_size=30, bos_token_id=0,
                         eos_token_id=1, pad_token_id=2)
    state = model.module.state_dict()
    assert state["vision.model.pos_embed"].shape == (1, 10, H)
    converted = tconvv.convert_hf_dinov2(tbase.hf_weights(str(tmp_path / "dinov2")),
                                         target_tokens=10)
    _file_keys_loaded(model, "vision.model.", converted)
    jmodel = jregistry.get("model", "VisionLanguage")(
        decoder=decoder, vision=dict(vision), vocab_size=30, bos_token_id=0, eos_token_id=1,
        pad_token_id=2)
    want = _jax_loaded(jmodel, _jax_batch(42))
    for k in converted:
        got, w = state[f"vision.model.{k}"], want[f"vision.model.{k}"]
        if k == "pos_embed":
            np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0, atol=1e-6)
        else:
            assert torch.equal(got, w), k


def test_rrs_roberta_encoder_matches_transformers(tmp_path):
    """The encoder's positions are shifted as ``RobertaModel``'s (the JAX
    package leaves them unshifted: a reference defect)."""
    from transformers import RobertaModel

    folder = _write_lm(tmp_path / "roberta")
    config = {"proto": "RRS", "encoder": {"proto": folder}, "decoder": {"proto": folder}}
    model = create_model(_config(config), device="cpu")
    assert model.pretrained_blocks == {"enc": (folder, "encoder"), "dec": (folder, "causal")}
    ids = torch.from_numpy(np.random.default_rng(0).integers(3, V, (2, 9)))
    mask = torch.ones_like(ids)
    with torch.no_grad():
        want = RobertaModel.from_pretrained(folder, add_pooling_layer=False, is_decoder=False)(
            input_ids=ids, attention_mask=mask).last_hidden_state
        got = model.module.enc(ids, mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("proto", ["ConVIRT", "GLoRIA"])
def test_selfsup_ignore_the_weights_like_jax(tmp_path, proto):
    from vilmedic_tpu.models.base import TaskModel

    folder = _write_lm(tmp_path / "roberta")
    if proto == "ConVIRT":
        config = {"proto": "ConVIRT", "encoder": {"proto": folder},
                  "cnn": {"proto": "VisualEncoder", "backbone": "resnet18",
                          "output_layer": "avgpool", "permute": "batch_first"},
                  "projection": {"visual_embedding_dim": 512, "textual_embedding_dim": H,
                                 "projection_dim": 8},
                  "loss": {"proto": "ConVIRTLoss", "tau": 0.1, "lambda_": 0.75}}
    else:
        config = {"proto": "GLoRIA", "encoder": {"proto": folder},
                  "cnn": {"backbone": "resnet50", "feature_dim": H}}
    model = create_model(_config(config), device="cpu", seed=1)
    assert not getattr(model, "pretrained_blocks", None) and not TaskModel._pretrained_blocks
    built = create_model(_config(config), device="cpu", seed=1).module.state_dict()
    for k, v in model.module.state_dict().items():
        assert torch.equal(v, built[k]), k
    weights = tconv.convert_hf_text_encoder(tbase.hf_weights(folder))
    own = model.module.state_dict()
    key = next(k for k in own if k.endswith("layer_0.self_attn.q.weight"))
    assert not torch.equal(own[key], weights["layer_0.self_attn.q.weight"])


def test_vocabulary_mismatch_keeps_the_init_with_a_warning(tmp_path, caplog):
    folder = _write_lm(tmp_path / "roberta")
    config = {"proto": "RRG", "decoder": {"proto": folder}, "cnn": VIT_CNN}
    with caplog.at_level(logging.WARNING):
        model = create_model(_config(config), device="cpu", vocab_size=V + 7,
                             logger=logging.getLogger("zoo_test"))
    from vilmedic_torch.models.rrg import RRG

    init = RRG(decoder={"proto": folder}, cnn=VIT_CNN, vocab_size=V + 7,
               device="cpu").module.state_dict()
    state = model.module.state_dict()
    for k in ("dec.embeddings.word_embeddings.weight", "dec.lm_head.weight",
              "dec.lm_head.bias"):
        assert torch.equal(state[k], init[k]), k
    assert not torch.equal(state["dec.embeddings.ln.weight"], init["dec.embeddings.ln.weight"])
    text = caplog.text
    assert "dec/embeddings.word_embeddings.weight" in text and "keeping random init" in text


def test_missing_weights_keep_the_init_with_jax_warning(tmp_path, caplog):
    folder = tmp_path / "config_only"
    folder.mkdir()
    (folder / "config.json").write_text(json.dumps({
        "model_type": "roberta", "vocab_size": V, "hidden_size": H, "num_hidden_layers": 1,
        "num_attention_heads": HEADS, "intermediate_size": INTER,
        "max_position_embeddings": 40}))
    config = {"proto": "RRG", "decoder": {"proto": str(folder)}, "cnn": VIT_CNN}
    with caplog.at_level(logging.WARNING):
        model = create_model(_config(config), device="cpu")
    assert model.pretrained_blocks == {"dec": (str(folder), "causal")}
    assert f"Pretrained weights for {str(folder)!r} not in the local HF cache" in caplog.text


# ---------------------------------------------------------------- AutoModel

REPORTS = ["no acute disease .", "heart size is normal .", "small pleural effusion .",
           "lungs are clear ."]


def _zoo_config(root, ckpt_dir):
    return {
        "ckpt_dir": str(ckpt_dir), "name": "zoo", "seed": 0,
        "dataset": {"proto": "ImSeq", "num_workers": 2,
                    "image": {"root": str(root), "file": "image.tok", "resize": 40, "crop": 32,
                              "ext": ".jpg"},
                    "seq": {"root": str(root), "file": "report.tok", "source": "tgt",
                            "tokenizer_max_len": 12, "processing": "r2gen_clean_report"}},
        "model": {"proto": "RRG",
                  "decoder": {"proto": None, "hidden_size": 32, "num_hidden_layers": 1,
                              "num_attention_heads": 4, "intermediate_size": 64,
                              "max_position_embeddings": 64},
                  "cnn": {"proto": "VisualEncoder", "backbone": "vit", "permute": "no_permute",
                          "hidden_size": 32, "num_hidden_layers": 1, "num_attention_heads": 4,
                          "intermediate_size": 64, "patch_size": 16}},
    }


@pytest.fixture(scope="module")
def zoo_dirs(tmp_path_factory):
    """A JAX-written checkpoint directory (random JAX variables through the
    JAX package's own zoo rebuild, saved by its ``save_checkpoint``) and the
    port's copy of it (the same weights through ``from_jax``, saved by the
    port's ``save_checkpoint``), each with the run's ``vocab.tgt``; and two
    JPEGs."""
    from vilmedic_tpu import registry as jregistry
    from vilmedic_tpu.config.config import Config as JConfig
    from vilmedic_tpu.data import composites  # noqa: F401
    from vilmedic_tpu.data.loader import DataLoader as JDataLoader
    from vilmedic_tpu.executors.checkpoint import save_checkpoint as jsave
    from vilmedic_tpu.zoo.modeling_auto import _dummy_batch

    root = tmp_path_factory.mktemp("zoo")
    rng = np.random.default_rng(0)
    images = []
    for i in range(2):
        images.append(str(root / f"im{i}.jpg"))
        Image.fromarray(rng.integers(0, 255, (48, 48, 3), dtype=np.uint8)).save(images[-1])
    words = sorted({w for r in REPORTS for w in r.split()})
    vocab = "\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words)
    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = root / side
        dirs[side].mkdir()
        (dirs[side] / "vocab.tgt").write_text(vocab)
    config = _zoo_config(root, dirs["jax"])
    dataset_config = JConfig(config).dataset.to_dict()
    for section in dataset_config.values():
        if isinstance(section, dict):
            section["inference_only"] = True
    dataset_config.pop("num_workers")
    dataset = jregistry.get("dataset", dataset_config.pop("proto"))(
        split="test", ckpt_dir=str(dirs["jax"]), called_by_ensemblor=True, **dataset_config)
    model_config = dict(config["model"])
    jmodel = jregistry.get("model", model_config.pop("proto"))(
        **model_config, dl=JDataLoader(dataset, batch_size=4, num_workers=0))
    variables = jmodel.init_variables(jax.random.key(3), _dummy_batch(dataset))
    variables = jax.tree.map(lambda x: np.asarray(x) + 0.02 * rng.standard_normal(
        np.shape(x)).astype(np.float32), variables)  # biases and norms off their init
    jsave(str(dirs["jax"] / "0.5_1_000000.ckpt"),
          {"model": variables, "opt_state": None, "config": config, "__version__": "jax"})
    save_checkpoint(str(dirs["port"] / "0.5_1_000000.ckpt"), {
        "model": rrg_state_dict_from_jax(variables), "opt_state": None,
        "training_scheduler": {}, "config": config, "__version__": "port"})
    return dirs, images


def _port_beams(model, dataset, batch, beam=2):
    from vilmedic_torch.models.evaluation_nlg import make_generate_fn

    tok = dataset.tokenizer
    generate = make_generate_fn([model], beam, 12, tok.cls_token_id, tok.sep_token_id,
                                tok.pad_token_id)
    return generate(model.encoder_inputs(batch)).sequences.numpy()


def _jax_beams(directory, batch_input):
    from vilmedic_tpu.models.evaluation_nlg import make_generate_fn
    from vilmedic_tpu.zoo import AutoModel as JAutoModel

    model, dataset = JAutoModel.from_pretrained(str(directory))
    batch = dataset.inference(**batch_input)
    tok = dataset.tokenizer
    generate = make_generate_fn([model], beam_width=2, max_len=12, bos_id=tok.cls_token_id,
                                eos_id=tok.sep_token_id, pad_id=tok.pad_token_id,
                                length_penalty=1.0)
    return np.asarray(generate([model.variables], model.encoder_inputs(batch)))


@pytest.mark.parametrize("side", ["jax", "port"])
def test_automodel_beams_match_jax_automodel(zoo_dirs, side):
    from vilmedic_torch.zoo import AutoModel

    dirs, images = zoo_dirs
    inputs = dict(seq=["no acute disease .", "lungs are clear ."], image=images)
    model, dataset = AutoModel.from_pretrained(str(dirs[side]), device="cpu")
    assert type(dataset).__name__ == "ImSeq" and len(dataset) == 0
    assert dataset.image.transform.__class__.__name__ == "EvalTransform"
    batch = dataset.inference(**inputs)
    assert batch["images"].shape == (2, 3, 32, 32)
    got = _port_beams(model, dataset, batch)
    assert (got[:, 1:] != dataset.tokenizer.pad_token_id).sum() > 4  # a real generation
    want = _jax_beams(dirs["jax"], inputs)
    np.testing.assert_array_equal(got, want[:, :got.shape[1]])
    assert (want[:, got.shape[1]:] == dataset.tokenizer.pad_token_id).all()
    other = AutoModel.from_pretrained(str(dirs["port" if side == "jax" else "jax"]),
                                      device="cpu")[0].module.state_dict()
    for k, v in model.module.state_dict().items():
        assert torch.equal(v, other[k]), k


def test_automodel_resolves_zoo_names_in_the_local_cache_only(monkeypatch, tmp_path):
    from vilmedic_torch.zoo import modeling_auto

    monkeypatch.setattr(modeling_auto, "MODEL_ZOO_CACHE_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="not in the local cache"):
        modeling_auto.AutoModel._resolve("rrg/baseline-mimic")
    with pytest.raises(KeyError, match="Unknown zoo name"):
        modeling_auto.AutoModel._resolve("rrg/unknown")
    (tmp_path / "rrg" / "baseline-mimic").mkdir(parents=True)
    assert modeling_auto.AutoModel._resolve("rrg/baseline-mimic") == str(
        tmp_path / "rrg" / "baseline-mimic")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        modeling_auto.AutoModel.from_pretrained("rrg/baseline-mimic", device="cpu")


def test_convert_checkpoint_clis_give_equal_states(tmp_path):
    import importlib.util

    from vilmedic_torch.bin import convert_checkpoint as tcli

    model = _tiny_rrg("densenet121")
    reference = tconv.reference_rrg_state_dict(_randomize(model.module.state_dict(), seed=9))
    pth = tmp_path / "model.pth"
    torch.save({"model": {f"module.{k}": v for k, v in reference.items()},
                "config": {"model": {"proto": "RRG"}}}, pth)
    spec = importlib.util.spec_from_file_location(
        "jax_convert_checkpoint", os.path.join(os.path.dirname(__file__), "..", "bin_tpu",
                                               "convert_checkpoint.py"))
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    args = ["--num-layers", str(L), "--backbone", "densenet121", "--tag", "0.25", "--epoch",
            "3", "--seed", "7"]
    jcli.main([str(pth), str(tmp_path / "jax")] + args)
    path = tcli.main([str(pth), str(tmp_path / "port")] + args)
    assert os.path.basename(path) == "0.25_3_7.ckpt"
    got, want = load_checkpoint(path), load_checkpoint(str(tmp_path / "jax" / "0.25_3_7.ckpt"))
    assert got["config"] == want["config"] == {"model": {"proto": "RRG"}}
    _equal(got["model"], want["model"])
    model.module.load_state_dict(got["model"])


# ---------------------------------------------------------------- inference()

def _zoo_dataset(package, proto, sections, ckpt_dir):
    if package == "jax":
        from vilmedic_tpu import registry
        from vilmedic_tpu.data import composites  # noqa: F401
    else:
        from vilmedic_torch import registry
        from vilmedic_torch.data import composites  # noqa: F401
    sections = {k: dict(v, inference_only=True) for k, v in sections.items()}
    return registry.get("dataset", proto)(split="test", ckpt_dir=str(ckpt_dir),
                                          called_by_ensemblor=True, **sections)


def _same_batch(got, want):
    assert sorted(k for k, v in want.items() if v is not None) == sorted(got)
    for k, v in got.items():
        w = np.asarray(want[k])
        if k == "images":
            w = np.moveaxis(w, -1, 1)
        np.testing.assert_array_equal(v.numpy(), w, err_msg=k)


COMPOSITES = {
    "ImSeq": ({"image": {"crop": 32, "resize": 40}, "seq": {"source": "tgt",
                                                            "tokenizer_max_len": 12}},
              dict(seq=["no acute disease .", "Small pleural effusion."], image="IMAGES")),
    "Seq2Seq": ({"src": {"tokenizer_max_len": 10}, "tgt": {"tokenizer_max_len": 12}},
                dict(src=["heart size is normal .", "lungs"], tgt=["no acute disease .", ""])),
    "ImSeq2Seq": ({"image": {"crop": 32, "resize": 40}, "src": {}, "tgt": {"tokenizer_max_len": 8}},
                  dict(src=["heart size is normal .", "lungs are clear"],
                       tgt=["no acute disease .", "clear"], image="IMAGES")),
    "ImLabel": ({"image": {"crop": 32, "resize": 40}, "label": {}},
                dict(image="IMAGES", label=["effusion", "normal"])),
}


@pytest.mark.parametrize("proto", sorted(COMPOSITES))
def test_composite_inference_matches_jax(zoo_dirs, tmp_path, proto):
    """Zoo mode reads the vocabularies / label map from ``ckpt_dir`` and no
    data file."""
    dirs, images = zoo_dirs
    vocab = (dirs["jax"] / "vocab.tgt").read_text()
    for name in ("vocab.src", "vocab.tgt"):
        (tmp_path / name).write_text(vocab)
    from vilmedic_tpu.data.utils import Labels

    Labels(["effusion", "normal", "effusion"]).dump(str(tmp_path / "labels.tok"))
    sections, inputs = COMPOSITES[proto]
    inputs = {k: (images if v == "IMAGES" else v) for k, v in inputs.items()}
    got = _zoo_dataset("port", proto, sections, tmp_path)
    want = _zoo_dataset("jax", proto, sections, tmp_path)
    assert len(got) == len(want) == 0
    _same_batch(got.inference(**inputs), want.inference(**inputs))
