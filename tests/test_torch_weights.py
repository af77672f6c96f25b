"""Weights into the PyTorch port: the JAX-variables bridge, the reference
``.pth`` route through ``convert_reference_rrg``, and the port's freedom from
JAX."""

import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vilmedic_torch.blocks.vision.densenet as tdensenet
import vilmedic_tpu.blocks.vision.densenet as jdensenet
from vilmedic_torch.models.rrg import RRG as TRRG
from vilmedic_torch.zoo.from_jax import rrg_state_dict_from_jax
from vilmedic_tpu.models.rrg import RRG as JRRG
from vilmedic_tpu.zoo.convert import convert_reference_rrg

TINY = (8, (2, 2), 16)
LAYERS = 2
DECODER = dict(proto=None, hidden_size=64, num_hidden_layers=LAYERS, num_attention_heads=2,
               intermediate_size=128, max_position_embeddings=16, vocab_size=40)
CNN = dict(backbone="densenet_tiny", output_layer="features", permute="batch_first",
           visual_projection={"in_features": 32, "out_features": 64})
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def tiny_densenet(monkeypatch):
    monkeypatch.setitem(jdensenet.CONFIGS, "densenet_tiny", TINY)
    monkeypatch.setitem(tdensenet.CONFIGS, "densenet_tiny", TINY)


def test_jax_variables_load_without_missing_or_unexpected_keys():
    jmodel = JRRG(decoder=dict(DECODER), cnn=dict(CNN), dtype="float32")
    batch = {"images": jnp.zeros((1, 32, 32, 3)), "input_ids": jnp.zeros((1, 4), jnp.int32),
             "attention_mask": jnp.ones((1, 4), jnp.int32)}
    variables = jax.jit(jmodel.init_variables)(jax.random.key(0), batch)
    variables = jax.tree.map(np.asarray, variables)
    sd = rrg_state_dict_from_jax(variables)
    tmodel = TRRG(decoder=dict(DECODER), cnn=dict(CNN), device="cpu")
    result = tmodel.module.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    # Dense (in, out) -> (out, in); conv HWIO -> OIHW; stats by name
    np.testing.assert_array_equal(
        tmodel.module.dec.layer_0.ffn.fc1.weight.detach().numpy(),
        variables["params"]["dec"]["layer_0"]["ffn"]["fc1"]["kernel"].T)
    np.testing.assert_array_equal(
        tmodel.module.enc.model.block1_layer0.Conv_1.weight.detach().numpy(),
        variables["params"]["enc"]["model"]["block1_layer0"]["Conv_1"]["kernel"]
        .transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        tmodel.module.enc.model.norm_final.running_var.numpy(),
        variables["batch_stats"]["enc"]["model"]["norm_final"]["var"])


# port name -> reference RRG .pth name (HF BertGeneration decoder, torchvision
# DenseNet under the reference's truncating Sequential)
_REFERENCE_NAMES = [
    (r"^dec\.embeddings\.ln\.", "dec.decoder.bert.embeddings.LayerNorm."),
    (r"^dec\.embeddings\.", "dec.decoder.bert.embeddings."),
    (r"^dec\.layer_(\d+)\.self_attn\.q\.", r"dec.decoder.bert.encoder.layer.\1.attention.self.query."),
    (r"^dec\.layer_(\d+)\.self_attn\.k\.", r"dec.decoder.bert.encoder.layer.\1.attention.self.key."),
    (r"^dec\.layer_(\d+)\.self_attn\.v\.", r"dec.decoder.bert.encoder.layer.\1.attention.self.value."),
    (r"^dec\.layer_(\d+)\.self_attn\.o\.", r"dec.decoder.bert.encoder.layer.\1.attention.output.dense."),
    (r"^dec\.layer_(\d+)\.self_ln\.", r"dec.decoder.bert.encoder.layer.\1.attention.output.LayerNorm."),
    (r"^dec\.layer_(\d+)\.cross_attn\.q\.", r"dec.decoder.bert.encoder.layer.\1.crossattention.self.query."),
    (r"^dec\.layer_(\d+)\.cross_attn\.k\.", r"dec.decoder.bert.encoder.layer.\1.crossattention.self.key."),
    (r"^dec\.layer_(\d+)\.cross_attn\.v\.", r"dec.decoder.bert.encoder.layer.\1.crossattention.self.value."),
    (r"^dec\.layer_(\d+)\.cross_attn\.o\.", r"dec.decoder.bert.encoder.layer.\1.crossattention.output.dense."),
    (r"^dec\.layer_(\d+)\.cross_ln\.", r"dec.decoder.bert.encoder.layer.\1.crossattention.output.LayerNorm."),
    (r"^dec\.layer_(\d+)\.ffn\.fc1\.", r"dec.decoder.bert.encoder.layer.\1.intermediate.dense."),
    (r"^dec\.layer_(\d+)\.ffn\.fc2\.", r"dec.decoder.bert.encoder.layer.\1.output.dense."),
    (r"^dec\.layer_(\d+)\.ffn_ln\.", r"dec.decoder.bert.encoder.layer.\1.output.LayerNorm."),
    (r"^dec\.lm_head\.", "dec.decoder.lm_head.decoder."),
    (r"^enc\.model\.norm_final\.", "enc.model.0.norm5."),
    (r"^enc\.model\.transition(\d+)_(norm|conv)\.",
     lambda m: f"enc.model.0.transition{int(m[1]) + 1}.{m[2]}."),
    (r"^enc\.model\.block(\d+)_layer(\d+)\.(BatchNorm|Conv)_(\d)\.",
     lambda m: (f"enc.model.0.denseblock{int(m[1]) + 1}.denselayer{int(m[2]) + 1}."
                f"{'norm' if m[3] == 'BatchNorm' else 'conv'}{int(m[4]) + 1}.")),
    (r"^enc\.model\.", "enc.model.0."),
]


def _reference_name(key: str) -> str:
    for pattern, repl in _REFERENCE_NAMES:
        new, n = re.subn(pattern, repl, key)
        if n:
            return new
    return key


def test_reference_state_dict_through_convert_and_bridge():
    """A reference-named RRG state dict reaches the port through
    ``convert_reference_rrg`` and the bridge, every tensor unchanged."""
    tmodel = TRRG(decoder=dict(DECODER), cnn=dict(CNN), device="cpu", seed=3)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():  # non-identity norms and statistics
        for name, t in tmodel.module.state_dict().items():
            if re.search(r"(BatchNorm_\d|norm\w*|_ln|\.ln)\.", name):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
    original = tmodel.module.state_dict()
    reference = {_reference_name(k): v.numpy() for k, v in original.items()}
    variables = convert_reference_rrg(reference, num_layers=LAYERS, backbone="densenet_tiny")
    bridged = rrg_state_dict_from_jax(variables)
    assert set(bridged) == set(original)
    for key, value in original.items():
        torch.testing.assert_close(bridged[key], value, rtol=0, atol=0, msg=key)


def test_vl_variables_load_without_missing_or_unexpected_keys(monkeypatch):
    """Every parameter of a JAX VisionLanguage (DINOv2 tower with its CLS
    token, position table and LayerScales, projection, image marker, prefix
    LM) reaches the port, and nothing else."""
    from vilmedic_torch.models.vision_language import VisionLanguage as TVL
    from vilmedic_torch.zoo.from_jax import vl_state_dict_from_jax
    from vilmedic_tpu.models import hf_compat
    from vilmedic_tpu.models.vision_language import VisionLanguage as JVL

    dino = dict(model_type="dinov2", hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                mlp_ratio=2.0, patch_size=8, image_size=16, use_swiglu_ffn=True)
    decoder = dict(proto=None, hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                   intermediate_size=96, max_position_embeddings=32, vocab_size=40,
                   bos_token_id=0, eos_token_id=2, pad_token_id=1)
    vision = {"vision_model_name": "tiny/dinov2"}
    monkeypatch.setattr(hf_compat, "_resolve_hf_config", lambda name: dict(dino))
    jmodel = JVL(decoder=dict(decoder), vision=dict(vision))
    batch = {"images": jnp.zeros((1, 16, 16, 3)), "input_ids": jnp.zeros((1, 4), jnp.int32),
             "attention_mask": jnp.ones((1, 4), jnp.int32)}
    variables = jax.tree.map(np.asarray,
                             jax.jit(jmodel.init_variables)(jax.random.key(0), batch))
    sd = vl_state_dict_from_jax(variables)
    tmodel = TVL(decoder=dict(decoder), vision=dict(vision), vision_hf_config=dino, device="cpu")
    result = tmodel.module.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    params = variables["params"]
    tower = tmodel.module.vision.model
    np.testing.assert_array_equal(tower.patch_embed.weight.detach().numpy(),
                                  params["vision"]["model"]["patch_embed"]["kernel"]
                                  .transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(tower.layer_1.ls2.detach().numpy(),
                                  params["vision"]["model"]["layer_1"]["ls2"])
    np.testing.assert_array_equal(tower.layer_0.ffn.weights_in.weight.detach().numpy(),
                                  params["vision"]["model"]["layer_0"]["ffn"]["weights_in"]
                                  ["kernel"].T)
    np.testing.assert_array_equal(tmodel.module.image_token_embedding.detach().numpy(),
                                  params["image_token_embedding"])


def test_port_imports_no_jax():
    """Every module of the port imports without jax, flax or vilmedic_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vilmedic_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(vilmedic_torch.__path__, 'vilmedic_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'vilmedic_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15  # every port module was imported


FORBIDDEN = ('transformers', 'tokenizers', 'huggingface_hub', 'safetensors', 'regex',
             'sentencepiece', 'rouge_score', 'nltk', 'stanza', 'sklearn', 'PIL')


def test_port_imports_no_tokenizer_scorer_or_image_packages():
    """Every module of the port imports without transformers, tokenizers,
    huggingface_hub, safetensors, regex, sentencepiece, rouge_score, nltk,
    stanza, scikit-learn or Pillow: the tokenizers (WordPiece, byte-level
    BPE, ``tokenizer.json``), ROUGE, METEOR's stemmer, the classification
    metrics, the clinical scorers, BERTScore's encoders (ModernBERT
    included), the LLaMA judge, the weight readers and the hub-cache lookup
    are the port's own, and Pillow is imported only inside
    ``data.image.open_image``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vilmedic_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(vilmedic_torch.__path__, 'vilmedic_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "new = {'vilmedic_torch.data.bpe',\n"
        "       'vilmedic_torch.data.tokenizer_json', 'vilmedic_torch.data.auto_tokenizer',\n"
        "       'vilmedic_torch.scorers.modernbert', 'vilmedic_torch.scorers.green',\n"
        "       'vilmedic_torch.blocks.llm.llama', 'vilmedic_torch.zoo.convert_llm'}\n"
        "assert new <= set(names), new - set(names)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 30  # the data, scorer and executor modules included


def test_pretrained_tokenizers_and_judge_run_without_hf_packages(tmp_path):
    """The four tokenizer kinds, read and run, and a tiny LLaMA judge loaded
    from safetensors and decoded greedily, load none of the forbidden
    packages (the files are written here with them, in this process)."""
    from test_torch_tokenizers import KINDS

    dirs = {k: make(str(tmp_path / k)) for k, make in KINDS.items()}
    import transformers as tr
    from safetensors.torch import save_file

    cfg = tr.LlamaConfig(vocab_size=400, hidden_size=32, intermediate_size=64,
                         num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1)
    judge = tr.LlamaForCausalLM(cfg)
    (tmp_path / "llama_prepend" / "config.json").write_text(json.dumps(cfg.to_dict()))
    save_file({k: v.contiguous() for k, v in judge.state_dict().items()},
              str(tmp_path / "llama_prepend" / "model.safetensors"))
    code = (
        "import sys, torch\n"
        "from vilmedic_torch.data.auto_tokenizer import AutoTokenizer\n"
        "from vilmedic_torch.zoo.convert_llm import build_hf_llama\n"
        "from vilmedic_torch.blocks.llm import greedy_generate\n"
        f"dirs = {dirs!r}\n"
        "for d in dirs.values():\n"
        "    t = AutoTokenizer.from_pretrained(d)\n"
        "    t.decode(t.encode('the heart’s size is normal ² ok'), skip_special_tokens=True)\n"
        "m = build_hf_llama(dirs['llama_prepend'], device='cpu')\n"
        "ids = torch.tensor([[5, 6, 7]])\n"
        "greedy_generate(m, ids, torch.ones_like(ids), 3, 2, 2)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_llama_variables_map_onto_the_port():
    """The JAX judge's LLaMA tree (untied and tied heads, GQA) loads into the
    port's ``LlamaForCausalLM`` with no key missing or left over."""
    from vilmedic_torch.blocks.llm import LlamaConfig as TConfig
    from vilmedic_torch.blocks.llm import LlamaForCausalLM as TLlama
    from vilmedic_torch.zoo.from_jax import llama_state_dict_from_jax
    from vilmedic_tpu.blocks.llm import LlamaConfig as JConfig
    from vilmedic_tpu.blocks.llm import LlamaForCausalLM as JLlama

    for tied in (False, True):
        kw = dict(vocab_size=50, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, tie_word_embeddings=tied)
        ids = jnp.ones((1, 4), jnp.int32)
        params = jax.jit(JLlama(JConfig(**kw, dtype=jnp.float32)).init)(
            jax.random.key(0), ids, ids)
        state = llama_state_dict_from_jax(jax.tree.map(np.asarray, params))
        model = TLlama(TConfig(**kw, dtype=torch.float32), device="cpu")
        model.load_state_dict(state, strict=True)
        np.testing.assert_array_equal(
            model.layers_1.self_attn.k_proj.weight.numpy(),
            np.asarray(params["params"]["layers_1"]["self_attn"]["k_proj"]["kernel"]).T)


@pytest.mark.parametrize("weights", ["safetensors", "bin"])
def test_bertscore_runs_without_transformers_or_safetensors(tmp_path, weights):
    """BERTScore computed by the port (tokenizer, encoder, weight file read)
    loads neither package, for either weight file."""
    from transformers import BertConfig, BertModel, BertTokenizer

    (tmp_path / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "lungs", "are", "clear"]))
    BertTokenizer(vocab_file=str(tmp_path / "vocab.txt")).save_pretrained(tmp_path)
    BertModel(BertConfig(vocab_size=9, hidden_size=16, num_hidden_layers=1,
                         num_attention_heads=2, intermediate_size=32)).save_pretrained(
        tmp_path, safe_serialization=weights == "safetensors")
    code = (
        "import sys\n"
        "from vilmedic_torch.scorers.bertscore_impl import bert_score_prf\n"
        f"p, r, f = bert_score_prf({str(tmp_path)!r}, ['the lungs are clear'], ['lungs clear'],"
        " rescale_with_baseline=False, device='cpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('transformers', 'safetensors')]\n"
        "assert not bad, bad\n"
        "print(f[0])\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert -1.0 <= float(proc.stdout.strip()) <= 1.0


def _all_mapped(variables, module, bridge):
    """Every JAX leaf lands on a port tensor of its shape, and every port
    parameter and buffer is set."""
    sd = bridge(variables)
    want = dict(module.state_dict())
    assert sorted(sd) == sorted(want)
    for key, value in sd.items():
        assert tuple(value.shape) == tuple(want[key].shape), key
    n_leaves = sum(len(jax.tree.leaves(variables.get(c) or {})) for c in ("params", "batch_stats"))
    assert n_leaves == len(sd)
    result = module.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys


@pytest.mark.parametrize("pre_ln", [False, True])
def test_vit_variables_map_onto_the_port(pre_ln):
    from vilmedic_torch.blocks.vision.vit import make_vit as tmake_vit
    from vilmedic_tpu.blocks.vision.vit import make_vit as jmake_vit

    arch = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=64, patch_size=8, image_size=32, pre_ln=pre_ln)
    jvit = jmake_vit("vit", **arch)
    variables = jax.tree.map(np.asarray, jax.jit(jvit.init)(jax.random.key(0),
                                                          jnp.zeros((1, 32, 32, 3))))
    tvit = tmake_vit("vit", **arch)
    _all_mapped(variables, tvit, rrg_state_dict_from_jax)
    np.testing.assert_array_equal(tvit.pos_embed.detach().numpy(), variables["params"]["pos_embed"])
    kernel = variables["params"]["patch_embed"]["kernel"]
    np.testing.assert_array_equal(tvit.patch_embed.weight.detach().numpy(),
                                  kernel.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("backbone", ["resnet18", "resnet50"])
def test_resnet_variables_map_onto_the_port(backbone):
    from vilmedic_torch.blocks.vision.resnet import make_resnet as tmake_resnet
    from vilmedic_tpu.blocks.vision.resnet import make_resnet as jmake_resnet

    jnet = jmake_resnet(backbone, "avgpool")
    variables = jax.tree.map(np.asarray, jax.jit(jnet.init)(jax.random.key(0),
                                                          jnp.zeros((1, 32, 32, 3))))
    tnet = tmake_resnet(backbone, "avgpool")
    _all_mapped(variables, tnet, rrg_state_dict_from_jax)
    np.testing.assert_array_equal(tnet.layer2_block0.conv_proj.weight.detach().numpy(),
                                  variables["params"]["layer2_block0"]["conv_proj"]["kernel"]
                                  .transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(tnet.bn_init.running_var.numpy(),
                                  variables["batch_stats"]["bn_init"]["var"])


@pytest.mark.parametrize("backbone", ["resnet50", "vit"])
def test_mvqa_variables_map_onto_the_port(backbone):
    from vilmedic_torch.models.mvqa import MVQA as TMVQA
    from vilmedic_torch.zoo.from_jax import mvqa_state_dict_from_jax
    from vilmedic_tpu.models.mvqa import MVQA as JMVQA

    cnn = ({"backbone": "resnet50", "output_layer": "layer4", "permute": "batch_first"}
           if backbone == "resnet50" else
           {"backbone": "vit", "hidden_size": 32, "num_hidden_layers": 1, "num_attention_heads": 4,
            "intermediate_size": 64, "patch_size": 16, "image_size": 32})
    cfg = dict(cnn=cnn, classifier={"num_classes": 7, "dropout": 0.1},
               adapter={"output_size": 32},
               transformer={"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
                            "intermediate_size": 64},
               loss={"proto": "LabelSmoothingCrossEntropy", "smoothing": 0.1})
    jmodel = JMVQA(**{k: dict(v) for k, v in cfg.items()})
    variables = jax.tree.map(np.asarray, jax.jit(jmodel.init_variables)(
        jax.random.key(0), {"images": jnp.zeros((1, 32, 32, 3))}))
    tmodel = TMVQA(**{k: dict(v) for k, v in cfg.items()}, device="cpu")
    _all_mapped(variables, tmodel.module, mvqa_state_dict_from_jax)
    np.testing.assert_array_equal(tmodel.module.classifier.Dense_0.weight.detach().numpy(),
                                  variables["params"]["classifier"]["Dense_0"]["kernel"].T)


@pytest.mark.parametrize("family", ["convirt", "gloria"])
def test_selfsup_variables_map_onto_the_port(family):
    """ConVIRT (ResNet-50 tower at avgpool, batch statistics included) and
    GLoRIA (resnet18 with layer3 captured) through their bridges."""
    from vilmedic_torch.models import selfsup as tselfsup
    from vilmedic_torch.zoo import from_jax
    from vilmedic_tpu.models import selfsup as jselfsup

    enc = {"proto": None, "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
           "intermediate_size": 64, "vocab_size": 40}
    if family == "convirt":
        cfg = dict(encoder=enc, cnn={"backbone": "resnet50", "output_layer": "avgpool"},
                   projection={"projection_dim": 16},
                   loss={"proto": "ConVIRTLoss", "tau": 0.1, "lambda_": 0.75})
        jcls, tcls = jselfsup.ConVIRT, tselfsup.ConVIRT
        bridge = from_jax.convirt_state_dict_from_jax
    else:
        cfg = dict(encoder=enc, cnn={"backbone": "resnet18", "feature_dim": 16})
        jcls, tcls = jselfsup.GLoRIA, tselfsup.GLoRIA
        bridge = from_jax.gloria_state_dict_from_jax
    ids = jnp.ones((1, 6), jnp.int32)
    batch = {"input_ids": ids, "attention_mask": ids, "images": jnp.zeros((1, 64, 64, 3))}
    jmodel = jcls(**{k: dict(v) for k, v in cfg.items()})
    variables = jax.tree.map(np.asarray, jax.jit(jmodel.init_variables)(jax.random.key(0), batch))
    tmodel = tcls(**{k: dict(v) for k, v in cfg.items()}, device="cpu")
    _all_mapped(variables, tmodel.module, bridge)


def test_roberta_decoder_variables_map_onto_the_port():
    """A RoBERTa-type decoder's LM-head transform leaves (``lm_transform``,
    ``lm_transform_ln``) land on the port's."""
    from vilmedic_torch.blocks.transformer import TransformerConfig as TConfig
    from vilmedic_torch.blocks.transformer import TransformerDecoder as TDecoder
    from vilmedic_tpu.blocks.transformer import TransformerConfig as JConfig
    from vilmedic_tpu.blocks.transformer import TransformerDecoder as JDecoder

    arch = dict(model_type="roberta", vocab_size=50, hidden_size=32, num_hidden_layers=1,
                num_attention_heads=4, intermediate_size=64, max_position_embeddings=16)
    jdec = JDecoder(JConfig.from_dict(arch))
    variables = jax.tree.map(np.asarray, jax.jit(jdec.init)(
        jax.random.key(0), jnp.ones((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32),
        jnp.zeros((1, 3, 32))))
    assert "lm_transform_ln" in variables["params"]
    tdec = TDecoder(TConfig.from_dict(arch))
    _all_mapped(variables, tdec, rrg_state_dict_from_jax)


@pytest.mark.parametrize("width", [32, 64], ids=["no-projection", "projection"])
def test_rrg_hf_variables_map_onto_the_port(width):
    """RRG_HF: the ViT tower under ``enc.model``, a projection only where
    the decoder's width differs from the tower's, the decoder."""
    from vilmedic_torch.models.hf_compat import RRG_HF as TRRG_HF
    from vilmedic_torch.zoo.from_jax import rrg_hf_state_dict_from_jax
    from vilmedic_tpu.models.hf_compat import RRG_HF as JRRG_HF

    vision = {"proto_config_args": {"hidden_size": 32, "num_hidden_layers": 1,
                                    "num_attention_heads": 4, "intermediate_size": 64,
                                    "patch_size": 16, "image_size": 32}}
    decoder = {"proto_config_args": dict(DECODER, hidden_size=width)}
    jmodel = JRRG_HF(vision=vision, decoder=decoder, dtype="float32")
    batch = {"images": jnp.zeros((1, 32, 32, 3)), "input_ids": jnp.zeros((1, 4), jnp.int32),
             "attention_mask": jnp.ones((1, 4), jnp.int32)}
    variables = jax.tree.map(np.asarray, dict(jax.jit(jmodel.init_variables)(
        jax.random.key(0), batch)))
    assert ("visual_projection" in variables["params"]["enc"]) == (width != 32)
    tmodel = TRRG_HF(vision=vision, decoder=decoder, dtype="float32", device="cpu")
    _all_mapped(variables, tmodel.module, rrg_hf_state_dict_from_jax)


def test_rrs_hf_variables_map_onto_the_port():
    from vilmedic_torch.models.hf_compat import RRS_HF as TRRS_HF
    from vilmedic_torch.zoo.from_jax import rrs_hf_state_dict_from_jax
    from vilmedic_tpu.models.hf_compat import RRS_HF as JRRS_HF

    block = {"proto_config_args": dict(DECODER, model_type="roberta")}
    jmodel = JRRS_HF(encoder=dict(block), decoder=dict(block), dtype="float32")
    ids = jnp.ones((1, 4), jnp.int32)
    variables = jax.tree.map(np.asarray, dict(jax.jit(
        lambda k: jmodel.module.init(k, ids, ids, ids, ids))(jax.random.key(0))))
    tmodel = TRRS_HF(encoder=dict(block), decoder=dict(block), dtype="float32", device="cpu")
    assert tmodel.dec_config.lm_head_transform
    _all_mapped(variables, tmodel.module, rrs_hf_state_dict_from_jax)


def test_3d_densenet_variables_map_onto_the_port():
    """DHWIO kernels -> OIDHW, the stem over the weights' channels."""
    from vilmedic_torch.blocks.vision.densenet import make_densenet as tmake_densenet
    from vilmedic_tpu.blocks.vision.densenet import make_densenet as jmake_densenet

    jnet = jmake_densenet("3d_densenet_tiny", spatial_dims=3)
    variables = jax.tree.map(np.asarray, jax.jit(jnet.init)(jax.random.key(0),
                                                          jnp.zeros((1, 16, 16, 16, 2))))
    kernel = variables["params"]["conv0"]["kernel"]
    tnet = tmake_densenet("3d_densenet_tiny", in_channels=kernel.shape[-2])
    _all_mapped(variables, tnet, rrg_state_dict_from_jax)
    np.testing.assert_array_equal(tnet.conv0.weight.detach().numpy(),
                                  kernel.transpose(4, 3, 0, 1, 2))


SCORER_BERT = dict(vocab_size=50, hidden_size=64, num_hidden_layers=2, num_attention_heads=1,
                   intermediate_size=96, max_position_embeddings=32)


def _scorer_inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 50, (3, 11))
    mask = np.ones_like(ids)
    mask[1, 7:] = 0
    seg = np.zeros_like(ids)
    seg[:, 5:] = 1
    return ids, mask, seg


@pytest.mark.parametrize("tree", ["chexbert", "token_classifier", "pair_classifier"])
def test_scorer_variables_map_onto_the_port(tree):
    """The JAX clinical scorers' BERT trees land on the port's scorer
    modules (HF names, the checkpoints' head names), which then give the
    JAX logits."""
    from vilmedic_torch.scorers import chexbert as tchexbert
    from vilmedic_torch.scorers import nli as tnli
    from vilmedic_torch.scorers import ner as tner
    from vilmedic_torch.zoo import from_jax
    from vilmedic_tpu.blocks.transformer import TransformerConfig
    from vilmedic_tpu.scorers import chexbert as jchexbert
    from vilmedic_tpu.scorers import nli as jnli
    from vilmedic_tpu.scorers import ner as jner

    cfg = TransformerConfig(**SCORER_BERT)
    tcfg = dict(SCORER_BERT, model_type="bert")
    ids, mask, seg = _scorer_inputs()
    args = [jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32)]
    if tree == "chexbert":
        jmod, tmod = jchexbert.CheXbertModule(cfg), tchexbert.CheXbertModule(tcfg)
        bridge = from_jax.chexbert_state_dict_from_jax
    elif tree == "token_classifier":
        jmod, tmod = jner.TokenClassifierModule(cfg, num_labels=5), tner.TokenClassifier(tcfg, 5)
        bridge = from_jax.token_classifier_state_dict_from_jax
    else:
        jmod, tmod = jnli.BertPairClassifier(cfg), tnli.BertPairClassifier(tcfg)
        bridge = from_jax.pair_classifier_state_dict_from_jax
        args.append(jnp.asarray(seg, jnp.int32))
    variables = jax.tree.map(np.asarray, jax.jit(jmod.init)(jax.random.key(0), *args))
    _all_mapped(variables, tmod, bridge)
    want = jmod.apply(variables, *args)
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(np.asarray(a, np.int64)) for a in args))
    rows = mask.astype(bool) if tree == "token_classifier" else slice(None)
    for g, w in zip(got if tree == "chexbert" else [got], want if tree == "chexbert" else [want]):
        np.testing.assert_allclose(g.numpy()[rows], np.asarray(w)[rows], rtol=1e-5, atol=1e-5)
