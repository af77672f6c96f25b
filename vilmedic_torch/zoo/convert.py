"""Reference and HF text checkpoints -> the port's state dicts (port of
``zoo/convert.py``).

The reference's zoo ships torch ``.pth`` checkpoints whose decoder is an HF
``BertGenerationDecoder`` and whose tower a torchvision module; its HF
protos load BERT / RoBERTa / BertGeneration blocks by name. The port's
modules keep the Flax tree's names (``zoo/from_jax.py``), so each converter
is a rename onto ``TransformerDecoder`` / ``TransformerEncoder`` names
(``embeddings.{word_embeddings,position_embeddings,ln}``, ``layer_{i}``
with ``self_attn`` / ``cross_attn`` ``q`` / ``k`` / ``v`` / ``o``,
``self_ln``, ``cross_ln``, ``ffn.fc1`` / ``fc2``, ``ffn_ln``, ``lm_head``,
``lm_transform`` / ``lm_transform_ln``) in torch's layouts, with the JAX
package's two changes of values:

- the token-type table's row 0 is added to the word table in f32 (the
  decoder has no token types, and one segment adds that row before the
  LayerNorm); the LM head takes the *unfolded* word table where the file
  ties it, so the two are separate tensors;
- RoBERTa's positions start at ``padding_idx + 1`` = 2: the table moves up
  by two rows and keeps its length, two zero rows appended.

:func:`overlay_params` lays converted tensors over a model's state dict,
keeping the model's tensor (with a warning) where the shapes differ and
wherever the file has no tensor: the cross-attention of a pretrained
causal LM keeps the port's seeded init (HF draws it from torch's global
generator, which the port does not reproduce).
"""

from __future__ import annotations

import logging
from typing import Dict

import torch

from .convert_vision import convert_densenet, convert_resnet, f32

_LAYER = (("self_attn.q", "attention.self.query"), ("self_attn.k", "attention.self.key"),
          ("self_attn.v", "attention.self.value"), ("self_attn.o", "attention.output.dense"),
          ("self_ln", "attention.output.LayerNorm"), ("ffn.fc1", "intermediate.dense"),
          ("ffn.fc2", "output.dense"), ("ffn_ln", "output.LayerNorm"))
_CROSS = (("cross_attn.q", "crossattention.self.query"),
          ("cross_attn.k", "crossattention.self.key"),
          ("cross_attn.v", "crossattention.self.value"),
          ("cross_attn.o", "crossattention.output.dense"),
          ("cross_ln", "crossattention.output.LayerNorm"))


def _pair(out: Dict, dst: str, sd: Dict, src: str) -> None:
    out[f"{dst}.weight"] = f32(sd[f"{src}.weight"])
    out[f"{dst}.bias"] = f32(sd[f"{src}.bias"])


def _layer(out: Dict, dst: str, sd: Dict, src: str) -> None:
    """One BERT-family layer (with its cross-attention where the file has
    one)."""
    names = _LAYER + (_CROSS if f"{src}.crossattention.self.query.weight" in sd else ())
    for a, b in names:
        _pair(out, f"{dst}.{a}", sd, f"{src}.{b}")


def _embeddings(sd: Dict, prefix: str, position_offset: int = 0) -> Dict[str, torch.Tensor]:
    """BERT / RoBERTa / BertGeneration embeddings (module doc)."""
    word = f32(sd[f"{prefix}word_embeddings.weight"])
    tt = sd.get(f"{prefix}token_type_embeddings.weight")
    if tt is not None:
        word = word + f32(tt)[0][None, :]
    pos = f32(sd[f"{prefix}position_embeddings.weight"])
    if position_offset:
        pos = torch.cat([pos[position_offset:], pos.new_zeros(position_offset, pos.shape[1])])
    out = {"embeddings.word_embeddings.weight": word,
           "embeddings.position_embeddings.weight": pos}
    _pair(out, "embeddings.ln", sd, f"{prefix}LayerNorm")
    return out


def _find_base_prefix(sd: Dict) -> str:
    for k in sd:
        i = k.find("embeddings.word_embeddings.weight")
        if i >= 0:
            return k[:i]
    raise KeyError("no word_embeddings in the state dict")


def _num_layers(sd: Dict, layer_prefix: str) -> int:
    return 1 + max(int(k[len(layer_prefix):].split(".")[0])
                   for k in sd if k.startswith(layer_prefix))


def _head(out: Dict, weight, bias) -> None:
    out["lm_head.weight"] = f32(weight)
    out["lm_head.bias"] = (f32(bias) if bias is not None
                           else torch.zeros(out["lm_head.weight"].shape[0]))


def convert_bert_generation_decoder(state_dict: Dict, num_layers: int
                                    ) -> Dict[str, torch.Tensor]:
    """HF ``BertGenerationDecoder`` -> ``TransformerDecoder`` (no token
    types, no position shift; the head's weight is the word table where the
    file ties it)."""
    sd = state_dict
    out = _embeddings({k: v for k, v in sd.items() if "token_type" not in k}, "bert.embeddings.")
    for i in range(num_layers):
        _layer(out, f"layer_{i}", sd, f"bert.encoder.layer.{i}")
    weight = sd.get("lm_head.decoder.weight", sd.get("bert.embeddings.word_embeddings.weight"))
    _head(out, weight, sd.get("lm_head.decoder.bias", sd.get("lm_head.bias")))
    return out


def convert_bert_generation_encoder(state_dict: Dict, num_layers: int
                                    ) -> Dict[str, torch.Tensor]:
    """HF ``BertGenerationEncoder`` -> ``TransformerEncoder``."""
    out = _embeddings({k: v for k, v in state_dict.items() if "token_type" not in k},
                      "embeddings.")
    for i in range(num_layers):
        _layer(out, f"layer_{i}", state_dict, f"encoder.layer.{i}")
    return out


def _roberta_offset(base: str, position_offset) -> int:
    if position_offset is None:
        return 2 if base.startswith("roberta") else 0
    return position_offset


def convert_hf_causal_lm(state_dict: Dict, position_offset: int = None
                         ) -> Dict[str, torch.Tensor]:
    """Any HF BERT-family causal LM (``BertGenerationDecoder``,
    ``RobertaForCausalLM``, ``BertLMHeadModel``; prefix ``bert.``,
    ``roberta.`` or none) -> ``TransformerDecoder``: RoBERTa's
    ``lm_head.dense`` / ``layer_norm`` and BERT's
    ``cls.predictions.transform`` map to ``lm_transform`` /
    ``lm_transform_ln`` (the decoder is built with ``lm_head_transform``
    for these)."""
    sd = state_dict
    base = _find_base_prefix(sd)
    out = _embeddings(sd, f"{base}embeddings.", _roberta_offset(base, position_offset))
    for i in range(_num_layers(sd, f"{base}encoder.layer.")):
        _layer(out, f"layer_{i}", sd, f"{base}encoder.layer.{i}")
    word = sd[f"{base}embeddings.word_embeddings.weight"]
    if "lm_head.dense.weight" in sd:  # RobertaLMHead
        _pair(out, "lm_transform", sd, "lm_head.dense")
        _pair(out, "lm_transform_ln", sd, "lm_head.layer_norm")
        head = "lm_head"
    elif "cls.predictions.transform.dense.weight" in sd:  # BertLMPredictionHead
        _pair(out, "lm_transform", sd, "cls.predictions.transform.dense")
        _pair(out, "lm_transform_ln", sd, "cls.predictions.transform.LayerNorm")
        head = "cls.predictions"
    else:  # BertGenerationOnlyLMHead: a bare (tied) Linear
        head = "lm_head"
    _head(out, sd.get(f"{head}.decoder.weight", word),
          sd.get(f"{head}.decoder.bias", sd.get(f"{head}.bias")))
    return out


def convert_hf_text_encoder(state_dict: Dict, position_offset: int = None
                            ) -> Dict[str, torch.Tensor]:
    """Any HF BERT-family encoder (``BertModel``, ``RobertaModel``,
    ``BertGenerationEncoder``) -> ``TransformerEncoder`` (the pooler
    dropped)."""
    sd = state_dict
    base = _find_base_prefix(sd)
    out = _embeddings(sd, f"{base}embeddings.", _roberta_offset(base, position_offset))
    for i in range(_num_layers(sd, f"{base}encoder.layer.")):
        _layer(out, f"layer_{i}", sd, f"{base}encoder.layer.{i}")
    return out


def overlay_params(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor], logger=None,
                   path: str = "") -> Dict[str, torch.Tensor]:
    """``dst`` with ``src``'s tensors where both have the key and the
    shapes agree (in ``dst``'s dtype); a shape mismatch keeps ``dst``'s
    tensor with a warning naming ``path``/key, and keys ``src`` lacks keep
    ``dst``'s."""
    logger = logger or logging.getLogger(__name__)
    out = dict(dst)
    for key, value in src.items():
        if key not in dst:
            continue
        if tuple(value.shape) == tuple(dst[key].shape):
            out[key] = value.to(dst[key].dtype)
        else:
            logger.warning(f"pretrained weight {path}/{key} shape {tuple(value.shape)} != model "
                           f"{tuple(dst[key].shape)}; keeping random init")
    return out


def convert_reference_rrg(model_state: Dict, num_layers: int, backbone: str = "densenet169"
                          ) -> Dict[str, torch.Tensor]:
    """A reference RRG ``.pth`` ``model`` state dict -> the port's
    ``RRGModule`` state dict: ``dec.decoder.*`` (``BertGenerationDecoder``)
    -> ``dec.*``; the tower ``enc.model.*`` out of the reference's
    truncating ``Sequential`` (a DenseNet keeps its children under index 0,
    ``0.<name>``; a ResNet's top-level modules become indices 0, 1 and
    4-7) -> ``enc.model.*``; ``enc.visual_projection``."""
    dec = {k[len("dec.decoder."):]: v for k, v in model_state.items()
           if k.startswith("dec.decoder.")}
    out = {f"dec.{k}": v for k, v in convert_bert_generation_decoder(dec, num_layers).items()}
    raw = {k[len("enc.model."):]: v for k, v in model_state.items()
           if k.startswith("enc.model.")}
    if raw:
        if any("denseblock" in k for k in raw):
            vision = {}
            for k, v in raw.items():
                head, _, rest = k.partition(".")
                vision[f"features.{rest if head.isdigit() and rest else k}"] = v
            tower = convert_densenet(vision, backbone)
        else:
            names = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2", "6": "layer3",
                     "7": "layer4"}
            vision = {}
            for k, v in raw.items():
                head, dot, rest = k.partition(".")
                vision[names.get(head, head) + dot + rest] = v
            tower = convert_resnet(vision, backbone)
        out.update({f"enc.model.{k}": v for k, v in tower.items()})
    if "enc.visual_projection.weight" in model_state:
        _pair(out, "enc.visual_projection", model_state, "enc.visual_projection")
    return out


_DENSE_LAYER = {"BatchNorm_0": "norm1", "Conv_0": "conv1", "BatchNorm_1": "norm2",
                "Conv_1": "conv2"}


def _reference_tower_name(key: str, dense: bool) -> str:
    """A port tower name -> the reference's truncating-Sequential name."""
    module, _, leaf = key.partition(".")
    if dense:
        if module.startswith("block"):
            b, l = module[len("block"):].split("_layer")
            sub, _, leaf = leaf.partition(".")
            module = f"denseblock{int(b) + 1}.denselayer{int(l) + 1}.{_DENSE_LAYER[sub]}"
        elif module.startswith("transition"):
            b, kind = module[len("transition"):].split("_")
            module = f"transition{int(b) + 1}.{kind}"
        elif module == "norm_final":
            module = "norm5"
        return f"0.{module}.{leaf}"
    if module in ("conv_init", "bn_init"):
        return f"{0 if module == 'conv_init' else 1}.{leaf}"
    s, b = module[len("layer"):].split("_block")
    sub, _, leaf = leaf.partition(".")
    kind, _, c = sub.rpartition("_")
    sub = {"conv_proj": "downsample.0", "norm_proj": "downsample.1"}.get(sub) or (
        f"conv{int(c) + 1}" if kind == "Conv" else f"bn{int(c) + 1}")
    return f"{int(s) + 3}.{b}.{sub}.{leaf}"


def reference_rrg_state_dict(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`convert_reference_rrg` for a model without
    token types or a position shift: a port ``RRGModule`` state dict (a
    DenseNet or ResNet tower, a BertGeneration-style decoder) in the
    reference ``.pth`` layout, the head under both ``lm_head.decoder.bias``
    and ``lm_head.bias`` as HF's state dict holds it."""
    inverse = {a: b for a, b in _LAYER + _CROSS}
    dense = any(k.startswith("enc.model.block") for k in state)
    out = {}
    for key, value in state.items():
        if key.startswith("enc.model."):
            name = "enc.model." + _reference_tower_name(key[len("enc.model."):], dense)
        elif key.startswith("dec.embeddings."):
            name = "dec.decoder.bert." + key[len("dec."):].replace("embeddings.ln.",
                                                                     "embeddings.LayerNorm.")
        elif key.startswith("dec.layer_"):
            layer, _, rest = key[len("dec.layer_"):].partition(".")
            module, _, leaf = rest.rpartition(".")
            name = f"dec.decoder.bert.encoder.layer.{layer}.{inverse[module]}.{leaf}"
        elif key.startswith("dec.lm_head."):
            name = "dec.decoder.lm_head.decoder." + key[len("dec.lm_head."):]
            if key.endswith("bias"):
                out["dec.decoder.lm_head.bias"] = value
        else:
            name = key
        out[name] = value
    return out
