"""Weight bridge from the JAX package's RRG, RRS, RRG_HF, RRS_HF, SCST,
VisionLanguage, MVQA, ConVIRT and GLoRIA variables, its clinical scorers'
BERT trees (CheXbert, the RadNER token classifier, the BERTNLI pair
classifier) and the GREEN judge's LLaMA tree, to the port's state dicts (counterpart of
``zoo/convert.py``); :func:`rrg_state_dict_from_jax` carries any tree of
the port's modules, a ViT or ResNet tower's own variables among them.

The port keeps the Flax tree's module names, so the bridge is a rename plus
transposes over ``{"params": ..., "batch_stats": ...}`` given as numpy arrays:

- Dense ``kernel`` (in, out) -> ``weight`` (out, in); conv ``kernel`` HWIO ->
  ``weight`` OIHW, a 3-D conv's DHWIO -> OIDHW; ``bias`` -> ``bias``;
- LayerNorm/BatchNorm ``scale`` -> ``weight``; Embed ``embedding`` -> ``weight``;
- BatchNorm statistics ``mean``/``var`` -> ``running_mean``/``running_var``;
- a BERT/RoBERTa decoder's LM-head transform, ``lm_transform`` (Dense) and
  ``lm_transform_ln`` (LayerNorm), by the same two rules;
- bare parameters (the ViT and DINOv2 ``cls_token`` and ``pos_embed``,
  LayerScale ``ls1``/``ls2``, VisionLanguage's ``image_token_embedding``)
  as they are.

The values stay f32, as the Flax parameters are: the port's Linear,
Embedding and convolution parameters (the DINOv2 patch embedding and SwiGLU
projections included) are f32 too and cast to the compute dtype at use.

The scorers' trees (``embeddings``, ``layer_{i}`` with ``self_attn``
``q``/``k``/``v``/``o``, ``self_ln``, ``ffn`` ``fc1``/``fc2``, ``ffn_ln``,
and the heads) map onto HF BERT names under ``bert.`` (``embeddings.ln`` ->
``LayerNorm``, ``layer_{i}`` -> ``encoder.layer.{i}``), the port's scorer
modules keeping their checkpoints' names: CheXbert's ``head_{i}`` ->
``linear_heads.{i}``, NLI's ``pooler`` -> ``bert.pooler.dense``.

A reference ``.pth`` state dict reaches the port through its own
``zoo/convert.py::convert_reference_rrg``; a checkpoint the JAX package
wrote through ``executors/checkpoint.load_checkpoint``, which reads its
msgpack and calls the function here of the config's proto.

The VisionLanguage serving routes with the int8 prefix and generated caches
and with the fused prefix add no parameters: their scales are derived from
the prefill's activations at run time, so the same state dict serves every
route (``tests/test_torch_vl_int8.py`` holds all four against the JAX
package).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _flatten(tree: Dict, prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _flatten(value, path + ".")
        else:
            yield path, value


_BARE = ("cls_token", "pos_embed", "ls1", "ls2", "image_token_embedding")


def _param(path: str, value) -> tuple:
    module, _, leaf = path.rpartition(".")
    arr = np.asarray(value)
    if leaf == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 5:
            arr = arr.transpose(4, 3, 0, 1, 2)
        else:
            raise ValueError(f"{path}: kernel of rank {arr.ndim}")
        leaf = "weight"
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    elif leaf != "bias" and leaf not in _BARE:
        raise ValueError(f"{path}: unknown parameter leaf {leaf!r}")
    return f"{module}.{leaf}" if module else leaf, arr


_STATS = {"mean": "running_mean", "var": "running_var"}


def rrg_state_dict_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX RRG ``{"params", "batch_stats"}`` (numpy leaves) -> the port's
    ``RRGModule`` state dict of f32 tensors."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(variables["params"]):
        key, arr = _param(path, value)
        out[key] = torch.tensor(arr, dtype=torch.float32)
    for path, value in _flatten(variables.get("batch_stats") or {}):
        module, _, leaf = path.rpartition(".")
        if leaf not in _STATS:
            raise ValueError(f"{path}: unknown batch statistic {leaf!r}")
        out[f"{module}.{_STATS[leaf]}"] = torch.tensor(np.asarray(value), dtype=torch.float32)
    return out


def vl_state_dict_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX VisionLanguage ``{"params"}`` (numpy leaves) -> the port's
    ``VisionLanguageModule`` state dict of f32 tensors. The tower has no
    batch statistics."""
    return rrg_state_dict_from_jax({"params": variables["params"]})


def rrs_state_dict_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX RRS ``{"params"}`` (numpy leaves: ``enc`` and ``dec``) -> the
    port's ``RRSModule`` state dict of f32 tensors."""
    return rrg_state_dict_from_jax({"params": variables["params"]})


def rrg_hf_state_dict_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``RRG_HF`` ``{"params"}`` (numpy leaves: the ViT tower under
    ``enc.model``, the projection where the widths differ, ``dec``) -> the
    port's ``RRGModule`` state dict of f32 tensors."""
    return rrg_state_dict_from_jax(variables)


def rrs_hf_state_dict_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``RRS_HF`` ``{"params"}``, an RRS tree, -> the port's
    ``RRSModule`` state dict of f32 tensors."""
    return rrs_state_dict_from_jax(variables)


def scst_state_dict_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``RRG_SCST`` / ``RRS_SCST`` variables, which are their base
    model's, -> the state dict of the SCST model's ``module`` (its base
    model's module)."""
    return rrg_state_dict_from_jax(variables)


def mvqa_state_dict_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX MVQA ``{"params", "batch_stats"}`` (numpy leaves: ``cnn``,
    ``adapter``, ``adapter_ln``, ``layer_{i}``, ``pooler``, ``classifier``)
    -> the port's ``MVQAModule`` state dict of f32 tensors."""
    return rrg_state_dict_from_jax(variables)


def convirt_state_dict_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX ConVIRT ``{"params", "batch_stats"}`` (numpy leaves:
    ``linguistic``, ``pooler``, ``lin_proj``, ``vis_proj``, ``visual``) ->
    the port's ``ConVIRTModule`` state dict of f32 tensors."""
    return rrg_state_dict_from_jax(variables)


def gloria_state_dict_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX GLoRIA ``{"params", "batch_stats"}`` (numpy leaves: ``cnn``,
    ``text_encoder`` and the four embedders) -> the port's ``GLoRIAModule``
    state dict of f32 tensors."""
    return rrg_state_dict_from_jax(variables)


_BERT_LAYER = {"self_attn.q": "attention.self.query", "self_attn.k": "attention.self.key",
               "self_attn.v": "attention.self.value", "self_attn.o": "attention.output.dense",
               "self_ln": "attention.output.LayerNorm", "ffn.fc1": "intermediate.dense",
               "ffn.fc2": "output.dense", "ffn_ln": "output.LayerNorm"}


def _bert_scorer_state_dict(params: Dict, heads: Dict[str, str]) -> Dict[str, torch.Tensor]:
    """A scorer's Flax BERT tree -> HF names under ``bert.``; ``heads``
    maps the tree's other modules to the port's names."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
        key, arr = _param(path, value)
        module, _, leaf = key.rpartition(".")
        top, _, rest = module.partition(".")
        if top == "embeddings":
            name = "bert.embeddings." + ("LayerNorm" if rest == "ln" else rest)
        elif top.startswith("layer_"):
            name = f"bert.encoder.layer.{top[len('layer_'):]}.{_BERT_LAYER[rest]}"
        else:
            name = heads[module]
        out[f"{name}.{leaf}"] = torch.tensor(arr, dtype=torch.float32)
    return out


def chexbert_state_dict_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``CheXbertModule`` ``{"params"}`` -> the port's
    ``CheXbertModule`` state dict (``head_{i}`` -> ``linear_heads.{i}``)."""
    params = variables["params"]
    heads = {k: f"linear_heads.{k[len('head_'):]}" for k in params if k.startswith("head_")}
    return _bert_scorer_state_dict(params, heads)


def token_classifier_state_dict_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``TokenClassifierModule`` ``{"params"}`` -> the port's
    ``TokenClassifier`` state dict."""
    return _bert_scorer_state_dict(variables["params"], {"classifier": "classifier"})


def pair_classifier_state_dict_from_jax(variables: Dict, head: str = "linear"
                                        ) -> Dict[str, torch.Tensor]:
    """JAX ``BertPairClassifier`` ``{"params"}`` -> the port's
    ``BertPairClassifier`` state dict, its head named ``head``."""
    return _bert_scorer_state_dict(variables["params"],
                                   {"pooler": "bert.pooler.dense", "classifier": head})


def llama_state_dict_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """The JAX ``LlamaForCausalLM`` params (``{"params": ...}`` or the tree
    itself) -> the port's ``blocks.llm.LlamaForCausalLM`` state dict (f32;
    the model casts to its dtype on load): Dense ``kernel`` transposed, Embed
    ``embedding`` -> ``weight``, the RMSNorm ``weight`` as it is."""
    tree = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(tree):
        if path.endswith(".weight"):  # RMSNorm
            key, arr = path, np.asarray(value)
        else:
            key, arr = _param(path, value)
        out[key] = torch.tensor(np.asarray(arr, np.float32))
    return out
