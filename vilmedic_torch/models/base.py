"""Pieces of the task-model contract that the RRG slice needs (port of part of
``models/base.py``)."""

from __future__ import annotations

import json
import logging
import os
from typing import Optional, Tuple

import torch


def get_special_token_ids(model_config, tokenizer=None) -> Tuple[int, int, int]:
    """BOS/EOS/PAD from the decoder config, or, where the config lacks one,
    the tokenizer's ``[CLS]``/``[SEP]``/``[PAD]`` ids."""
    ids = [getattr(model_config, f"{name}_token_id", None) for name in ("bos", "eos", "pad")]
    if None in ids:
        if tokenizer is None:
            raise ValueError("special token ids are missing from the decoder config")
        ids = [tokenizer.vocab[t] for t in
               (tokenizer.cls_token, tokenizer.sep_token, tokenizer.pad_token)]
    return tuple(int(i) for i in ids)


def resolve_device(device) -> torch.device:
    """The device an entry point builds on. The entry points default to the
    card (``"cuda"``); without one that raises, so nothing quietly builds on
    the CPU unless the caller asks for it with ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA device is available; "
                           "pass device='cpu' to build on the CPU")
    return dev


#: ``AutoConfig.to_dict()`` fills the model class's defaults where a bare
#: ``config.json`` omits a key: these are those defaults for the keys
#: ``TransformerConfig`` reads (``transformers``' BertConfig, RobertaConfig
#: and BertGenerationConfig) and the keys the ViT and DINOv2 towers read
#: (ViTConfig, DeiTConfig, Dinov2Config), so that a config file builds the same blocks as in the JAX
#: package, which resolves it through ``AutoConfig``.
_BERT_DEFAULTS = dict(
    vocab_size=30522, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
    intermediate_size=3072, hidden_act="gelu", hidden_dropout_prob=0.1,
    attention_probs_dropout_prob=0.1, max_position_embeddings=512, initializer_range=0.02,
    layer_norm_eps=1e-12, pad_token_id=0, bos_token_id=None, eos_token_id=None,
    add_cross_attention=False)
_VIT_DEFAULTS = dict(
    hidden_size=768, num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072,
    hidden_act="gelu", hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
    initializer_range=0.02, layer_norm_eps=1e-12, image_size=224, patch_size=16)
HF_CONFIG_DEFAULTS = {
    "bert": _BERT_DEFAULTS,
    "roberta": dict(_BERT_DEFAULTS, vocab_size=50265, pad_token_id=1, bos_token_id=0,
                    eos_token_id=2),
    "bert-generation": dict(_BERT_DEFAULTS, vocab_size=50358, hidden_size=1024,
                            num_hidden_layers=24, num_attention_heads=16,
                            intermediate_size=4096, bos_token_id=2, eos_token_id=1),
    "vit": _VIT_DEFAULTS,
    "deit": _VIT_DEFAULTS,
    "dinov2": dict(
        hidden_size=768, num_hidden_layers=12, num_attention_heads=12, mlp_ratio=4,
        hidden_act="gelu", hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        initializer_range=0.02, layer_norm_eps=1e-6, image_size=224, patch_size=14,
        use_swiglu_ffn=False),
}
#: the model types whose positions start at ``padding_idx + 1``
ROBERTA_TYPES = ("roberta", "camembert", "xlm-roberta")
#: The weight files ``from_pretrained`` would load from beside a config.
HF_WEIGHT_FILES = ("model.safetensors", "model.safetensors.index.json", "pytorch_model.bin",
                   "pytorch_model.bin.index.json")


def hf_hub_cache() -> str:
    """The HF hub cache that ``AutoConfig.from_pretrained(name,
    local_files_only=True)`` reads: ``$HF_HUB_CACHE``, else
    ``$HF_HOME/hub``, else ``~/.cache/huggingface/hub``."""
    if os.environ.get("HF_HUB_CACHE"):
        return os.environ["HF_HUB_CACHE"]
    home = os.environ.get("HF_HOME") or os.path.join(os.path.expanduser("~"), ".cache",
                                                     "huggingface")
    return os.path.join(home, "hub")


def hub_cached_file(name: str, filename: str) -> Optional[str]:
    """``filename`` in the hub cache's snapshot of the model ``name`` (the
    revision ``models--{org}--{name}/refs/main`` names), as
    ``huggingface_hub.try_to_load_from_cache`` finds it; None without it."""
    repo = os.path.join(hf_hub_cache(), "models--" + name.replace("/", "--"))
    try:
        with open(os.path.join(repo, "refs", "main")) as f:
            revision = f.read().strip()
    except OSError:
        return None
    path = os.path.join(repo, "snapshots", revision, filename)
    return path if os.path.isfile(path) else None


def local_hf_config_dir(name: str) -> Optional[str]:
    """The directory holding ``name``'s ``config.json``: ``name`` itself
    when it is such a directory, else the hub cache's snapshot
    (:func:`hub_cached_file`); None without either."""
    if os.path.isfile(os.path.join(name, "config.json")):
        return name
    path = hub_cached_file(name, "config.json")
    return os.path.dirname(path) if path else None


def resolve_block(block_cfg):
    """Resolve a reference-style encoder/decoder block config to
    ``(config_dict, pretrained_name_or_None)``, as the JAX package does
    without ``transformers``.

    ``proto: null`` keeps the explicit keys (the flagship RRG decoder). A
    ``proto`` name is read as JSON from a local directory holding
    ``config.json`` or from the HF hub cache (:func:`local_hf_config_dir`),
    with the model class's defaults (:data:`HF_CONFIG_DEFAULTS`) under the
    file's keys and the explicit keys over both; the name comes back beside
    it. Without a local config the explicit keys are kept with JAX's
    warning, and the name comes back as None. Weights beside the config
    are not read here: the model records the name, and
    :func:`load_pretrained` lays them over its seeded init."""
    from ..config.config import Config

    if isinstance(block_cfg, Config):
        block_cfg = block_cfg.to_dict()
    block_cfg = dict(block_cfg or {})
    proto = block_cfg.pop("proto", None)
    if not (isinstance(proto, str) and proto):
        return block_cfg, None
    folder = local_hf_config_dir(proto)
    if folder is None:
        logging.getLogger(__name__).warning(
            f"Pretrained config {proto!r} not in local cache; using explicit keys/defaults")
        return block_cfg, None
    hf = read_hf_config(folder)
    resolved = {**HF_CONFIG_DEFAULTS.get(hf.get("model_type"), {}), **hf, **block_cfg}
    return resolved, proto


def read_hf_config(folder: str) -> dict:
    """``folder``'s ``config.json`` as a dict."""
    with open(os.path.join(folder, "config.json")) as f:
        return json.load(f)


def hf_weights(name: str):
    """The state dict beside ``name``'s config (a directory or the hub
    cache's snapshot; :data:`HF_WEIGHT_FILES`, read without
    ``transformers``), or None without a config or weights."""
    from ..zoo.convert_llm import read_weight_files

    folder = local_hf_config_dir(name)
    if folder is None or not any(os.path.exists(os.path.join(folder, f))
                                 for f in HF_WEIGHT_FILES):
        return None
    return read_weight_files(folder)


def load_pretrained(model, logger=None):
    """Lay the pretrained weights of ``model.pretrained_blocks`` (block
    prefix -> ``(name, kind)``, recorded by the constructor where the JAX
    package records them) over the model's seeded init, as the JAX
    package's ``TaskModel.load_pretrained``: ``causal`` through
    ``zoo.convert.convert_hf_causal_lm``, ``encoder`` through
    ``convert_hf_text_encoder``, ``vit`` / ``dinov2`` through
    ``zoo.convert_vision`` into the block's tower (DINOv2's position grid
    re-gridded to the tower's token count). A RoBERTa-family text block
    (``model_type`` roberta, camembert, xlm-roberta) takes its positions
    shifted by ``padding_idx + 1``, the encoder too: the JAX package loads an
    encoder through ``AutoModel``, whose state dict has no ``roberta.``
    prefix, and so leaves its positions unshifted (a defect the port does
    not copy; ``tests/test_torch_zoo.py`` holds the port's encoder against
    ``transformers``' ``RobertaModel``). Tensors the file lacks, such as
    a causal LM's cross-attention, keep the seeded init; a shape that
    differs keeps it with a warning (``overlay_params``). A name without
    weights keeps the init with JAX's warning. Returns ``model``."""
    from ..zoo.convert import convert_hf_causal_lm, convert_hf_text_encoder, overlay_params
    from ..zoo.convert_vision import convert_hf_dinov2, convert_hf_vit

    logger = logger or logging.getLogger(__name__)
    blocks = getattr(model, "pretrained_blocks", None) or {}
    if not blocks:
        return model
    state = model.module.state_dict()
    for key, (name, kind) in blocks.items():
        sd = hf_weights(name)
        if sd is None:
            logger.warning(f"Pretrained weights for {name!r} not in the local HF cache; "
                           f"{key} keeps random init")
            continue
        if kind == "vit":
            converted = {f"model.{k}": v for k, v in convert_hf_vit(sd).items()}
        elif kind == "dinov2":
            tokens = state[f"{key}.model.pos_embed"].shape[1]
            converted = {f"model.{k}": v
                         for k, v in convert_hf_dinov2(sd, target_tokens=tokens).items()}
        else:
            model_type = read_hf_config(local_hf_config_dir(name)).get("model_type")
            offset = 2 if model_type in ROBERTA_TYPES else 0
            convert = convert_hf_causal_lm if kind == "causal" else convert_hf_text_encoder
            converted = convert(sd, position_offset=offset)
        block = {k[len(key) + 1:]: v for k, v in state.items() if k.startswith(key + ".")}
        block = overlay_params(block, converted, logger, key)
        state.update({f"{key}.{k}": v for k, v in block.items()})
        logger.info(f"Loaded pretrained {name} weights into {key!r}")
    model.module.load_state_dict(state)
    return model


def loader_crop(dl):
    """The image crop of a loader's dataset (None without one): the input
    size a ViT tower's position table is built for."""
    image = getattr(getattr(dl, "dataset", None), "image", None)
    crop = getattr(image, "crop", None)
    return int(crop) if crop is not None else None


def loader_channels(dl):
    """The channels of a loader's images (None without images): 3 for
    decoded JPEG / PNG files (RGB), else the last axis of the first
    ``.npy`` image. A CNN's stem is built for them."""
    image = getattr(getattr(dl, "dataset", None), "image", None)
    if not getattr(image, "images", None):
        return None
    if image.ext not in (".npy", ".npz"):
        return 3
    from ..data.image import open_image

    return int(open_image(image.images[0][0], image.ext).shape[-1])


def init_weights_(module, generator, std: float, in_layer) -> None:
    """Random weights from ``generator``, drawn on the CPU, at the Flax
    initializers' scales: Linear and convolution weights N(0, std) where
    ``in_layer(name)`` (the transformer layers' ``normal(initializer_range)``)
    and N(0, 1/fan_in) elsewhere (Flax's lecun_normal, untruncated);
    Embedding tables N(0, std); biases 0; LayerNorm and BatchNorm at
    identity with running statistics (0, 1), each residual block's last
    BatchNorm scale 0; a ViT's positions N(0, 0.02) and CLS token 0."""
    import math

    from torch import nn

    from ..blocks.transformer import LayerNorm
    from ..blocks.vision.densenet import BatchNorm
    from ..blocks.vision.resnet import zero_last_norm_scales_
    from ..blocks.vision.vit import ViT

    def normal_(p, s):
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=generator) * s)

    for name, m in module.named_modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            normal_(m.weight, std if in_layer(name) else math.sqrt(1.0 / m.weight[0].numel()))
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, std)
        elif isinstance(m, (LayerNorm, BatchNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, ViT):
            normal_(m.pos_embed, 0.02)
            nn.init.zeros_(m.cls_token)
    zero_last_norm_scales_(module)


def in_transformer_layer(name: str) -> bool:
    """A module of a transformer layer (attention or FFN), by its name."""
    return ".self_attn." in f".{name}" or ".ffn." in f".{name}"
