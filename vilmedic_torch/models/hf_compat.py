"""HF-surface model protos ``RRG_HF`` and ``RRS_HF`` (port of
``models/hf_compat.py``).

The reference builds HF ``VisionEncoderDecoderModel`` /
``EncoderDecoderModel`` from ``proto_model`` / ``proto_config`` /
``proto_config_args`` sections or pretrained names. The JAX package maps
that config surface onto its own modules, and the port onto its:

- ``RRG_HF``: a ViT :class:`~..blocks.vision.visual_encoder.VisualEncoder`
  (``permute: no_permute``, a projection only where the encoder's width
  differs from the decoder's) feeding :class:`~.rrg.RRGModule`'s
  cross-attention decoder, with the data's tokenizer's vocabulary and
  ``[CLS]`` / ``[SEP]`` / ``[PAD]`` ids as the decoder's BOS / EOS / PAD.
  A (B, N, 3, H, W) batch with ``images_mask`` takes the tower's
  multi-image path: the N images' patch sequences form one (B, N·S, D)
  memory with a patch-level mask.
- ``RRS_HF``: :class:`~.rrs.RRS` with string ``encoder`` / ``decoder``
  names passed on as ``{"proto": name}`` to ``base.resolve_block``.

Configs resolve as the JAX package resolves them through
``transformers.AutoConfig``, without ``transformers``: a pretrained name's
``config.json`` is read as JSON from a local directory or the HF hub cache
(``base.local_hf_config_dir``) under the model class's defaults
(``base.HF_CONFIG_DEFAULTS``); an ``encoder-decoder`` or
``vision-encoder-decoder`` file's ``encoder`` and ``decoder`` each take
their own ``model_type``'s defaults, as ``AutoConfig.to_dict()`` fills
them. A dict section gives its ``proto_config_args`` alone (``proto_model``
and ``proto_config`` are ignored, as in JAX). A name without a local config
raises: the JAX package would go to the network there, and the port does
not. Weights beside a pretrained ``decoder`` name (causal LM) and a
pretrained ``vit`` ``vision`` name are recorded in ``pretrained_blocks``
and laid over the init by ``base.load_pretrained``, as the JAX package
loads them; RRS_HF's names go through RRS's blocks.

Mirrored on purpose: only a string ``vision`` name whose ``model_type`` is
``vit`` turns on the pre-LN tower (a dict section, a ``deit`` name and an
encoder-decoder file's encoder build the post-LN one); the tower's keys
are the whitelist below, so ``hidden_act`` stays ``gelu``; a
``bert-generation`` decoder has no LM-head transform, a BERT / RoBERTa
one does (``TransformerConfig.from_dict``).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..blocks.transformer import TransformerConfig
from ..blocks.vision.visual_encoder import VisualEncoder
from ..config.config import Config
from ..registry import register
from .base import (
    HF_CONFIG_DEFAULTS, loader_crop, local_hf_config_dir, read_hf_config, resolve_device,
)
from .evaluation_nlg import evaluation
from .rrg import RRG, RRGModule, init_rrg_weights_
from .rrs import RRS

#: the model types whose config nests an ``encoder`` and a ``decoder``
COMPOSITE_TYPES = ("encoder-decoder", "vision-encoder-decoder")
#: the vision section's keys the tower takes (the JAX package's whitelist)
VISION_KEYS = ("hidden_size", "num_hidden_layers", "num_attention_heads", "intermediate_size",
               "patch_size", "image_size", "hidden_dropout_prob", "layer_norm_eps", "pre_ln")


def _d(cfg):
    if isinstance(cfg, Config):
        return cfg.to_dict()
    return dict(cfg or {})


def _with_class_defaults(cfg: Dict, name: str) -> Dict:
    model_type = cfg.get("model_type")
    if model_type in COMPOSITE_TYPES:
        return {**cfg, "encoder": _with_class_defaults(dict(cfg["encoder"]), name),
                "decoder": _with_class_defaults(dict(cfg["decoder"]), name)}
    if model_type not in HF_CONFIG_DEFAULTS:
        raise NotImplementedError(
            f"{name!r}: model_type {model_type!r} has no class defaults in the port "
            f"(models/base.HF_CONFIG_DEFAULTS: {sorted(HF_CONFIG_DEFAULTS)})")
    return {**HF_CONFIG_DEFAULTS[model_type], **cfg}


def _resolve_hf_config(name: str) -> Dict:
    """A pretrained name's config dict, for the keys the port reads as
    ``AutoConfig.from_pretrained(name, local_files_only=True).to_dict()``
    gives them (module doc)."""
    folder = local_hf_config_dir(name)
    if folder is None:
        raise RuntimeError(
            f"HF config {name!r} not in the local cache and VILMEDIC_OFFLINE "
            f"is set — pre-populate the cache or unset the env var.")
    return _with_class_defaults(read_hf_config(folder), name)


def _config_args(section) -> Dict:
    """A pretrained name's resolved config, or a dict section's
    ``proto_config_args``."""
    if isinstance(section, str):
        return _resolve_hf_config(section)
    return _d(_d(section).get("proto_config_args"))


@register("model")
class RRG_HF(RRG):
    """RRG over the HF ``VisionEncoderDecoder`` surface (module doc): either
    ``encoderdecoder`` (a pretrained name) or both ``vision`` and
    ``decoder``. Weights are random from ``seed`` (pretrained names:
    module doc); the entry point builds on
    ``device`` (the card unless the caller names another)."""

    def __init__(self, encoderdecoder=None, decoder=None, vision=None, dl=None,
                 dtype="float32", device="cuda", seed: int = 0, **kwargs):
        if (encoderdecoder is None) == (decoder is None or vision is None):
            raise ValueError("Either proto should be provided, or both decoder and vision "
                             "should be provided.")
        device = resolve_device(device)
        compute_dtype = torch.bfloat16 if str(dtype) in ("bfloat16", "bf16") else torch.float32
        pretrained = {}
        if encoderdecoder is not None:
            full = _resolve_hf_config(encoderdecoder)
            vision_args, decoder_args = dict(full["encoder"]), dict(full["decoder"])
        else:
            vision_args, decoder_args = _config_args(vision), _config_args(decoder)
            if isinstance(decoder, str):
                pretrained["dec"] = (decoder, "causal")
            if isinstance(vision, str) and vision_args.get("model_type") == "vit":
                vision_args["pre_ln"] = True  # a pretrained HF ViT's residual structure
                pretrained["enc"] = (vision, "vit")
        tok = {}
        if dl is not None:
            tokenizer = dl.dataset.tokenizer
            tok = dict(vocab_size=tokenizer.vocab_size, bos_token_id=tokenizer.cls_token_id,
                       eos_token_id=tokenizer.sep_token_id, pad_token_id=tokenizer.pad_token_id)
        self.dec_config = TransformerConfig.from_dict(decoder_args, **tok, dtype=compute_dtype)
        width = self.dec_config.hidden_size
        projection = width if vision_args.get("hidden_size", 768) != width else None
        enc = VisualEncoder("vit", None, projection, dtype=compute_dtype, permute="no_permute",
                            crop=loader_crop(dl),
                            **{k: v for k, v in vision_args.items() if k in VISION_KEYS})
        self.module = RRGModule(enc, self.dec_config)
        init_rrg_weights_(self.module, torch.Generator().manual_seed(seed))
        self.module.to(device).eval()
        self.pretrained_blocks = pretrained
        self.frozen_prefixes = ()
        self.eval_func = evaluation

    def __repr__(self):
        return "model: RRG_HF (ViT VisualEncoder + TransformerDecoder)"


@register("model")
class RRS_HF(RRS):
    """RRS over the HF ``EncoderDecoder`` surface: ``encoderdecoder`` (a
    pretrained name whose file nests both blocks), or ``encoder`` and
    ``decoder``, each a pretrained name (passed on as ``{"proto": name}``)
    or a dict section."""

    def __init__(self, encoderdecoder=None, encoder=None, decoder=None, dl=None,
                 **kwargs):
        if encoderdecoder is not None:
            full = _resolve_hf_config(encoderdecoder)
            encoder_args, decoder_args = full["encoder"], full["decoder"]
        else:
            encoder_args = ({"proto": encoder} if isinstance(encoder, str)
                            else _config_args(encoder))
            decoder_args = ({"proto": decoder} if isinstance(decoder, str)
                            else _config_args(decoder))
        super().__init__(encoder=encoder_args, decoder=decoder_args, dl=dl, **kwargs)

    def __repr__(self):
        return "model: RRS_HF (TransformerEncoder + TransformerDecoder)"
