"""Pieces of the task-model contract that the RRG slice needs (port of part of
``models/base.py``)."""

from __future__ import annotations

from typing import Tuple

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


def resolve_block(block_cfg):
    """Resolve a reference-style encoder/decoder block config to
    ``(config_dict, pretrained_name_or_None)``.

    ``proto: null`` keeps the explicit keys (the flagship RRG decoder). A
    pretrained ``proto`` name needs the HF config cache and the zoo, which are
    not ported yet."""
    from ..config.config import Config

    if isinstance(block_cfg, Config):
        block_cfg = block_cfg.to_dict()
    block_cfg = dict(block_cfg or {})
    proto = block_cfg.pop("proto", None)
    if isinstance(proto, str) and proto:
        raise NotImplementedError(f"pretrained block config {proto!r} is not ported")
    return block_cfg, None


def loader_crop(dl):
    """The image crop of a loader's dataset (None without one): the input
    size a ViT tower's position table is built for."""
    image = getattr(getattr(dl, "dataset", None), "image", None)
    crop = getattr(image, "crop", None)
    return int(crop) if crop is not None else None


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
        if isinstance(m, (nn.Linear, nn.Conv2d)):
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
