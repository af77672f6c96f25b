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
