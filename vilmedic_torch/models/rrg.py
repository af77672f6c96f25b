"""RRG: radiology report generation, a vision encoder feeding a causal
cross-attention decoder (port of ``models/rrg.py``)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..blocks.transformer import TransformerConfig, TransformerDecoder, causal_lm_loss
from ..blocks.vision.visual_encoder import VisualEncoder, build_visual_encoder
from ..registry import register
from .base import (
    init_weights_, in_transformer_layer, loader_channels, loader_crop, resolve_block,
    resolve_device,
)
from .evaluation_nlg import evaluation


class RRGModule(nn.Module):
    def __init__(self, enc: VisualEncoder, dec_config: TransformerConfig):
        super().__init__()
        self.enc = enc
        self.dec = TransformerDecoder(dec_config)

    def forward(self, images, input_ids, attention_mask, images_mask=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """Teacher-forced logits and the shifted causal-LM loss. ``train``:
        the tower's batch statistics (kept as pending statistics, see
        ``densenet.commit_batch_stats``) and attention routed as a training
        step; ``generator`` draws the dropout masks (None: no dropout)."""
        enc_hidden, enc_mask = self.enc.encode(images, images_mask, train=train,
                                               generator=generator)
        logits = self.dec(input_ids, attention_mask, encoder_hidden_states=enc_hidden,
                          encoder_attention_mask=enc_mask.to(torch.int32), train=train,
                          generator=generator)
        return {"loss": causal_lm_loss(logits, input_ids, attention_mask), "logits": logits}

    def encode(self, images, images_mask=None):
        return self.enc.encode(images, images_mask)

    def init_cache(self, enc_hidden, max_len: int):
        """-> (self_cache, cross_cache): mutable beam state vs loop invariants."""
        return self.dec(encoder_hidden_states=enc_hidden, mode="init_cache", max_len=max_len)

    def decode_step(self, tokens, self_cache, cross_cache, enc_mask, index: int,
                    blocked_head=None, ancestry=None):
        return self.dec(tokens, encoder_attention_mask=enc_mask, mode="decode",
                        cache=(self_cache, cross_cache), decode_index=index,
                        blocked_head=blocked_head, ancestry=ancestry)


def init_rrg_weights_(module: RRGModule, generator: torch.Generator) -> None:
    """Random weights from ``generator`` (``base.init_weights_``): the
    decoder's and a ViT tower's layers at the decoder's
    ``initializer_range``."""
    init_weights_(module, generator, module.dec.config.initializer_range,
                  lambda name: name.startswith("dec.") or in_transformer_layer(name))


@register("model")
class RRG:
    """Host-side task model around :class:`RRGModule`, built from a config's
    ``model:`` block. The vocabulary size comes from the data loader's
    tokenizer (``dl``), or from ``vocab_size`` without one; a CNN tower's
    stem from the loader's image channels. Weights are random
    from ``seed`` unless a state dict is loaded after; a decoder named by a
    pretrained ``proto`` is recorded in ``pretrained_blocks`` for
    ``base.load_pretrained``. ``cnn.freeze`` keeps
    the backbone out of training (``frozen_prefixes``); the projection stays
    trainable. ``eval_func`` is :func:`~.evaluation_nlg.evaluation`."""

    def __init__(self, decoder, cnn, dl=None, dtype="float32", vocab_size: Optional[int] = None,
                 device="cuda", seed: int = 0, **kwargs):
        device = resolve_device(device)
        compute_dtype = torch.bfloat16 if str(dtype) in ("bfloat16", "bf16") else torch.float32
        if dl is not None:
            vocab_size = dl.dataset.tokenizer.vocab_size
        dec_args, dec_pretrained = resolve_block(decoder)
        # the decoder's pretrained weights, laid over the init by base.load_pretrained
        self.pretrained_blocks = {"dec": (dec_pretrained, "causal")} if dec_pretrained else {}
        self.dec_config = TransformerConfig.from_dict(
            dec_args, **({"vocab_size": vocab_size} if vocab_size else {}), dtype=compute_dtype,
        )
        self.module = RRGModule(build_visual_encoder(cnn, dtype=compute_dtype,
                                                     crop=loader_crop(dl),
                                                     in_channels=loader_channels(dl)),
                                self.dec_config)
        init_rrg_weights_(self.module, torch.Generator().manual_seed(seed))
        self.module.to(device).eval()
        self.frozen_prefixes = ("enc/model",) if (cnn or {}).get("freeze") else ()
        self.eval_func = evaluation

    def apply_train(self, batch, generator: Optional[torch.Generator] = None):
        """One training forward over ``{"images", "input_ids",
        "attention_mask"}``: ``{"loss", "logits"}`` with the graph for the
        backward. The tower's batch statistics wait as pending statistics
        for the trainer to commit (on a finite loss); ``generator`` (on the
        model's device) draws the dropout masks."""
        return self.module(batch["images"], batch["input_ids"], batch["attention_mask"],
                           images_mask=batch.get("images_mask"), train=True,
                           generator=generator)

    def encoder_inputs(self, batch) -> Dict[str, Any]:
        return {"images": batch["images"], "images_mask": batch.get("images_mask")}

    def __repr__(self):
        return "model: RRG (VisualEncoder + TransformerDecoder)"
