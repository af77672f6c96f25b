"""RRS: radiology report summarization, a text encoder over the findings and
a causal cross-attention decoder generating the impression (port of
``models/rrs.py``). It shares the NLG ``evaluation`` with RRG: beam search
over the kernel cache (K1) with the blocked-stats head (K2) from a target
vocabulary of 4096 up."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..blocks.transformer import (
    Embedding, LayerNorm, Linear, TransformerConfig, TransformerDecoder, TransformerEncoder,
    causal_lm_loss,
)
from ..registry import register
from .base import resolve_block, resolve_device
from .evaluation_nlg import evaluation


class RRSModule(nn.Module):
    def __init__(self, enc_config: TransformerConfig, dec_config: TransformerConfig):
        super().__init__()
        self.enc = TransformerEncoder(enc_config)
        self.dec = TransformerDecoder(dec_config)

    def forward(self, input_ids, attention_mask, decoder_input_ids, decoder_attention_mask,
                train: bool = False, generator: Optional[torch.Generator] = None):
        """Teacher-forced logits and the shifted causal-LM loss over the
        target; ``train`` routes attention as a training step,
        ``generator`` draws the dropout masks (None: no dropout)."""
        enc_hidden = self.enc(input_ids, attention_mask, train=train, generator=generator)
        logits = self.dec(decoder_input_ids, decoder_attention_mask,
                          encoder_hidden_states=enc_hidden,
                          encoder_attention_mask=attention_mask, train=train,
                          generator=generator)
        return {"loss": causal_lm_loss(logits, decoder_input_ids, decoder_attention_mask),
                "logits": logits}

    def encode(self, input_ids, attention_mask):
        return self.enc(input_ids, attention_mask), attention_mask

    def init_cache(self, enc_hidden, max_len: int):
        """-> (self_cache, cross_cache): mutable beam state vs loop invariants."""
        return self.dec(encoder_hidden_states=enc_hidden, mode="init_cache", max_len=max_len)

    def decode_step(self, tokens, self_cache, cross_cache, enc_mask, index: int,
                    blocked_head=None, ancestry=None):
        return self.dec(tokens, encoder_attention_mask=enc_mask, mode="decode",
                        cache=(self_cache, cross_cache), decode_index=index,
                        blocked_head=blocked_head, ancestry=ancestry)


def init_rrs_weights_(module: RRSModule, generator: torch.Generator) -> None:
    """Random weights from ``generator``, drawn on the CPU, at the Flax
    initializers' scales: each side's Linear and Embedding weights
    N(0, its initializer_range), biases 0, LayerNorms at identity."""
    for side in (module.enc, module.dec):
        std = side.config.initializer_range
        for m in side.modules():
            if isinstance(m, (Linear, Embedding)):
                with torch.no_grad():
                    m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * std)
                if getattr(m, "bias", None) is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)


@register("model")
class RRS:
    """Host-side task model around :class:`RRSModule`, from a config's
    ``model:`` block. The vocabulary sizes come from the loader's source
    and target tokenizers (``dl``), or from the blocks' ``vocab_size``
    without one. Weights are random from ``seed``."""

    def __init__(self, encoder, decoder, dl=None, dtype="float32", device="cuda", seed: int = 0,
                 **kwargs):
        device = resolve_device(device)
        compute_dtype = torch.bfloat16 if str(dtype) in ("bfloat16", "bf16") else torch.float32
        vocab = ({}, {})
        if dl is not None:
            vocab = ({"vocab_size": dl.dataset.src.tokenizer.vocab_size},
                     {"vocab_size": dl.dataset.tgt.tokenizer.vocab_size})
        enc_args, _ = resolve_block(encoder)
        dec_args, _ = resolve_block(decoder)
        self.enc_config = TransformerConfig.from_dict(enc_args, **vocab[0], dtype=compute_dtype)
        self.dec_config = TransformerConfig.from_dict(dec_args, **vocab[1], dtype=compute_dtype)
        self.module = RRSModule(self.enc_config, self.dec_config)
        init_rrs_weights_(self.module, torch.Generator().manual_seed(seed))
        self.module.to(device).eval()
        self.frozen_prefixes = ()
        self.eval_func = evaluation

    def apply_train(self, batch, generator: Optional[torch.Generator] = None):
        """One training forward over the Seq2Seq batch: ``{"loss",
        "logits"}`` with the graph for the backward."""
        return self.module(batch["input_ids"], batch["attention_mask"],
                           batch["decoder_input_ids"], batch["decoder_attention_mask"],
                           train=True, generator=generator)

    def encoder_inputs(self, batch) -> Dict[str, Any]:
        return {"input_ids": batch["input_ids"], "attention_mask": batch["attention_mask"]}

    def __repr__(self):
        return "model: RRS (TransformerEncoder + TransformerDecoder)"
