"""MVQA: medical VQA / image classification (port of ``models/mvqa.py``),
the model of ``config/MVQA`` and ``config/CLASS``.

:class:`MVQAModule`: the vision tower (``cnn:``, a ``VisualEncoder``), then
``adapter`` (a linear layer to ``adapter.output_size``) and ``adapter_ln``,
then ``num_hidden_layers`` post-LN encoder layers over the tokens, a tanh
pooler on token 0 and :class:`~..blocks.classifier.Classifier`; the logits
are f32. :class:`MVQA` builds the loss from ``loss.proto`` and returns
``loss``, ``output`` (the logits) and ``answer`` (their argmax); its
``eval_func`` is the ensemble classification loop
(:func:`~..blocks.classifier.evaluation`). ``cnn.freeze`` keeps the tower
out of training.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .. import registry
from ..blocks import losses  # noqa: F401  (registers the losses)
from ..blocks.classifier import Classifier, evaluation
from ..blocks.transformer import EncoderLayer, LayerNorm, Linear, TransformerConfig
from ..blocks.vision.visual_encoder import VisualEncoder, build_visual_encoder
from ..config.config import Config
from .base import in_transformer_layer, init_weights_, loader_crop, resolve_device


class MVQAModule(nn.Module):
    def __init__(self, cnn: VisualEncoder, adapter_out: int, config: TransformerConfig,
                 num_classes: int, classifier_dropout: float = 0.0):
        super().__init__()
        self.config = config
        dt = config.dtype
        self.cnn = cnn
        self.adapter = Linear(cnn.width, adapter_out, dt)
        self.adapter_ln = LayerNorm(adapter_out, config.layer_norm_eps, dt)
        for i in range(config.num_hidden_layers):
            self.add_module(f"layer_{i}", EncoderLayer(config))
        self.pooler = Linear(config.hidden_size, config.hidden_size, dt)
        self.classifier = Classifier(config.hidden_size, num_classes, classifier_dropout)

    @property
    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.config.num_hidden_layers)]

    def forward(self, images, train: bool = False, generator: Optional[torch.Generator] = None):
        """(B, 3, H, W) images -> (B, num_classes) f32 logits. ``train``: the
        tower's batch statistics (pending, for the trainer to commit) and
        attention routed as a training step; ``generator`` draws the dropout
        masks (None: no dropout)."""
        gen = generator if train else None
        out = self.cnn(images, train, gen)
        if out.ndim == 2:
            out = out[:, None, :]  # a pooled vector is one token
        out = self.adapter_ln(self.adapter(out))
        for layer in self.layers:
            out = layer(out, None, train, gen)
        pooled = torch.tanh(self.pooler(out[:, 0]))
        return self.classifier(pooled, gen).float()


def _d(cfg) -> Dict:
    return cfg.to_dict() if isinstance(cfg, Config) else dict(cfg or {})


@registry.register("model")
class MVQA:
    """Host-side task model around :class:`MVQAModule`, built from a
    config's ``model:`` block. ``classifier.num_classes`` (or, without it,
    the loader's label map) sets the classes. Weights are random from
    ``seed`` unless a state dict is loaded after; builds on the card unless
    ``device`` names another."""

    def __init__(self, cnn, classifier, adapter, transformer, loss, dl=None, dtype="float32",
                 device="cuda", seed: int = 0, **kwargs):
        device = resolve_device(device)
        compute_dtype = torch.bfloat16 if str(dtype) in ("bfloat16", "bf16") else torch.float32
        transformer, adapter, classifier, loss = map(_d, (transformer, adapter, classifier, loss))
        self.transformer_cfg = TransformerConfig.from_dict(transformer, dtype=compute_dtype)
        num_classes = classifier.get("num_classes")
        if num_classes is None:
            if dl is None:
                raise ValueError("MVQA needs classifier.num_classes or a loader's label map")
            num_classes = len(dl.dataset.labels_map)
        self.num_classes = int(num_classes)
        self.loss_fn = registry.get("loss", loss.pop("proto"))(**loss)
        self.frozen_prefixes = ("cnn/model",) if _d(cnn).get("freeze") else ()
        self.module = MVQAModule(
            build_visual_encoder(cnn, dtype=compute_dtype, crop=loader_crop(dl)),
            adapter.get("output_size", self.transformer_cfg.hidden_size), self.transformer_cfg,
            self.num_classes, float(classifier.get("dropout", 0.0) or 0.0))
        init_weights_(self.module, torch.Generator().manual_seed(seed),
                      self.transformer_cfg.initializer_range, in_transformer_layer)
        self.module.to(device).eval()
        self.eval_func = evaluation

    def _apply(self, batch, train: bool, generator=None) -> Dict:
        logits = self.module(batch["images"], train, generator)
        labels = batch.get("labels")
        loss = (self.loss_fn(logits, labels) if labels is not None
                else torch.zeros((), device=logits.device))
        return {"loss": loss, "output": logits, "answer": logits.argmax(dim=-1)}

    def apply_train(self, batch, generator: Optional[torch.Generator] = None) -> Dict:
        """One training forward over ``{"images", "labels"}``, with the graph
        for the backward; the tower's batch statistics wait as pending
        statistics for the trainer to commit."""
        return self._apply(batch, True, generator)

    @torch.no_grad()
    def apply_eval(self, batch) -> Dict:
        return self._apply(batch, False)

    def __repr__(self):
        return "model: MVQA (VisualEncoder + set-transformer + Classifier)"
