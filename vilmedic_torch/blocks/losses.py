"""Classification losses (port of the classification part of
``blocks/losses.py``), registered under the config's ``loss.proto`` names.

All compute in f32 whatever the logits' dtype:

- :func:`cross_entropy`: ``torch.nn.CrossEntropyLoss`` semantics with
  ``ignore_index`` (-100): the mean over the rows that count (at least 1);
- ``BCEWithLogitsLoss``: ``max(x, 0) - x * t + log1p(exp(-|x|))``;
- ``LabelSmoothingCrossEntropy`` (the reference's MVQA loss):
  ``smoothing / C * (-sum of log-softmax)`` plus ``(1 - smoothing)`` times
  the cross entropy, each reduced by ``reduction``.

The contrastive self-supervision losses of the JAX module wait for the
SELFSUP models.
"""

from __future__ import annotations

import torch

from ..registry import register


def cross_entropy(logits, labels, reduction: str = "mean", ignore_index: int = -100):
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    nll = -log_probs.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    return nll.sum() / valid.sum().clamp_min(1)


def binary_cross_entropy_with_logits(logits, targets, reduction: str = "mean"):
    x = logits.float()
    loss = torch.clamp_min(x, 0) - x * targets + torch.log1p(torch.exp(-x.abs()))
    if reduction == "none":
        return loss
    return loss.sum() if reduction == "sum" else loss.mean()


@register("loss", "CrossEntropyLoss")
class CrossEntropyLoss:
    def __init__(self, reduction: str = "mean", ignore_index: int = -100, **kwargs):
        self.reduction = reduction
        self.ignore_index = ignore_index

    def __call__(self, logits, labels, **kwargs):
        return cross_entropy(logits, labels, self.reduction, self.ignore_index)


@register("loss", "BCEWithLogitsLoss")
class BCEWithLogitsLoss:
    def __init__(self, reduction: str = "mean", **kwargs):
        self.reduction = reduction

    def __call__(self, logits, targets, **kwargs):
        return binary_cross_entropy_with_logits(logits, targets, self.reduction)


@register("loss", "LabelSmoothingCrossEntropy")
class LabelSmoothingCrossEntropy:
    def __init__(self, smoothing: float = 0.1, reduction: str = "mean", **kwargs):
        self.smoothing = smoothing
        self.reduction = reduction

    def __call__(self, output, target, **kwargs):
        c = output.shape[-1]
        log_preds = torch.log_softmax(output.float(), dim=-1)
        if self.reduction == "sum":
            loss = -log_preds.sum()
        else:
            loss = -log_preds.sum(dim=-1)
            if self.reduction == "mean":
                loss = loss.mean()
        nll = cross_entropy(output, target, self.reduction)
        return loss * self.smoothing / c + (1 - self.smoothing) * nll
