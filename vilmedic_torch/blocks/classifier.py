"""Classifier head and the ensemble classification evaluation (port of
``blocks/classifier.py``, one device).

:class:`Classifier` is dropout then a linear layer with f32 parameters, in
f32 (the JAX module's default ``dtype``). :func:`evaluation` runs every
model of an ensemble over the loader in eval mode, stacks their logits to
(N, n_models, C) and returns their mean as ``hyps``, the labels as
``refs``, the mean of the per-batch, per-model losses as ``loss`` and the
stacked ``logits``. Data parallel evaluation is not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..data.image import prepare_batch
from .transformer import Linear, dropout


class Classifier(nn.Module):
    def __init__(self, in_features: int, num_classes: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = float(dropout)
        self.Dense_0 = Linear(in_features, num_classes, torch.float32)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """``generator`` draws the dropout mask (None: eval, no dropout)."""
        return self.Dense_0(dropout(x, self.dropout, generator))


@torch.no_grad()
def evaluation(models, config, dl, **kwargs) -> Dict:
    """Ensemble classification over ``dl`` (module doc), on the models'
    device."""
    device = next(models[0].module.parameters()).device
    all_logits: List[np.ndarray] = []
    all_labels: List[np.ndarray] = []
    losses: List[List[float]] = []
    for batch in dl:
        labels = batch["labels"]
        on_device = prepare_batch({k: v.to(device) if torch.is_tensor(v) else v
                                   for k, v in batch.items()}, dl.dataset)
        outs = [m.apply_eval(on_device) for m in models]
        all_logits.append(np.stack([o["output"].float().cpu().numpy() for o in outs], axis=1))
        all_labels.append(np.asarray(labels.cpu().numpy() if torch.is_tensor(labels) else labels))
        losses.append([float(o["loss"]) for o in outs])
    logits = np.concatenate(all_logits, axis=0)
    return {
        "loss": float(np.mean(losses)),
        "refs": np.concatenate(all_labels, axis=0),
        "hyps": np.mean(logits, axis=1),
        "logits": logits,
    }
