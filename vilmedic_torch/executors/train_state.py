"""Optimizer factory and the gated update (port of ``executors/train_state.py``).

``torch.optim`` in place of optax, with the optax chain's semantics:

- ``adamw``: b1 0.9, b2 0.999, eps 1e-8 and **weight decay 1e-4** (optax's
  default, not torch's 1e-2), decoupled and applied to every trainable
  parameter (optax's unmasked ``adamw``);
- ``adam`` with ``weight_decay``: additive L2 on the gradient before Adam
  (``optax.add_decayed_weights`` in the chain), as ``torch.optim.Adam`` does;
- ``clip_grad_norm``: ``optax.clip_by_global_norm`` over the trainable
  gradients only, ahead of the rest of the chain;
- frozen prefixes (``VisionLanguage.frozen_prefixes``) and parameters that
  take no gradient are left out of the optimizer: no state at all;
- a trainable parameter that got no gradient is updated with a zero one, as
  optax sees the zeros of a gradient tree.

The other optax aliases of the JAX package raise ``NotImplementedError``
until they are ported. The learning rate is written into the parameter
groups before every update (:func:`set_learning_rate`), the counterpart of
``optax.inject_hyperparams``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

# of the JAX package's optax aliases, only these two are ported
_PORTED = ("adam", "adamw")
OPTAX_ADAMW_WEIGHT_DECAY = 1e-4


@dataclasses.dataclass
class TrainOptimizer:
    """A ``torch.optim`` optimizer over the trainable parameters, with the
    chain's global-norm clip."""

    optimizer: torch.optim.Optimizer
    params: List[torch.nn.Parameter]
    names: List[str]
    clip_grad_norm: Optional[float] = None


def _is_frozen(name: str, frozen_prefixes: Sequence[str]) -> bool:
    """Prefixes are '/'-joined module paths (``"vision"``,
    ``"vision/model"``), matched on whole components of the '.'-joined
    parameter name."""
    parts = tuple(name.split("."))
    return any(parts[:len(p)] == p for p in (tuple(f.split("/")) for f in frozen_prefixes))


def create_optimizer(optimizer: str, optim_params: Dict, clip_grad_norm: Optional[float] = None,
                     frozen_prefixes: Sequence[str] = (), *,
                     named_parameters: Iterable[Tuple[str, torch.nn.Parameter]]
                     ) -> TrainOptimizer:
    """The config's ``optimizer``/``optim_params`` (torch names: ``lr``,
    ``betas``, ``eps``, ``weight_decay``) over ``named_parameters`` minus
    the frozen and the gradient-free ones."""
    name = optimizer.lower()
    if name not in _PORTED:
        raise NotImplementedError(f"optimizer {optimizer!r} is not ported; ported: {_PORTED}")
    lr = float(optim_params.get("lr", optim_params.get("learning_rate")))
    betas = tuple(float(b) for b in optim_params.get("betas", (0.9, 0.999)))
    eps = float(optim_params.get("eps", 1e-8))
    named = [(n, p) for n, p in named_parameters
             if p.requires_grad and not _is_frozen(n, frozen_prefixes)]
    params = [p for _, p in named]
    if name == "adamw":
        wd = float(optim_params.get("weight_decay", OPTAX_ADAMW_WEIGHT_DECAY))
        opt = torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps, weight_decay=wd)
    else:
        wd = float(optim_params.get("weight_decay", 0.0))
        opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=eps, weight_decay=wd)
    clip = None if clip_grad_norm is None else float(clip_grad_norm)
    return TrainOptimizer(opt, params, [n for n, _ in named], clip)


def set_learning_rate(tx: TrainOptimizer, lr: float) -> None:
    for group in tx.optimizer.param_groups:
        group["lr"] = float(lr)


def _clip_by_global_norm(params, max_norm: float) -> None:
    """``optax.clip_by_global_norm``: g -> g / |g| * max_norm when the global
    norm |g| is at or above ``max_norm``; on the device, no host read."""
    grads = [p.grad for p in params]
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def gated_update(tx: TrainOptimizer, lr: float, gate_loss: torch.Tensor) -> bool:
    """One optimizer update from the parameters' ``.grad`` at learning rate
    ``lr``, unless ``gate_loss`` is not finite: then the parameters **and**
    the optimizer state keep their old values (the reference checks the loss
    before ``optimizer.step``). Reads the loss on the host, one sync per
    update. Returns whether it stepped."""
    if not bool(torch.isfinite(gate_loss)):
        return False
    for p in tx.params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    set_learning_rate(tx, lr)
    if tx.clip_grad_norm is not None:
        _clip_by_global_norm(tx.params, tx.clip_grad_norm)
    tx.optimizer.step()
    return True
