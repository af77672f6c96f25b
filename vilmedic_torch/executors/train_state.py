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
- ``radam``: :class:`RAdam`, ``optax.radam``'s update (b1 0.9, b2 0.999, eps
  1e-8 outside the square root of the bias-corrected second moment,
  threshold 5 on the SMA length rho_t: the un-rectified ``m_hat`` below it,
  which are the first six steps at b2 0.999). ``weight_decay`` adds L2 to
  the gradient before the update (``optax.add_decayed_weights`` ahead of
  the alias, as ``torch.optim.RAdam`` and the reference trainer do). The
  JAX package hands ``weight_decay`` to ``optax.radam``, which takes no such
  argument, so there the flagship config's ``weight_decay: 0.`` raises;
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

import numpy as np
import torch

# of the JAX package's optax aliases, only these are ported
_PORTED = ("adam", "adamw", "radam")
OPTAX_ADAMW_WEIGHT_DECAY = 1e-4
RADAM_THRESHOLD = 5.0  # optax's: the rectified update once rho_t reaches it


class RAdam(torch.optim.Optimizer):
    """Rectified Adam as ``optax.scale_by_radam`` computes it, then
    ``-lr``: with t the step count, m and v the moments,
    ``m_hat = m / (1 - b1^t)``, ``v_hat = v / (1 - b2^t)``,
    ``rho_t = rho_inf - 2 t b2^t / (1 - b2^t)`` (``rho_inf = 2 / (1 - b2)
    - 1``); the update is ``r_t * m_hat / (sqrt(v_hat) + eps)`` where
    ``rho_t >= RADAM_THRESHOLD``, else ``m_hat``. ``torch.optim.RAdam`` adds eps
    to ``sqrt(v)`` before the bias correction instead. ``weight_decay`` adds
    ``weight_decay * p`` to the gradient first (L2). The scalars depend on
    t only and are computed on the host; the tensors update in place with
    ``torch._foreach`` ops."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            for p in params:
                if not self.state[p]:
                    self.state[p]["mu"] = torch.zeros_like(p)
                    self.state[p]["nu"] = torch.zeros_like(p)
            mus = [self.state[p]["mu"] for p in params]
            nus = [self.state[p]["nu"] for p in params]
            grads = [p.grad for p in params]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, grads, alpha=1 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1 - b2)
            t = group["step"] = group.get("step", 0) + 1
            bc1, bc2, rho, r = _radam_scalars(b1, b2, t)
            lr = group["lr"]
            if rho >= RADAM_THRESHOLD:
                denom = torch._foreach_div(nus, bc2)
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, group["eps"])
                torch._foreach_addcdiv_(params, mus, denom, value=-lr * r / bc1)
            else:
                torch._foreach_add_(params, mus, alpha=-lr / bc1)


def _radam_scalars(b1: float, b2: float, t: int):
    """``(1 - b1^t, 1 - b2^t, rho_t, r_t)`` in f32, in optax's order of
    operations: near the threshold ``rho_t`` is a difference of two numbers
    near ``rho_inf`` (1999 at b2 0.999), so its f32 rounding moves r_t by
    up to 1%; computing it as optax does keeps the two within a rounding of
    ``b2^t``."""
    f = np.float32
    b1t, b2t = f(b1) ** f(t), f(b2) ** f(t)
    rho_inf = f(2.0 / (1.0 - b2) - 1.0)
    rho = rho_inf - f(2) * f(t) * b2t / (f(1) - b2t)
    r = np.sqrt((rho - f(4)) * (rho - f(2)) * rho_inf
                / ((rho_inf - f(4)) * (rho_inf - f(2)) * rho)) if rho >= 4 else f(0)
    return float(f(1) - b1t), float(f(1) - b2t), float(rho), float(r)


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
    elif name == "radam":
        wd = float(optim_params.get("weight_decay", 0.0))
        opt = RAdam(params, lr=lr, betas=betas, eps=eps, weight_decay=wd)
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
