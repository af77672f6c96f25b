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
  optax sees the zeros of a gradient tree;
- ``sgd``, ``rmsprop``, ``adagrad``, ``adadelta``, ``adafactor``, ``lamb``
  and ``lion``: :class:`OptaxAlias`, optax's update of each alias (not
  ``torch.optim``'s, whose eps, accumulators, factored moments, trust ratio
  and betas differ) with the options ``_translate_params`` passes (``betas``
  as b1 / b2, ``eps``, ``momentum``, ``nesterov``); ``weight_decay`` is the
  alias's own for lamb and lion (lion's default 1e-3, optax's) and L2 on
  the gradient ahead of the alias for the other five
  (``optax.add_decayed_weights``), as the JAX package chains it. An option
  the alias does not take raises ``TypeError``, as optax's alias does.

The learning rate is written into the parameter
groups before every update (:func:`set_learning_rate`), the counterpart of
``optax.inject_hyperparams``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

# the JAX package's optax aliases (executors/train_state.py)
_OPTIMIZERS = ("adam", "adamw", "radam", "sgd", "rmsprop", "adagrad", "adadelta", "adafactor",
               "lamb", "lion")
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


# the options of each alias that the config can reach through
# ``_translate_params`` (betas -> b1 / b2, eps, momentum, nesterov, and
# weight_decay where the alias takes it), at optax's defaults
ALIAS_OPTIONS = {
    "sgd": dict(momentum=None, nesterov=False),
    "rmsprop": dict(eps=1e-8, momentum=None, nesterov=False),
    "adagrad": dict(eps=1e-7),
    "adadelta": dict(eps=1e-6),
    "adafactor": dict(eps=1e-30, momentum=None),
    "lamb": dict(b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.0),
    "lion": dict(b1=0.9, b2=0.99, weight_decay=1e-3),
}
RMSPROP_DECAY = 0.9
ADAGRAD_INITIAL_ACCUMULATOR = 0.1
ADADELTA_RHO = 0.9
ADAFACTOR = dict(min_dim_size_to_factor=128, decay_rate=0.8, clipping_threshold=1.0,
                 min_param_scale=1e-3)


class OptaxAlias(torch.optim.Optimizer):
    """One of optax's ``sgd``, ``rmsprop``, ``adagrad``, ``adadelta``,
    ``adafactor``, ``lamb`` or ``lion`` (``name``), as the JAX package
    chains it: ``additive_weight_decay`` adds ``wd * p`` to the gradient
    first (the five aliases without a weight decay of their own), then the
    alias's transform and ``-lr``. Per tensor, with ``g`` the gradient:

    - sgd: with ``momentum``, ``t = g + momentum * t`` and the update ``t``
      (``g + momentum * t`` with ``nesterov``), else ``g``;
    - rmsprop: ``nu = 0.1 g^2 + 0.9 nu`` from 0, ``g * rsqrt(nu + eps)``,
      then ``-lr`` and, with ``momentum``, the trace of the scaled updates;
    - adagrad: ``s = g^2 + s`` from 0.1, ``rsqrt(s + eps) * g`` where
      ``s > 0``;
    - adadelta (rho 0.9): ``e_g`` then ``sqrt(e_x + eps) / sqrt(e_g + eps) *
      g``, then ``e_x`` from that update;
    - adafactor: the factored second moment (row and column means of ``g^2 +
      eps`` over the two largest axes when the second largest is at least
      128, else the full one) at decay ``1 - (t + 1)^-0.8``, the update
      clipped to block RMS 1, times ``lr``, times the parameter's RMS (at
      least 1e-3), an undebiased EMA with ``momentum``, negated;
    - lamb: Adam's bias-corrected ``m_hat / (sqrt(v_hat) + eps)``, plus
      ``weight_decay * p``, times the trust ratio ``|p| / |u|`` (1 where
      either norm is 0);
    - lion: ``sign((1 - b1) g + b1 m)`` plus ``weight_decay * p``, then
      ``m = (1 - b2) g + b2 m``.

    Bias corrections and decays depend on the step only and are computed
    on the host in f32, as optax rounds them; tensors update in place."""

    def __init__(self, params, name: str, lr: float, additive_weight_decay: float = 0.0,
                 **options):
        unknown = sorted(set(options) - set(ALIAS_OPTIONS[name]))
        if unknown:
            raise TypeError(f"optax.{name}() got unexpected keyword arguments {unknown}")
        super().__init__(params, dict(lr=lr, name=name, wd=additive_weight_decay,
                                      **{**ALIAS_OPTIONS[name], **options}))

    def _state(self, params, *names, fill=0.0):
        for p in params:
            st = self.state[p]
            for key in names:
                if key not in st:
                    st[key] = torch.full_like(p, fill)
        return [[self.state[p][key] for p in params] for key in names]

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if group["wd"]:
                grads = torch._foreach_add(grads, params, alpha=group["wd"])
            t = group["step"] = group.get("step", 0) + 1
            updates = getattr(self, "_" + group["name"])(group, params, grads, t)
            torch._foreach_add_(params, updates)

    def _trace(self, group, params, updates, key="trace"):
        if group["momentum"] is None:
            return updates
        (trace,) = self._state(params, key)
        torch._foreach_mul_(trace, group["momentum"])
        torch._foreach_add_(trace, updates)
        if group["nesterov"]:
            return torch._foreach_add(updates, trace, alpha=group["momentum"])
        return trace

    def _sgd(self, group, params, grads, t):
        return torch._foreach_mul(self._trace(group, params, grads), -group["lr"])

    def _rmsprop(self, group, params, grads, t):
        (nu,) = self._state(params, "nu")
        torch._foreach_mul_(nu, RMSPROP_DECAY)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - RMSPROP_DECAY)
        scale = torch._foreach_add(nu, group["eps"])
        torch._foreach_rsqrt_(scale)
        updates = torch._foreach_mul(scale, grads)
        torch._foreach_mul_(updates, -group["lr"])
        return self._trace(group, params, updates)

    def _adagrad(self, group, params, grads, t):
        (acc,) = self._state(params, "sum_of_squares", fill=ADAGRAD_INITIAL_ACCUMULATOR)
        torch._foreach_addcmul_(acc, grads, grads)
        out = []
        for s, g in zip(acc, grads):
            inv = torch.where(s > 0, torch.rsqrt(s + group["eps"]), torch.zeros_like(s))
            out.append(inv * g * -group["lr"])
        return out

    def _adadelta(self, group, params, grads, t):
        e_g, e_x = self._state(params, "e_g", "e_x")
        torch._foreach_mul_(e_g, ADADELTA_RHO)
        torch._foreach_addcmul_(e_g, grads, grads, value=1 - ADADELTA_RHO)
        eps = group["eps"]
        updates = [torch.sqrt(x + eps) / torch.sqrt(s + eps) * g
                   for x, s, g in zip(e_x, e_g, grads)]
        torch._foreach_mul_(e_x, ADADELTA_RHO)
        torch._foreach_addcmul_(e_x, updates, updates, value=1 - ADADELTA_RHO)
        return torch._foreach_mul(updates, -group["lr"])

    def _adafactor(self, group, params, grads, t):
        f = np.float32
        decay = float(f(1) - f(t) ** f(-ADAFACTOR["decay_rate"]))  # step t - 1, 0-based
        eps, out = group["eps"], []
        for p, g in zip(params, grads):
            st = self.state[p]
            dims = _factored_dims(p.shape)
            sq = g * g + eps
            if dims is not None:
                d1, d0 = dims
                if not st:
                    st["v_row"] = torch.zeros_like(sq.mean(dim=d0))
                    st["v_col"] = torch.zeros_like(sq.mean(dim=d1))
                st["v_row"] = decay * st["v_row"] + (1 - decay) * sq.mean(dim=d0)
                st["v_col"] = decay * st["v_col"] + (1 - decay) * sq.mean(dim=d1)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = st["v_row"].mean(dim=reduced_d1, keepdim=True)
                row_factor = (st["v_row"] / row_col_mean) ** -0.5
                col_factor = st["v_col"] ** -0.5
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            else:
                if not st:
                    st["v"] = torch.zeros_like(p)
                st["v"] = decay * st["v"] + (1 - decay) * sq
                u = g * st["v"] ** -0.5
            u = u / torch.clamp(torch.sqrt((u * u).mean()) / ADAFACTOR["clipping_threshold"],
                                min=1.0)
            u = u * group["lr"]
            rms = torch.sqrt((p * p).mean())
            u = u * torch.where(rms <= ADAFACTOR["min_param_scale"],
                                torch.full_like(rms, ADAFACTOR["min_param_scale"]), rms)
            if group["momentum"] is not None:
                ema = st.setdefault("ema", torch.zeros_like(p))
                u = ema.mul_(group["momentum"]).add_(u, alpha=1 - group["momentum"])
            out.append(-u)
        return out

    def _lamb(self, group, params, grads, t):
        b1, b2 = group["b1"], group["b2"]
        mu, nu = self._state(params, "mu", "nu")
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
        f = np.float32
        bc1, bc2 = float(f(1) - f(b1) ** f(t)), float(f(1) - f(b2) ** f(t))
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, group["eps"])
        updates = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        if group["weight_decay"]:
            torch._foreach_add_(updates, params, alpha=group["weight_decay"])
        out = []
        for u, p in zip(updates, params):
            pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
            ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
            out.append(u * ratio * -group["lr"])
        return out

    def _lion(self, group, params, grads, t):
        b1, b2 = group["b1"], group["b2"]
        (mu,) = self._state(params, "mu")
        updates = [torch.sign((1.0 - b1) * g + b1 * m) for g, m in zip(grads, mu)]
        torch._foreach_mul_(mu, b2)
        torch._foreach_add_(mu, grads, alpha=1 - b2)
        if group["weight_decay"]:
            torch._foreach_add_(updates, params, alpha=group["weight_decay"])
        return torch._foreach_mul(updates, -group["lr"])


def _factored_dims(shape):
    """optax's ``_factored_dims``: the two largest axes (second largest,
    largest) when the second largest is at least 128, else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR["min_dim_size_to_factor"]:
        return None
    return int(order[-2]), int(order[-1])


def translate_params(name: str, params: Dict) -> Dict:
    """The JAX package's ``_translate_params``: torch's option names onto
    the alias's keywords (``betas`` -> b1 / b2; ``weight_decay`` the
    alias's own for adam(w) / radam / lamb / lion, else
    ``additive_weight_decay``; ``eps``, ``momentum``, ``nesterov`` as they
    are); other torch options are dropped."""
    out = {}
    for k, v in params.items():
        if k == "betas":
            out["b1"], out["b2"] = float(v[0]), float(v[1])
        elif k == "weight_decay":
            key = ("weight_decay" if name in ("adamw", "adam", "radam", "lamb", "lion")
                   else "additive_weight_decay")
            out[key] = float(v)
        elif k in ("eps", "momentum", "nesterov"):
            out[k] = v
    return out


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
    if name not in _OPTIMIZERS:
        raise NotImplementedError(f"optimizer {optimizer!r}; available: {sorted(_OPTIMIZERS)}")
    lr = float(optim_params.get("lr", optim_params.get("learning_rate")))
    betas = tuple(float(b) for b in optim_params.get("betas", (0.9, 0.999)))
    eps = float(optim_params.get("eps", 1e-8))
    named = [(n, p) for n, p in named_parameters
             if p.requires_grad and not _is_frozen(n, frozen_prefixes)]
    params = [p for _, p in named]
    if name in ALIAS_OPTIONS:
        opt = OptaxAlias(params, name, lr, **translate_params(name, dict(optim_params)))
    elif name == "adamw":
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
