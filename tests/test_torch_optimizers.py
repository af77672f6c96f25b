"""The port's optax aliases (``executors/train_state.OptaxAlias``) against
the JAX package's ``create_optimizer``, on the CPU.

Seven optimizers (sgd, rmsprop, adagrad, adadelta, adafactor, lamb, lion),
each with the options a config can reach (torch names, translated as the
JAX package translates them), take 5 steps on the same seeded gradients
from the same parameters: a matrix adafactor factors, a 3-d tensor it
factors over its two largest axes, a small matrix and a vector it does not,
and a zero tensor (lamb's trust ratio of 1). After every step each
parameter agrees within 1e-6 of its largest magnitude; the clip of
``clip_grad_norm`` runs ahead of the chain in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vilmedic_torch.executors.train_state import create_optimizer as t_create, gated_update
from vilmedic_tpu.executors.train_state import create_optimizer as j_create, set_learning_rate

SHAPES = {"a": (130, 200), "b": (4, 160, 136), "c": (5, 7), "d": (17,), "z": (3, 4)}
CASES = {
    "sgd": dict(lr=0.05, momentum=0.9, nesterov=True, weight_decay=0.01),
    "rmsprop": dict(lr=0.01, eps=1e-6, momentum=0.5, weight_decay=0.01),
    "adagrad": dict(lr=0.1, eps=1e-8),
    "adadelta": dict(lr=1.0, eps=1e-6, weight_decay=0.001),
    "adafactor": dict(lr=0.01, momentum=0.9, weight_decay=0.001),
    "lamb": dict(lr=0.01, betas=(0.8, 0.99), eps=1e-6, weight_decay=0.01),
    "lion": dict(lr=1e-3, betas=(0.9, 0.99)),
}
TOL = 1e-6


@pytest.mark.parametrize("name", sorted(CASES))
def test_alias_matches_optax(name):
    rng = np.random.default_rng(len(name))
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    init["z"][:] = 0
    clip = 5.0
    tx = j_create(name, dict(CASES[name]), clip_grad_norm=clip)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    module = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                     for k, v in init.items()})
    ttx = t_create(name, dict(CASES[name]), clip_grad_norm=clip,
                   named_parameters=module.named_parameters())
    lr = CASES[name]["lr"]
    for step in range(5):
        grads = {k: (rng.standard_normal(s) * (0.1 + step)).astype(np.float32)
                 for k, s in SHAPES.items()}
        jstate = set_learning_rate(jstate, lr)
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate,
                                    jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in module.items():
            p.grad = torch.from_numpy(grads[k])
        assert gated_update(ttx, lr, torch.tensor(1.0))
        for k, p in module.items():
            want = np.asarray(jax.device_get(jparams[k]))
            scale = max(float(np.abs(want).max()), 1e-30)
            err = float(np.abs(p.detach().numpy() - want).max()) / scale
            assert err <= TOL, (name, step, k, err)
    moved = [k for k in SHAPES if not np.array_equal(module[k].detach().numpy(), init[k])]
    assert moved, name


def test_option_the_alias_does_not_take_raises():
    """optax's sgd takes no eps: the JAX package's alias call raises a
    TypeError when the optimizer is initialized, and the port's when it is
    built."""
    module = torch.nn.Linear(2, 2)
    with pytest.raises(TypeError):
        j_create("sgd", {"lr": 0.1, "eps": 1e-8}).init({"w": jnp.zeros(2)})
    with pytest.raises(TypeError, match="eps"):
        t_create("sgd", {"lr": 0.1, "eps": 1e-8}, named_parameters=module.named_parameters())
