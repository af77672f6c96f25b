"""Tensor-parallel placement rules (port of ``parallel/sharding.py``).

The JAX package's Megatron rules, by parameter name: the attention q / k / v
and FFN ``fc1`` kernels are split by output (column-sharded), the attention
output ``o`` and FFN ``fc2`` kernels by input (row-sharded), the LM head by
vocabulary; everything else is replicated. A Flax kernel is (in, out) and a
torch ``Linear.weight`` is (out, in), so the JAX package's ``P(None,
'model')`` is ``Shard(0)`` here and ``P('model', None)`` is ``Shard(1)``.
:func:`param_specs` gives each parameter's placement as the JAX package's
spec (``(None, "model")``, ``("model", None)`` or ``()``, read on the Flax
layout) beside the torch placement; :func:`shard_params` distributes the
parameters over a 1-D ``DeviceMesh`` with
``torch.distributed.tensor.distribute_tensor``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

MODEL_AXIS = "model"
COLUMN_KERNELS = ("q", "k", "v", "fc1")
ROW_KERNELS = ("o", "fc2")


def spec_for(name: str, param: torch.Tensor) -> Tuple:
    """The JAX package's spec of parameter ``name`` (its kernel read in the
    Flax (in, out) layout): ``(None, "model")`` for column kernels and the
    LM head, ``("model", None)`` for row kernels, ``()`` otherwise."""
    parts = name.split(".")
    if parts[-1] == "weight" and param.ndim == 2 and len(parts) >= 2:
        parent = parts[-2]
        if parent in COLUMN_KERNELS or parent == "lm_head":
            return (None, MODEL_AXIS)
        if parent in ROW_KERNELS:
            return (MODEL_AXIS, None)
    return ()


def placement_for(spec: Tuple):
    """The torch placement of a JAX spec on a (out, in) weight."""
    from torch.distributed.tensor import Replicate, Shard

    if spec == (None, MODEL_AXIS):
        return Shard(0)
    if spec == (MODEL_AXIS, None):
        return Shard(1)
    return Replicate()


def param_specs(module: torch.nn.Module) -> Dict[str, Tuple]:
    """Each parameter's JAX-package spec, by its name in ``module``."""
    return {name: spec_for(name, p) for name, p in module.named_parameters()}


def shard_params(module: torch.nn.Module, mesh) -> torch.nn.Module:
    """Replace ``module``'s parameters by ``DTensor``\\ s over the 1-D
    ``mesh`` (a ``DeviceMesh`` with one ``"model"`` axis) placed by the
    rules; returns ``module``."""
    from torch.distributed.tensor import distribute_tensor

    for name, p in list(module.named_parameters()):
        owner = module.get_submodule(name.rpartition(".")[0]) if "." in name else module
        leaf = name.rpartition(".")[2]
        placed = distribute_tensor(p.detach(), mesh, [placement_for(spec_for(name, p))])
        setattr(owner, leaf, torch.nn.Parameter(placed, requires_grad=p.requires_grad))
    return module
