"""Weight bridge from the JAX package's RRG and VisionLanguage variables to the
port's state dicts (counterpart of ``zoo/convert.py``).

The port keeps the Flax tree's module names, so the bridge is a rename plus
transposes over ``{"params": ..., "batch_stats": ...}`` given as numpy arrays:

- Dense ``kernel`` (in, out) -> ``weight`` (out, in); conv ``kernel`` HWIO ->
  ``weight`` OIHW; ``bias`` -> ``bias``;
- LayerNorm/BatchNorm ``scale`` -> ``weight``; Embed ``embedding`` -> ``weight``;
- BatchNorm statistics ``mean``/``var`` -> ``running_mean``/``running_var``;
- bare parameters (DINOv2's ``cls_token``, ``pos_embed``, LayerScale
  ``ls1``/``ls2``, VisionLanguage's ``image_token_embedding``) as they are.

The values stay f32, as the Flax parameters are: the port's Linear and
Embedding parameters are f32 too and cast to the compute dtype at use. Only
the frozen towers' convolutions (DenseNet, the DINOv2 patch embedding) and
DINOv2's SwiGLU projections are held in the compute dtype, so
``load_state_dict`` rounds those once, where Flax rounds at use to the same
values.

A reference ``.pth`` state dict reaches the port through the JAX package's
``convert_reference_rrg`` and then this function.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _flatten(tree: Dict, prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _flatten(value, path + ".")
        else:
            yield path, value


_BARE = ("cls_token", "pos_embed", "ls1", "ls2", "image_token_embedding")


def _param(path: str, value) -> tuple:
    module, _, leaf = path.rpartition(".")
    arr = np.asarray(value)
    if leaf == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"{path}: kernel of rank {arr.ndim}")
        leaf = "weight"
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    elif leaf != "bias" and leaf not in _BARE:
        raise ValueError(f"{path}: unknown parameter leaf {leaf!r}")
    return f"{module}.{leaf}" if module else leaf, arr


_STATS = {"mean": "running_mean", "var": "running_var"}


def rrg_state_dict_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX RRG ``{"params", "batch_stats"}`` (numpy leaves) -> the port's
    ``RRGModule`` state dict of f32 tensors."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(variables["params"]):
        key, arr = _param(path, value)
        out[key] = torch.tensor(arr, dtype=torch.float32)
    for path, value in _flatten(variables.get("batch_stats") or {}):
        module, _, leaf = path.rpartition(".")
        if leaf not in _STATS:
            raise ValueError(f"{path}: unknown batch statistic {leaf!r}")
        out[f"{module}.{_STATS[leaf]}"] = torch.tensor(np.asarray(value), dtype=torch.float32)
    return out


def vl_state_dict_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX VisionLanguage ``{"params"}`` (numpy leaves) -> the port's
    ``VisionLanguageModule`` state dict of f32 tensors. The tower has no
    batch statistics."""
    return rrg_state_dict_from_jax({"params": variables["params"]})
