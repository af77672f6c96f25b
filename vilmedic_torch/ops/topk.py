"""The stable top-k shared by the decoding helpers and the plain version of
the fused LM head."""

from __future__ import annotations

import torch


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties toward the
    lower index (``lax.top_k``'s order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]
