"""Dense attention and attention biases (port of ``ops/attention.py``).

Scores and softmax are f32 whatever the compute dtype; masks are additive
biases of 0 / -1e9. Attention whose query and key axes are both long (>=
``FLASH_MIN_LEN``, or ``FLASH_MIN_LEN_TRAIN`` when ``train=True``: a forward
whose backward will run) and whose bias is key-padding only goes to
:func:`~.flash_attention.flash_attention`, as in the JAX package: the CUDA
kernels on the card, their plain versions on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention

NEG_INF = -1e9  # additive mask value; safe in f32 and bf16

# the JAX package's flash-route thresholds, for inference and for training
# steps (measured there on a TPU; kept so the port takes the flash kernels
# exactly where the reference does). Read at call time.
FLASH_MIN_LEN = 1024
FLASH_MIN_LEN_TRAIN = 512


def _softmax_f32(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    m = x.amax(dim=-1, keepdim=True)
    unnorm = torch.exp(x - m)
    return unnorm / unnorm.sum(dim=-1, keepdim=True)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.float32,
    causal: bool = False,
    train: bool = False,
) -> torch.Tensor:
    """Scaled dot-product attention.

    q: (B, Tq, H, D), k/v: (B, Tk, H, D), bias broadcastable to (B, H, Tq, Tk).
    ``causal=True`` adds the causal constraint (query r sees key c iff
    c <= r + Tk - Tq) on top of ``bias``. ``train=True`` lowers the flash
    threshold to ``FLASH_MIN_LEN_TRAIN``. Returns (B, Tq, H, D) in ``dtype``.
    """
    key_bias_only = bias is None or (
        bias.ndim == 4 and bias.shape[1] == 1 and bias.shape[2] == 1
    )
    min_len = FLASH_MIN_LEN_TRAIN if train else FLASH_MIN_LEN
    if q.shape[1] >= min_len and k.shape[1] >= min_len and key_bias_only:
        key_mask = None if bias is None else bias[:, 0, 0, :] >= -0.5
        return flash_attention(q, k, v, key_mask=key_mask, causal=causal).to(dtype)

    depth = q.shape[-1]
    q = q * (depth ** -0.5)
    # f32 products of the compute-dtype values, f32 accumulation
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if bias is not None:
        scores = scores + bias
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        row = torch.arange(tq, device=scores.device)[:, None]
        col = torch.arange(tk, device=scores.device)[None, :]
        scores = scores + torch.where(col <= row + (tk - tq), 0.0, NEG_INF)
    weights = _softmax_f32(scores).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v.to(dtype))


def mask_to_bias(mask: torch.Tensor) -> torch.Tensor:
    """(..., Tq, Tk) boolean or 0/1 mask -> f32 additive bias (0 keep, NEG_INF drop)."""
    return torch.where(mask > 0, 0.0, NEG_INF).to(torch.float32)


def make_attention_bias(
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    query_len: Optional[int] = None,
    key_len: Optional[int] = None,
    decode_index: Optional[int] = None,
    device: Optional[torch.device] = None,
) -> Optional[torch.Tensor]:
    """Build a (B, 1, Tq, Tk) additive bias from a key padding mask and causality.

    During incremental decoding (Tq == 1) ``decode_index`` is the query's
    position, so the causal constraint becomes "attend to keys <= index".
    ``device`` places a causal-only bias; with ``key_mask`` its device wins.
    """
    bias = None
    if key_mask is not None:
        bias = mask_to_bias(key_mask[:, None, None, :])
        device = key_mask.device
    if causal:
        if decode_index is not None:
            positions = torch.arange(key_len, device=device)[None, None, None, :]
            causal_bias = torch.where(positions <= decode_index, 0.0, NEG_INF)
        else:
            tq = query_len
            tk = key_len if key_len is not None else tq
            row = torch.arange(tq, device=device)[:, None]
            col = torch.arange(tk, device=device)[None, :]
            causal_bias = torch.where(col <= row, 0.0, NEG_INF)[None, None, :, :]
        causal_bias = causal_bias.to(torch.float32)
        bias = causal_bias if bias is None else bias + causal_bias
    return bias
