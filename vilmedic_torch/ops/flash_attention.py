"""Tiled online-softmax attention over long token axes (port of the forward
of ``ops/flash_attention.py``).

``flash_attention`` takes the (B, T, H, D) layout of the JAX entry. The key
mask (1 keep) becomes an f32 additive bias of 0 / -1e9; ``causal=True`` lets
query r see key c iff ``c <= r + Tk - Tq``. The quirks of the JAX kernel are
kept: the mask value is the finite -1e9, so a row whose keys are all masked
averages V instead of giving 0 or NaN; the running max starts at -1e9; the
denominator is floored at 1e-30. Keys past Tk do not exist (the kernel masks
its ragged last tile instead of padding), so such a row averages the real
keys only. A causal row that sees no key at all (Tq > Tk) is undefined, as in
the JAX package.

:func:`flash_attention` launches ``csrc/flash_attention.cu`` for CUDA tensors
and runs :func:`flash_attention_reference`, the same function in plain
PyTorch, for CPU tensors. The per-row log-sum-exp that the JAX forward saves
for its backward is not ported (training is not).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_lib

NEG_INF = -1e9


def _key_bias(key_mask: Optional[torch.Tensor], b: int, tk: int, device) -> Optional[torch.Tensor]:
    if key_mask is None:
        return None
    if tuple(key_mask.shape) != (b, tk):
        raise ValueError(f"flash attention: key mask {tuple(key_mask.shape)} vs (B, Tk) = {(b, tk)}")
    return torch.where(key_mask > 0, 0.0, NEG_INF).to(device=device, dtype=torch.float32)


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; expected (B, T, H, D)")
    if q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"flash attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")


def flash_attention_reference(q, k, v, key_mask=None, causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with its rounding points: f32
    scores of the input-dtype operands, the scale applied to the f32 scores,
    ``p = exp(s - m)`` rounded to V's dtype before the PV product, and
    ``acc / max(l, 1e-30)`` cast to q's dtype. (B, Tq, H, D) out."""
    _check(q, k, v)
    b, tq, _, d = q.shape
    tk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (d ** -0.5)
    bias = _key_bias(key_mask, b, tk, q.device)
    if bias is not None:
        s = s + bias[:, None, None, :]
    if causal:
        row = torch.arange(tq, device=q.device)[:, None]
        col = torch.arange(tk, device=q.device)[None, :]
        s = torch.where(col <= row + (tk - tq), s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    l = p.sum(dim=-1).clamp_min(1e-30)  # (B, H, Tq)
    return (acc / l.transpose(1, 2)[..., None]).to(q.dtype)


def flash_attention(q, k, v, key_mask=None, causal: bool = False) -> torch.Tensor:
    """Attention over long axes; see the module doc.

    CPU tensors take :func:`flash_attention_reference`. CUDA tensors launch
    the kernel or raise: q/k/v (B, T, H, D) contiguous, one dtype (float32 or
    bfloat16), head dim 32, 64 or 128; ``key_mask`` (B, Tk), nonzero = keep."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, key_mask, causal)
    _check(q, k, v)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    dev = cuda_lib.require_cuda("flash_attention", q, k, v)
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k, v must share one dtype, float32 or bfloat16")
    if d not in (32, 64, 128):
        raise ValueError(f"flash_attention: head dim {d} not in (32, 64, 128)")
    if tq == 0 or tk == 0:
        raise ValueError("flash_attention: empty query or key axis")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must start on 16-byte boundaries")
    bias = _key_bias(key_mask, b, tk, dev)
    if bias is not None:
        bias = bias.contiguous()
    out = torch.empty_like(q)
    lib = cuda_lib.lib()
    fn = lib.vt_flash_attention_bf16 if q.dtype == torch.bfloat16 else lib.vt_flash_attention_f32
    with torch.cuda.device(dev):
        status = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            0 if bias is None else bias.data_ptr(), out.data_ptr(),
            b, tq, tk, h, d, int(bool(causal)), d ** -0.5, cuda_lib.stream_of(out),
        )
    cuda_lib.check(status, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
