"""Tiled online-softmax attention over long token axes, with its backward
(port of ``ops/flash_attention.py``).

``flash_attention`` takes the (B, T, H, D) layout of the JAX entry. The key
mask (1 keep) becomes an f32 additive bias of 0 / -1e9; ``causal=True`` lets
query r see key c iff ``c <= r + Tk - Tq``. The quirks of the JAX kernel are
kept: the mask value is the finite -1e9, so a row whose keys are all masked
averages V instead of giving 0 or NaN; the running max starts at -1e9; the
denominator is floored at 1e-30. Keys past Tk do not exist (the kernel masks
its ragged last tile instead of padding), so such a row averages the real
keys only. A causal row that sees no key at all (Tq > Tk) averages every V,
in the kernels as in the plain version.

Differentiation: when grad is enabled and an input requires it,
``flash_attention`` runs :class:`FlashAttentionFunction`, whose forward also
writes the per-row log-sum-exp (``lse`` (B, H, Tq) f32) and whose backward
is the FlashAttention-2 pair of the JAX custom VJP: ``delta = rowsum(dO * O)``
in plain PyTorch, then a dq kernel over query tiles and a dk/dv/dbias kernel
over key tiles that recompute ``p = exp(s - lse)``. The key mask is not
differentiable; dbias (summed over heads, as JAX does) comes out of
:func:`flash_attention_backward` for checking.

Every entry launches ``csrc/flash_attention.cu`` (K4) or
``csrc/flash_attention_bwd.cu`` (K5) for CUDA tensors, or raises, and runs the
same function in plain PyTorch (``*_reference``) for CPU tensors, so autograd
on the CPU goes through the port's own backward too.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_lib

NEG_INF = -1e9
HEAD_DIMS = (16, 32, 64, 128)  # the head dims the kernels are built for


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


def _scores(q, k, key_mask, causal: bool) -> torch.Tensor:
    """(B, H, Tq, Tk) f32 scores of the input-dtype operands: scaled, plus the
    key bias, causal-masked to -1e9."""
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
    return s


def flash_attention_reference(q, k, v, key_mask=None, causal: bool = False,
                              return_lse: bool = False):
    """Plain PyTorch version of K4, with its rounding points: f32 scores of
    the input-dtype operands, the scale applied to the f32 scores,
    ``p = exp(s - m)`` rounded to V's dtype before the PV product, and
    ``acc / max(l, 1e-30)`` cast to q's dtype. (B, Tq, H, D) out, and with
    ``return_lse`` also ``lse = m + log(max(l, 1e-30))`` (B, H, Tq) f32."""
    _check(q, k, v)
    s = _scores(q, k, key_mask, causal)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    l = p.sum(dim=-1).clamp_min(1e-30)  # (B, H, Tq)
    out = (acc / l.transpose(1, 2)[..., None]).to(q.dtype)
    if return_lse:
        return out, m[..., 0] + torch.log(l)
    return out


def _delta(out, dout) -> torch.Tensor:
    """(B, H, Tq) f32 ``rowsum(dO * O)`` per (row, head), as the JAX wrappers
    compute it outside the Pallas calls."""
    return (dout.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_attention_backward_reference(q, k, v, key_mask, out, lse, dout, causal: bool = False):
    """Plain PyTorch version of K5, with the TPU kernels' rounding points: dS
    rounded to K's dtype before dS K and to Q's before dS^T Q, p rounded to
    dO's dtype before p^T dO; dbias sums the unrounded f32 dS over heads and
    query rows. Returns ``(dq, dk, dv, dbias (B, Tk) f32)``."""
    _check(q, k, v)
    scale = q.shape[-1] ** -0.5
    p = torch.exp(_scores(q, k, key_mask, causal) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    ds = p * (dp - _delta(out, dout)[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(), dout.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds.sum(dim=(1, 2))


def _check_kernel_operands(name: str, *tensors) -> torch.device:
    """One CUDA device, contiguous, one dtype (float32 or bfloat16), head
    dim in HEAD_DIMS, 16-byte aligned; returns the device."""
    dev = cuda_lib.require_cuda(name, *tensors)
    dtype = tensors[0].dtype
    if dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != dtype for t in tensors):
        raise ValueError(f"{name}: q, k, v (and dO, O) must share one dtype, float32 or bfloat16")
    d = tensors[0].shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    if any(t.shape[1] == 0 for t in tensors):
        raise ValueError(f"{name}: empty query or key axis")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: operands must start on 16-byte boundaries")
    return dev


def _kernel_forward(q, k, v, key_mask, causal: bool, with_lse: bool):
    """Launch K4; returns ``(out, lse or None)``."""
    _check(q, k, v)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    dev = _check_kernel_operands("flash_attention", q, k, v)
    bias = _key_bias(key_mask, b, tk, dev)
    if bias is not None:
        bias = bias.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=dev) if with_lse else None
    lib = cuda_lib.lib()
    fn = lib.vt_flash_attention_bf16 if q.dtype == torch.bfloat16 else lib.vt_flash_attention_f32
    with torch.cuda.device(dev):
        status = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            0 if bias is None else bias.data_ptr(), out.data_ptr(),
            0 if lse is None else lse.data_ptr(),
            b, tq, tk, h, d, int(bool(causal)), d ** -0.5, cuda_lib.stream_of(out),
        )
    cuda_lib.check(status, "flash_attention")
    return out, lse


def flash_attention(q, k, v, key_mask=None, causal: bool = False) -> torch.Tensor:
    """Attention over long axes; see the module doc.

    With grad enabled and an input that requires it, this is
    :class:`FlashAttentionFunction`. Otherwise CPU tensors take
    :func:`flash_attention_reference` and CUDA tensors launch K4 or raise:
    q/k/v (B, T, H, D) contiguous, one dtype (float32 or bfloat16), head dim
    16, 32, 64 or 128; ``key_mask`` (B, Tk), nonzero = keep."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, key_mask, causal)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, key_mask, causal)
    out, _ = _kernel_forward(q, k, v, key_mask, causal, with_lse=False)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_with_lse(q, k, v, key_mask=None, causal: bool = False):
    """The forward the backward needs: ``(out, lse (B, H, Tq) f32)`` through
    K4's LSE output (CUDA) or the plain version (CPU)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, key_mask, causal, return_lse=True)
    out, lse = _kernel_forward(q, k, v, key_mask, causal, with_lse=True)
    flash_attention_with_lse.launches += 1
    return out, lse


flash_attention_with_lse.launches = 0


def _check_stats(name: str, lse, delta, b: int, h: int, tq: int, dev) -> None:
    for t in (lse, delta):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous() \
                or tuple(t.shape) != (b, h, tq):
            raise ValueError(f"{name}: lse and delta must be contiguous f32 (B, H, Tq) = "
                             f"{(b, h, tq)} on {dev}")


def flash_attention_bwd_dq(q, k, v, bias, dout, lse, delta, causal: bool = False):
    """K5's dq kernel (CUDA only): dq (B, Tq, H, D) in q's dtype from the
    forward's operands, the f32 key ``bias`` (B, Tk) or None, dO, lse and
    delta (B, H, Tq) f32."""
    _check(q, k, v)
    b, tq, h, d = q.shape
    dev = _check_kernel_operands("flash_attention_bwd_dq", q, k, v, dout)
    if dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd_dq: dO {tuple(dout.shape)} vs q {tuple(q.shape)}")
    _check_stats("flash_attention_bwd_dq", lse, delta, b, h, tq, dev)
    dq = torch.empty_like(q)
    lib = cuda_lib.lib()
    fn = (lib.vt_flash_attention_bwd_dq_bf16 if q.dtype == torch.bfloat16
          else lib.vt_flash_attention_bwd_dq_f32)
    with torch.cuda.device(dev):
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    0 if bias is None else bias.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                    delta.data_ptr(), dq.data_ptr(), b, tq, k.shape[1], h, d,
                    int(bool(causal)), d ** -0.5, cuda_lib.stream_of(dq))
    cuda_lib.check(status, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, bias, dout, lse, delta, causal: bool = False):
    """K5's dk/dv/dbias kernel (CUDA only), arguments as
    :func:`flash_attention_bwd_dq`: ``(dk, dv, dbias (B, H, Tk) f32 per
    head)``."""
    _check(q, k, v)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    dev = _check_kernel_operands("flash_attention_bwd_dkv", q, k, v, dout)
    if dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd_dkv: dO {tuple(dout.shape)} vs q {tuple(q.shape)}")
    _check_stats("flash_attention_bwd_dkv", lse, delta, b, h, tq, dev)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty((b, h, tk), dtype=torch.float32, device=dev)
    lib = cuda_lib.lib()
    fn = (lib.vt_flash_attention_bwd_dkv_bf16 if q.dtype == torch.bfloat16
          else lib.vt_flash_attention_bwd_dkv_f32)
    with torch.cuda.device(dev):
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    0 if bias is None else bias.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                    delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(),
                    b, tq, tk, h, d, int(bool(causal)), d ** -0.5, cuda_lib.stream_of(dk))
    cuda_lib.check(status, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv, dbias


flash_attention_bwd_dkv.launches = 0


def flash_attention_backward(q, k, v, key_mask, out, lse, dout, causal: bool = False):
    """Gradients of :func:`flash_attention` at ``(q, k, v)`` for the upstream
    gradient ``dout``, from the forward's ``out`` and ``lse``: ``(dq, dk, dv,
    dbias (B, Tk) f32)``. CPU tensors take
    :func:`flash_attention_backward_reference`; CUDA tensors compute delta in
    plain PyTorch and launch K5's two kernels, or raise."""
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, key_mask, out, lse, dout, causal)
    _check(q, k, v)
    if out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError("flash_attention_backward: out must match q in shape and dtype")
    bias = _key_bias(key_mask, q.shape[0], k.shape[1], q.device)
    if bias is not None:
        bias = bias.contiguous()
    delta = _delta(out, dout)
    dq = flash_attention_bwd_dq(q, k, v, bias, dout, lse, delta, causal)
    dk, dv, dbias = flash_attention_bwd_dkv(q, k, v, bias, dout, lse, delta, causal)
    return dq, dk, dv, dbias.sum(dim=1)


class FlashAttentionFunction(torch.autograd.Function):
    """``flash_attention`` with its gradient: forward through
    :func:`flash_attention_with_lse`, backward through
    :func:`flash_attention_backward`. ``key_mask`` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal):
        out, lse = flash_attention_with_lse(q, k, v, key_mask, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        dq, dk, dv, _ = flash_attention_backward(q, k, v, key_mask, out, lse,
                                                 dout.contiguous(), ctx.causal)
        return dq, dk, dv, None, None
