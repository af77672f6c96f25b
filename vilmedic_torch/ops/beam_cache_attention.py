"""Reorder-free beam-decode self-attention with an in-place KV-cache write
(port of ``ops/beam_cache_attention.py``, stages (a) and (b)).

Beam search never permutes the KV caches: each beam's history is named by a
dense 0/1 ancestry mask over the joint (t, slot) axis of its item-group, and
the attention reads its ancestors' K/V where they lie. One call is one decode
step of one layer: it attends over the ancestor lanes with ``t < index`` plus
the current step's own K/V (an analytic extra lane), and writes this step's
K/V into the caches at ``t = index``.

:func:`fused_beam_cache_attention` launches ``csrc/beam_cache_attention.cu``
for CUDA tensors and runs :func:`fused_beam_cache_attention_reference`, the
same function in plain PyTorch, for CPU tensors. Both update ``kc``/``vc`` IN
PLACE (the JAX kernel aliases them input to output) and return ``out``; with
``return_stats=True`` (stage (b)) they return ``(out, m, l)``, the per-(row,
head) softmax max and denominator in the scaled-score domain, over the
ancestor lanes plus the current-step lane, so that a caller can merge this
segment with another (the prefix-LM decode does).
"""

from __future__ import annotations

import torch

from . import cuda_lib

NEG_INF = -1e9


def _dims(kc, vc, q, k_new, v_new, mask, index: int):
    if kc.ndim != 3 or kc.shape != vc.shape:
        raise ValueError(f"beam cache attention: caches {tuple(kc.shape)} / {tuple(vc.shape)}")
    t, n, hd = kc.shape
    if q.ndim != 3 or q.shape[0] != n or q.shape[1] * q.shape[2] != hd:
        raise ValueError(f"beam cache attention: q {tuple(q.shape)} vs cache {tuple(kc.shape)}")
    if k_new.shape != q.shape or v_new.shape != q.shape:
        raise ValueError("beam cache attention: q, k_new, v_new must share a shape")
    groups, rows, lanes = mask.shape
    if groups * rows != n or lanes != t * rows:
        raise ValueError(f"beam cache attention: mask {tuple(mask.shape)} vs N={n}, T={t}")
    if not 0 <= index < t:
        raise ValueError(f"beam cache attention: index {index} outside [0, {t})")
    return t, n, q.shape[1], q.shape[2], groups, rows


def fused_beam_cache_attention_reference(kc, vc, q, k_new, v_new, mask, index,
                                         return_stats: bool = False):
    """Plain PyTorch version of the kernel, with its rounding points.

    kc/vc: (T, N, H*D) caches, updated in place at ``index``; q/k_new/v_new:
    (N, H, D) in the cache dtype; mask: (groups, rows, T*rows), nonzero at the
    ancestor lanes; index: the decode position. Returns out (N, H, D) f32,
    and with ``return_stats`` also m and l, each (N, H) f32. Lanes with
    ``t >= index`` are never read, whatever the mask holds there.
    """
    index = int(index)
    t, n, heads, d, groups, rows = _dims(kc, vc, q, k_new, v_new, mask, index)
    scale = d ** -0.5
    qf = q.float() * scale  # (N, H, D): the current-step score's operand
    qr = qf.to(kc.dtype).float()  # rounded to the cache dtype for the cache dots
    # only positions t < index exist for this step
    kg = kc[:index].view(index, groups, rows, heads, d)
    vg = vc[:index].view(index, groups, rows, heads, d)
    s = torch.einsum("grhd,tgjhd->grhtj", qr.view(groups, rows, heads, d), kg.float())
    live = mask.view(groups, rows, t, rows)[:, :, :index] != 0
    s = s.masked_fill(~live[:, :, None], float("-inf"))  # (groups, rows, H, index, rows)
    s_cur = (qf * k_new.float()).sum(-1).view(groups, rows, heads)
    m = torch.cat([s.flatten(-2), s_cur[..., None]], dim=-1).amax(dim=-1)
    p = torch.exp(s - m[..., None, None])
    p_cur = torch.exp(s_cur - m)
    denom = p.sum(dim=(-2, -1)) + p_cur
    acc = torch.einsum("grhtj,tgjhd->grhd", p.to(kc.dtype).float(), vg.float())
    acc = acc + p_cur[..., None] * v_new.float().view(groups, rows, heads, d)
    out = (acc / denom[..., None]).reshape(n, heads, d)
    kc[index] = k_new.reshape(n, heads * d)
    vc[index] = v_new.reshape(n, heads * d)
    if return_stats:
        return out, m.reshape(n, heads), denom.reshape(n, heads)
    return out


def fused_beam_cache_attention(kc, vc, q, k_new, v_new, mask, index, return_stats: bool = False):
    """One decode step of reorder-free beam self-attention; see the module doc.

    CPU tensors take :func:`fused_beam_cache_attention_reference`. CUDA
    tensors launch the kernel or raise: caches and q/k_new/v_new f32 or bf16
    (one dtype), mask bool or uint8, all contiguous."""
    if kc.device.type == "cpu":
        return fused_beam_cache_attention_reference(kc, vc, q, k_new, v_new, mask, index,
                                                    return_stats)
    index = int(index)
    t, n, heads, d, groups, rows = _dims(kc, vc, q, k_new, v_new, mask, index)
    dev = cuda_lib.require_cuda("fused_beam_cache_attention", kc, vc, q, k_new, v_new, mask)
    if kc.dtype not in (torch.float32, torch.bfloat16) or any(
        x.dtype != kc.dtype for x in (vc, q, k_new, v_new)
    ):
        raise ValueError("fused_beam_cache_attention: caches and q/k/v must share "
                         "one dtype, float32 or bfloat16")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise ValueError("fused_beam_cache_attention: mask must be bool or uint8 on CUDA")
    if d not in (32, 64, 128):
        raise ValueError(f"fused_beam_cache_attention: head dim {d} not in (32, 64, 128)")
    out = torch.empty((n, heads, d), dtype=torch.float32, device=dev)
    stats = (torch.empty((n, heads), dtype=torch.float32, device=dev),
             torch.empty((n, heads), dtype=torch.float32, device=dev)) if return_stats else None
    lib = cuda_lib.lib()
    fn = (lib.vt_beam_cache_attention_bf16 if kc.dtype == torch.bfloat16
          else lib.vt_beam_cache_attention_f32)
    with torch.cuda.device(dev):
        status = fn(
            kc.data_ptr(), vc.data_ptr(), q.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), mask.data_ptr(), out.data_ptr(),
            *((stats[0].data_ptr(), stats[1].data_ptr()) if stats else (0, 0)),
            n, heads, d, t, rows, index, d ** -0.5, cuda_lib.stream_of(out),
        )
    cuda_lib.check(status, "fused_beam_cache_attention")
    fused_beam_cache_attention.launches += 1
    return (out, *stats) if stats else out


fused_beam_cache_attention.launches = 0
