"""Reorder-free beam-decode self-attention with an in-place KV-cache write
(port of ``ops/beam_cache_attention.py``, stages (a) to (d)).

Beam search never permutes the KV caches: each beam's history is named by a
dense 0/1 ancestry mask over the joint (t, slot) axis of its item-group, and
the attention reads its ancestors' K/V where they lie. One call is one decode
step of one layer: it attends over the ancestor lanes with ``t < index`` plus
the current step's own K/V (an analytic extra lane), and writes this step's
K/V into the caches at ``t = index``.

:func:`fused_beam_cache_attention` launches ``csrc/beam_cache_attention.cu``
for CUDA tensors and runs :func:`fused_beam_cache_attention_reference`, the
same function in plain PyTorch, for CPU tensors. Both update ``kc``/``vc`` IN
PLACE (the JAX kernel aliases them input to output) and return ``out``. The
stages:

- (a) the plain step;
- (b) ``return_stats=True``: also the per-(row, head) softmax max ``m`` and
  denominator ``l`` in the scaled-score domain, over every key the call
  attended, so that a caller can merge this segment with another (the
  prefix-LM decode merges it with its beam-shared prefix);
- (c) ``kv_scales`` (2, H*D) f32: int8 caches with per-lane K (row 0) and V
  (row 1) scales. This step's K/V are quantized (round half to even,
  saturated at ±127) before the write; the K scale folds into the query, the
  V scale out of the accumulator. The current step's own lane stays exact;
- (d) ``prefix=KernelPrefix``: a beam-shared prefix K/V, at batch B, joins
  the same online softmax, so the call covers prefix, generated cache and
  current step with no merge. Row n attends to the prefix of item
  ``n // beams``.

(c) and (d) exclude each other, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from . import cuda_lib

NEG_INF = -1e9
HEAD_DIMS = (32, 64, 128)  # the head dims the kernel is built for


@dataclasses.dataclass(frozen=True)
class KernelPrefix:
    """A beam-shared prefix K/V packed for stage (d): ``pk``/``pv`` (B, P,
    H*D) in the cache dtype, each item's prefix contiguous, of which the
    first ``p_real`` positions are keys; ``beams`` rows per item (rows are
    beam-major within an item). Not a tuple, so that it never passes for
    the int8 prefix's 4-tuple."""

    pk: torch.Tensor
    pv: torch.Tensor
    p_real: int
    beams: int


def pack_kernel_prefix(pk, pv, beams: int) -> KernelPrefix:
    """(B, P, H, D) prefix K/V -> :class:`KernelPrefix` in (B, P, H*D).

    The JAX package's (P_pad, B, H*D) layout, padded to 128 positions, is a
    TPU layout (128-lane DMA slices); on the card an item's prefix is one
    contiguous run and the kernel masks its own ragged tail, so nothing is
    padded."""
    b, p, h, d = pk.shape
    return KernelPrefix(pk.reshape(b, p, h * d).contiguous(),
                        pv.reshape(b, p, h * d).contiguous(), p, beams)


def prefix_fusable(beam_width: int, group_items: int, prefix_len: int) -> bool:
    """True iff stage (d) can stream the prefix: whole beams per row group
    (always so here, rows = group_items * beam_width) and a prefix to stream.

    The JAX package also requires ``group_items % 8 == 0``, a Mosaic sublane
    rule of its (P_pad, groups, gB, H*D) slab view, which left the route
    unreachable at beam 8 on the TPU; the card has no such rule, so any
    ``group_items`` fuses."""
    return beam_width > 0 and group_items > 0 and prefix_len > 0


def _dims(kc, vc, q, k_new, v_new, mask, index: int, kv_scales, prefix):
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
    int8 = kc.dtype == torch.int8 or vc.dtype == torch.int8
    if kv_scales is None and int8:
        raise ValueError("beam cache attention: an int8 cache requires kv_scales")
    if kv_scales is not None:
        if prefix is not None:
            raise ValueError("beam cache attention: kv_scales and prefix exclude each other")
        if kc.dtype != torch.int8 or vc.dtype != torch.int8:
            raise ValueError("beam cache attention: kv_scales requires int8 caches")
        if tuple(kv_scales.shape) != (2, hd) or kv_scales.dtype != torch.float32:
            raise ValueError(f"beam cache attention: kv_scales {tuple(kv_scales.shape)} "
                             f"{kv_scales.dtype}, want (2, {hd}) float32")
    if prefix is not None:
        pk, pv, p_real, beams = prefix.pk, prefix.pv, prefix.p_real, prefix.beams
        if beams <= 0 or rows % beams:
            raise ValueError(f"beam cache attention: {rows} rows per group, {beams} beams")
        if (pk.ndim != 3 or pk.shape != pv.shape or pk.shape[0] * beams != n
                or pk.shape[2] != hd or not 0 < p_real <= pk.shape[1]):
            raise ValueError(f"beam cache attention: prefix {tuple(pk.shape)} with p_real "
                             f"{p_real}, beams {beams} vs N={n}, H*D={hd}")
        if pk.dtype != kc.dtype or pv.dtype != kc.dtype:
            raise ValueError("beam cache attention: the prefix must be in the cache dtype")
    return t, n, q.shape[1], q.shape[2], groups, rows


def quantize_cache_rows(x, scale):
    """f32 ``x`` over per-lane ``scale`` -> int8, round half to even,
    saturated at ±127: stage (c)'s in-place write."""
    return torch.clamp(torch.round(x / scale), -127.0, 127.0).to(torch.int8)


def fused_beam_cache_attention_reference(kc, vc, q, k_new, v_new, mask, index,
                                         return_stats: bool = False, kv_scales=None,
                                         prefix=None):
    """Plain PyTorch version of the kernel, with its rounding points.

    kc/vc: (T, N, H*D) caches, updated in place at ``index``, in q's dtype,
    or int8 with ``kv_scales``; q/k_new/v_new: (N, H, D); mask: (groups,
    rows, T*rows), nonzero at the ancestor lanes; index: the decode position;
    ``kv_scales``/``prefix``: stages (c)/(d), see the module doc. Returns out
    (N, H, D) f32, and with ``return_stats`` also m and l, each (N, H) f32.
    Lanes with ``t >= index`` are never read, whatever the mask holds there.
    """
    index = int(index)
    t, n, heads, d, groups, rows = _dims(kc, vc, q, k_new, v_new, mask, index, kv_scales,
                                         prefix)
    scale = d ** -0.5
    qf = q.float() * scale  # (N, H, D): the current-step score's operand
    vn = v_new.float()
    if kv_scales is not None:
        ks, vs = kv_scales[0].view(heads, d), kv_scales[1].view(heads, d)
        # the K scale folds into the query, rounded once to q's dtype; the V
        # scale factors out: seed with v_new / vs, scale the output at the end
        qd = (qf * ks).to(q.dtype).float()
        vn = vn / vs
        p_dtype = q.dtype
    else:
        qd = qf.to(kc.dtype).float()  # rounded to the cache dtype for the cache dots
        p_dtype = kc.dtype
    # only positions t < index exist for this step
    kg = kc[:index].view(index, groups, rows, heads, d)
    vg = vc[:index].view(index, groups, rows, heads, d)
    s = torch.einsum("grhd,tgjhd->grhtj", qd.view(groups, rows, heads, d), kg.float())
    live = mask.view(groups, rows, t, rows)[:, :, :index] != 0
    s = s.masked_fill(~live[:, :, None], float("-inf"))  # (groups, rows, H, index, rows)
    s_cur = (qf * k_new.float()).sum(-1).view(groups, rows, heads)
    m = torch.cat([s.flatten(-2), s_cur[..., None]], dim=-1).amax(dim=-1)
    if prefix is not None:
        pk, pv, p_real, beams = prefix.pk, prefix.pv, prefix.p_real, prefix.beams
        b = pk.shape[0]
        pkh = pk[:, :p_real].view(b, p_real, heads, d).float()
        pvh = pv[:, :p_real].view(b, p_real, heads, d).float()
        # rows are beam-major within an item: row n belongs to item n // beams
        sp = torch.einsum("bfhd,bphd->bfhp", qd.view(b, beams, heads, d), pkh)
        sp = sp.reshape(groups, rows, heads, p_real)
        m = torch.maximum(m, sp.amax(dim=-1))
    p = torch.exp(s - m[..., None, None])
    p_cur = torch.exp(s_cur - m)
    denom = p.sum(dim=(-2, -1)) + p_cur
    acc = torch.einsum("grhtj,tgjhd->grhd", p.to(p_dtype).float(), vg.float())
    acc = acc + p_cur[..., None] * vn.view(groups, rows, heads, d)
    if prefix is not None:
        pp = torch.exp(sp - m[..., None])
        denom = denom + pp.sum(dim=-1)
        pp = pp.to(pv.dtype).float().reshape(b, beams, heads, p_real)
        acc = acc + torch.einsum("bfhp,bphd->bfhd", pp, pvh).reshape(groups, rows, heads, d)
    out = (acc / denom[..., None]).reshape(n, heads, d)
    if kv_scales is not None:
        out = out * vs
        kc[index] = quantize_cache_rows(k_new.float(), ks).reshape(n, heads * d)
        vc[index] = quantize_cache_rows(v_new.float(), vs).reshape(n, heads * d)
    else:
        kc[index] = k_new.reshape(n, heads * d)
        vc[index] = v_new.reshape(n, heads * d)
    if return_stats:
        return out, m.reshape(n, heads), denom.reshape(n, heads)
    return out


def fused_beam_cache_attention(kc, vc, q, k_new, v_new, mask, index, return_stats: bool = False,
                               kv_scales=None, prefix=None):
    """One decode step of reorder-free beam self-attention; see the module doc.

    CPU tensors take :func:`fused_beam_cache_attention_reference`. CUDA
    tensors launch the kernel or raise: q/k_new/v_new f32 or bf16 (one
    dtype), the caches in that dtype or int8 with ``kv_scales`` (2, H*D)
    f32, a ``prefix`` in the cache dtype, mask bool or uint8, all contiguous.

    Counts: ``launches`` every launch; ``launches_stats``, ``launches_int8``
    and ``launches_prefix`` the launches with ``return_stats``,
    ``kv_scales`` and ``prefix``."""
    if kc.device.type == "cpu":
        return fused_beam_cache_attention_reference(kc, vc, q, k_new, v_new, mask, index,
                                                    return_stats, kv_scales, prefix)
    index = int(index)
    t, n, heads, d, groups, rows = _dims(kc, vc, q, k_new, v_new, mask, index, kv_scales,
                                         prefix)
    extra = [] if kv_scales is None else [kv_scales]
    if prefix is not None:
        extra += [prefix.pk, prefix.pv]
    dev = cuda_lib.require_cuda("fused_beam_cache_attention", kc, vc, q, k_new, v_new, mask,
                                *extra)
    if q.dtype not in (torch.float32, torch.bfloat16) or any(
        x.dtype != q.dtype for x in (k_new, v_new)
    ):
        raise ValueError("fused_beam_cache_attention: q/k_new/v_new must share one dtype, "
                         "float32 or bfloat16")
    if kv_scales is None and kc.dtype != q.dtype:
        raise ValueError("fused_beam_cache_attention: caches must be in q's dtype "
                         "(or int8 with kv_scales)")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise ValueError("fused_beam_cache_attention: mask must be bool or uint8 on CUDA")
    if d not in HEAD_DIMS:
        raise ValueError(f"fused_beam_cache_attention: head dim {d} not in {HEAD_DIMS}")
    out = torch.empty((n, heads, d), dtype=torch.float32, device=dev)
    stats = (torch.empty((n, heads), dtype=torch.float32, device=dev),
             torch.empty((n, heads), dtype=torch.float32, device=dev)) if return_stats else None
    pk, pv, p_len, p_real, beams = (
        (prefix.pk.data_ptr(), prefix.pv.data_ptr(), prefix.pk.shape[1], prefix.p_real,
         prefix.beams) if prefix is not None else (0, 0, 0, 0, 1))
    lib = cuda_lib.lib()
    fn = (lib.vt_beam_cache_attention_bf16 if q.dtype == torch.bfloat16
          else lib.vt_beam_cache_attention_f32)
    with torch.cuda.device(dev):
        status = fn(
            kc.data_ptr(), vc.data_ptr(), q.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), mask.data_ptr(),
            kv_scales.data_ptr() if kv_scales is not None else 0, pk, pv, out.data_ptr(),
            *((stats[0].data_ptr(), stats[1].data_ptr()) if stats else (0, 0)),
            n, heads, d, t, rows, index, p_len, p_real, beams, d ** -0.5,
            cuda_lib.stream_of(out),
        )
    cuda_lib.check(status, "fused_beam_cache_attention")
    counts = fused_beam_cache_attention
    counts.launches += 1
    counts.launches_stats += bool(return_stats)
    counts.launches_int8 += kv_scales is not None
    counts.launches_prefix += prefix is not None
    return (out, *stats) if stats else out


fused_beam_cache_attention.launches = 0
fused_beam_cache_attention.launches_stats = 0
fused_beam_cache_attention.launches_int8 = 0
fused_beam_cache_attention.launches_prefix = 0
