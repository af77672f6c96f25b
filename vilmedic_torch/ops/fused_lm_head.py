"""LM head with each row's top-r logits and logsumexp in one pass over the
weights (port of ``ops/fused_lm_head.py``).

``(row top-r values, their columns, logsumexp)`` is what the two-stage beam
candidate selection reads from the logits (``decoding.decode._topk_and_lse``);
:func:`lm_head_topk_lse` computes it from the hidden states without writing
the (n, Vp) logits. It launches ``csrc/fused_lm_head.cu`` for CUDA tensors
and runs :func:`lm_head_topk_lse_reference`, the same function in plain
PyTorch, for CPU tensors. Like the JAX package, beam search does not call it.

The kernels split the work into units of (128-row tile, chunk of ``sub``
128-column vocab tiles), each writing partial top-r lists and (max,
sum-exp) per row that a merge kernel combines; :func:`work_split` picks
``sub`` and the chunk count, and chunk c holds tiles ``[c * sub, (c + 1) *
sub)``.

Layout and contract are the JAX kernel's: ``w`` is the (H, Vp) kernel padded
once by :func:`pad_lm_head_weights` (Vp a multiple of ``tile_v``; pad columns
have weight 0 and bias ``NEG``, so they never enter the top-r and add exactly
0 to the sum), ``b`` is (Vp,) f32, and ``lse`` comes back as (n,). Ties go to
the lower column, ``lax.top_k``'s order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib
from .topk import top_k

NEG = -1.0e30
BLK = 128  # the kernels' row tile and vocab tile
MAX_R = 32  # one list entry per lane of a warp
# the f32 chunk kernel's vocab split aims at two blocks per SM over the grid
BLOCKS_PER_SM = 2


def pad_lm_head_weights(kernel, bias, tile_v: int = 2048):
    """Pad the (H, V) head kernel and its bias to a multiple of ``tile_v``
    columns: weight 0 and bias ``NEG`` on the pad. Returns ``(kernel (H, Vp)
    contiguous, bias (Vp,) f32)``."""
    pad = (-kernel.shape[1]) % tile_v
    bias = bias.float()
    if pad:
        kernel = F.pad(kernel, (0, pad))
        bias = F.pad(bias, (0, pad), value=NEG)
    return kernel.contiguous(), bias


def _dims(h, w, b, r: int, tile_v: int):
    if h.ndim != 2 or w.ndim != 2 or h.shape[1] != w.shape[0]:
        raise ValueError(f"lm_head_topk_lse: h {tuple(h.shape)} vs w {tuple(w.shape)}")
    vp = w.shape[1]
    if vp % tile_v or b.shape != (vp,):
        raise ValueError(f"lm_head_topk_lse: padded vocab {vp} (bias {tuple(b.shape)}) must "
                         f"be a multiple of tile_v {tile_v}")
    if not 1 <= r <= vp:
        raise ValueError(f"lm_head_topk_lse: r {r} of a vocab of {vp}")
    return h.shape[0], h.shape[1], vp


def work_split(n: int, vp: int, sms: int, dtype=torch.bfloat16):
    """The kernels' work units: ``(sub, nchunks)``, ``sub`` 128-column vocab
    tiles to a chunk and ``nchunks`` chunks, so the units are the (128-row
    tile, chunk) pairs. bf16: one unit per persistent CTA (one per SM) where
    the tiles allow, so a CTA walks ``sub`` tiles; f32: one block per unit,
    about two per SM."""
    tiles, mtiles = vp // BLK, -(-n // BLK)
    if dtype == torch.bfloat16:
        sub = -(-(mtiles * tiles) // sms)
    else:
        sub = max(1, round(mtiles * tiles / (sms * BLOCKS_PER_SM)))
    return sub, -(-tiles // sub)


def lm_head_topk_lse_reference(h, w, b, r: int = 16, tile_v: int = 2048):
    """Plain PyTorch version: the f32-accumulated product plus the f32 bias
    (the inputs taken up to f32, exact for bf16), then the stable top-r and
    the logsumexp. Returns ``(values (n, r) f32, indices (n, r) int32, lse
    (n,) f32)``."""
    _dims(h, w, b, r, tile_v)
    logits = h.float() @ w.float() + b.float()
    values, indices = top_k(logits, r)
    return values, indices.to(torch.int32), torch.logsumexp(logits, dim=-1)


def lm_head_topk_lse(h, w, b, r: int = 16, tile_v: int = 2048):
    """Top-r logits, their columns and the logsumexp per row; see the module
    doc.

    CPU tensors take :func:`lm_head_topk_lse_reference`. Otherwise the
    kernel launches or the call raises: h, w and b on one CUDA device, h and
    w float32 or bfloat16 (one dtype), b float32, H a multiple of 32, Vp of
    128, r at most 32, all contiguous and 16-byte aligned."""
    if all(t.device.type == "cpu" for t in (h, w, b)):
        return lm_head_topk_lse_reference(h, w, b, r, tile_v)
    n, k, vp = _dims(h, w, b, r, tile_v)
    dev = cuda_lib.require_cuda("lm_head_topk_lse", h, w, b)
    if h.dtype not in (torch.float32, torch.bfloat16) or w.dtype != h.dtype:
        raise ValueError("lm_head_topk_lse: h and w must share one dtype, float32 or bfloat16")
    if b.dtype != torch.float32:
        raise ValueError("lm_head_topk_lse: bias must be float32")
    if k % 32 or vp % BLK:
        raise ValueError(f"lm_head_topk_lse: hidden size {k} must be a multiple of 32 and the "
                         f"padded vocab {vp} of {BLK}")
    if r > MAX_R:
        raise ValueError(f"lm_head_topk_lse: r {r} > {MAX_R}")
    if any(t.data_ptr() % 16 for t in (h, w, b)):
        raise ValueError("lm_head_topk_lse: the kernel reads 16-byte vectors; h, w and b must "
                         "start 16-byte aligned")
    sub, chunks = work_split(n, vp, torch.cuda.get_device_properties(dev).multi_processor_count,
                             h.dtype)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    vals, idx, lse = torch.empty((n, r), **f32), torch.empty((n, r), **i32), torch.empty(n, **f32)
    part_v, part_c = torch.empty((n, r, chunks), **f32), torch.empty((n, r, chunks), **i32)
    part_m, part_s = torch.empty((n, chunks), **f32), torch.empty((n, chunks), **f32)
    lib = cuda_lib.lib()
    fn = lib.vt_lm_head_topk_lse_bf16 if h.dtype == torch.bfloat16 else lib.vt_lm_head_topk_lse_f32
    with torch.cuda.device(dev):
        status = fn(h.data_ptr(), w.data_ptr(), b.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                    lse.data_ptr(), part_v.data_ptr(), part_c.data_ptr(), part_m.data_ptr(),
                    part_s.data_ptr(), n, k, vp, r, sub, cuda_lib.stream_of(h))
    cuda_lib.check(status, "lm_head_topk_lse")
    lm_head_topk_lse.launches += 1
    return vals, idx, lse


lm_head_topk_lse.launches = 0
