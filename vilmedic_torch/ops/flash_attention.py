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

Every entry launches, for CUDA tensors, ``csrc/flash_attention.cu`` (K4) and
``csrc/flash_attention_bwd.cu`` (K5) in bf16 or
``csrc/flash_attention_f32.cu`` in float32 up to head dim 128, and above it
``csrc/flash_attention_wide_tc.cu`` (bf16) or
``csrc/flash_attention_f32_split.cu`` (float32), both as a cluster of CTAs
that split the head dim where one CTA does not hold it, and
``csrc/flash_attention_gemm.cu`` for heads wider than a cluster splits
(matrix products over a score block in a workspace the wrapper allocates:
:func:`gemm_chunk`, :func:`gemm_workspace_bytes`), or raises; it runs the
same function in plain PyTorch (``*_reference``) for CPU tensors, so
autograd on the CPU goes through the port's own backward too. The float32
tensor-core kernels run as three TF32 passes (:func:`split_tf32` gives the
halves): one pass would not hold the f32 route's parity with the plain
version, three keep f32's own order of error.

Head dims: every d runs on the card, at :func:`padded_head_dim` (d, dtype):
the least of ``HEAD_DIMS`` (16, 32, 64, 128, 256) at or above it; above 256
(in float32 above 128) the next multiple of ``WIDE_STEP`` (64), which the
float32 kernels split into n shares of ``F32_SHARE`` (64) columns up to 16
CTAs (:func:`f32_split_of`: 192 to 1024), and in bf16 above 320 the next
width that a cluster of n CTAs splits into n equal shares of 192, 256 or 320
columns (:func:`split_of`: 384, 512, 640 as pairs, 768 to 1280 as 3 or 4, up
to 5120 as 16). Wider heads stay at the multiple of 64. q, k, v (and dO, O)
get zero columns along D, the kernels take the true scale ``d ** -0.5``, and
the outputs are sliced back to d. Zero columns change no score, no output
column, no LSE and no ``delta``, so this is the same function (the JAX
package's v1 kernel, which takes any head dim, pads its VMEM tile alike).
:func:`kernel_route` names the C entries for each dtype and padded head dim;
``ENTRY_LAUNCHES`` counts the launches of each entry.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_lib

NEG_INF = -1e9
HEAD_DIMS = (16, 32, 64, 128, 256)  # the head dims the kernels are built for
WIDE_STEP = 64  # above 256: the wide kernels' head-dim chunk
SPLIT_WIDTHS = (192, 256, 320)  # bf16 above 320: the columns a CTA of a cluster holds
SPLIT_MAX = 16  # CTAs of a cluster (Hopper's largest, non-portable above 8)
F32_SHARE = 64  # f32 above 128: the columns a CTA of a cluster holds
GEMM_ROUTES = ("wide", "wide_bf16")  # csrc/flash_attention_gemm.cu's routes
WORKSPACE_CAP = 2 << 30  # bytes of those routes' score block, a chunk of rows
GEMM_ROW_STEP = 64  # their chunks of rows are multiples of this
GEMM_DUAL_N = {torch.float32: 64, torch.bfloat16: 128}  # columns of a backward score tile
ENTRY_LAUNCHES: dict = {}  # C entry name -> launches
_ENTRIES: dict = {}  # (C entry name, library) -> its function


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


def split_of(width: int) -> tuple:
    """``(n, w)``: the CTAs of the cluster that a bf16 head of (a multiple of
    ``WIDE_STEP``) ``width`` above 320 takes, ``n = ceil(width / 320)``, and
    the columns each holds, ``width / n`` rounded up to a multiple of 64 (192,
    256 or 320). The head runs at ``n * w`` when n is at most ``SPLIT_MAX``."""
    n = -(-width // SPLIT_WIDTHS[-1])
    return n, -(-width // (n * WIDE_STEP)) * WIDE_STEP


def f32_split_of(width: int) -> tuple:
    """``(n, w)``: the CTAs of the cluster that an f32 head of (a multiple
    of ``WIDE_STEP``) ``width`` above 128 takes and the columns each holds:
    ``w = F32_SHARE``, the narrowest share, so n = width / 64 (3 at 192).
    The head runs on the split kernels when n is at most ``SPLIT_MAX`` (up
    to 1024; 128-column shares do not fit the dq kernel's shared memory)."""
    return -(-width // F32_SHARE), F32_SHARE


def padded_head_dim(d: int, dtype=None) -> int:
    """The head dim that head dim ``d`` runs at on the card: the least one in
    ``HEAD_DIMS`` at or above ``d``; above the largest (for float32 above
    128), ``d`` rounded up to a multiple of ``WIDE_STEP``, which
    :func:`f32_split_of` splits as it is; for bf16 above 320 the width
    :func:`split_of` gives, where a cluster splits it (up to 5120)."""
    if d < 1:
        raise ValueError(f"flash attention: head dim {d}")
    width = -(-d // WIDE_STEP) * WIDE_STEP
    if dtype == torch.float32 and d > HEAD_DIMS[-2]:
        return width
    for built in HEAD_DIMS:
        if d <= built:
            return built
    if dtype == torch.bfloat16 and width > SPLIT_WIDTHS[-1]:
        n, w = split_of(width)
        if n <= SPLIT_MAX:
            return n * w
    return width


def kernel_route(dtype, width: int) -> str:
    """The suffix of the C entries (forward, dq, dk/dv) that run the padded
    head dim ``width``: ``bf16`` up to 128, the wgmma kernels of
    ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``; ``f32``
    up to 128, ``csrc/flash_attention_f32.cu`` (wgmma, three TF32 passes);
    ``f32_split`` for f32 above 128 up to ``SPLIT_MAX`` * 64 = 1024,
    ``csrc/flash_attention_f32_split.cu`` (three TF32 passes, a cluster of
    :func:`f32_split_of` CTAs); ``wide_tc`` for bf16 above 128 up to
    ``SPLIT_MAX`` * 320 = 5120, the wgmma kernels of
    ``csrc/flash_attention_wide_tc.cu`` (one CTA a row block at 256 and
    320, a cluster of :func:`split_of` CTAs above); the matrix products of
    ``csrc/flash_attention_gemm.cu`` (wgmma; three TF32 passes in f32),
    ``wide`` for f32 and ``wide_bf16`` for bf16 heads wider than a cluster
    splits."""
    if width <= 128:
        return "bf16" if dtype == torch.bfloat16 else "f32"
    if dtype != torch.bfloat16:
        return "f32_split" if width <= SPLIT_MAX * F32_SHARE else "wide"
    return "wide_tc" if width <= SPLIT_MAX * SPLIT_WIDTHS[-1] else "wide_bf16"


def split_tf32(x: torch.Tensor):
    """``(hi, lo)`` with ``x = hi + lo`` exactly (float32): ``hi`` is ``x``
    rounded to TF32 (10 mantissa bits; nearest, ties away from zero, as the
    kernels round each operand), ``lo`` the rest. A tensor core reads an f32
    word as TF32 by dropping its low 13 bits, which ``lo`` loses too; the
    f32 kernels sum ``lo_a hi_b + hi_a lo_b + hi_a hi_b``."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return hi, x - hi


def _round_up(x: int, step: int = GEMM_ROW_STEP) -> int:
    return -(-x // step) * step


def gemm_score_bytes(kind: str, dtype) -> int:
    """Bytes a score takes in a GEMM route's workspace: the forward's f32 S
    and P (V's dtype; f32 as TF32 hi and lo halves), dq's dS, dk/dv's P^T
    and dS^T (``kind`` ``fwd``, ``dq``, ``dkv``)."""
    rounded = 8 if dtype == torch.float32 else 2
    return {"fwd": 4 + rounded, "dq": rounded, "dkv": 2 * rounded}[kind]


def gemm_chunk(rows: int, b: int, h: int, cols: int, score_bytes: int,
               cap: int = None) -> int:
    """The rows (queries for the forward and dq, keys for dk/dv) a GEMM
    route's launch takes at a time: a multiple of ``GEMM_ROW_STEP``, at
    least one step, no more than ``rows`` rounded up, and otherwise the most
    whose scores over ``cols`` (rounded up) columns for every (b, h) fit in
    ``cap`` bytes (``WORKSPACE_CAP``)."""
    cap = WORKSPACE_CAP if cap is None else cap
    per_row = b * h * _round_up(cols) * score_bytes
    fit = cap // per_row // GEMM_ROW_STEP * GEMM_ROW_STEP
    return min(max(fit, GEMM_ROW_STEP), _round_up(rows))


def gemm_workspace_bytes(kind: str, dtype, b: int, tq: int, tk: int, h: int, d: int,
                         chunk: int) -> int:
    """The workspace of ``csrc/flash_attention_gemm.cu``'s entry ``kind`` at
    padded head dim ``d``, laid out as the entry carves it (each region on a
    1024-byte boundary): in f32 the TF32 hi and lo halves of its operands
    (forward Q, K, V^T; dq Q, dO, K, V, K^T; dk/dv K, V, Q, dO, Q^T, dO^T;
    the transposes with their rows padded to 64), then the score block of a
    chunk (and the forward's row denominators, dk/dv's per-tile dbias
    sums)."""
    f32 = dtype == torch.float32
    esize, halves = (4, 2) if f32 else (2, 1)
    tkp, tqp = _round_up(tk), _round_up(tq)
    operands = {"fwd": [(tq, False), (tk, False), (tk, True)],
                "dq": [(tq, False), (tq, False), (tk, False), (tk, False), (tk, True)],
                "dkv": [(tk, False), (tk, False), (tq, False), (tq, False), (tq, True),
                        (tq, True)]}[kind]
    regions = []
    if f32:
        for t, trans in operands:
            regions += [b * (_round_up(t) if trans else t) * h * d * 4] * 2
    cols = tqp if kind == "dkv" else tkp
    block = b * chunk * h * cols
    if kind == "fwd":
        regions += [block * 4, halves * block * esize, b * h * chunk * 4]
    elif kind == "dq":
        regions += [halves * block * esize]
    else:
        n_ct = -(-tqp // GEMM_DUAL_N[dtype])
        regions += [halves * block * esize] * 2 + [b * h * chunk * n_ct * 4]
    used = 0
    for size in regions:
        used = _round_up(used, 1024) + size
    return used


def _workspace(kind: str, dtype, b: int, tq: int, tk: int, h: int, width: int, dev):
    """``(workspace, C arguments)`` of a GEMM route's entry (``(None, ())``
    for the other routes): a uint8 tensor of :func:`gemm_workspace_bytes`
    and ``(its pointer, its bytes, the chunk)``."""
    if kernel_route(dtype, width) not in GEMM_ROUTES:
        return None, ()
    rows, cols = (tk, tq) if kind == "dkv" else (tq, tk)
    chunk = gemm_chunk(rows, b, h, cols, gemm_score_bytes(kind, dtype))
    size = gemm_workspace_bytes(kind, dtype, b, tq, tk, h, width, chunk)
    ws = torch.empty(size, dtype=torch.uint8, device=dev)
    return ws, (ws.data_ptr(), size, chunk)


def pad_head_dim(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` with zero columns appended along its last axis up to ``width``."""
    return x if x.shape[-1] == width else torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def _scores(q, k, key_mask, causal: bool, scale: Optional[float] = None) -> torch.Tensor:
    """(B, H, Tq, Tk) f32 scores of the input-dtype operands: times ``scale``
    (``D ** -0.5`` unless given), plus the key bias, causal-masked to -1e9."""
    b, tq, _, d = q.shape
    tk = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    bias = _key_bias(key_mask, b, tk, q.device)
    if bias is not None:
        s = s + bias[:, None, None, :]
    if causal:
        row = torch.arange(tq, device=q.device)[:, None]
        col = torch.arange(tk, device=q.device)[None, :]
        s = torch.where(col <= row + (tk - tq), s, NEG_INF)
    return s


def flash_attention_reference(q, k, v, key_mask=None, causal: bool = False,
                              return_lse: bool = False, scale: Optional[float] = None):
    """Plain PyTorch version of K4, with its rounding points: f32 scores of
    the input-dtype operands, the scale (``D ** -0.5`` unless given) applied
    to the f32 scores, ``p = exp(s - m)`` rounded to V's dtype before the PV
    product, and ``acc / max(l, 1e-30)`` cast to q's dtype. (B, Tq, H, D)
    out, and with ``return_lse`` also ``lse = m + log(max(l, 1e-30))`` (B,
    H, Tq) f32."""
    _check(q, k, v)
    s = _scores(q, k, key_mask, causal, scale)
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


def flash_attention_backward_reference(q, k, v, key_mask, out, lse, dout, causal: bool = False,
                                       scale: Optional[float] = None):
    """Plain PyTorch version of K5, with the TPU kernels' rounding points: dS
    rounded to K's dtype before dS K and to Q's before dS^T Q, p rounded to
    dO's dtype before p^T dO; dbias sums the unrounded f32 dS over heads and
    query rows. ``scale`` as in :func:`flash_attention_reference`. Returns
    ``(dq, dk, dv, dbias (B, Tk) f32)``."""
    _check(q, k, v)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    p = torch.exp(_scores(q, k, key_mask, causal, scale) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    ds = p * (dp - _delta(out, dout)[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(), dout.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds.sum(dim=(1, 2))


def _kernel_operands(name: str, *tensors):
    """One CUDA device, contiguous, one dtype (float32 or bfloat16), 16-byte
    aligned. Returns ``(device, d, tensors)``, the tensors zero-padded along
    D to :func:`padded_head_dim`."""
    dev = cuda_lib.require_cuda(name, *tensors)
    dtype = tensors[0].dtype
    if dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != dtype for t in tensors):
        raise ValueError(f"{name}: q, k, v (and dO, O) must share one dtype, float32 or bfloat16")
    d = tensors[0].shape[-1]
    if any(t.shape[1] == 0 for t in tensors):
        raise ValueError(f"{name}: empty query or key axis")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: operands must start on 16-byte boundaries")
    width = padded_head_dim(d, dtype)
    return dev, d, [pad_head_dim(t, width) for t in tensors]


def _entry(name: str, dtype, width: int):
    """The C entry ``name_<kernel_route>`` for ``dtype`` at the padded head
    dim ``width``, as ``(entry name, function)``, looked up once per loaded
    library."""
    entry = f"{name}_{kernel_route(dtype, width)}"
    library = cuda_lib.lib()
    fn = _ENTRIES.get((entry, library))
    if fn is None:
        fn = _ENTRIES[(entry, library)] = getattr(library, entry)
    return entry, fn


def _head_args(dtype, width: int) -> tuple:
    """The C entries' head-dim arguments at the padded ``width``: ``(width,)``,
    and for the ``wide_tc`` and ``f32_split`` entries ``(width, n)``, n the
    CTAs a head takes (:func:`split_of`, 1 at 256 and 320;
    :func:`f32_split_of`), which the entry checks against the widths it is
    built for."""
    route = kernel_route(dtype, width)
    if route == "wide_tc":
        return width, split_of(width)[0]
    if route == "f32_split":
        return width, f32_split_of(width)[0]
    return (width,)


def _launch(name: str, kernel: str, dtype, width: int, *args) -> None:
    """Call the C entry :func:`_entry` names, raise on its status, count it."""
    entry, fn = _entry(name, dtype, width)
    cuda_lib.check(fn(*args), kernel)
    ENTRY_LAUNCHES[entry] = ENTRY_LAUNCHES.get(entry, 0) + 1


def _unpad(x: torch.Tensor, d: int) -> torch.Tensor:
    return x if x.shape[-1] == d else x[..., :d].contiguous()


def _kernel_forward(q, k, v, key_mask, causal: bool, with_lse: bool):
    """Launch K4; returns ``(out, lse or None)``."""
    _check(q, k, v)
    b, tq, h, _ = q.shape
    tk = k.shape[1]
    dev, d, (q, k, v) = _kernel_operands("flash_attention", q, k, v)
    bias = _key_bias(key_mask, b, tk, dev)
    if bias is not None:
        bias = bias.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=dev) if with_lse else None
    ws, ws_args = _workspace("fwd", q.dtype, b, tq, tk, h, q.shape[-1], dev)
    with torch.cuda.device(dev):
        _launch("vt_flash_attention", "flash_attention", q.dtype, q.shape[-1],
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                0 if bias is None else bias.data_ptr(), out.data_ptr(),
                0 if lse is None else lse.data_ptr(),
                b, tq, tk, h, *_head_args(q.dtype, q.shape[-1]), int(bool(causal)), d ** -0.5,
                *ws_args, cuda_lib.stream_of(out))
    return _unpad(out, d), lse


def flash_attention(q, k, v, key_mask=None, causal: bool = False) -> torch.Tensor:
    """Attention over long axes; see the module doc.

    With grad enabled and an input that requires it, this is
    :class:`FlashAttentionFunction`. Otherwise CPU tensors take
    :func:`flash_attention_reference` and CUDA tensors launch K4 or raise:
    q/k/v (B, T, H, D) contiguous, one dtype (float32 or bfloat16), any head
    dim (see the module doc); ``key_mask`` (B, Tk), nonzero = keep."""
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
    b, tq, h, _ = q.shape
    if dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd_dq: dO {tuple(dout.shape)} vs q {tuple(q.shape)}")
    dev, d, (q, k, v, dout) = _kernel_operands("flash_attention_bwd_dq", q, k, v, dout)
    _check_stats("flash_attention_bwd_dq", lse, delta, b, h, tq, dev)
    dq = torch.empty_like(q)
    ws, ws_args = _workspace("dq", q.dtype, b, tq, k.shape[1], h, q.shape[-1], dev)
    with torch.cuda.device(dev):
        _launch("vt_flash_attention_bwd_dq", "flash_attention_bwd_dq", q.dtype, q.shape[-1],
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                0 if bias is None else bias.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), b, tq, k.shape[1], h,
                *_head_args(q.dtype, q.shape[-1]),
                int(bool(causal)), d ** -0.5, *ws_args, cuda_lib.stream_of(dq))
    flash_attention_bwd_dq.launches += 1
    return _unpad(dq, d)


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, bias, dout, lse, delta, causal: bool = False):
    """K5's dk/dv/dbias kernel (CUDA only), arguments as
    :func:`flash_attention_bwd_dq`: ``(dk, dv, dbias (B, H, Tk) f32 per
    head)``."""
    _check(q, k, v)
    b, tq, h, _ = q.shape
    tk = k.shape[1]
    if dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd_dkv: dO {tuple(dout.shape)} vs q {tuple(q.shape)}")
    dev, d, (q, k, v, dout) = _kernel_operands("flash_attention_bwd_dkv", q, k, v, dout)
    _check_stats("flash_attention_bwd_dkv", lse, delta, b, h, tq, dev)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty((b, h, tk), dtype=torch.float32, device=dev)
    ws, ws_args = _workspace("dkv", q.dtype, b, tq, tk, h, q.shape[-1], dev)
    with torch.cuda.device(dev):
        _launch("vt_flash_attention_bwd_dkv", "flash_attention_bwd_dkv", q.dtype, q.shape[-1],
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                0 if bias is None else bias.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(),
                b, tq, tk, h, *_head_args(q.dtype, q.shape[-1]), int(bool(causal)), d ** -0.5,
                *ws_args, cuda_lib.stream_of(dk))
    flash_attention_bwd_dkv.launches += 1
    return _unpad(dk, d), _unpad(dv, d), dbias


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
