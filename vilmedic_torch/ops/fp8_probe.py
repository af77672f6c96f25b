"""fp8 (e4m3) cache probes (port of ``experiments/spike_fp8_cache.py``).

The JAX spike asked whether the TPU's kernel compiler converts, multiplies
and copies e4m3 data, before an fp8 generated-token cache was tried. These are
its three kernels for the card, each with a plain PyTorch version and a
launch count, and :func:`probe`, the spike's ``main`` (its inputs, its three
checks):

- :func:`fp8_scale2`: e4m3 -> f32, times 2 (or another factor), -> e4m3;
- :func:`fp8_matmul`: (M, K) @ (K, N) of e4m3 matrices with f32 sums, on the
  card's fp8 tensor cores;
- :func:`fp8_slab_copy`: the first rows of an e4m3 slab copied to shared
  memory by one TMA bulk copy, then -> f32.

CPU tensors take the ``*_reference`` versions; CUDA tensors launch
``csrc/fp8_probe.cu`` or raise. fp8 tensors are ``torch.float8_e4m3fn``.

Rounding to e4m3 (:func:`e4m3_from_f32`) is the JAX package's (ml_dtypes)
and CUDA's ``__NV_NOSAT``: to nearest even, and beyond 464 (448 plus half a
step), or at an infinity, to NaN with the value's sign. PyTorch's own cast
saturates to ±448 instead (even from an infinity), so the plain versions
correct it. The card's f32 arithmetic returns the canonical NaN, so a NaN
doubled by :func:`fp8_scale2` loses its sign in both versions.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_lib

E4M3 = torch.float8_e4m3fn
E4M3_OVERFLOW = 464.0  # 448 plus half a step: the largest value that rounds to 448
MAX_SLAB_BYTES = 48 * 1024  # the kernel's kMaxSlab


def e4m3_from_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> e4m3 as ml_dtypes and ``__nv_cvt_float_to_fp8(.., __NV_NOSAT,
    __NV_E4M3)`` round: PyTorch's cast, with |x| > 464 and the infinities
    set to NaN (0x7F, with the sign bit of x)."""
    x = x.float()
    codes = x.to(E4M3).view(torch.uint8)
    nan = torch.signbit(x).to(torch.uint8) * 128 + 0x7F
    codes = torch.where((x.abs() > E4M3_OVERFLOW) & ~torch.isnan(x), nan, codes)
    return codes.view(E4M3)


def _require_e4m3(name: str, *tensors):
    for t in tensors:
        if t.dtype != E4M3:
            raise ValueError(f"{name}: expects torch.float8_e4m3fn, got {t.dtype}")


def fp8_scale2_reference(x: torch.Tensor, scale: float = 2.0) -> torch.Tensor:
    """Plain version: e4m3 -> f32, times ``scale`` in f32 (NaN made the
    canonical +NaN, as the card's f32 multiply returns it), -> e4m3
    (:func:`e4m3_from_f32`)."""
    _require_e4m3("fp8_scale2", x)
    y = x.float() * torch.tensor(scale, dtype=torch.float32, device=x.device)
    y = torch.where(torch.isnan(y), torch.full_like(y, float("nan")), y)
    return e4m3_from_f32(y)


def fp8_scale2(x: torch.Tensor, scale: float = 2.0) -> torch.Tensor:
    """e4m3 -> f32 -> times ``scale`` -> e4m3, elementwise, any shape. The
    spike doubles; another factor lets a test reach the rounding edge (8 *
    58 = 464 rounds to 448). CPU tensors take :func:`fp8_scale2_reference`;
    a CUDA tensor must be contiguous."""
    if x.device.type == "cpu":
        return fp8_scale2_reference(x, scale)
    _require_e4m3("fp8_scale2", x)
    dev = cuda_lib.require_cuda("fp8_scale2", x)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        status = cuda_lib.lib().vt_fp8_scale2(x.data_ptr(), out.data_ptr(), x.numel(), scale,
                                              cuda_lib.stream_of(x))
    cuda_lib.check(status, "fp8_scale2")
    fp8_scale2.launches += 1
    return out


fp8_scale2.launches = 0


def _matmul_dims(a, b):
    _require_e4m3("fp8_matmul", a, b)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"fp8_matmul: a {tuple(a.shape)} vs b {tuple(b.shape)}")
    return a.shape[0], b.shape[1], a.shape[1]


def fp8_matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: the e4m3 values widened to f32 (each product is exact
    in f32), multiplied with f32 sums. (M, N) f32."""
    _matmul_dims(a, b)
    return a.float() @ b.float()


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) of e4m3 matrices -> (M, N) f32. CPU tensors take
    :func:`fp8_matmul_reference`; CUDA tensors run ``mma.sync`` on e4m3 and
    need M % 16, N % 8, K % 32 == 0, contiguous, 4-byte aligned."""
    if a.device.type == b.device.type == "cpu":
        return fp8_matmul_reference(a, b)
    m, n, k = _matmul_dims(a, b)
    dev = cuda_lib.require_cuda("fp8_matmul", a, b)
    if m % 16 or n % 8 or k % 32:
        raise ValueError(f"fp8_matmul: M {m}, N {n}, K {k} must be multiples of 16, 8 and 32")
    if a.data_ptr() % 4:
        raise ValueError("fp8_matmul: a must start 4-byte aligned")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = cuda_lib.lib().vt_fp8_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n,
                                              k, cuda_lib.stream_of(a))
    cuda_lib.check(status, "fp8_matmul")
    fp8_matmul.launches += 1
    return out


fp8_matmul.launches = 0


def _slab_dims(x, rows: int):
    _require_e4m3("fp8_slab_copy", x)
    if x.ndim != 2 or not 0 < rows <= x.shape[0]:
        raise ValueError(f"fp8_slab_copy: {rows} rows of a slab {tuple(x.shape)}")
    return rows * x.shape[1]


def fp8_slab_copy_reference(x: torch.Tensor, rows: int = 8) -> torch.Tensor:
    """Plain version: rows ``0:rows`` of the (R, W) e4m3 slab as f32."""
    _slab_dims(x, rows)
    return x[:rows].float()


def fp8_slab_copy(x: torch.Tensor, rows: int = 8) -> torch.Tensor:
    """Rows ``0:rows`` of an (R, W) e4m3 slab -> (rows, W) f32, through
    shared memory by one TMA bulk copy. CPU tensors take
    :func:`fp8_slab_copy_reference`; a CUDA slab must be contiguous and
    16-byte aligned, with rows * W a multiple of 16 and at most
    ``MAX_SLAB_BYTES``."""
    if x.device.type == "cpu":
        return fp8_slab_copy_reference(x, rows)
    nbytes = _slab_dims(x, rows)
    dev = cuda_lib.require_cuda("fp8_slab_copy", x)
    if nbytes % 16 or nbytes > MAX_SLAB_BYTES or x.data_ptr() % 16:
        raise ValueError(f"fp8_slab_copy: {nbytes} bytes must be a multiple of 16, at most "
                         f"{MAX_SLAB_BYTES}, from a 16-byte aligned slab")
    out = torch.empty((rows, x.shape[1]), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = cuda_lib.lib().vt_fp8_slab_copy(x.data_ptr(), out.data_ptr(), nbytes,
                                                 cuda_lib.stream_of(x))
    cuda_lib.check(status, "fp8_slab_copy")
    fp8_slab_copy.launches += 1
    return out


fp8_slab_copy.launches = 0


def spike_inputs(device="cpu"):
    """The spike's inputs: N(0, 1) draws from numpy generators 0, 1 and 2,
    rounded to bf16 and then to e4m3 (a second rounding, as the spike does):
    ``x`` (128, 256), ``a`` and ``b`` (128, 128)."""
    def draw(seed, shape):
        z = torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))
        return e4m3_from_f32(z.to(torch.bfloat16).float()).to(device)

    return draw(0, (128, 256)), draw(1, (128, 128)), draw(2, (128, 128))


def probe(device="cuda") -> dict:
    """The spike's ``main`` on ``device``: each kernel once on the spike's
    inputs and its error against the spike's own check. Returns ``{name:
    (out, max error)}``: ``scale2`` max relative error against x * 2,
    ``matmul`` max error relative to |ref| + 1e-3, ``slab`` max absolute error
    against the first 8 rows."""
    x, a, b = spike_inputs(device)
    out = fp8_scale2(x)
    want = x.float() * 2.0
    scale2 = ((out.float() - want).abs() / (want.abs() + 1e-6)).max().item()
    mm = fp8_matmul(a, b)
    ref = a.float() @ b.float()
    matmul = ((mm - ref).abs() / (ref.abs() + 1e-3)).max().item()
    slab_in = x[:16].contiguous()
    slab = fp8_slab_copy(slab_in, 8)
    slab_err = (slab - x[:8].float()).abs().max().item()
    return {"scale2": (out, scale2), "matmul": (mm, matmul), "slab": (slab, slab_err)}
