"""Build and load the port's hand-written CUDA kernels (``vilmedic_torch/csrc``).

All ``csrc/*.cu`` sources compile with ``nvcc`` for ``sm_90a`` (the ``a``:
``wgmma`` and ``setmaxnreg`` exist only for that target), one ``nvcc`` per
source, all started together, and link into ONE shared library with a plain
C interface, loaded with ``ctypes``. The build runs at first use, into
``vilmedic_torch/_build/`` (git-ignored), under a file name that hashes the
sources, the headers they share (``csrc/*.cuh``) and the flags, so an edited
source or header rebuilds and an unchanged one is reused. The library needs
no link flag beyond the runtime's: kernels that take TMA tensor maps encode
them with ``cuTensorMapEncodeTiled``, found through the runtime's
``cudaGetDriverEntryPoint``. Nothing here runs at import time.

Every C entry returns ``cudaGetLastError()`` after its launch; :func:`check`
turns a non-zero status into an exception naming the kernel. ptxas reports
each kernel's registers, shared memory and spills (``-Xptxas -v``, no effect
on the code) into :func:`ptxas_log_path` beside the library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
PTXAS_VERBOSE = ("-Xptxas", "-v")  # the compile step's report, kept in the build log

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_WS = [_P, _L, _I]  # the GEMM routes' workspace, its bytes, the rows a chunk

# C entry -> argtypes (every entry returns an int status)
SIGNATURES = {
    "vt_crop_normalize": [_P] * 4 + [_I] * 3 + [_F] * 6 + [_P],
    "vt_beam_cache_attention_f32": [_P] * 12 + [_I] * 9 + [_F, _P],
    "vt_beam_cache_attention_bf16": [_P] * 12 + [_I] * 9 + [_F, _P],
    "vt_flash_attention_f32": [_P] * 6 + [_I] * 6 + [_F, _P],
    "vt_flash_attention_bf16": [_P] * 6 + [_I] * 6 + [_F, _P],
    "vt_flash_attention_bwd_dq_f32": [_P] * 8 + [_I] * 6 + [_F, _P],
    "vt_flash_attention_bwd_dq_bf16": [_P] * 8 + [_I] * 6 + [_F, _P],
    "vt_flash_attention_bwd_dkv_f32": [_P] * 10 + [_I] * 6 + [_F, _P],
    "vt_flash_attention_bwd_dkv_bf16": [_P] * 10 + [_I] * 6 + [_F, _P],
    "vt_flash_attention_wide": [_P] * 6 + [_I] * 6 + [_F] + _WS + [_P],
    "vt_flash_attention_bwd_dq_wide": [_P] * 8 + [_I] * 6 + [_F] + _WS + [_P],
    "vt_flash_attention_bwd_dkv_wide": [_P] * 10 + [_I] * 6 + [_F] + _WS + [_P],
    "vt_flash_attention_wide_bf16": [_P] * 6 + [_I] * 6 + [_F] + _WS + [_P],
    "vt_flash_attention_bwd_dq_wide_bf16": [_P] * 8 + [_I] * 6 + [_F] + _WS + [_P],
    "vt_flash_attention_bwd_dkv_wide_bf16": [_P] * 10 + [_I] * 6 + [_F] + _WS + [_P],
    "vt_flash_attention_wide_tc": [_P] * 6 + [_I] * 7 + [_F, _P],
    "vt_flash_attention_bwd_dq_wide_tc": [_P] * 8 + [_I] * 7 + [_F, _P],
    "vt_flash_attention_bwd_dkv_wide_tc": [_P] * 10 + [_I] * 7 + [_F, _P],
    "vt_flash_attention_f32_split": [_P] * 6 + [_I] * 7 + [_F, _P],
    "vt_flash_attention_bwd_dq_f32_split": [_P] * 8 + [_I] * 7 + [_F, _P],
    "vt_flash_attention_bwd_dkv_f32_split": [_P] * 10 + [_I] * 7 + [_F, _P],
    "vt_lm_head_blocked_stats_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "vt_lm_head_blocked_stats_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "vt_lm_head_topk_lse_f32": [_P] * 10 + [_I] * 5 + [_P],
    "vt_lm_head_topk_lse_bf16": [_P] * 10 + [_I] * 5 + [_P],
    "vt_fp8_scale2": [_P, _P, _I, _F, _P],
    "vt_fp8_matmul": [_P, _P, _P, _I, _I, _I, _P],
    "vt_fp8_slab_copy": [_P, _P, _I, _P],
}


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME): cannot build the kernels")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def headers():
    return sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in sources() + headers():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libvilmedic_kernels_{digest.hexdigest()[:16]}.so"


def ptxas_log_path() -> Path:
    return library_path().with_suffix(".ptxas.txt")


def _wait(jobs) -> str:
    """Wait for every (cmd, process); raise with the first failure's output,
    else return their standard error, joined."""
    failed, errs = [], []
    for cmd, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}\n{err}")
        errs.append(err)
    if failed:
        raise RuntimeError(failed[0])
    return "".join(errs)


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def build() -> Path:
    """Compile the kernels unless this exact build exists; returns the .so.

    Objects and the library are written in a temporary directory and the
    library is renamed into place, so a concurrent or interrupted build never
    leaves a partial library behind.
    """
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources()]
        log = _wait([_start([nvcc, *NVCC_FLAGS, *PTXAS_VERBOSE, "-c", "-o", str(obj), str(src)])
                     for src, obj in zip(sources(), objs)])
        lib_tmp = Path(tmp) / path.name
        _wait([_start([nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib_tmp), *map(str, objs)])])
        log_tmp = Path(tmp) / ptxas_log_path().name
        log_tmp.write_text(log)
        os.replace(log_tmp, ptxas_log_path())
        os.replace(lib_tmp, path)
    return path


@functools.cache
def lib() -> ctypes.CDLL:
    handle = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    handle.vt_error_string.argtypes = [ctypes.c_int]
    handle.vt_error_string.restype = ctypes.c_char_p
    return handle


def check(status: int, kernel: str) -> None:
    if status != 0:
        msg = lib().vt_error_string(status).decode()
        raise RuntimeError(f"{kernel}: CUDA error {status} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """All tensors on one CUDA device, contiguous; returns that device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")
    if dev.type != "cuda":
        raise ValueError(f"{name}: expects CUDA or CPU tensors, got {dev}")
    return dev

