"""ctypes binding for the port's DICOM codecs (``csrc/dicom_codecs.cpp``,
port of ``data/dicom_codecs.py``).

JPEG Lossless (SOF3, predictors 1-7) and RLE segment decoding for the
compressed DICOM transfer syntaxes. The library is built with ``g++`` at
first use into ``vilmedic_torch/_build/`` (``utils.native_build``); a
failed build, or no ``g++``, raises.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

from ..utils.native_build import build_library

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR / "csrc" / "dicom_codecs.cpp"
BUILD_DIR = PKG_DIR / "_build"
MAX_SAMPLES = 1 << 26  # 64M samples (8k x 8k), the JAX package's bound

_lock = threading.Lock()
_lib = None


def build() -> Path:
    return build_library(SOURCE, BUILD_DIR, "libdicom_codecs")


def get_lib() -> ctypes.CDLL:
    """The loaded codecs, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.decode_jpeg_lossless.restype = ctypes.c_int
            lib.decode_jpeg_lossless.argtypes = [
                ctypes.c_char_p, ctypes.c_long,
                ctypes.POINTER(ctypes.c_uint16), ctypes.c_long,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ]
            lib.decode_rle_segment.restype = ctypes.c_long
            lib.decode_rle_segment.argtypes = [
                ctypes.c_char_p, ctypes.c_long,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
            ]
            _lib = lib
        return _lib


def decode_jpeg_lossless(data: bytes) -> Tuple[np.ndarray, int]:
    """-> (array (H, W) or (H, W, C) uint16, precision). Raises on failure."""
    out = np.empty((MAX_SAMPLES,), np.uint16)
    w, h, prec, ncomp = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = get_lib().decode_jpeg_lossless(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), MAX_SAMPLES,
        ctypes.byref(w), ctypes.byref(h), ctypes.byref(prec), ctypes.byref(ncomp))
    if rc != 0:
        raise ValueError(f"JPEG lossless decode failed (rc={rc})")
    arr = out[:w.value * h.value * ncomp.value].copy()
    shape = (h.value, w.value) if ncomp.value == 1 else (h.value, w.value, ncomp.value)
    return arr.reshape(shape), prec.value


def decode_rle_segment(data: bytes, expected: int) -> np.ndarray:
    """One PackBits segment -> at most ``expected`` bytes. Raises on failure."""
    out = np.empty((expected,), np.uint8)
    n = get_lib().decode_rle_segment(data, len(data),
                                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), expected)
    if n < 0:
        raise ValueError("RLE segment decode failed")
    return out[:n]
