"""ctypes binding for the port's host n-gram core (``csrc/ngram_scores.cpp``,
port of ``scorers/nlg/native.py``).

The library is built at first use with ``g++`` into ``vilmedic_torch/_build/``
under a file name that hashes the source and the flags, so an edited source
rebuilds and an unchanged one is reused. A failed build raises and names the
compiler's error: nothing falls back quietly to Python. The pure-Python
scorers run only where a caller asks for them (``Bleu(use_native=False)``,
``Rouge(..., use_native=False)``).

``bleu_native`` is corpus + per-sentence BLEU of single-reference pairs;
``rouge_l_native`` the per-pair ROUGE-L F1 over token lists the caller has
already tokenized and stemmed. Both feed the SCST rewards, the hot host loop
of RL fine-tuning.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Tuple

PKG_DIR = Path(__file__).resolve().parents[2]
SOURCE = PKG_DIR / "csrc" / "ngram_scores.cpp"
BUILD_DIR = PKG_DIR / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libngram_scores_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the core unless this exact build exists; returns the .so. The
    library is written under a temporary name and renamed, so processes that
    build at once never load a half-written file."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *FLAGS, "-o", tmp, str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        os.unlink(tmp)
        raise RuntimeError(f"cannot build {SOURCE.name}: g++ not found") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def get_lib() -> ctypes.CDLL:
    """The loaded core, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.bleu_score.restype = ctypes.c_double
            lib.bleu_score.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                       ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                       ctypes.c_int, ctypes.POINTER(ctypes.c_double)]
            lib.rouge_l_batch.restype = None
            lib.rouge_l_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                          ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_double)]
            _lib = lib
        return _lib


def _strings(items: List[str]):
    return (ctypes.c_char_p * len(items))(*[s.encode("utf-8") for s in items])


def bleu_native(refs: List[str], hyps: List[str], n: int = 4) -> Tuple[float, List[float]]:
    """Corpus BLEU-n and the per-sentence BLEU-n of single-reference pairs."""
    count = len(refs)
    per = (ctypes.c_double * count)()
    corpus = get_lib().bleu_score(_strings(refs), _strings(hyps), count, n, per)
    return float(corpus), [float(x) for x in per]


def rouge_l_native(ref_tokens: List[List[str]], hyp_tokens: List[List[str]]) -> List[float]:
    """Per-pair ROUGE-L F1 of already tokenized and stemmed token lists."""
    count = len(ref_tokens)
    f1 = (ctypes.c_double * count)()
    get_lib().rouge_l_batch(_strings([" ".join(t) for t in ref_tokens]),
                            _strings([" ".join(t) for t in hyp_tokens]), count, f1)
    return [float(x) for x in f1]
