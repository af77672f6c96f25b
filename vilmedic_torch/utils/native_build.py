"""Host C++ libraries of the port, built with ``g++`` at first use.

A library is written into ``vilmedic_torch/_build/`` under a file name that
hashes its source and flags, so an edited source rebuilds and an unchanged
one is reused. A failed build raises and names the compiler's error, and a
missing ``g++`` raises too: nothing falls back quietly.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path(source: Path, build_dir: Path, stem: str, flags=FLAGS) -> Path:
    digest = hashlib.sha256(Path(source).read_bytes())
    digest.update(" ".join(flags).encode())
    return Path(build_dir) / f"{stem}_{digest.hexdigest()[:16]}.so"


def build_library(source: Path, build_dir: Path, stem: str, flags=FLAGS) -> Path:
    """Compile ``source`` unless this exact build exists; returns the .so.
    The library is written under a temporary name and renamed, so processes
    that build at once never load a half-written file."""
    so = library_path(source, build_dir, stem, flags)
    if so.exists():
        return so
    Path(build_dir).mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    cmd = ["g++", *flags, "-o", tmp, str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        os.unlink(tmp)
        raise RuntimeError(f"cannot build {Path(source).name}: g++ not found") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, so)
    return so
