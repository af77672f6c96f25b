"""The kernel build's cache key (``vilmedic_torch.ops.cuda_lib``), on the CPU:
the library's file name hashes every source and every shared header, so an
edit to either builds anew and nothing else does. No compiler is needed."""

import pytest

from vilmedic_torch.ops import cuda_lib


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "kernel.cu").write_text('#include "common.cuh"\nextern "C" int vt_k() {}\n')
    (tmp_path / "common.cuh").write_text("#pragma once\nconstexpr int kStages = 2;\n")
    monkeypatch.setattr(cuda_lib, "CSRC_DIR", tmp_path)
    return tmp_path


@pytest.mark.parametrize("name,edits", [("common.cuh", True), ("kernel.cu", True),
                                        ("notes.txt", False)])
def test_library_path_follows_sources_and_headers(csrc, name, edits):
    """A source or a ``*.cuh`` header edited: another library name (a stale
    build is never loaded); any other file: the same name."""
    before = cuda_lib.library_path()
    path = csrc / name
    path.write_text((path.read_text() if path.exists() else "") + "// edited\n")
    assert (cuda_lib.library_path() != before) is edits
    assert cuda_lib.library_path().parent == cuda_lib.BUILD_DIR


def test_headers_are_not_compiled_alone(csrc):
    """Headers enter the hash but get no ``nvcc -c`` of their own."""
    assert [p.name for p in cuda_lib.sources()] == ["kernel.cu"]
    assert [p.name for p in cuda_lib.headers()] == ["common.cuh"]



def test_build_keeps_the_ptxas_report(csrc, tmp_path, monkeypatch):
    """``build`` compiles each source with ``-Xptxas -v`` and keeps what the
    compile steps print (each kernel's registers and spills) beside the
    library, under ``ptxas_log_path``. A stand-in ``nvcc`` script writes its
    output file and, when compiling, one report line."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        'out=""; prev=""\n'
        'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
        ': > "$out"\n'
        'case " $* " in *" -c "*) echo "ptxas info    : Used 42 registers ($out)" >&2;; esac\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_lib, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "build")
    path = cuda_lib.build()
    assert path.exists() and path == cuda_lib.library_path()
    report = cuda_lib.ptxas_log_path().read_text()
    assert "Used 42 registers" in report and "kernel.o" in report
    assert cuda_lib.ptxas_log_path().parent == path.parent
