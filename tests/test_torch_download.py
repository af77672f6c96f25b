"""The port's download CLI (``vilmedic_torch.bin.vilmedic_download``), as
``tests/test_download_cli.py`` holds the JAX package's: the catalog, local
``--source`` installs (``.zip`` and directory, then the cached entry left
as it is), the direct-URL ``.zip`` flow against a loopback HTTP server, its
failures (no server, a page that is not a ``.zip``), and the by-name
branch, which reaches ``huggingface_hub`` only there (a stand-in module
records the call; its failure names the target directory)."""

import importlib.util
import os
import sys
import threading
import types
import zipfile

import pytest

import vilmedic_torch.bin.vilmedic_download as tdownload
from vilmedic_tpu.zoo.modeling_auto import MODEL_ZOO as JMODEL_ZOO

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "jax_vilmedic_download", os.path.join(REPO, "bin_tpu", "vilmedic_download.py"))
jdownload = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jdownload)


@pytest.fixture()
def cli(monkeypatch, tmp_path):
    monkeypatch.setattr(tdownload, "DATA_ZOO_CACHE_DIR", str(tmp_path / "data"))
    monkeypatch.setattr(tdownload, "MODEL_ZOO_CACHE_DIR", str(tmp_path / "models"))
    return tdownload


def _make_zip(tmp_path):
    z = tmp_path / "artifact.zip"
    with zipfile.ZipFile(z, "w") as f:
        f.writestr("train.report.tok", "no acute disease .\n")
        f.writestr("sub/extra.txt", "x")
    return z


def _serve(tmp_path):
    import http.server
    import socketserver

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **k):
            super().__init__(*a, directory=str(tmp_path), **k)

        def log_message(self, *a):
            pass

    httpd = socketserver.TCPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def test_list_catalog_as_the_jax_cli(cli, capsys):
    assert cli.DATA_ZOO == jdownload.DATA_ZOO and cli.MODEL_ZOO == JMODEL_ZOO
    cli.main(["--list"])
    out = capsys.readouterr().out
    assert "RRG/mimic-cxr" in out and "Models:" in out and "rrg/baseline-mimic" in out


def test_install_from_source_zip_and_dir(cli, tmp_path, capsys):
    z = _make_zip(tmp_path)
    cli.main(["RRG/mimic-cxr", "--source", str(z)])
    installed = os.path.join(cli.DATA_ZOO_CACHE_DIR, "RRG/mimic-cxr")
    assert open(os.path.join(installed, "train.report.tok")).read().startswith("no acute")
    cli.main(["RRG/mimic-cxr", "--source", str(z)])
    assert "already cached" in capsys.readouterr().out
    src_dir = tmp_path / "plaindir"
    src_dir.mkdir()
    (src_dir / "a.tok").write_text("hello")
    cli.main(["rrg/baseline-mimic", "--source", str(src_dir)])  # a model: the zoo's directory
    assert open(os.path.join(cli.MODEL_ZOO_CACHE_DIR, "rrg/baseline-mimic", "a.tok")).read() \
        == "hello"
    cli.main(["--list"])
    assert "[cached] rrg/baseline-mimic" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="does not exist"):
        cli.main(["RRG/indiana", "--source", str(tmp_path / "nowhere")])


def test_download_url_over_loopback_http(cli, tmp_path, capsys):
    _make_zip(tmp_path)
    httpd = _serve(tmp_path)
    try:
        cli.main(["RRS/mimic-cxr", "--url",
                  f"http://127.0.0.1:{httpd.server_address[1]}/artifact.zip"])
    finally:
        httpd.shutdown()
        httpd.server_close()
    installed = os.path.join(cli.DATA_ZOO_CACHE_DIR, "RRS/mimic-cxr")
    assert os.path.exists(os.path.join(installed, "sub/extra.txt"))
    assert "installed RRS/mimic-cxr" in capsys.readouterr().out


def test_download_url_failures(cli, tmp_path):
    with pytest.raises(SystemExit, match="download failed"):
        cli.main(["RRG/padchest", "--url", "http://127.0.0.1:1/nope.zip"])
    (tmp_path / "artifact.zip").write_text("<html>404-ish</html>")
    httpd = _serve(tmp_path)
    try:
        with pytest.raises(SystemExit, match="did not return a .zip"):
            cli.main(["MVQA/imageclef", "--url",
                      f"http://127.0.0.1:{httpd.server_address[1]}/artifact.zip"])
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_by_name_through_huggingface_hub(cli, monkeypatch, capsys):
    calls = []

    def snapshot_download(repo_id, local_dir):
        calls.append((repo_id, local_dir))
        if repo_id.endswith("indiana"):
            raise OSError("no network")
        os.makedirs(local_dir)

    monkeypatch.setitem(sys.modules, "huggingface_hub",
                        types.SimpleNamespace(snapshot_download=snapshot_download))
    cli.main(["RRG/padchest"])
    assert calls == [("vilmedic/RRG-padchest", os.path.join(cli.DATA_ZOO_CACHE_DIR,
                                                             "RRG/padchest"))]
    assert "downloaded to" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="Place the files manually under"):
        cli.main(["RRG/indiana"])
