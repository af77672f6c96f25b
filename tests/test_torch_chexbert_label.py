"""The port's CheXbert labelling CLI (``vilmedic_torch.data_tools.
get_chexbert_label``) against the JAX package's
``data_tools/get_chexbert_label.py``: both label the same
``split.report.tok`` with the same random-weight CheXbert files (the
fixture of ``tests/test_torch_clinical_scorers.py``, laid out as
``VILMEDIC_WEIGHTS_DIR`` expects), and the label files must be equal byte
for byte."""

import importlib.util
import shutil

import pytest

from test_torch_clinical_scorers import SCORER_ENV, _reports, write_scorer_weights
from vilmedic_torch.data_tools import get_chexbert_label as tlabel
from vilmedic_torch.scorers import chexbert as tchexbert

REPO = __import__("pathlib").Path(__file__).resolve().parents[1]


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_get_chexbert_label", REPO / "data_tools" / "get_chexbert_label.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory):
    return write_scorer_weights(tmp_path_factory.mktemp("chexbert_label_weights"))


@pytest.fixture
def env(weights_dir, monkeypatch, tmp_path):
    for key in SCORER_ENV:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("VILMEDIC_WEIGHTS_DIR", str(weights_dir))
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty_hub"))


def test_label_file_equals_jax_byte_for_byte(env, tmp_path):
    reports = _reports(24, 7) + ["", "no acute cardiopulmonary process ."]
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        (tmp_path / side / "train.report.tok").write_text("\n".join(reports) + "\n")
    want = _jax_cli().compute_labels(str(tmp_path / "jax" / "train.report.tok"))
    got = tlabel.main([str(tmp_path / "port" / "train.report.tok"), "--device", "cpu"])
    assert got == str(tmp_path / "port" / "train.label.tok")
    assert open(got, "rb").read() == open(want, "rb").read()
    lines = open(got).read().split("\n")
    assert len(lines) == len(reports) and len(set(lines)) > 3


def test_no_positive_condition_writes_no_finding(env, tmp_path, monkeypatch):
    rows = [[""] * 13 + [0], [1] + [0] * 12 + [1], [-1, 0, 1] + [""] * 11]
    monkeypatch.setattr(tchexbert.CheXbert, "get_labels", lambda self, reports, mode: rows)
    (tmp_path / "test.report.tok").write_text("a\nb\nc")
    out = tlabel.compute_labels(str(tmp_path / "test.report.tok"), device="cpu")
    assert open(out).read() == ("No Finding\nEnlarged Cardiomediastinum,No Finding\n"
                                "Lung Opacity")


def test_report_file_name_must_be_split_report_tok(env, tmp_path):
    path = tmp_path / "reports.txt"
    path.write_text("no acute disease .")
    with pytest.raises(ValueError, match="split.report.tok"):
        tlabel.compute_labels(str(path), device="cpu")
    shutil.copy(path, tmp_path / "validate.report.tok")
    assert tlabel.compute_labels(str(tmp_path / "validate.report.tok"), device="cpu").endswith(
        "validate.label.tok")
