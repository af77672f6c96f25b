"""The port's host NLG scorers against the JAX package's, on fixed hyps and
refs: BLEU (the JAX package's native core and its Python path), ROUGE-1/2/L
(the port's own tokenizer, Porter stemmer and LCS against ``rouge_score``
with the stemmer on) and CIDEr-D, to 1e-12; the Porter stemmer against
NLTK's word for word; ``compute_scores``'s names, dumps and refusals."""

import json
import logging
import re

import numpy as np
import pytest
from nltk.stem.porter import PorterStemmer

from vilmedic_torch.scorers.nlg.bleu import Bleu as TBleu
from vilmedic_torch.scorers.nlg.ciderd import CiderD as TCiderD
from vilmedic_torch.scorers.nlg.porter import stem
from vilmedic_torch.scorers.nlg.rouge import Rouge as TRouge
from vilmedic_torch.scorers.scores import compute_scores
from vilmedic_torch.utils import set_logger
from vilmedic_tpu.scorers.nlg.bleu import Bleu as JBleu
from vilmedic_tpu.scorers.nlg.ciderd import CiderD as JCiderD
from vilmedic_tpu.scorers.nlg.rouge import Rouge as JRouge

TOL = 1e-12

REFS = [
    "no acute cardiopulmonary process .",
    "heart size is normal . lungs are clear .",
    "small left pleural effusion with adjacent atelectasis .",
    "stable cardiomegaly . no pneumothorax .",
    "the lungs are hyperinflated , consistent with copd !",
    "interval improvement of pulmonary edema .",
    "there are no focal consolidations .",
    "",
]
HYPS = [
    "no acute cardiopulmonary process .",
    "heart size is normal . the lungs are clearly clear .",
    "small pleural effusions with atelectases .",
    "cardiomegaly is stable . no pneumothoraces .",
    "lungs hyperinflation , consistent with chronic obstructive disease",
    "improving pulmonary edemas .",
    "",
    "no acute disease .",
]


def _corpus(seed, n=40):
    words = sorted({w for s in REFS + HYPS for w in s.split()}) + ["generalization", "hopping"]
    rng = np.random.default_rng(seed)
    make = lambda: " ".join(rng.choice(words, rng.integers(1, 25)))  # noqa: E731
    return [make() for _ in range(n)], [make() for _ in range(n)]


CASES = [(REFS, HYPS), _corpus(0), _corpus(1)]


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("native", [True, False])
def test_bleu_matches_jax(case, native):
    refs, hyps = CASES[case]
    got, got_each = TBleu()(refs, hyps)
    want, want_each = JBleu(use_native=native)(refs, hyps)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_each, want_each, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("kind", ["rouge1", "rouge2", "rougeL"])
def test_rouge_matches_jax(case, kind):
    refs, hyps = CASES[case]
    got, got_each = TRouge(rouges=[kind])(refs, hyps)
    want, want_each = JRouge(rouges=[kind.lower()])(refs, hyps)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_each, want_each, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_ciderd_matches_jax(case):
    refs, hyps = CASES[case]
    got, got_each = TCiderD()(refs, hyps)
    want, want_each = JCiderD()(refs, hyps)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_each, want_each, rtol=TOL, atol=TOL)


def test_porter_stemmer_matches_nltk():
    """Every word of this repository's sources and docs, and words that
    reach the irregular forms and the extension rules."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    words = {"skies", "dying", "ties", "dies", "happy", "enjoy", "spy", "hopping", "filing",
             "controll", "roll", "generalization", "feed", "agreed", "bled", "conflated",
             "analogousli", "fulli", "archaeologi", "y", "yy", "ayy", "byy", "innings"}
    for path in list(root.glob("*.md")) + list((root / "vilmedic_tpu").rglob("*.py")):
        words |= set(re.findall(r"[a-z]+", path.read_text(errors="ignore").lower()))
    ref = PorterStemmer()
    assert len(words) > 3000
    assert [w for w in sorted(words) if stem(w) != ref.stem(w)] == []


def test_compute_scores_names_dumps_and_refusals(tmp_path):
    logger = set_logger(str(tmp_path), "scorers-test")
    scores = compute_scores(["BLEU", "ROUGEL", {"ROUGE1": None}, "CIDERD"], REFS, HYPS,
                            "validate", "scorers-test", {}, 3, logger)
    assert sorted(scores) == ["BLEU", "CIDERD", "ROUGE1", "ROUGEL"]
    assert scores["BLEU"] == TBleu()(REFS, HYPS)[0]
    assert (tmp_path / "validate_scorers-test_hyps.txt").read_text() == "\n".join(HYPS)
    assert (tmp_path / "validate_scorers-test_refs.txt").read_text() == "\n".join(REFS)
    dumped = json.loads((tmp_path / "validate_scorers-test_metrics.txt").read_text())
    assert dumped["epoch"] == 3 and dumped["scores"] == scores
    with pytest.raises(NotImplementedError, match="METEOR"):
        compute_scores(["BLEU", "METEOR"], REFS, HYPS, "validate", 0, {}, 0,
                       logging.getLogger("scorers-test"), dump=False)
