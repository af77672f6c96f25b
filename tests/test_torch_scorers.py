"""The port's host NLG scorers against the JAX package's, on fixed hyps and
refs and random report pairs, to 1e-12: BLEU (the port's native core and
its Python path against the JAX package's core and Python path), ROUGE-1/2/L
(the port's own tokenizer, Porter stemmer and LCS, ROUGE-L through the
native LCS, against ``rouge_score`` with the stemmer on), CIDEr-D, METEOR
(on the fixtures of tests/test_meteor15.py, with no resource file, a synonym
file, and synonym and paraphrase files set for both packages), SPICE, and
the metrics CLI against ``bin_tpu/vilmedic_metrics.py``; a failed native
build raises; the Porter stemmer against NLTK's word for word;
``compute_scores``'s names, dumps and refusals."""

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
    with pytest.raises(NotImplementedError, match="radcliq"):
        compute_scores(["BLEU", "radcliq"], REFS, HYPS, "validate", 0, {}, 0,
                       logging.getLogger("scorers-test"), dump=False)


# ---------------------------------------------------------------- the native core

NATIVE_REFS = [  # the fixture of tests/test_native.py
    "there is no evidence of pneumonia .",
    "heart size is normal .",
    "small left pleural effusion .",
    "a b c d e f g h i j",
    "",
]
NATIVE_HYPS = [
    "there is no pneumonia .",
    "the heart size is enlarged .",
    "no pleural effusion .",
    "a b c d",
    "something",
]
NATIVE_CASES = [(NATIVE_REFS, NATIVE_HYPS), (REFS, HYPS), _corpus(2), _corpus(3, n=200)]


@pytest.mark.parametrize("case", range(len(NATIVE_CASES)))
def test_native_bleu_matches_python_and_jax(case):
    """The port's C++ BLEU against its pure-Python BLEU and JAX's
    ``bleu_native``, corpus and per sentence, to 1e-12."""
    from vilmedic_torch.scorers.nlg.native import bleu_native as tbleu_native
    from vilmedic_tpu.scorers.nlg.native import bleu_native as jbleu_native

    refs, hyps = NATIVE_CASES[case]
    got, got_each = tbleu_native(refs, hyps)
    for want, want_each in (TBleu(use_native=False)(refs, hyps), jbleu_native(refs, hyps)):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got_each, want_each, rtol=TOL, atol=TOL)
    assert TBleu()(refs, hyps) == (got, got_each)  # the default path is the core


@pytest.mark.parametrize("case", range(len(NATIVE_CASES)))
def test_native_rouge_l_matches_python_and_jax(case):
    """ROUGE-L through the C++ LCS against the port's Python LCS, JAX's
    ``rouge_l_native`` over the same tokens, and JAX's ``Rouge`` (its native
    ``_rouge_l_fast`` and ``rouge_score``'s own scorer), to 1e-12."""
    from vilmedic_torch.scorers.nlg.native import rouge_l_native as trouge_l_native
    from vilmedic_torch.scorers.nlg.rouge import tokenize
    from vilmedic_tpu.scorers.nlg.native import rouge_l_native as jrouge_l_native

    refs, hyps = NATIVE_CASES[case]
    got, got_each = TRouge(rouges=["rougeL"])(refs, hyps)
    plain, plain_each = TRouge(rouges=["rougeL"], use_native=False)(refs, hyps)
    np.testing.assert_allclose(got_each, plain_each, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, plain, rtol=TOL, atol=TOL)
    toks = [tokenize(r) for r in refs], [tokenize(h) for h in hyps]
    np.testing.assert_allclose(trouge_l_native(*toks), jrouge_l_native(*toks), rtol=TOL, atol=TOL)
    jscorer = JRouge(rouges=["rougeL"])
    np.testing.assert_allclose(got_each, jscorer(refs, hyps)[1], rtol=TOL, atol=TOL)
    slow = [jscorer.scorer.score(r, h)["rougeL"].fmeasure for r, h in zip(refs, hyps)]
    np.testing.assert_allclose(got_each, slow, rtol=TOL, atol=TOL)


def test_native_build_failure_names_the_compiler_error(tmp_path, monkeypatch):
    """A source g++ rejects raises with the compiler's message: no quiet
    fallback to Python."""
    from vilmedic_torch.scorers.nlg import native

    bad = tmp_path / "ngram_scores.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()


# ---------------------------------------------------------------- METEOR and SPICE

METEOR_PAIRS = [  # (ref, hyp): the fixtures of tests/test_meteor15.py
    ("the lungs are clear", "the lungs are clear"),
    ("effusion seen", "effusion seen"),
    ("effusion seen", "effusions seen"),
    ("heart is enlarged", "heart is big"),
    ("there is no acute disease", "there is zilch found"),
    ("the of and effusion", "the of and pneumonia"),
    ("xxle of pleural effusion", "zzle by pleural effusion"),
    ("no acute disease .", "no disease"),
    ("small left effusion .", "effusion maybe right"),
    ("no acute disease .", "no acute disease ."),
    ("small tiny heart , enlarged .", "a tiny big heart is zilch found here"),
]


@pytest.fixture(params=["none", "synonyms", "synonyms+paraphrase"])
def matcher_files(request, tmp_path, monkeypatch):
    """The METEOR resources for both packages: none, a synonym file, or a
    synonym file and a paraphrase file; JAX's matcher singleton is reset
    (with ``METEOR_SYNONYMS`` set it skips WordNet)."""
    from vilmedic_tpu.scorers.nlg import meteor as jmeteor

    monkeypatch.delenv("METEOR_SYNONYMS", raising=False)
    monkeypatch.delenv("METEOR_PARAPHRASE", raising=False)
    if "synonyms" in request.param:
        syn = tmp_path / "syn.tsv"
        syn.write_text("enlarged\tbig\tcardiomegaly\nsmall\ttiny\nlungs\tlung\n")
        monkeypatch.setenv("METEOR_SYNONYMS", str(syn))
    if "paraphrase" in request.param:
        para = tmp_path / "para.txt"
        para.write_text("zilch found ||| no acute disease\nheart ||| cardiac silhouette\n")
        monkeypatch.setenv("METEOR_PARAPHRASE", str(para))
    monkeypatch.setattr(jmeteor._Matchers, "_instance", None)
    yield request.param
    jmeteor._Matchers._instance = None


def test_meteor_matches_jax(matcher_files):
    """``single_meteor_score`` on the METEOR fixtures and ``Meteor`` on
    them and on random report pairs, against the JAX package, to 1e-12."""
    from vilmedic_torch.scorers.nlg.meteor import Meteor as TMeteor
    from vilmedic_torch.scorers.nlg.meteor import _Matchers as TMatchers
    from vilmedic_torch.scorers.nlg.meteor import single_meteor_score as tsingle
    from vilmedic_tpu.scorers.nlg.meteor import Meteor as JMeteor
    from vilmedic_tpu.scorers.nlg.meteor import _Matchers as JMatchers
    from vilmedic_tpu.scorers.nlg.meteor import single_meteor_score as jsingle

    tm, jm = TMatchers.get(), JMatchers.get()
    assert tm.has_synonyms == jm.has_synonyms == (matcher_files != "none")
    assert (tm.paraphrases is None) == (jm.paraphrases is None)
    got = [tsingle(r.split(), h.split(), tm) for r, h in METEOR_PAIRS]
    want = [jsingle(r.split(), h.split(), jm) for r, h in METEOR_PAIRS]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert len(set(np.round(got, 9))) > 5  # the fixtures reach different scores
    for refs, hyps in [([r for r, _ in METEOR_PAIRS], [h for _, h in METEOR_PAIRS])] + CASES:
        (g, g_each), (w, w_each) = TMeteor()(refs, hyps), JMeteor()(refs, hyps)
        np.testing.assert_allclose(g_each, w_each, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_meteor_stages_order_the_scores(matcher_files):
    """Synonym and paraphrase files raise the scores of the pairs they
    match, as in tests/test_meteor15.py."""
    from vilmedic_torch.scorers.nlg.meteor import _Matchers, single_meteor_score

    m = _Matchers.get()
    syn = single_meteor_score("heart is enlarged".split(), "heart is big".split(), m)
    para = single_meteor_score("there is no acute disease".split(),
                               "there is zilch found".split(), m)
    base = single_meteor_score("heart is enlarged".split(), "heart is small".split(), m)
    assert (syn > base) == (matcher_files != "none")
    plain = _Matchers(None, None)
    assert (para > single_meteor_score("there is no acute disease".split(),
                                       "there is zilch found".split(), plain)) == \
        (matcher_files == "synonyms+paraphrase")


def test_spice_matches_jax(matcher_files):
    """SPICE's tuples and scores against the JAX package, on the report
    fixtures and random pairs, with and without the synonym table."""
    from vilmedic_torch.scorers.nlg.spice import Spice as TSpice
    from vilmedic_torch.scorers.nlg.spice import extract_tuples as textract
    from vilmedic_tpu.scorers.nlg.spice import Spice as JSpice
    from vilmedic_tpu.scorers.nlg.spice import extract_tuples as jextract

    texts = REFS + HYPS + ["no edema or effusion . small left pleural effusion in the lung base",
                           "without pneumothorax ; mild enlarged heart with big effusions"]
    assert [textract(t) for t in texts] == [jextract(t) for t in texts]
    for refs, hyps in CASES + [(texts[::-1], texts)]:
        (g, g_each), (w, w_each) = TSpice()(refs, hyps), JSpice()(refs, hyps)
        np.testing.assert_allclose(g_each, w_each, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_meteor_is_an_scst_reward():
    from vilmedic_torch.scorers.nlg.meteor import Meteor as TMeteor
    from vilmedic_torch.scorers.scores import REWARD_COMPLIANT

    assert REWARD_COMPLIANT["meteor"] == (TMeteor, 1)


# ---------------------------------------------------------------- the metrics CLI

@pytest.mark.parametrize("metrics", [["BLEU", "ROUGEL", "METEOR", "CIDERD"],
                                     ["ROUGE1", "ROUGE2", "SPICE", "BLEU"]])
def test_metrics_cli_matches_jax(metrics, tmp_path, capsys, monkeypatch):
    """``python -m vilmedic_torch.bin.vilmedic_metrics`` prints the same JSON
    as ``bin_tpu/vilmedic_metrics.py`` on the same files (blank lines
    dropped), every score within 1e-12."""
    import importlib.util
    import pathlib

    from vilmedic_torch.bin.vilmedic_metrics import main as tmain
    from vilmedic_tpu.scorers.nlg import meteor as jmeteor

    monkeypatch.delenv("METEOR_SYNONYMS", raising=False)
    monkeypatch.delenv("METEOR_PARAPHRASE", raising=False)
    monkeypatch.setattr(jmeteor._Matchers, "_instance", None)
    refs, hyps = _corpus(4, n=30)
    (tmp_path / "h.txt").write_text("\n".join(hyps[:15] + [""] + hyps[15:]) + "\n")
    (tmp_path / "r.txt").write_text("\n".join(refs) + "\n\n")
    argv = ["--hyps", str(tmp_path / "h.txt"), "--refs", str(tmp_path / "r.txt"), "--metrics",
            *metrics]
    script = pathlib.Path(__file__).resolve().parents[1] / "bin_tpu" / "vilmedic_metrics.py"
    spec = importlib.util.spec_from_file_location("jax_vilmedic_metrics", script)
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    got = tmain(argv)
    tout = capsys.readouterr().out
    jcli.main(argv)
    jout = capsys.readouterr().out
    printed, want = json.loads(tout), json.loads(jout)
    assert printed == json.loads(json.dumps(got, default=str))
    assert sorted(printed) == sorted(want) == sorted(m.upper() for m in metrics)
    for k in want:
        np.testing.assert_allclose(printed[k], want[k], rtol=TOL, atol=TOL)
