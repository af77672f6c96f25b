"""The port's classification metrics (numpy, ``scorers/classification.py``)
against the JAX package's ``compute_scores``, which calls scikit-learn:
``accuracy`` and ``auroc`` to 1e-12 and the ``f1-score`` report character
for character, on multi-class logits, tied logits (argmax and the ROC
curve's tied scores), labels that only the predictions hold, the ignore
label, multi-hot labels, and the inputs on which scikit-learn raises (both
packages then score the metric ``None``; the port's functions raise
``ValueError`` where scikit-learn does)."""

import logging

import numpy as np
import pytest
from sklearn.metrics import classification_report, roc_auc_score

from vilmedic_torch.scorers import classification as tcls
from vilmedic_torch.scorers.scores import compute_scores as tcompute
from vilmedic_tpu.scorers.scores import compute_scores as jcompute

TOL = 1e-12
METRICS = ["accuracy", "f1-score", "auroc"]


def _case(name):
    rng = np.random.default_rng(abs(hash(name)) % 2**32)
    if name == "multiclass":
        refs = np.concatenate([np.arange(7), rng.integers(0, 7, 57)]).astype(np.int32)
        return refs, rng.normal(size=(64, 7)).astype(np.float32)
    if name == "ties":  # integer logits: tied argmaxes and tied softmax scores
        refs = np.concatenate([np.arange(5), rng.integers(0, 5, 35)]).astype(np.int32)
        return refs, rng.integers(-2, 3, (40, 5)).astype(np.float32)
    if name == "many_classes":
        refs = np.concatenate([np.arange(23), rng.integers(0, 23, 105)]).astype(np.int32)
        return refs, (3 * rng.normal(size=(128, 23))).astype(np.float32)
    if name == "pred_only_label":  # class 3 is never a ref: its precision divides by 0
        refs = rng.integers(0, 3, 30).astype(np.int32)
        hyps = rng.normal(size=(30, 4)).astype(np.float32)
        hyps[:5, 3] += 10
        return refs, hyps
    if name == "ignore_label":  # every class among the refs, beside the ignore label
        refs = np.concatenate([np.arange(4), rng.integers(0, 4, 20)]).astype(np.int32)
        refs[[5, 9]] = -100
        return refs, rng.normal(size=(24, 4)).astype(np.float32)
    if name == "binary":  # two score columns: scikit-learn's AUROC raises
        return rng.integers(0, 2, 20).astype(np.int32), rng.normal(size=(20, 2)).astype(np.float32)
    if name == "missing_class":  # a class without refs: AUROC raises
        return rng.integers(0, 3, 20).astype(np.int32), rng.normal(size=(20, 4)).astype(np.float32)
    if name == "multi_hot":  # the F1 report raises; AUROC averages columns
        refs = (rng.random((32, 4)) < 0.4).astype(np.float32)
        refs[0], refs[1] = 1.0, 0.0
        return refs, rng.normal(size=(32, 4)).astype(np.float32)
    raise KeyError(name)


CASES = ["multiclass", "ties", "many_classes", "pred_only_label", "ignore_label", "binary",
         "missing_class", "multi_hot"]


def _scores(compute, refs, hyps):
    return compute(METRICS, refs, hyps, "validate", 0, None, 0,
                   logging.getLogger("class-metrics-test"), dump=False)


@pytest.mark.parametrize("case", CASES)
def test_compute_scores_match_jax(case):
    refs, hyps = _case(case)
    got, want = _scores(tcompute, refs, hyps), _scores(jcompute, refs, hyps)
    assert sorted(got) == sorted(want) == sorted(METRICS)
    for key in ("accuracy", "auroc"):
        if want[key] is None:
            assert got[key] is None, (key, got[key])
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=TOL)
    assert got["f1-score"] == want["f1-score"]
    # scikit-learn raises: two score columns for binary refs; a score column
    # without refs (a class only the predictions hold, or the ignore label
    # counted as a class); multi-hot refs in the report (and accuracy's
    # comparison of (N, C) refs with (N,) predictions)
    expect_none = {"binary": ["auroc"], "missing_class": ["auroc"],
                   "pred_only_label": ["auroc"], "ignore_label": ["auroc"],
                   "multi_hot": ["accuracy", "f1-score"]}
    assert [k for k in METRICS if got[k] is None] == expect_none.get(case, [])


@pytest.mark.parametrize("case", ["binary", "missing_class", "multi_hot"])
def test_raises_where_sklearn_raises(case):
    refs, hyps = _case(case)
    probs = tcls.softmax(hyps)
    if case == "multi_hot":
        with pytest.raises(ValueError, match="mix of"):
            classification_report(refs, np.argmax(hyps, -1))
        with pytest.raises(ValueError, match="mix of"):
            tcls.classification_report(refs, np.argmax(hyps, -1))
        return
    with pytest.raises(ValueError):
        roc_auc_score(refs, probs, multi_class="ovr")
    with pytest.raises(ValueError):
        tcls.roc_auc_ovr(refs, probs)


def test_tied_scores_follow_sklearn():
    """A binary ROC curve over heavily tied scores (each tie one step of the
    curve) and a column whose refs hold one class (NaN, as scikit-learn
    scores it)."""
    rng = np.random.default_rng(5)
    y = rng.integers(0, 2, 200)
    s = rng.integers(0, 4, 200).astype(np.float32) / 4
    np.testing.assert_allclose(tcls.binary_roc_auc(y, s), roc_auc_score(y, s), rtol=TOL, atol=TOL)
    assert np.isnan(tcls.binary_roc_auc(np.ones(5), np.arange(5.0)))


def test_softmax_matches_scipy():
    from scipy.special import softmax

    x = np.random.default_rng(0).normal(size=(6, 9)).astype(np.float32) * 20
    np.testing.assert_array_equal(tcls.softmax(x), softmax(x, axis=-1))
