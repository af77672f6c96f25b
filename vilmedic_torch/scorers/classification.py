"""Classification metrics in numpy: ``accuracy``, ``f1-score`` and ``auroc``
(the JAX package's ``compute_scores`` computes them with scikit-learn,
which the port does not import).

- :func:`accuracy`: ``round(mean(refs == argmax(hyps)) * 100, 2)``;
- :func:`classification_report`: the text of scikit-learn's
  ``classification_report(refs, preds)`` (default arguments), character for
  character: per-label precision, recall, F1 and support over the sorted
  union of the labels, then the accuracy, macro and weighted averages, a
  division by zero scored 0; the supports print as floats (``2.0``) when no
  prediction equals its reference, as scikit-learn's do;
- :func:`roc_auc_ovr`: ``roc_auc_score(refs, scores, multi_class="ovr")``,
  the macro one-vs-rest average of binary ROC AUCs, each over the curve's
  distinct thresholds (tied scores form one step) by the trapezoidal rule;
  multi-hot refs average their columns the same way. It raises where
  scikit-learn raises (binary refs with two score columns, a class count
  that differs from the score columns, scores that are not probabilities,
  an unsupported target type) and, as scikit-learn does, scores a column
  whose refs hold one class NaN;
- :func:`multilabel_report`: ``classification_report(refs, preds,
  target_names=names, output_dict=True, zero_division=0)`` over multi-hot
  (N, L) labels (CheXbert's metric): per label precision, recall, F1 and
  support, then the micro, macro, weighted (by support; unweighted when
  every support is 0) and samples averages, every value a float.
"""

from __future__ import annotations

from typing import List

import numpy as np

_trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2 names it trapz


def softmax(x, axis: int = -1) -> np.ndarray:
    """``scipy.special.softmax``: exp of the max-shifted values over their sum."""
    x = np.asarray(x)
    e = np.exp(x - np.max(x, axis=axis, keepdims=True))
    return e / np.sum(e, axis=axis, keepdims=True)


def accuracy(refs, hyps) -> float:
    return round(float(np.mean(np.asarray(refs) == np.argmax(hyps, axis=-1))) * 100, 2)


def type_of_target(y) -> str:
    """scikit-learn's target type of a numeric array: ``binary``,
    ``multiclass``, ``multilabel-indicator``, ``continuous`` or a
    ``-multioutput`` kind."""
    y = np.asarray(y)
    if y.ndim > 2 or y.ndim == 0:
        return "unknown"
    if y.ndim == 2 and y.shape[1] > 1:
        if np.isin(y, (0, 1)).all():
            return "multilabel-indicator"
        suffix = "-multioutput"
    else:
        suffix = ""
    if y.dtype.kind == "f" and np.any(y != y.astype(int)):
        return "continuous" + suffix
    if suffix or np.unique(y).size > 2:
        return "multiclass" + suffix
    return "binary"


def _targets(refs, preds):
    """scikit-learn's ``_check_targets`` for 1-D labels: the common type
    and the sorted union of the labels."""
    types = {type_of_target(refs), type_of_target(preds)}
    if types == {"binary", "multiclass"}:
        types = {"multiclass"}
    if len(types) > 1:
        a, b = type_of_target(refs), type_of_target(preds)
        raise ValueError(f"Classification metrics can't handle a mix of {a} and {b} targets")
    (kind,) = types
    if kind not in ("binary", "multiclass"):
        raise ValueError(f"{kind} is not supported")
    labels = np.union1d(np.ravel(refs), np.ravel(preds))
    if kind == "binary" and labels.size > 2:
        kind = "multiclass"
    return kind, labels


def _divide(num, den) -> np.ndarray:
    num, den = np.asarray(num, np.float64), np.asarray(den, np.float64)
    out = num / np.where(den == 0, 1.0, den)
    return np.where(den == 0, 0.0, out)


def _prf(refs, preds, labels, average=None):
    refs, preds = np.ravel(refs), np.ravel(preds)
    tp = np.array([np.sum((refs == c) & (preds == c)) for c in labels])
    pred_sum = np.array([np.sum(preds == c) for c in labels])
    true_sum = np.array([np.sum(refs == c) for c in labels])
    if average == "micro":
        tp, pred_sum, true_sum = tp.sum(keepdims=True), pred_sum.sum(keepdims=True), \
            true_sum.sum(keepdims=True)
    if not tp.any():
        # scikit-learn's multilabel_confusion_matrix starts from float zeros
        # when no prediction equals its reference, so the supports are floats
        true_sum = true_sum.astype(np.float64)
    precision = _divide(tp, pred_sum)
    recall = _divide(tp, true_sum)
    f1 = _divide(2.0 * tp, true_sum.astype(np.float64) + pred_sum)
    if average is None:
        return precision, recall, f1, true_sum
    weights = true_sum if average == "weighted" else None
    return tuple(float(np.mean(x) if weights is None else np.sum(x * weights) / np.sum(weights))
                 for x in (precision, recall, f1)) + (None,)


def classification_report(refs, preds, digits: int = 2) -> str:
    """The text report of scikit-learn's ``classification_report``."""
    _, labels = _targets(refs, preds)
    names: List[str] = ["%s" % lab for lab in labels]
    headers = ["precision", "recall", "f1-score", "support"]
    p, r, f1, s = _prf(refs, preds, labels)
    width = max(max(len(n) for n in names), len("weighted avg"), digits)
    report = ("{:>{width}s} " + " {:>9}" * len(headers)).format("", *headers, width=width)
    report += "\n\n"
    row_fmt = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    for row in zip(names, p, r, f1, s):
        report += row_fmt.format(*row, width=width, digits=digits)
    report += "\n"
    support = np.sum(s)
    _, _, acc, _ = _prf(refs, preds, labels, "micro")
    report += ("{:>{width}s} " + " {:>9.{digits}}" * 2 + " {:>9.{digits}f}" + " {:>9}\n").format(
        "accuracy", "", "", acc, support, width=width, digits=digits)
    for average in ("macro", "weighted"):
        avg_p, avg_r, avg_f1, _ = _prf(refs, preds, labels, average)
        report += row_fmt.format(f"{average} avg", avg_p, avg_r, avg_f1, support, width=width,
                                 digits=digits)
    return report


def binary_roc_auc(y_true, y_score) -> float:
    """Area under the ROC curve of 0/1 ``y_true`` against ``y_score``: the
    curve's points at the distinct scores, descending, the collinear ones
    dropped, from (0, 0); NaN when ``y_true`` holds one class."""
    y_true = np.ravel(y_true)
    y_score = np.asarray(y_score)
    if np.unique(y_true).size != 2:
        return float("nan")
    if y_score.ndim == 2 and y_score.shape[1] == 1:
        y_score = y_score[:, 0]
    if y_score.ndim != 1:
        raise ValueError(f"y should be a 1d array, got an array of shape {y_score.shape} instead.")
    if not np.all(np.isfinite(y_score)):
        raise ValueError("Input contains NaN or infinity.")
    order = np.argsort(-y_score, kind="stable")
    y_score, y_true = y_score[order], (y_true[order] == 1).astype(np.float64)
    thresholds = np.concatenate([np.nonzero(np.diff(y_score))[0], [y_true.size - 1]])
    tps = np.cumsum(y_true, dtype=np.float64)[thresholds]
    fps = 1 + thresholds.astype(np.float64) - tps
    if fps.shape[0] > 2:
        keep = np.where(np.concatenate(
            [[True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), [True]]))[0]
        fps, tps = fps[keep], tps[keep]
    tps = np.concatenate([[0.0], tps])
    fps = np.concatenate([[0.0], fps])
    fpr, tpr = fps / fps[-1], tps / tps[-1]
    return float(_trapezoid(tpr, fpr))


def roc_auc_ovr(refs, scores) -> float:
    """``roc_auc_score(refs, scores, multi_class="ovr")`` (macro average)."""
    refs, scores = np.asarray(refs), np.asarray(scores)
    kind = type_of_target(refs)
    if kind == "multiclass" or (kind == "binary" and scores.ndim == 2 and scores.shape[1] > 2):
        if scores.ndim != 2:
            raise ValueError("`y_score` needs to be of shape `(n_samples, n_classes)`, since "
                             f"`y_true` contains multiple classes. Got "
                             f"`y_score.shape={scores.shape}`.")
        if not np.allclose(1, scores.sum(axis=1)):
            raise ValueError("Target scores need to be probabilities for multiclass roc_auc, "
                             "i.e. they should sum up to 1.0 over classes")
        classes = np.unique(refs)
        if len(classes) != scores.shape[1]:
            raise ValueError("Number of classes in y_true not equal to the number of columns "
                             "in 'y_score'")
        refs = (refs[:, None] == classes[None, :]).astype(int)
    elif kind == "binary":
        return binary_roc_auc(refs == np.unique(refs)[-1], scores)
    elif kind != "multilabel-indicator":
        raise ValueError(f"{kind} format is not supported")
    per_class = [binary_roc_auc(refs[:, c], scores[:, c]) for c in range(scores.shape[1])]
    return float(np.mean(np.asarray(per_class, np.float64)))


def multilabel_report(refs, preds, target_names) -> dict:
    """scikit-learn's multilabel ``classification_report(output_dict=True,
    zero_division=0)`` (module doc)."""
    refs, preds = np.asarray(refs), np.asarray(preds)
    if refs.ndim != 2 or refs.shape != preds.shape or not np.isin(refs, (0, 1)).all() \
            or not np.isin(preds, (0, 1)).all():
        raise ValueError("multilabel_report takes two (N, L) 0/1 arrays of one shape")
    if len(target_names) != refs.shape[1]:
        raise ValueError(f"Number of classes, {refs.shape[1]}, does not match size of "
                         f"target_names, {len(target_names)}. Try specifying the labels "
                         "parameter")
    refs, preds = refs.astype(bool), preds.astype(bool)

    def prf(tp, pred_sum, true_sum):
        return (_divide(tp, pred_sum), _divide(tp, true_sum),
                _divide(2.0 * tp, true_sum.astype(np.float64) + pred_sum))

    tp, pred_sum, true_sum = ((refs & preds).sum(0), preds.sum(0), refs.sum(0))
    p, r, f1 = prf(tp, pred_sum, true_sum)
    headers = ("precision", "recall", "f1-score", "support")
    report = {name: dict(zip(headers, map(float, row)))
              for name, *row in zip(target_names, p, r, f1, true_sum)}
    support = float(np.sum(true_sum))
    micro = prf(tp.sum(keepdims=True), pred_sum.sum(keepdims=True), true_sum.sum(keepdims=True))
    report["micro avg"] = dict(zip(headers, [float(x[0]) for x in micro] + [support]))
    report["macro avg"] = dict(zip(headers, [float(np.mean(x)) for x in (p, r, f1)] + [support]))
    weights = true_sum if true_sum.sum() else None
    report["weighted avg"] = dict(zip(headers, [float(np.average(x, weights=weights))
                                                for x in (p, r, f1)] + [support]))
    samples = prf((refs & preds).sum(1), preds.sum(1), refs.sum(1))
    report["samples avg"] = dict(zip(headers, [float(np.mean(x)) for x in samples] + [support]))
    return report
