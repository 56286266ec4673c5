"""Per-task evaluation metrics (counterpart: ``bpx/train/metrics.py``).

Host-side numpy, computed from stacked logits, with the same keys per task
as the JAX package, the reference's mislabelled ones included (mmimdb's
"micro_f1" is AP-micro etc.; honestly named duplicates beside them).

The JAX package computes them with scikit-learn, which the port does not
need: :func:`f1_score`, :func:`average_precision_score` and
:func:`accuracy_score` below are numpy copies of scikit-learn's, for the
inputs these tasks give them (0/1 indicator matrices, or 1-D binary
vectors) and with the same edge cases: ``zero_division=0``; a threshold per
distinct score (tied scores share one); a label column with no positives,
whose precision-recall curve has recall 1 at every threshold.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


# ---------------------------------------------------------------------------
# scikit-learn's classification metrics, in numpy
# ---------------------------------------------------------------------------

def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """``num / den`` with 0 where ``den`` is 0 (``zero_division=0``)."""
    num = np.asarray(num, dtype=np.float64)
    den = np.asarray(den, dtype=np.float64)
    out = np.zeros(np.broadcast(num, den).shape)
    np.divide(num, den, out=out, where=den != 0)
    return out


def f1_score(y_true, y_pred, average: Optional[str] = "macro",
             zero_division: float = 0):
    """F1 of 0/1 indicator matrices (multilabel: one column per label) or
    of 1-D binary vectors (one label per value present in either).
    ``average``: "macro", "micro", "weighted" (by each label's support in
    ``y_true``), "samples" (multilabel only) or None (per label)."""
    if zero_division != 0:
        raise NotImplementedError("only zero_division=0 is copied")
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if y_true.ndim == 1:
        labels = np.union1d(y_true, y_pred)
        yt = y_true[:, None] == labels[None, :]
        yp = y_pred[:, None] == labels[None, :]
    else:
        yt, yp = y_true.astype(bool), y_pred.astype(bool)
    axis = 1 if average == "samples" else 0
    tp = (yt & yp).sum(axis)
    true_sum = yt.sum(axis)
    pred_sum = yp.sum(axis)
    if average == "micro":
        tp, true_sum, pred_sum = tp.sum(), true_sum.sum(), pred_sum.sum()
    f = _divide(2.0 * tp, true_sum + pred_sum)
    if average is None:
        return f
    if average == "weighted" and true_sum.sum() > 0:
        return float(np.average(f, weights=true_sum))
    return float(np.mean(f))


def accuracy_score(y_true, y_pred) -> float:
    """Share of exact matches: of whole rows for indicator matrices
    (subset accuracy), of values for 1-D vectors."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    same = y_true == y_pred
    if same.ndim > 1:
        same = same.all(axis=1)
    return float(np.mean(same))


def _binary_average_precision(y_true: np.ndarray,
                              y_score: np.ndarray) -> float:
    """Area under the step precision-recall curve of one binary column
    (scikit-learn's uninterpolated average precision)."""
    y_true = (np.asarray(y_true) == 1).astype(np.float64)
    order = np.argsort(y_score, kind="stable")[::-1]
    y_score = np.asarray(y_score)[order]
    y_true = y_true[order]
    # one threshold per distinct score: the last index of each tie run
    distinct = np.where(np.diff(y_score))[0]
    idx = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true)[idx]
    fps = 1 + idx - tps
    precision = _divide(tps, tps + fps)
    if tps[-1] == 0:
        recall = np.ones_like(tps)
    else:
        recall = tps / tps[-1]
    precision = np.r_[precision[::-1], 1.0]
    recall = np.r_[recall[::-1], 0.0]
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def average_precision_score(y_true, y_score,
                            average: Optional[str] = "macro"):
    """Average precision of a 0/1 indicator matrix: per label averaged
    ("macro"), over the flattened matrix ("micro"), per sample averaged
    ("samples"), or per label (None)."""
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score)
    if average == "micro":
        return _binary_average_precision(y_true.ravel(), y_score.ravel())
    if y_true.ndim == 1:
        y_true, y_score = y_true[:, None], y_score[:, None]
    if average == "samples":
        y_true, y_score = y_true.T, y_score.T
    score = np.array([_binary_average_precision(y_true[:, c], y_score[:, c])
                      for c in range(y_true.shape[1])])
    if average is None:
        return score
    return float(np.mean(score))


# ---------------------------------------------------------------------------
# the tasks' metrics
# ---------------------------------------------------------------------------

def weighted_acc(preds: np.ndarray, truths: np.ndarray):
    """Class-balanced accuracy + F1 for one binary label."""
    preds = np.asarray(preds).astype(np.int64)
    truths = np.asarray(truths).astype(np.int64)
    n = int((truths == 0).sum())
    p = int((truths == 1).sum())
    tn = int(((truths == 0) & (preds == 0)).sum())
    tp = int(((truths == 1) & (preds == 1)).sum())
    if p == 0 or n == 0:
        w_acc = float("nan")
    else:
        w_acc = (tp * n / p + tn) / (2 * n)
    fp, fn = n - tn, p - tp
    recall = tp / (tp + fn + 1e-8)
    precision = tp / (tp + fp + 1e-8)
    f1 = 2 * recall * precision / (recall + precision + 1e-8)
    return w_acc, f1


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def compute_metrics(task: str, task_type: str,
                    logits: np.ndarray, targets: np.ndarray,
                    losses: Optional[np.ndarray] = None,
                    loss_weights: Optional[np.ndarray] = None
                    ) -> Dict[str, float]:
    """Stacked (N, C) logits + targets -> metric dict.

    ``loss_weights`` (per-batch valid-sample counts) excludes wrap-padded
    rows of the final partial batch from the reported mean loss.
    """
    metrics: Dict[str, float] = {}
    if losses is not None:
        metrics["loss"] = float(np.average(losses, weights=loss_weights))

    if task_type == "multilabel":
        raw = _sigmoid(logits)
        preds = raw > 0.5
        tgts = targets.astype(np.int64)
        if task == "moviescope":
            metrics["macro_f1"] = f1_score(tgts, preds, average="macro",
                                           zero_division=0)
            metrics["micro_f1"] = f1_score(tgts, preds, average="micro",
                                           zero_division=0)
            metrics["auc_pr_macro"] = average_precision_score(
                tgts, raw, average="macro")
            metrics["auc_pr_micro"] = average_precision_score(
                tgts, raw, average="micro")
            metrics["auc_pr_samples"] = average_precision_score(
                tgts, raw, average="samples")
        elif task == "mmimdb":
            # the reference's keys with the quantities it computes under
            # them, plus honest names
            metrics["macro_f1"] = f1_score(tgts, preds, average="macro",
                                           zero_division=0)
            metrics["micro_f1"] = average_precision_score(tgts, raw,
                                                          average="micro")
            metrics["auc_pr_macro"] = f1_score(tgts, preds,
                                               average="weighted",
                                               zero_division=0)
            metrics["auc_pr_micro"] = f1_score(tgts, preds, average="micro",
                                               zero_division=0)
            metrics["auc_pr_samples"] = f1_score(tgts, preds,
                                                 average="samples",
                                                 zero_division=0)
            # honest duplicates
            metrics["true_micro_f1"] = metrics["auc_pr_micro"]
            metrics["true_auc_pr_micro"] = metrics["micro_f1"]
            metrics["weighted_f1"] = metrics["auc_pr_macro"]
        elif task == "counseling":
            metrics["acc"] = accuracy_score(tgts, preds)
            metrics["auc_pr_micro"] = average_precision_score(
                tgts, raw, average="micro")
            f1s = [weighted_acc(preds[:, i], tgts[:, i])[1]
                   for i in range(2)]
            metrics["f1_low"] = f1s[1]
            metrics["f1_high"] = f1s[0]
        elif task == "cmu-mosei":
            n_emo = tgts.shape[1]
            accs, f1s = [], []
            for i in range(n_emo):
                wacc, f1 = weighted_acc(preds[:, i], tgts[:, i])
                accs.append(wacc)
                f1s.append(f1)
            for i in range(n_emo):
                metrics[f"f1_emo{i + 1}"] = f1s[i]
                metrics[f"wacc_emo{i + 1}"] = accs[i]
            metrics["f1_emos"] = float(np.nanmean(f1s))
            metrics["wacc_emos"] = average_precision_score(
                tgts, raw, average="micro")
            metrics["auc_pr_micro"] = float(np.nanmean(accs))
        else:   # iemocap and other multilabel tasks: the moviescope set
            metrics["macro_f1"] = f1_score(tgts, preds, average="macro",
                                           zero_division=0)
            metrics["micro_f1"] = f1_score(tgts, preds, average="micro",
                                           zero_division=0)
            metrics["auc_pr_macro"] = average_precision_score(
                tgts, raw, average="macro")
            metrics["auc_pr_micro"] = average_precision_score(
                tgts, raw, average="micro")
    else:
        # cmu-mosi regression: sigmoid preds are mapped to [-3, 3] via *6-3
        raw = _sigmoid(logits[:, 0])
        tgts = targets.astype(np.float64).reshape(-1)
        predict = raw * 6.0 - 3.0
        metrics["mae"] = float(np.mean(np.abs(predict - tgts)))
        if np.std(predict) > 0 and np.std(tgts) > 0:
            metrics["corr"] = float(np.corrcoef(predict, tgts)[0][1])
        else:
            metrics["corr"] = 0.0
        metrics["accuracy_7"] = float(
            np.mean(np.round(predict) == np.round(tgts)))
        non_zeros = tgts != 0
        if non_zeros.any():
            bt = tgts[non_zeros] > 0
            bp = predict[non_zeros] > 0
            # the reference's argument order: predictions as y_true
            metrics["weighted_f1"] = f1_score(bp, bt, average="weighted",
                                              zero_division=0)
            metrics["accuracy_2"] = accuracy_score(bt, bp)
        metrics["weight_f1"] = metrics["mae"]   # tuning metric alias
    return metrics


def tuning_metric(task: str, task_type: str,
                  metrics: Dict[str, float]) -> float:
    """The epoch tuning metric."""
    if task_type == "multilabel":
        return metrics["auc_pr_micro"]
    return metrics["weight_f1"]


def log_metrics(prefix: str, metrics: Dict[str, float], task: str,
                logger) -> None:
    """One formatted metric line."""
    ordered = sorted(metrics.items())
    line = " | ".join(f"{k}: {v:.4f}" for k, v in ordered
                      if isinstance(v, (int, float)) and np.isfinite(v))
    logger.info("%s — %s", prefix, line)
