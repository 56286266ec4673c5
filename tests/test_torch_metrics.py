"""The port's numpy metrics against the JAX package's scikit-learn ones.

``compute_metrics`` and ``tuning_metric`` for every task, within 1e-9, on
logits made with numpy from a seed; the cases include a label column with
no positives, all-negative predictions and tied scores.  The numpy copies of
``f1_score``, ``average_precision_score`` and ``accuracy_score`` are also
held against scikit-learn itself for every average the tasks use.
"""

import numpy as np
import pytest
from sklearn import metrics as skm

from bpx.train import metrics as jmetrics

from bpx_torch.train import metrics

# scikit-learn warns about a label column with no positives, a case here
pytestmark = pytest.mark.filterwarnings("ignore:No positive class found")
TOL = dict(rtol=0, atol=1e-9)
N_CLASSES = {"moviescope": 13, "mmimdb": 23, "counseling": 2,
             "cmu-mosei": 6, "iemocap": 8, "synthetic": 5}
CASES = ["seeded", "empty_column", "all_negative", "ties"]


def _multilabel_case(case, n_classes, seed=0):
    rng = np.random.RandomState(seed)
    n = 37
    logits = (rng.randn(n, n_classes) * 2).astype(np.float32)
    targets = (rng.rand(n, n_classes) > 0.6).astype(np.float32)
    if case == "empty_column":
        targets[:, 1] = 0
        targets[3] = 0                   # a sample with no label either
    elif case == "all_negative":
        logits = -np.abs(logits) - 0.1
    elif case == "ties":
        logits = np.round(logits).astype(np.float32)   # few distinct scores
        targets[:, 0] = 0
    return logits, targets


def _assert_metrics_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("task", sorted(N_CLASSES))
def test_multilabel_metrics_match_bpx(task, case):
    logits, targets = _multilabel_case(case, N_CLASSES[task])
    losses = np.array([0.5, 0.7, 0.2])
    weights = np.array([8, 8, 3])
    got = metrics.compute_metrics(task, "multilabel", logits, targets,
                                  losses, weights)
    want = jmetrics.compute_metrics(task, "multilabel", logits, targets,
                                    losses, weights)
    _assert_metrics_equal(got, want)
    assert metrics.tuning_metric(task, "multilabel", got) == pytest.approx(
        jmetrics.tuning_metric(task, "multilabel", want), abs=1e-9)


@pytest.mark.parametrize("case", ["seeded", "constant", "zeros"])
def test_mosi_regression_metrics_match_bpx(case):
    rng = np.random.RandomState(3)
    logits = rng.randn(41, 1).astype(np.float32)
    targets = np.round(rng.uniform(-3, 3, 41), 1).astype(np.float32)
    if case == "constant":            # one predicted class: the swapped
        logits[:] = 2.0               # f1 arguments matter here
    elif case == "zeros":
        targets[::3] = 0
    got = metrics.compute_metrics("cmu-mosi", "classification", logits,
                                  targets, np.array([1.25]))
    want = jmetrics.compute_metrics("cmu-mosi", "classification", logits,
                                    targets, np.array([1.25]))
    _assert_metrics_equal(got, want)
    assert metrics.tuning_metric("cmu-mosi", "classification", got) == \
        got["mae"]


@pytest.mark.parametrize("average", ["macro", "micro", "weighted", "samples",
                                     None])
@pytest.mark.parametrize("case", CASES)
def test_f1_score_matches_sklearn(case, average):
    logits, targets = _multilabel_case(case, 7, seed=1)
    y, p = targets.astype(np.int64), logits > 0
    np.testing.assert_allclose(
        metrics.f1_score(y, p, average=average, zero_division=0),
        skm.f1_score(y, p, average=average, zero_division=0), **TOL)


@pytest.mark.parametrize("average", ["macro", "micro", "samples", None])
@pytest.mark.parametrize("case", CASES)
def test_average_precision_matches_sklearn(case, average):
    logits, targets = _multilabel_case(case, 7, seed=2)
    raw = 1.0 / (1.0 + np.exp(-logits))
    y = targets.astype(np.int64)
    np.testing.assert_allclose(
        metrics.average_precision_score(y, raw, average=average),
        skm.average_precision_score(y, raw, average=average), **TOL)


def test_binary_f1_and_accuracy_match_sklearn():
    rng = np.random.RandomState(4)
    a, b = rng.rand(30) > 0.4, rng.rand(30) > 0.7
    for y, p in ((a, b), (b, a), (a, np.ones(30, bool)),
                 (np.zeros(30, bool), b)):
        np.testing.assert_allclose(
            metrics.f1_score(y, p, average="weighted", zero_division=0),
            skm.f1_score(y, p, average="weighted", zero_division=0), **TOL)
        assert metrics.accuracy_score(y, p) == skm.accuracy_score(y, p)
    y2 = (rng.rand(20, 3) > 0.5).astype(np.int64)
    p2 = y2.copy()
    p2[::4, 1] ^= 1
    assert metrics.accuracy_score(y2, p2) == skm.accuracy_score(y2, p2)
