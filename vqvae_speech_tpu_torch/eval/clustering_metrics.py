"""Clustering agreement scores in numpy and scipy, without scikit-learn.

The JAX package scores alignments with ``sklearn.metrics``
(``eval/alignment_stats.py``); the GPU machine has no scikit-learn, so the
port computes the same three scores here, by scikit-learn 1.9's
definitions (``sklearn/metrics/cluster/_supervised.py`` and
``_expected_mutual_info_fast.pyx``):

* ``adjusted_rand_score``: the pair-confusion form with int64 pair counts,
  1.0 where no pair is split differently (empty input, full agreement);
* ``normalized_mutual_info_score`` and ``adjusted_mutual_info_score`` with
  ``average_method="arithmetic"``: 1.0 when both labelings hold one class
  (or none), AMI 0.0 when only one of them does, NMI 0.0 when the mutual
  information is 0; the expected mutual information of AMI is summed over
  the same terms as scikit-learn's, vectorised one contingency row at a
  time, with log-factorials read from one ``gammaln`` table.

The contingency is kept as its non-zero cells in row-major order, as
scikit-learn's sparse contingency gives them, so the sums run in the same
order.
"""
from math import log

import numpy as np
from scipy.special import gammaln

__all__ = ["adjusted_rand_score", "normalized_mutual_info_score",
           "adjusted_mutual_info_score", "clustering_scores"]

_EPS = np.finfo(np.float64).eps


class _Contingency:
    """The non-zero cells (row, col, count) of the classes x clusters
    table, row-major, with its row and column sums (int64)."""

    def __init__(self, labels_true, labels_pred):
        labels_true = np.asarray(labels_true)
        labels_pred = np.asarray(labels_pred)
        if labels_true.ndim != 1 or labels_pred.ndim != 1:
            raise ValueError("labels must be 1D")
        if labels_true.shape != labels_pred.shape:
            raise ValueError(f"labels of {labels_true.shape[0]} and "
                             f"{labels_pred.shape[0]} samples")
        self.n = int(labels_true.shape[0])
        _, rows = np.unique(labels_true, return_inverse=True)
        _, cols = np.unique(labels_pred, return_inverse=True)
        self.n_rows = int(rows.max()) + 1 if self.n else 0
        self.n_cols = int(cols.max()) + 1 if self.n else 0
        cells, counts = np.unique(
            rows.astype(np.int64) * max(self.n_cols, 1) + cols,
            return_counts=True)
        self.row = cells // max(self.n_cols, 1)
        self.col = cells % max(self.n_cols, 1)
        self.count = counts.astype(np.int64)
        self.row_sums = np.bincount(self.row, self.count,
                                    minlength=self.n_rows).astype(np.int64)
        self.col_sums = np.bincount(self.col, self.count,
                                    minlength=self.n_cols).astype(np.int64)


def _entropy(sizes: np.ndarray) -> float:
    """Entropy of a labeling from its class sizes (scikit-learn's
    ``_entropy``)."""
    if sizes.size == 0:
        return 1.0
    if sizes.size == 1:
        return 0.0
    pi = sizes.astype(np.float64)
    pi_sum = np.sum(pi)
    return float(-np.sum((pi / pi_sum) * (np.log(pi) - log(pi_sum))))


def _mutual_info(c: _Contingency) -> float:
    if c.n_rows == 1 or c.n_cols == 1:
        return 0.0
    nz_val = c.count
    contingency_sum = int(nz_val.sum())
    log_contingency_nm = np.log(nz_val)
    contingency_nm = nz_val / contingency_sum
    outer = c.row_sums[c.row] * c.col_sums[c.col]
    log_outer = (-np.log(outer) + log(int(c.row_sums.sum()))
                 + log(int(c.col_sums.sum())))
    mi = (contingency_nm * (log_contingency_nm - log(contingency_sum))
          + contingency_nm * log_outer)
    mi = np.where(np.abs(mi) < _EPS, 0.0, mi)
    return float(np.clip(mi.sum(), 0.0, None))


def _expected_mutual_info(c: _Contingency) -> float:
    """E[MI] under the hypergeometric model of random labelings with these
    class sizes: for each cell (i, j), the sum over n_ij from
    max(1, a_i + b_j - N) to min(a_i, b_j) of
    n_ij/N * log(N n_ij / (a_i b_j)) * P(n_ij)."""
    a, b, n = c.row_sums, c.col_sums, c.n
    if a.size == 1 or b.size == 1:
        return 0.0
    # log k! for k = 0..N, read by index: gammaln at the same arguments
    log_fact = gammaln(np.arange(n + 1, dtype=np.float64) + 1)
    log_n = np.log(n)
    log_a, log_b = np.log(a), np.log(b)
    emi = 0.0
    for i in range(a.size):
        start = np.maximum(1, a[i] - n + b)
        end = np.minimum(a[i], b) + 1
        lengths = np.maximum(end - start, 0)
        total = int(lengths.sum())
        if total == 0:
            continue
        j = np.repeat(np.arange(b.size), lengths)
        first = np.repeat(np.cumsum(lengths) - lengths, lengths)
        nij = np.arange(total) - first + start[j]
        term1 = nij / n
        term2 = (log_n + np.log(nij)) - log_a[i] - log_b[j]
        gln = (log_fact[a[i]] + log_fact[b[j]] + log_fact[n - a[i]]
               + log_fact[n - b[j]]
               - (log_fact[nij] + log_fact[n])
               - log_fact[a[i] - nij] - log_fact[b[j] - nij]
               - log_fact[n - a[i] - b[j] + nij])
        emi += float(np.sum(term1 * term2 * np.exp(gln)))
    return emi


def adjusted_rand_score(labels_true, labels_pred) -> float:
    c = _Contingency(labels_true, labels_pred)
    sum_squares = int((c.count ** 2).sum())
    tp = sum_squares - c.n
    fp = int((c.count * c.col_sums[c.col]).sum()) - sum_squares
    fn = int((c.count * c.row_sums[c.row]).sum()) - sum_squares
    tn = c.n ** 2 - fp - fn - sum_squares
    if fn == 0 and fp == 0:
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn)
                                        + (tp + fp) * (fp + tn))


def normalized_mutual_info_score(labels_true, labels_pred) -> float:
    c = _Contingency(labels_true, labels_pred)
    if c.n_rows == c.n_cols and c.n_rows in (0, 1):
        return 1.0
    mi = _mutual_info(c)
    if mi == 0:
        return 0.0
    normalizer = np.mean([_entropy(c.row_sums), _entropy(c.col_sums)])
    return float(mi / normalizer)


def adjusted_mutual_info_score(labels_true, labels_pred) -> float:
    c = _Contingency(labels_true, labels_pred)
    if c.n_rows == c.n_cols and c.n_rows in (0, 1):
        return 1.0
    if c.n_rows == 1 or c.n_cols == 1:
        return 0.0
    mi = _mutual_info(c)
    emi = _expected_mutual_info(c)
    normalizer = np.mean([_entropy(c.row_sums), _entropy(c.col_sums)])
    denominator = normalizer - emi
    if denominator < 0:
        denominator = min(denominator, -_EPS)
    else:
        denominator = max(denominator, _EPS)
    numerator = mi - emi
    if numerator < 0:
        numerator = min(numerator, -_EPS)
    else:
        numerator = max(numerator, _EPS)
    return float(numerator / denominator)


def clustering_scores(labels_true, labels_pred) -> dict:
    """The three scores under the names the alignment statistics save."""
    return {
        "adjusted_rand_score": adjusted_rand_score(labels_true, labels_pred),
        "adjusted_mutual_info_score":
            adjusted_mutual_info_score(labels_true, labels_pred),
        "normalized_mutual_info_score":
            normalized_mutual_info_score(labels_true, labels_pred),
    }
