"""Growth as a product with closed-form binomial weight rows.

The port's copy of panacus_tpu/ops/growth_device.py: the large-n growth
route of hist.Hist.calc_growth (GROWTH_MATMUL_MIN_N, growth_matmul) and the
full weight matrices of every (coverage, quorum) pair
(growth_weight_matrix, growth_weight_stack), which calc_growth does not
use, as in panacus_tpu. numpy and scipy only.

growth[m] = sum_i hist[i] * W[m-1, i], with
  union:  W[m-1,i] = [i>=c] * (1 - C(n-i,m)/C(n,m))
  core:   W[m-1,i] = [i>=max(m,c)] * C(i,m)/C(n,m)
  quorum: W[m-1,i] = sum_{j=max(ceil(m q),c)}^{m} C(i,j) C(n-i,m-j) / C(n,m)
(the closed form behind the reference's recurrences,
src/graph_broker/hist.rs:89-187). The recurrences of hist.py stay the
bit-parity reference; the products agree with them to ~1e-9 relative.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
from scipy.special import gammaln

from ..utils import Threshold


def _lg_choose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """log C(a, b); -inf outside 0 <= b <= a."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    with np.errstate(invalid="ignore"):
        v = gammaln(a + 1.0) - gammaln(b + 1.0) - gammaln(a - b + 1.0)
    return np.where((b < 0) | (b > a), -np.inf, v)


def growth_weight_matrix(
    n: int, t_coverage: Threshold, t_quorum: Threshold
) -> np.ndarray:
    """[n, n+1] f64 weight matrix for one (coverage, quorum) pair."""
    if n <= 0:
        return np.zeros((0, 1))
    quorum_abs = max(1, t_quorum.to_absolute(n))
    mm = np.arange(1, n + 1, dtype=np.float64).reshape(-1, 1)  # m axis
    ii = np.arange(0, n + 1, dtype=np.float64).reshape(1, -1)  # i axis
    lg_nm = _lg_choose(np.full_like(mm, n), mm)  # log C(n, m)

    if quorum_abs == 1:  # union
        c = max(1, t_coverage.to_absolute(n))
        with np.errstate(invalid="ignore"):
            p_absent = np.exp(_lg_choose(n - ii, mm) - lg_nm)
        p_absent = np.nan_to_num(p_absent, nan=0.0, posinf=0.0)
        return (1.0 - p_absent) * (ii >= c)

    if quorum_abs >= n:  # core
        c = max(1, t_coverage.to_absolute(n + 1))
        with np.errstate(invalid="ignore"):
            p_all = np.exp(_lg_choose(ii, mm) - lg_nm)
        p_all = np.nan_to_num(p_all, nan=0.0, posinf=0.0)
        return p_all * (ii >= np.maximum(mm, c))

    # general quorum, with the reference's asymmetric coverage gating
    # (hist.rs:152-184): the full-containment term requires total coverage
    # i >= max(m, c); the partial terms require in-subset count j >= max(mq, c)
    c = max(1, t_coverage.to_absolute(n))
    q_rel = t_quorum.to_relative(n)
    W = np.zeros((n, n + 1), dtype=np.float64)
    i_ax = np.arange(0, n + 1, dtype=np.float64)
    for m in range(1, n + 1):
        j_lo = max(int(math.ceil(m * q_rel)), c)
        lgnm = _lg_choose(np.float64(n), np.float64(m))
        with np.errstate(invalid="ignore"):
            full = np.exp(_lg_choose(i_ax, np.float64(m)) - lgnm)
        acc = np.nan_to_num(full, nan=0.0, posinf=0.0) * (i_ax >= max(m, c))
        for j in range(j_lo, m):
            with np.errstate(invalid="ignore"):
                term = np.exp(
                    _lg_choose(i_ax, np.float64(j))
                    + _lg_choose(n - i_ax, np.float64(m - j))
                    - lgnm
                )
            acc += np.nan_to_num(term, nan=0.0, posinf=0.0)
        W[m - 1] = acc
    return W


def growth_weight_stack(
    n: int, coverages: List[Threshold], quorums: List[Threshold]
) -> np.ndarray:
    """[n_pairs, n, n+1] stacked weight matrices for a ThresholdContainer."""
    return np.stack(
        [growth_weight_matrix(n, c, q) for c, q in zip(coverages, quorums)]
    )

# hist.Hist.calc_growth routes union/core growths through the weight-row
# product from this group count up (the per-m recurrences are an O(n)
# Python loop).
GROWTH_MATMUL_MIN_N = 2048
_CHUNK_ROWS = 1 << 20  # elements per W chunk (bounds peak memory ~16 MB)


def growth_matmul(
    hist: np.ndarray, t_coverage: Threshold, t_quorum: Threshold
) -> "np.ndarray | None":
    """growth[m] for m in 1..n via chunked rows of the f64 weight matrix
    (union/core only). Returns None for a general quorum, which keeps the
    memoized recurrence. Agrees with the recurrence to ~1e-9 relative; the
    TSV writer floors cells."""
    n = len(hist) - 1
    if n <= 0:
        return np.zeros(0)
    quorum_abs = max(1, t_quorum.to_absolute(n))
    if 1 < quorum_abs < n:
        return None
    h = np.asarray(hist, dtype=np.float64)
    out = np.empty(n, dtype=np.float64)
    rows = max(1, _CHUNK_ROWS // (n + 1))
    # log-factorial table: lgC(a, b) = t[a] - t[b] - t[a-b]
    t = gammaln(np.arange(n + 1, dtype=np.float64) + 1.0)

    def lgC(a, b):
        """log C(a, b) for integer index arrays, -inf outside 0<=b<=a."""
        ok = (b >= 0) & (b <= a)
        a_c = np.where(ok, a, 0)
        b_c = np.where(ok, b, 0)
        return np.where(ok, t[a_c] - t[b_c] - t[a_c - b_c], -np.inf)

    ii = np.arange(0, n + 1, dtype=np.int64).reshape(1, -1)
    for m0 in range(1, n + 1, rows):
        m1 = min(m0 + rows, n + 1)
        mm = np.arange(m0, m1, dtype=np.int64).reshape(-1, 1)
        lg_nm = lgC(np.full_like(mm, n), mm)
        with np.errstate(invalid="ignore"):
            if quorum_abs == 1:  # union
                c = max(1, t_coverage.to_absolute(n))
                p_absent = np.exp(lgC(n - ii, mm) - lg_nm)
                W = (
                    1.0 - np.nan_to_num(p_absent, nan=0.0, posinf=0.0)
                ) * (ii >= c)
            else:  # core (reference's to_absolute(n+1) quirk, hist.rs:118)
                c = max(1, t_coverage.to_absolute(n + 1))
                p_all = np.exp(lgC(ii, mm) - lg_nm)
                W = np.nan_to_num(p_all, nan=0.0, posinf=0.0) * (
                    ii >= np.maximum(mm, c)
                )
        out[m0 - 1 : m1 - 1] = W @ h
    return out
