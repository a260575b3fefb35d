"""The reference's counts: coverage hists by group and growth.

Hists are exact integers. Growth is the exact expectation
over the random m-subsets of the n groups, as a fraction of Python integers,
with the upstream tool's conventions (panacus hist.rs; its CLI's threshold
rules):

- quorum q (a share of the m groups drawn) and coverage c (an absolute
  count); a relative threshold t is ceil(t * n) absolute;
- quorum at most 1 group (absolute): union growth, an item of total coverage
  i >= c counts when one of the m groups holds it:
  tot - sum_{i=c}^{n-m} h[i] C(n-i, m) / C(n, m);
- quorum n or more: core growth, the item in all m groups, with c taken
  against n + 1: sum_{i >= max(m, c)} h[i] C(i, m) / C(n, m);
- otherwise, with mq = ceil(m q): the core part above, plus
  sum_{i=mq}^{n-1} h[i] sum_{j=max(mq, c)}^{min(m-1, i)} C(i, j) C(n-i, m-j) / C(n, m).

`dtype=np.float32` computes the same in float32: the control that a lower
precision than the configuration states has to fail.
"""

from __future__ import annotations

import functools
import math
from fractions import Fraction
from typing import Dict, List, Tuple

import numpy as np

from .gfa import Graph

COUNTS = ("node", "bp", "edge")


def coverage(g: Graph, groups: Dict[str, list], count: str) -> np.ndarray:
    """Groups holding each item: node coverage for node and bp, edge
    coverage for edge."""
    n_items = g.n_edges if count == "edge" else g.n_nodes
    cov = np.zeros(n_items, dtype=np.int64)
    mark = np.zeros(n_items, dtype=bool)
    for paths in groups.values():
        mark[:] = False
        for p in paths:
            mark[g.path_edges(p) if count == "edge" else p.nodes] = True
        cov += mark
    return cov


def hist(cov: np.ndarray, weights, n_groups: int, dtype=np.int64) -> np.ndarray:
    """h[i]: the summed weight (1 a node or an edge, bp for bp) of the items
    that i groups hold, i = 0..n_groups."""
    if dtype == np.int64:
        w = np.ones(len(cov), dtype=np.int64) if weights is None else weights
        order = np.argsort(cov, kind="stable")
        bounds = np.searchsorted(cov[order], np.arange(n_groups + 2))
        csum = np.concatenate(([0], np.cumsum(w[order])))
        return csum[bounds[1:]] - csum[bounds[:-1]]
    w = np.ones(len(cov), dtype=dtype) if weights is None else weights.astype(dtype)
    out = np.zeros(n_groups + 1, dtype=dtype)
    np.add.at(out, cov, w)
    return out


def _binom_table(n: int) -> List[List[int]]:
    return [[math.comb(i, j) for j in range(n + 1)] for i in range(n + 1)]


def to_absolute(t: Tuple[float, bool], n: int) -> int:
    value, relative = t
    return int(math.ceil(n * value)) if relative else int(value)


def to_relative(t: Tuple[float, bool], n: int) -> float:
    value, relative = t
    return value if relative else (value / n if n else 0.0)


@functools.lru_cache(maxsize=None)
def growth_terms(n: int, c_t, q_t) -> List[Tuple[List[int], int]]:
    """For m = 1..n: (N_i for i = 0..n, C(n, m)) with growth(m) =
    sum_i h[i] N_i / C(n, m) + base(m) as the module's docstring sets out;
    union growth has base tot and negative N_i."""
    C = _binom_table(n)
    quorum = max(1, to_absolute(q_t, n))
    out = []
    for m in range(1, n + 1):
        N = [0] * (n + 1)
        if quorum == 1:
            c = max(1, to_absolute(c_t, n))
            for i in range(c, n - m + 1):
                N[i] = -C[n - i][m]
        else:
            c = max(1, to_absolute(c_t, n + 1)) if quorum >= n else max(1, to_absolute(c_t, n))
            for i in range(max(m, c), n + 1):
                N[i] = C[i][m]
            if quorum < n:
                mq = int(math.ceil(m * to_relative(q_t, n)))
                for i in range(mq, n):
                    s = 0
                    for j in range(max(mq, c), min(m - 1, i) + 1):
                        if m - j <= n - i:
                            s += C[i][j] * C[n - i][m - j]
                    N[i] += s
        out.append((N, C[n][m]))
    return out


def growth(h: np.ndarray, c_t, q_t, dtype=None) -> list:
    """growth(m) for m = 1..n from the hist h: exact Fractions, or floats of
    `dtype` computed in that precision."""
    n = len(h) - 1
    quorum = max(1, to_absolute(q_t, n))
    c = max(1, to_absolute(c_t, n))
    hi = [int(x) for x in h]
    tot = sum(hi[c:]) if quorum == 1 else 0
    res = []
    for N, denom in growth_terms(n, c_t, q_t):
        if dtype is None:
            res.append(Fraction(tot) + Fraction(sum(a * b for a, b in zip(hi, N)), denom))
        else:
            p = np.array([x / denom for x in N], dtype=dtype)
            v = np.dtype(dtype).type(tot) + np.dot(np.asarray(h, dtype=dtype), p)
            res.append(float(np.dtype(dtype).type(v)))
    return res
