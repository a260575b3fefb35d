"""The port's closed-form growth weight matrices (ops/growth_device.py:
growth_weight_matrix, growth_weight_stack) against panacus_tpu's and
against the port's recurrences (hist.Hist.calc_growth), to the tolerance
of tests/test_growth_device.py (1e-9 relative, 1e-7 absolute): union,
core and general quorums, coverage floors absolute and relative."""

from __future__ import annotations

import numpy as np
import pytest

from panacus_torch.hist import Hist
from panacus_torch.ops.growth_device import growth_weight_matrix, growth_weight_stack
from panacus_torch.utils import CountType, Threshold

PAIRS = [
    ("1", "0"),
    ("2", "0"),
    ("1", "1"),
    ("1", "0.6"),
    ("3", "0.35"),
    ("0.1", "0.5"),
]


def _threshold(text: str, pkg=Threshold):
    return pkg.rel(float(text)) if "." in text else pkg.absolute(int(text))


@pytest.mark.parametrize("n", [1, 7, 20])
@pytest.mark.parametrize("cov,q", PAIRS)
def test_weight_matrix_matches_recurrence(n, cov, q):
    rng = np.random.default_rng(n)
    hist = np.zeros(n + 1, dtype=np.int64)
    hist[1:] = rng.integers(0, 100, n)
    t_cov, t_q = _threshold(cov), _threshold(q)
    exact = np.array(Hist(CountType.NODE, hist.tolist()).calc_growth(t_cov, t_q))
    W = growth_weight_matrix(n, t_cov, t_q)
    assert W.shape == (n, n + 1)
    np.testing.assert_allclose(W @ hist.astype(np.float64), exact, rtol=1e-9, atol=1e-7)


@pytest.mark.parametrize("n", [0, 5, 33])
def test_weight_matrices_equal_jax_package(n):
    pytest.importorskip("jax")
    from panacus_tpu.ops import growth_device as jgd
    from panacus_tpu.utils import Threshold as JaxThreshold

    covs = [_threshold(c) for c, _ in PAIRS]
    qs = [_threshold(q) for _, q in PAIRS]
    jcovs = [_threshold(c, JaxThreshold) for c, _ in PAIRS]
    jqs = [_threshold(q, JaxThreshold) for _, q in PAIRS]
    for c, q, jc, jq in zip(covs, qs, jcovs, jqs):
        np.testing.assert_array_equal(
            growth_weight_matrix(n, c, q), jgd.growth_weight_matrix(n, jc, jq)
        )
    if n:
        got = growth_weight_stack(n, covs, qs)
        assert got.shape == (len(PAIRS), n, n + 1)
        np.testing.assert_array_equal(got, jgd.growth_weight_stack(n, jcovs, jqs))
