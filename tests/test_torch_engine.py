"""panacus_torch CountingEngine against panacus_tpu's.

The same packed membership matrix, made from a numpy seed, goes through
the JAX engine (build_from_host_matrix) and, carried across with
`np.asarray(jax_engine.M)`, through the port's engine
(CountingEngine.from_host_state) on the CPU. hist, hist_multi([None, bp])
and coverage must agree exactly (int64), for 1 to 4096 groups, with the
sentinel item 0 and the item padding. The two engines pad the item axis
differently (the JAX one to 16384 * devices), so only results are
compared, never M's shape.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from panacus_torch.ops.engine import ITEM_ALIGN, CountingEngine, MembershipStream

CPU = torch.device("cpu")


def _membership(rng, n_items: int, n_groups: int, n_items_pad: int) -> np.ndarray:
    """Random bits for items 1..n_items in groups < n_groups; the sentinel
    column 0 and the padding stay zero."""
    n_words = max((n_groups + 31) // 32, 1)
    M = np.zeros((n_words, n_items_pad), dtype=np.uint32)
    M[:, 1 : n_items + 1] = rng.integers(
        0, 2**32, size=(n_words, n_items), dtype=np.uint32
    )
    if n_groups % 32:
        M[-1] &= np.uint32((1 << (n_groups % 32)) - 1)
    return M


@pytest.mark.parametrize("n_groups", [1, 31, 32, 33, 90, 4096])
def test_engine_matches_jax_engine(n_groups):
    pytest.importorskip("jax")
    from panacus_tpu.ops import CountingEngine as JaxEngine

    n_items = 3001
    rng = np.random.default_rng(n_groups)
    jeng = JaxEngine(n_items, n_groups)
    jeng.build_from_host_matrix(_membership(rng, n_items, n_groups, jeng.n_items_pad))
    teng = CountingEngine.from_host_state(np.asarray(jeng.M), n_items, n_groups, CPU)
    assert teng.n_items_pad % ITEM_ALIGN == 0

    bp = rng.integers(1, 1 << 20, n_items + 1)
    bp[0] = 0  # sentinel
    np.testing.assert_array_equal(teng.hist(), jeng.hist())
    for got, want in zip(teng.hist_multi([None, bp]), jeng.hist_multi([None, bp])):
        assert got.dtype == np.int64 and len(got) == n_groups + 1
        np.testing.assert_array_equal(got, want)
    cov = teng.coverage()
    assert len(cov) == n_items + 1 and cov[0] == 0
    np.testing.assert_array_equal(cov, jeng.coverage())
    # the all-ones hist counts every item once, the sentinel never
    assert teng.hist().sum() == n_items


def test_from_host_state_rejects_bits_past_n_items():
    M = np.zeros((1, 2 * ITEM_ALIGN), dtype=np.uint32)
    M[0, 11] = 1
    with pytest.raises(ValueError):
        CountingEngine.from_host_state(M, 10, 3, CPU)


def test_weights_past_int32_rejected():
    eng = CountingEngine.from_host_state(np.zeros((1, 11), np.uint32), 10, 3, CPU)
    w = np.zeros(11, dtype=np.int64)
    w[3] = 2**31
    with pytest.raises(ValueError):
        eng.hist(w)


def test_membership_stream_cpu_rows_in_place():
    """On the CPU, host_row is a view of the final M: packing it in place
    and feeding it copies nothing; unfed words stay zero."""
    n_items, n_groups = 100, 70
    s = MembershipStream(n_items, n_groups, CPU)
    row = s.host_row(1)
    row[5] = 3
    s.feed(1, row)
    with pytest.raises(ValueError):
        s.feed(1, row)
    eng = s.finalize()
    cov = eng.coverage()
    assert cov[5] == 2 and cov.sum() == 2
    h = eng.hist()
    assert h[2] == 1 and h[0] == n_items - 1


def test_membership_stream_takes_only_its_own_rows():
    """feed accepts only the view host_row(word) returned for that word."""
    s = MembershipStream(100, 70, CPU)
    with pytest.raises(ValueError):
        s.feed(0, np.zeros(s.engine.n_items_pad, dtype=np.uint32))
    with pytest.raises(ValueError):
        s.feed(0, s.host_row(1))
    s.feed(0, s.host_row(0))


def test_group_kernels_not_ported():
    """The group kernels, once unported, now run on the engine: on the CPU
    through their plain versions (tests/test_torch_group.py holds them
    against the JAX engine)."""
    M = np.zeros((1, 11), np.uint32)
    M[0, 1:] = [0b111, 0b001, 0b010, 0b100, 0b011, 0, 0b101, 0b110, 0b001, 0b111]
    eng = CountingEngine.from_host_state(M, 10, 3, CPU)
    w = np.ones(11, np.int64)
    w[0] = 0
    np.testing.assert_array_equal(eng.ordered_growth(w, 0.0, 1), [6, 8, 9])
    np.testing.assert_array_equal(eng.ordered_growth(w, 0.0, 3), [2, 2, 2])
    S = eng.similarity(w)
    np.testing.assert_array_equal(np.diagonal(S), [6, 5, 5])
    assert S[0, 1] == 3 and S[1, 0] == 3
