"""panacus_torch ordered growth and similarity against panacus_tpu.

The same packed membership matrix, made from a numpy seed, goes through
the JAX engine (panacus_tpu.ops.CountingEngine) and, carried across with
CountingEngine.from_host_state, through the port's engine on the CPU, where
the wrappers of panacus_torch.ops.group_kernels run their plain PyTorch
versions. Results must agree exactly (int64) with the JAX engine and with
the numpy oracles of tests/test_tpu_group_kernels.py, for 1 to 4096
groups, dense and sparse membership, every quorum and coverage floor of
the grid, and weights of every style the JAX similarity takes.

The tests marked `cuda` launch the kernels of csrc/group.cu against the
plain versions and skip without a card; run them there with
`PANACUS_TEST_TPU=1 python -m pytest -m cuda tests/test_torch_group.py`.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from panacus_torch.ops import group_kernels as gk
from panacus_torch.ops import kernels
from panacus_torch.ops.engine import CountingEngine
from panacus_tpu.utils import CountType
from test_torch_engine import _membership as engine_membership

CPU = torch.device("cpu")
N_ITEMS = 1500
QUORUMS = [0.0, 0.3, 0.5, 0.9, 1.0]
C_MINS = [1, 2, 3]
GROUPS = [1, 31, 33, 90, 520, 2100, 4096]


def _oracle_similarity(M: np.ndarray, w: np.ndarray, n_groups: int) -> np.ndarray:
    """(P * w) @ P.T from the packed word rows, as numpy float64 (BLAS): exact
    while every sum stays below 2^53, which the test weights keep to."""
    assert w.sum() < 2**53
    bits = (M[:, None, :] >> np.arange(32, dtype=np.uint32)[None, :, None]) & 1
    P = bits.reshape(-1, M.shape[1])[:n_groups].astype(np.float64)
    return ((P * w) @ P.T).astype(np.int64)


def _membership(rng, n_groups: int, n_items_pad: int, sparse: bool) -> np.ndarray:
    """Random bits for items 1..N_ITEMS in groups < n_groups; sparse rows
    AND three draws, so many items start with absent groups and some have
    coverage below the floors."""
    M = engine_membership(rng, N_ITEMS, n_groups, n_items_pad)
    if sparse:
        M &= engine_membership(rng, N_ITEMS, n_groups, n_items_pad)
        M &= engine_membership(rng, N_ITEMS, n_groups, n_items_pad)
    return M


def _engines(n_groups: int, sparse: bool):
    from panacus_tpu.ops import CountingEngine as JaxEngine

    rng = np.random.default_rng(n_groups * 2 + sparse)
    jeng = JaxEngine(N_ITEMS, n_groups)
    jeng.build_from_host_matrix(_membership(rng, n_groups, jeng.n_items_pad, sparse))
    M = np.asarray(jeng.M)
    teng = CountingEngine.from_host_state(M, N_ITEMS, n_groups, CPU)
    return jeng, teng, M[:, : N_ITEMS + 1], rng


def _ordered_combos(n_groups: int, sparse: bool):
    """Every (quorum, c_min) of the grid up to 90 groups; above, the JAX
    engine takes seconds a call, so dense and sparse split the quorums and
    each cycles through the floors."""
    if n_groups <= 90:
        return [(q, c) for q in QUORUMS for c in C_MINS]
    qs = QUORUMS[0::2] if not sparse else QUORUMS[1::2]
    return [(q, C_MINS[k % 3]) for k, q in enumerate(qs)]


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("n_groups", GROUPS)
def test_ordered_growth_matches_jax_and_oracle(n_groups, sparse):
    pytest.importorskip("jax")
    from test_tpu_group_kernels import _oracle_ordered

    jeng, teng, M, rng = _engines(n_groups, sparse)
    w = rng.integers(1, 1000, N_ITEMS + 1)
    w[0] = 0
    before = dict(kernels.launches)
    for q, c in _ordered_combos(n_groups, sparse):
        got = teng.ordered_growth(w, q, c)
        assert got.dtype == np.int64 and got.shape == (n_groups,)
        np.testing.assert_array_equal(got, jeng.ordered_growth(w, q, c), f"q={q} c={c}")
        np.testing.assert_array_equal(got, _oracle_ordered(M, w, q, c, n_groups))
    assert kernels.launches == before  # CPU tensors take the plain version


def _sim_weights(rng, style: str, n: int) -> np.ndarray:
    """Weights of one style, all exact in float32 (the JAX engine takes
    float32 weights); slot 0 is the sentinel."""
    if style == "ones":
        w = np.ones(n, dtype=np.int64)
    elif style == "bp":
        w = rng.integers(0, 1 << 16, n).astype(np.int64)
    elif style == "wide":  # > 2^16: the JAX version's high half engages
        w = rng.integers(1 << 16, 1 << 24, n).astype(np.int64)
    elif style == "carry":  # large weights on full membership: planes carry
        w = np.full(n, 2**31 - 128, dtype=np.int64)
    else:  # pragma: no cover
        raise AssertionError(style)
    w[0] = 0
    return w


def _fill(M: np.ndarray, n_groups: int) -> None:
    """Every item of M in every group (the sentinel column stays empty)."""
    M[:, 1:] = 0xFFFFFFFF
    if n_groups % 32:
        M[-1] &= np.uint32((1 << (n_groups % 32)) - 1)


@pytest.mark.parametrize("style", ["ones", "bp", "wide", "carry"])
@pytest.mark.parametrize("n_groups", [1, 31, 33, 90])
def test_similarity_matches_jax_engine_and_oracle(n_groups, style):
    pytest.importorskip("jax")
    from panacus_tpu.ops import CountingEngine as JaxEngine

    rng = np.random.default_rng(n_groups + 7)
    jeng = JaxEngine(N_ITEMS, n_groups)
    M = _membership(rng, n_groups, jeng.n_items_pad, False)
    if style == "carry":
        _fill(M[:, : N_ITEMS + 1], n_groups)
    w = _sim_weights(rng, style, N_ITEMS + 1)
    jeng.build_from_host_matrix(M)
    teng = CountingEngine.from_host_state(M, N_ITEMS, n_groups, CPU)
    got = teng.similarity(w)
    assert got.dtype == np.float64 and got.shape == (n_groups, n_groups)
    np.testing.assert_array_equal(got, jeng.similarity(w.astype(np.float32)))
    np.testing.assert_array_equal(
        got.astype(np.int64), _oracle_similarity(M[:, : N_ITEMS + 1], w, n_groups)
    )
    if style == "carry":
        assert got.min() == w.sum() >= 2**40


@pytest.mark.parametrize("n_groups", [520, 2100, 4096])
def test_similarity_many_groups_matches_jax_and_oracle(n_groups):
    """Past 90 groups the JAX engine's sharded matmul over 131072 padded
    items takes minutes on the CPU, so its similarity_intersections runs
    on the unpadded columns (padding adds nothing)."""
    jax = pytest.importorskip("jax")
    from panacus_tpu.ops.engine import similarity_intersections

    rng = np.random.default_rng(n_groups)
    M = _membership(rng, n_groups, N_ITEMS + 1, False)
    w = _sim_weights(rng, "wide", N_ITEMS + 1)
    want = similarity_intersections(jax.device_put(M, jax.devices()[0]), w, n_groups)
    got = CountingEngine.from_host_state(M, N_ITEMS, n_groups, CPU).similarity(w)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.astype(np.int64), _oracle_similarity(M, w, n_groups))


@pytest.mark.parametrize("count", [CountType.NODE, CountType.BP])
def test_similarity_matrix_rounds_bp_like_jax(count):
    """AbacusByGroup.similarity_matrix casts node lengths through float32 as
    panacus_tpu does: above 2^24 bp the two agree on the rounded weights."""
    pytest.importorskip("jax")
    from panacus_torch.abacus import AbacusByGroup
    from panacus_tpu.abacus import AbacusByGroup as JaxAbacusByGroup
    from panacus_tpu.ops import CountingEngine as JaxEngine

    n_groups = 33
    rng = np.random.default_rng(24)
    lens = rng.integers(1 << 24, 1 << 30, N_ITEMS + 1)
    lens[0] = 0
    assert (lens.astype(np.float32).astype(np.int64) != lens).any()
    graph = types.SimpleNamespace(node_lens=lens)
    jeng = JaxEngine(N_ITEMS, n_groups)
    jeng.build_from_host_matrix(_membership(rng, n_groups, jeng.n_items_pad, False))
    teng = CountingEngine.from_host_state(np.asarray(jeng.M), N_ITEMS, n_groups, CPU)
    groups = [f"g{k}" for k in range(n_groups)]
    args = (groups, {}, graph, None, 0, [])
    got, got_sizes = AbacusByGroup(count, teng, *args).similarity_matrix()
    want, want_sizes = JaxAbacusByGroup(count, jeng, *args).similarity_matrix()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_sizes, want_sizes)


def test_zero_groups():
    eng = CountingEngine.from_host_state(np.zeros((1, 11), np.uint32), 10, 0, CPU)
    assert eng.ordered_growth(np.ones(11, np.int64), 0.5, 1).shape == (0,)
    assert eng.similarity(np.ones(11, np.int64)).shape == (0, 0)


def test_wrappers_reject_bad_operands():
    M = torch.zeros((2, 8), dtype=torch.int32)
    w = torch.zeros(8, dtype=torch.int32)
    thr = torch.zeros(40, dtype=torch.int32)
    with pytest.raises(ValueError):  # weights of the wrong length
        gk.similarity(M, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):  # 64-bit weights
        gk.ordered_growth(M, w.long(), thr, 1)
    with pytest.raises(ValueError):  # 70 groups need 3 words, M has 2
        gk.ordered_growth(M, w, torch.zeros(70, dtype=torch.int32), 1)
    with pytest.raises(ValueError):  # float thresholds
        gk.ordered_growth(M, w, thr.float(), 1)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (no CUDA device here)")
    return torch.device("cuda")


def _t(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)


def _thr(n_groups: int, q: float) -> np.ndarray:
    return np.ceil(np.arange(1, n_groups + 1) * q).astype(np.int32)


# (n_groups, n_items_pad, sparse): the main path's width, a tail word, 4096
# groups, and 30000 groups, whose int64 difference array (240 KB) exceeds the
# shared memory a block may opt into: the kernel accumulates in global memory
CUDA_ORDERED = [(90, 1 << 16, False), (33, 1 << 14, True), (4096, 1 << 14, False),
                (4096, 1 << 14, True), (30000, 1 << 12, False)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n_groups,n_items_pad,sparse", CUDA_ORDERED,
    ids=[f"g{c[0]}-n{c[1]}-{'sparse' if c[2] else 'dense'}" for c in CUDA_ORDERED],
)
def test_ordered_growth_kernel_matches_plain_on_cuda(
    cuda_device, n_groups, n_items_pad, sparse
):
    rng = np.random.default_rng(n_groups)
    n_words = (n_groups + 31) // 32
    M_np = rng.integers(0, 2**32, size=(n_words, n_items_pad), dtype=np.uint32)
    if sparse:
        M_np &= rng.integers(0, 2**32, size=M_np.shape, dtype=np.uint32)
    # bits past n_groups are set on purpose: neither version may count them
    M = _t(M_np, cuda_device)
    w_np = rng.integers(0, 2**31, n_items_pad).astype(np.int32)
    w_np[0] = 0
    w = _t(w_np, cuda_device)
    for q, c in [(0.0, 1), (0.5, 1), (1.0, 2), (0.3, 3)]:
        thr = _t(_thr(n_groups, q), cuda_device)
        before = kernels.launches["pt_ordered_growth"]
        got = gk.ordered_growth(M, w, thr, c)
        torch.cuda.synchronize()
        assert kernels.launches["pt_ordered_growth"] == before + 1
        assert torch.equal(got, gk.ordered_growth_ref(M, w, thr, c)), (q, c)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n_groups,n_items_pad,style",
    [(90, 1 << 16, "bp"), (33, 1 << 14, "ones"), (64, 1 << 14, "carry"),
     (4096, 1 << 12, "wide")],
)
def test_similarity_kernel_matches_plain_on_cuda(
    cuda_device, n_groups, n_items_pad, style
):
    rng = np.random.default_rng(n_groups + 1)
    n_words = (n_groups + 31) // 32
    M_np = rng.integers(0, 2**32, size=(n_words, n_items_pad), dtype=np.uint32)
    if style == "carry":
        _fill(M_np, n_groups)
    w_np = _sim_weights(rng, style, n_items_pad).astype(np.int32)
    M, w = _t(M_np, cuda_device), _t(w_np, cuda_device)
    before = kernels.launches["pt_similarity"]
    got = gk.similarity(M, w)
    torch.cuda.synchronize()
    assert kernels.launches["pt_similarity"] == before + 1
    assert torch.equal(got, gk.similarity_ref(M, w))
    assert torch.equal(got, got.T)


@pytest.mark.cuda
def test_engine_group_ops_on_cuda(cuda_device):
    """The engine on the card equals the engine on the CPU."""
    n_groups = 90
    rng = np.random.default_rng(3)
    M = _membership(rng, n_groups, N_ITEMS + 1, True)
    w = rng.integers(1, 1 << 20, N_ITEMS + 1)
    w[0] = 0
    cpu = CountingEngine.from_host_state(M, N_ITEMS, n_groups, CPU)
    gpu = CountingEngine.from_host_state(M, N_ITEMS, n_groups, cuda_device)
    np.testing.assert_array_equal(gpu.similarity(w), cpu.similarity(w))
    for q, c in [(0.0, 1), (0.5, 2)]:
        np.testing.assert_array_equal(
            gpu.ordered_growth(w, q, c), cpu.ordered_growth(w, q, c)
        )
