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
    """Weights of one style; slot 0 is the sentinel. All but "byte" and
    "max31" are exact in float32 (the JAX engine takes float32 weights).
    Byte planes (pt_similarity): ones and byte 1, bp 2, wide 3, carry and
    max31 4."""
    if style == "ones":
        w = np.ones(n, dtype=np.int64)
    elif style == "byte":
        w = rng.integers(0, 1 << 8, n).astype(np.int64)
    elif style == "max31":
        w = rng.integers(0, 2**31, n).astype(np.int64)
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


@pytest.mark.parametrize("count", ["NODE", "BP"], ids=["node", "bp"])
def test_similarity_matrix_rounds_bp_like_jax(count):
    """AbacusByGroup.similarity_matrix casts node lengths through float32 as
    panacus_tpu does: above 2^24 bp the two agree on the rounded weights.
    Each package gets the count type of its own utils.CountType."""
    pytest.importorskip("jax")
    from panacus_torch.abacus import AbacusByGroup
    from panacus_torch.utils import CountType
    from panacus_tpu.abacus import AbacusByGroup as JaxAbacusByGroup
    from panacus_tpu.ops import CountingEngine as JaxEngine
    from panacus_tpu.utils import CountType as JaxCountType

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
    got, got_sizes = AbacusByGroup(CountType[count], teng, *args).similarity_matrix()
    want, want_sizes = JaxAbacusByGroup(
        JaxCountType[count], jeng, *args
    ).similarity_matrix()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_sizes, want_sizes)


def _byte_planes(w: torch.Tensor, planes: int) -> torch.Tensor:
    """int32 [planes, len(w)]: B_p = (w >> 8p) & 0xFF, the weight operand of
    each of pt_similarity's per-plane products."""
    return torch.stack([(w >> (8 * p)) & 0xFF for p in range(planes)])


def _similarity_by_planes(M: torch.Tensor, w: torch.Tensor, slice_items: int):
    """pt_similarity's arithmetic in plain PyTorch: per byte plane and item
    slice an exact product P diag(B_p) P^T that must fit the kernel's int32
    accumulators, shifted by 8p and summed in int64."""
    g_pad = 32 * M.shape[0]
    S = torch.zeros((g_pad, g_pad), dtype=torch.int64)
    planes = _byte_planes(w, gk.n_planes(int(w.max())))
    for p in range(planes.shape[0]):
        for lo in range(0, M.shape[1], slice_items):
            hi = lo + slice_items
            S_p = gk.similarity_ref(M[:, lo:hi], planes[p, lo:hi].contiguous())
            assert int(S_p.max()) < 2**31  # the kernel's int32 accumulators
            S += S_p << (8 * p)
    return S


@pytest.mark.parametrize(
    "w_max,planes",
    [(1, 1), (255, 1), (256, 2), (65535, 2), (65536, 3), (2**24, 4), (2**31 - 1, 4)],
)
def test_byte_planes_recombine(w_max, planes):
    """pt_similarity's weight split: the plane count follows max(w), and
    sum_p B_p << 8p gives the weights back exactly."""
    rng = np.random.default_rng(w_max)
    w = torch.from_numpy(rng.integers(0, w_max + 1, 4096).astype(np.int32))
    w[7] = w_max
    assert gk.n_planes(int(w.max())) == planes
    B = _byte_planes(w, planes)
    assert B.shape == (planes, 4096) and int(B.min()) >= 0 and int(B.max()) <= 255
    back = sum(B[p].long() << (8 * p) for p in range(planes))
    assert torch.equal(back, w.long())
    with pytest.raises(ValueError):
        gk.n_planes(2**31)
    w[3] = -w_max  # its sign would fall outside every plane
    with pytest.raises(ValueError, match="min is"):
        gk.similarity(torch.zeros((1, 4096), dtype=torch.int32), w)


@pytest.mark.parametrize("style", ["byte", "bp", "wide", "max31", "carry"])
@pytest.mark.parametrize("n_groups", [1, 90, 130])
def test_similarity_by_planes_matches_plain(n_groups, style):
    """The kernel's arithmetic (a product per byte plane and item slice, each
    within int32, shifted and summed in int64) equals the plain version and
    the numpy oracle; slices of 512 items over 1500 leave a ragged one."""
    rng = np.random.default_rng(n_groups * 5 + len(style))
    n_words = (n_groups + 31) // 32
    M = _membership(rng, n_groups, N_ITEMS + 1, False)
    if style == "carry":
        _fill(M, n_groups)
    w = _sim_weights(rng, style, N_ITEMS + 1)
    Mt = torch.from_numpy(M.view(np.int32))
    wt = torch.from_numpy(w.astype(np.int32))
    got = _similarity_by_planes(Mt, wt, slice_items=512)
    assert got.shape == (32 * n_words, 32 * n_words)
    assert torch.equal(got, gk.similarity_ref(Mt, wt))
    if style != "max31":  # the oracle stays below 2^53
        want = _oracle_similarity(M, w, n_groups)
        np.testing.assert_array_equal(got[:n_groups, :n_groups].numpy(), want)
    if style == "carry":
        assert int(got[0, 0]) == w.sum() >= 2**32


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
    with pytest.raises(ValueError, match="on the host"):  # thresholds off the host
        gk.ordered_growth(M, w, thr.to("meta"), 1)


# -- pt_ordered_growth's bit-sliced scan, emulated -----------------------------

FULL = 0xFFFFFFFF
OG_WARPS = 8  # csrc/group.cu kOgWarps


def _transpose32(x):
    """csrc/group.cu:transpose32 on 32 int64 tensors of uint32 words:
    afterwards bit k of x[b] is what bit b of x[k] was."""
    x = list(x)
    for j in (16, 8, 4, 2, 1):
        m = {16: 0x0000FFFF, 8: 0x00FF00FF, 4: 0x0F0F0F0F, 2: 0x33333333, 1: 0x55555555}[j]
        for k in range(32):
            if k & j == 0:
                t = ((x[k] >> j) ^ x[k + j]) & m
                x[k] = x[k] ^ ((t << j) & FULL)
                x[k + j] = x[k + j] ^ t
    return x


def _popc(x):
    return ((x.unsqueeze(-1) >> torch.arange(32)) & 1).sum(-1)


def _bit_length(x):
    """One past the highest set bit of each uint32 word (0 for none)."""
    return (((x.unsqueeze(-1) >> torch.arange(32)) & 1) * torch.arange(1, 33)).amax(-1)


def _ordered_growth_bitsliced(M, w, thr, c_min, grid_blocks, n_seg=1):
    """pt_ordered_growth's arithmetic in plain PyTorch (int64 tensors of
    uint32 bit words), in the kernel's grouping: chunks of 1024 items, one
    a warp, lanes of 32 interleaved items, the 32 x 32 transposes, dif = cum
    - thr in NB + 1 bit planes moved by one full adder a step, the items
    each lane switches on and off per group (counted times the lane's one
    weight where it has one), the warp's int64 sum per group into its own
    array over the block steps of grid_blocks blocks, the blocks' sums, the
    prefix. With n_seg > 1 the word rows of a chunk are split between n_seg
    warps of a block: each packs its items' present groups in its rows and
    one past the last of them (count << 16 | last), and each starts from the
    packed values of the segments before its own; coverage from them all."""
    n_words, n_pad = M.shape
    n_groups = thr.shape[0]
    NB = 7 if n_groups < 127 else 11 if n_groups < 2047 else 16
    # a warp takes 1024 items a step; bit k = 4 j + s of lane l holds item
    # 128 j + 4 l + s of them (its loads read 512 contiguous bytes)
    n_ch = (n_pad + 1023) // 1024
    n_lb = 32 * n_ch
    Mu = torch.zeros((n_words, n_ch * 1024), dtype=torch.int64)
    Mu[:, :n_pad] = M.to(torch.int64) & FULL
    W = torch.zeros(n_ch * 1024, dtype=torch.int64)
    W[:n_pad] = w.to(torch.int64)
    k = torch.arange(32)
    item = (1024 * torch.arange(n_ch).view(-1, 1, 1) + 128 * (k >> 2).view(1, 1, 32)
            + 4 * torch.arange(32).view(1, 32, 1) + (k & 3).view(1, 1, 32)).reshape(n_lb, 32)
    words = Mu[:, item]
    W = W[item]
    bit = 1 << torch.arange(32, dtype=torch.int64)
    E = ((W != 0).to(torch.int64) * bit).sum(1)
    last = (1 << (n_groups % 32)) - 1 if n_groups % 32 else FULL
    masked = [words[wd] & (last if wd == n_words - 1 else FULL) for wd in range(n_words)]
    nz = W != 0
    wu = torch.where(nz, W, 0).amax(1)
    uni = (torch.where(nz, W, wu.unsqueeze(1)) == wu.unsqueeze(1)).all(1)
    c = thr.to(torch.int64).clamp(0, n_groups + 1)
    steps = c - torch.cat([torch.zeros(1, dtype=torch.int64), c[:-1]])
    assert bool(((steps == 0) | (steps == 1)).all())  # what the wrapper lets through
    bounds = [s * n_words // n_seg for s in range(n_seg + 1)]
    packed = []  # per segment [n_lb, 32]: present groups << 16 | one past the last
    for s in range(n_seg):
        cnt = torch.zeros((n_lb, 32), dtype=torch.int64)
        lst = torch.zeros((n_lb, 32), dtype=torch.int64)
        for wd in range(bounds[s], bounds[s + 1]):
            v = masked[wd]
            cnt += _popc(v)
            lst = torch.where(v != 0, 32 * wd + _bit_length(v), lst)
        packed.append((cnt << 16) | lst)
    cov = sum(p >> 16 for p in packed)
    if n_seg > 1 or c_min > 1:
        E &= ((cov >= c_min).to(torch.int64) * bit).sum(1)
    per_block = OG_WARPS // n_seg
    chunk = torch.arange(n_ch)
    acc = torch.zeros((grid_blocks * OG_WARPS, n_groups), dtype=torch.int64)
    for s in range(n_seg):
        # the warp of segment s of each chunk, over the block steps
        slot = ((chunk // per_block) % grid_blocks) * OG_WARPS + (chunk % per_block) * n_seg + s
        cum = sum((packed[t] >> 16 for t in range(s)), torch.zeros((n_lb, 32), dtype=torch.int64))
        lastp = torch.zeros((n_lb, 32), dtype=torch.int64)
        for t in range(s):
            lastp = torch.where(packed[t] & 0xFFFF != 0, packed[t] & 0xFFFF, lastp)
        r0, r1 = bounds[s], bounds[s + 1]
        d = cum - (int(c[32 * r0 - 1]) if r0 > 0 else 0)
        dif = [(((d >> i) & 1) * bit).sum(1) for i in range(NB + 1)]
        counted = (lastp > 0) & (cum >= c[(lastp - 1).clamp(min=0)])
        ok = (counted.to(torch.int64) * bit).sum(1) & E
        for wd in range(r0, r1):
            x = _transpose32([words[wd, :, k] for k in range(32)])
            for b in range(min(32, n_groups - 32 * wd)):
                g = 32 * wd + b
                p = x[b] & E
                # dif += p - step, one full adder
                dm = FULL if int(steps[g]) == 1 else 0
                a = dm & (p ^ FULL)
                carry = dif[0] & (p ^ dm)
                dif[0] = dif[0] ^ p ^ dm
                for i in range(1, NB + 1):
                    n = (dif[i] & a) | (carry & (dif[i] | a))
                    dif[i] = dif[i] ^ a ^ carry
                    carry = n
                now = (ok & (p ^ FULL)) | ((dif[NB] ^ FULL) & p)
                sw = now ^ ok
                ok = now
                on, off = sw & now, sw & (now ^ FULL)
                d_lane = (W * (((on.unsqueeze(1) >> torch.arange(32)) & 1)
                               - ((off.unsqueeze(1) >> torch.arange(32)) & 1))).sum(1)
                assert torch.equal(
                    torch.where(uni, wu * (_popc(on) - _popc(off)), d_lane), d_lane
                )
                per_chunk = torch.zeros(n_ch, dtype=torch.int64).index_add_(
                    0, torch.arange(n_lb) // 32, d_lane)
                acc[:, g].index_add_(0, slot, per_chunk)
    return acc.sum(0).cumsum(0)


def _thresholds(n_groups, kind):
    """int32 thresholds: ceil((g + 1) q) for a quorum, steps of 2-3 (q =
    2.5, clamped past n_groups), or a saw that decreases."""
    g = np.arange(1, n_groups + 1, dtype=np.int64)
    if kind == "saw":
        thr = (g % 7) * 3 - 2
    else:
        thr = np.ceil(g * float(kind))
    return torch.from_numpy(thr.astype(np.int32))


QUORUM_KINDS = ["0", "0.5", "1", "0.3"]
# (n_groups, quorum, segments a chunk): every quorum up to 520 groups (NB =
# 7 and 11), split where the rows allow (33 and 90 groups in 2, 520 in 4:
# 4 + 4 + 4 + 5 rows); at 2100 groups (NB = 16, seconds a case here) one
# case split 8 ways and one not
BITSLICED_CASES = (
    [(1, k, 1) for k in QUORUM_KINDS]
    + [(g, k, s) for g in (33, 90) for k in QUORUM_KINDS for s in (1, 2)]
    + [(520, k, s) for k in QUORUM_KINDS for s in (1, 4)]
    + [(2100, "0.5", 8), (2100, "0.3", 1)]
)


@pytest.mark.parametrize("n_groups,kind,n_seg", BITSLICED_CASES)
def test_ordered_growth_bitsliced_matches_plain(n_groups, kind, n_seg):
    """The kernel's scan, emulated over 1500 items and a grid of 2 blocks
    (chunks past the grid wrap to earlier warps), equals the plain version
    exactly at every coverage floor; up to 90 groups also the JAX engine
    (XLA on the CPU)."""
    jeng, teng, M_np, rng = _engines(n_groups, sparse=n_groups % 2 == 0)
    w = rng.integers(1, 1000, N_ITEMS + 1)
    w[0] = 0
    w[rng.integers(1, N_ITEMS, 200)] = 0
    M = torch.from_numpy(M_np.copy().view(np.int32))
    thr = _thresholds(n_groups, kind)
    for c_min in (1, 2):
        for wt in (torch.from_numpy(w.astype(np.int32)),
                   torch.from_numpy((w > 0).astype(np.int32))):
            got = _ordered_growth_bitsliced(M, wt, thr, c_min, grid_blocks=2, n_seg=n_seg)
            assert torch.equal(got, gk.ordered_growth_ref(M, wt, thr, c_min)), (c_min,)
        if n_groups <= 90:
            pytest.importorskip("jax")
            np.testing.assert_array_equal(
                got.numpy(), jeng.ordered_growth((w > 0).astype(np.int64), float(kind), c_min)
            )


@pytest.mark.parametrize("kind", ["2.5", "saw", "negative"])
def test_ordered_growth_takes_only_thresholds_that_step_by_0_or_1(kind):
    """Thresholds whose clamped values step by 2 or more or fall are
    rejected on every device; thresholds below 0 clamp to 0 and are taken."""
    n_groups = 90
    rng = np.random.default_rng(len(kind))
    M = torch.from_numpy(rng.integers(0, 2**32, (3, 4096), dtype=np.uint32).view(np.int32))
    w = torch.ones(4096, dtype=torch.int32)
    thr = _thresholds(n_groups, "0.5" if kind == "negative" else kind)
    if kind == "negative":
        thr = thr - 40
        assert torch.equal(gk.ordered_growth(M, w, thr, 1), gk.ordered_growth_ref(M, w, thr, 1))
    else:
        with pytest.raises(ValueError, match="step by 0 or 1"):
            gk.ordered_growth(M, w, thr, 1)


def test_kernel_times_captures_the_engines_thresholds():
    """kernel_times times pt_ordered_growth on the thresholds the engine
    makes: host int32 vectors that kernel_times.thresholds rebuilds."""
    from panacus_torch import kernel_times as kt

    _, teng, _, _ = _engines(90, sparse=True)
    w = np.ones(N_ITEMS + 1, dtype=np.int64)
    with kt.capture() as calls:
        for q, c in kt.ORDERED_QC:
            teng.ordered_growth(w, q, c)
    assert len(calls["pt_ordered_growth"]) == len(kt.ORDERED_QC)
    for (q, c), (_, _, thr, c_min) in zip(kt.ORDERED_QC, calls["pt_ordered_growth"]):
        assert c_min == c and thr.device.type == "cpu"
        assert torch.equal(thr, kt.thresholds(90, q))
        gk.check_thresholds(thr)


def test_ordered_growth_past_65534_groups_matches_jax():
    """65,537 groups (past the 16-bit counts the CUDA kernel once had):
    the port's ordered growth equals panacus_tpu's engine ordered growth on
    a few items, at every quorum and floor of ordered-histgrowth -q 0,0.5,1
    -l 1,1,2 and at a floor of 2."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from panacus_tpu.ops import engine as jax_engine

    n_groups, n_items_pad = 65_537, 64
    rng = np.random.default_rng(65_537)
    n_words = (n_groups + 31) // 32
    M_np = rng.integers(0, 2**32, size=(n_words, n_items_pad), dtype=np.uint32)
    M_np[-1] &= np.uint32(1)  # group 65,536: the one bit of the last word
    M_np[:, 0] = 0
    M_np[:, 5] = 0  # an item in no group
    w = rng.integers(1, 100, n_items_pad).astype(np.int32)
    w[0] = 0
    M = torch.from_numpy(M_np.view(np.int32))
    M_jax = jnp.asarray(M_np)
    for q, c in [(0.0, 1), (0.5, 1), (1.0, 2), (0.5, 2)]:
        thr = torch.from_numpy(
            np.ceil(np.arange(1, n_groups + 1) * q).astype(np.int32))
        got = gk.ordered_growth(M, torch.from_numpy(w), thr, c)
        want = jax_engine.ordered_growth(M_jax, w, q, c, n_groups)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got[-1] > 0 if q < 1 else True


def test_ordered_histgrowth_help_states_no_group_cap(capsys):
    """Neither the command list nor ordered-histgrowth --help caps the
    groups."""
    from panacus_torch.cli import run_cli

    outs = []
    for argv in (["--help"], ["ordered-histgrowth", "--help"]):
        with pytest.raises(SystemExit) as e:
            run_cli(argv)
        assert e.value.code == 0
        outs.append(capsys.readouterr().out)
    assert "Calculate growth curve based on group file order" in outs[0]
    assert "usage: panacus ordered-histgrowth" in outs[1]
    for out in outs:
        assert "65,534" not in out and "65534" not in out and "at most" not in out


def test_transpose32_network():
    rng = np.random.default_rng(32)
    x = torch.from_numpy(rng.integers(0, 2**32, (32, 5), dtype=np.uint64).astype(np.int64))
    y = _transpose32(list(x))
    for b in range(32):
        want = (((x >> b) & 1) << torch.arange(32).view(32, 1)).sum(0)
        assert torch.equal(y[b], want)


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


# (n_groups, n_items_pad, sparse): the main path's width, a tail word, 512
# groups (the per-warp difference arrays' tier; 16 chunks of 1024 items
# split 4 ways), 1024 groups x 2^18 (one block-shared array; chunks split 8
# ways), 4096 groups (split 8 ways), and 30000 groups, whose int64
# difference array (240 KB) exceeds the shared memory a block may opt into:
# the kernel accumulates in global memory
CUDA_ORDERED = [(90, 1 << 16, False), (33, 1 << 14, True), (512, 1 << 14, False),
                (1024, 1 << 18, True), (4096, 1 << 14, False), (4096, 1 << 14, True),
                (30000, 1 << 12, False)]


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
        thr = torch.from_numpy(_thr(n_groups, q))
        before = kernels.launches["pt_ordered_growth"]
        got = gk.ordered_growth(M, w, thr, c)
        torch.cuda.synchronize()
        assert kernels.launches["pt_ordered_growth"] == before + 1
        assert torch.equal(got, gk.ordered_growth_ref(M, w, thr, c)), (q, c)


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["max", "max31"])
def test_ordered_growth_one_switch_position_on_cuda(cuda_device, weights):
    """Every item in every group: at q=0 and q=1 every item switches on at
    group 0 and never off, so all of a warp's changes land on one entry,
    whose sum (2^20 items of weights near 2^31) passes 2^32; one weight on
    every item takes the count path, weights that differ the halves."""
    n_groups, n_items_pad = 90, (1 << 20) + 1024
    rng = np.random.default_rng(31)
    M_np = np.zeros((3, n_items_pad), dtype=np.uint32)
    _fill(M_np, n_groups)
    if weights == "max":
        w_np = np.full(n_items_pad, 2**31 - 1, dtype=np.int32)
    else:
        w_np = rng.integers(2**30, 2**31, n_items_pad).astype(np.int32)
    w_np[0] = 0
    M, w = _t(M_np, cuda_device), _t(w_np, cuda_device)
    total = int(w_np.astype(np.int64).sum())
    for q in (0.0, 1.0):
        thr = torch.from_numpy(_thr(n_groups, q))
        got = gk.ordered_growth(M, w, thr, 1)
        torch.cuda.synchronize()
        assert torch.equal(got, gk.ordered_growth_ref(M, w, thr, 1))
        assert int(got[0]) == int(got[-1]) == total >= 2**32


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["saw", "2.5", "negative"])
def test_ordered_growth_any_thresholds_on_cuda(cuda_device, kind):
    """Thresholds that decrease or step by more than 1 are rejected before
    any launch; thresholds below 0 clamp to 0 and equal the plain version."""
    n_groups, n_items_pad = 90, 1 << 16
    rng = np.random.default_rng(len(kind))
    M_np = rng.integers(0, 2**32, size=(3, n_items_pad), dtype=np.uint32)
    M_np &= rng.integers(0, 2**32, size=M_np.shape, dtype=np.uint32)
    w_np = rng.integers(0, 1000, n_items_pad).astype(np.int32)
    w_np[0] = 0
    thr = _thresholds(n_groups, "0.5" if kind == "negative" else kind)
    M, w = _t(M_np, cuda_device), _t(w_np, cuda_device)
    before = kernels.launches["pt_ordered_growth"]
    if kind != "negative":
        with pytest.raises(ValueError, match="step by 0 or 1"):
            gk.ordered_growth(M, w, thr, 1)
        assert kernels.launches["pt_ordered_growth"] == before
        return
    thr = thr - 40
    for c in (1, 3):
        got = gk.ordered_growth(M, w, thr, c)
        torch.cuda.synchronize()
        assert torch.equal(got, gk.ordered_growth_ref(M, w, thr, c)), c


@pytest.mark.cuda
@pytest.mark.parametrize("n_groups", [65_535, 70_001])
def test_ordered_growth_past_65534_groups_on_cuda(cuda_device, n_groups):
    """The 31-plane tier: 65,535 groups (the first count that 16 planes
    cannot hold with n_groups + 1) and 70,001, a few hundred items split
    between warps, every quorum at floors 1 and 2, exact."""
    rng = np.random.default_rng(n_groups)
    n_words, n_items_pad = (n_groups + 31) // 32, 516
    M_np = rng.integers(0, 2**32, size=(n_words, n_items_pad), dtype=np.uint32)
    M_np[:, 300:] &= rng.integers(0, 2**32, size=(n_words, n_items_pad - 300),
                                  dtype=np.uint32)
    M_np[:, 400:] = 0
    M_np[: n_words // 2, 350:400] = 0  # items only in the later groups
    M_np[:, 0] = 0
    w_np = rng.integers(0, 2**31, n_items_pad).astype(np.int32)
    w_np[0] = 0
    M, w = _t(M_np, cuda_device), _t(w_np, cuda_device)
    for q in (0.0, 0.5, 1.0):
        for c in (1, 2):
            thr = torch.from_numpy(_thr(n_groups, q))
            before = kernels.launches["pt_ordered_growth"]
            got = gk.ordered_growth(M, w, thr, c)
            torch.cuda.synchronize()
            assert kernels.launches["pt_ordered_growth"] == before + 1
            assert torch.equal(got, gk.ordered_growth_ref(M, w, thr, c)), (q, c)


# (n_groups, n_items_pad, weights): groups 1 to 4096 (one 128-group tile
# pair up to many, ragged tails of the last word and tile), item counts that
# are not a multiple of the kernel's 128-item chunk, every byte-plane count
# (ones/byte 1, bp 2, wide 3, carry/max31 4), totals past 2^32 (carry), and
# 2^23 + 1028 items of full membership at 4 planes: at least two item slices,
# each plane's int32 sum at its bound (255 * 2^23)
CUDA_SIMILARITY = [
    (90, 1 << 16, "bp"), (33, 1 << 14, "ones"), (64, 1 << 14, "carry"),
    (4096, 1 << 12, "wide"), (1, 1000, "ones"), (33, 4100, "byte"),
    (90, 917_500, "bp"), (130, 16_388, "wide"), (130, 70_004, "carry"),
    (1024, (1 << 16) + 4, "max31"), (4096, 4_100, "byte"),
    (33, (1 << 23) + 1028, "carry"),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n_groups,n_items_pad,style", CUDA_SIMILARITY,
    ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in CUDA_SIMILARITY],
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
    if style == "carry":
        want = int(w_np.astype(np.int64).sum())
        assert int(got[:n_groups, :n_groups].min()) == want >= 2**32


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
