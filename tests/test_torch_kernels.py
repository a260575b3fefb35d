"""panacus_torch coverage kernels: plain versions against the JAX package,
and the CUDA kernels against the plain versions on the card.

On the CPU the wrappers of panacus_torch.ops.hist_kernels run their plain
PyTorch versions; they are held, exactly in int64, against
panacus_tpu's Pallas kernel run in interpret mode (hist_pallas_host) and
its XLA coverage, on the case grid of tests/test_pallas_hist.py, and
against a numpy oracle on cases the TPU kernel cannot take (4096 groups,
weights >= 2^24, totals >= 2^31).

The tests marked `cuda` launch the kernels of csrc/hist.cu and skip
without a card; run them there with
`PANACUS_TEST_TPU=1 python -m pytest -m cuda tests/test_torch_kernels.py`.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from panacus_torch.ops import hist_kernels as hk
from panacus_torch.ops import kernels
from panacus_torch.ops.engine import CountingEngine, MembershipStream

BLOCK = 16384  # panacus_tpu.ops.pallas_kernels.BLOCK_ITEMS


def _oracle_hist(M: np.ndarray, w: np.ndarray, n_bins: int) -> np.ndarray:
    """Popcount coverage -> weighted bincount, exact in int64; coverages
    >= n_bins are dropped."""
    cov = np.bitwise_count(M).astype(np.int64).sum(axis=0)
    keep = cov < n_bins
    h = np.zeros(n_bins, dtype=np.int64)
    np.add.at(h, cov[keep], w[keep].astype(np.int64))
    return h


def _make_case(rng, n_words, n_items, style):
    """(M, weights) as tests/test_pallas_hist.py builds them, plus the
    weight styles only the port takes."""
    M = rng.integers(0, 2**32, size=(n_words, n_items), dtype=np.uint32)
    if style == "ones":
        w = np.ones(n_items, dtype=np.int32)
    elif style == "limb0":
        w = rng.integers(0, 256, n_items, dtype=np.int32)
    elif style == "two_limbs":
        w = rng.integers(0, 1 << 16, n_items, dtype=np.int32)
    elif style == "all_limbs":
        w = rng.integers(0, 1 << 24, n_items, dtype=np.int32)
    elif style == "plane_boundary":
        M[:] = 0
        M[0] = rng.integers(0, 4, n_items, dtype=np.uint32)  # cov in 0..2
        w = np.full(n_items, 0xFFFFFF, dtype=np.int32)
    elif style == "wide":  # weights >= 2^24, beyond the TPU kernel's limbs
        w = rng.integers(1 << 24, 2**31, n_items, dtype=np.int32)
    elif style == "max":  # every weight 2^31 - 1: totals far above 2^31
        w = np.full(n_items, 2**31 - 1, dtype=np.int32)
    else:  # pragma: no cover
        raise AssertionError(style)
    # sentinel slot 0 and a padding tail carry zero weight in production
    w[0] = 0
    w[-7:] = 0
    return M, w


# (n_words, n_items, n_bins, n_vecs, style): tests/test_pallas_hist.py CASES
PALLAS_CASES = [
    (1, BLOCK, 34, 1, "ones"),
    (1, BLOCK, 34, 1, "limb0"),
    (2, BLOCK, 66, 2, "all_limbs"),
    (33, 2 * BLOCK, 1026, 1, "all_limbs"),
    (33, BLOCK, 1026, 2, "limb0"),
    (3, BLOCK, 98, 2, "two_limbs"),
    (1, 2 * BLOCK, 34, 1, "plane_boundary"),
]
# cases past the TPU kernel's limits: 4096 groups (4098 bins), weights
# >= 2^24, totals >= 2^31
WIDE_CASES = [
    (128, 4096, 4098, 2, "ones"),
    (128, 4096, 4098, 1, "max"),
    (3, BLOCK, 92, 2, "wide"),
    (1, 2 * BLOCK, 34, 1, "max"),
]


def _ids(cases):
    return [f"{c[4]}-w{c[0]}-n{c[1]}-b{c[2]}-v{c[3]}" for c in cases]


def _inputs(n_words, n_items, n_bins, n_vecs, style):
    rng = np.random.default_rng(n_words * 1000 + n_bins + n_vecs)
    M, _ = _make_case(rng, n_words, n_items, style)
    W = np.stack([_make_case(rng, n_words, n_items, style)[1] for _ in range(n_vecs)])
    return M, W


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32/int32 numpy -> int32 torch, same bits."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize(
    "n_words,n_items,n_bins,n_vecs,style", PALLAS_CASES, ids=_ids(PALLAS_CASES)
)
def test_fused_hist_ref_matches_pallas_interpret(
    n_words, n_items, n_bins, n_vecs, style
):
    jax = pytest.importorskip("jax")
    from panacus_tpu.ops import pallas_kernels as pk

    M, W = _inputs(n_words, n_items, n_bins, n_vecs, style)
    want = pk.hist_pallas_host(
        jax.device_put(M), list(W), n_bins, interpret=True
    )
    before = dict(kernels.launches)
    got = hk.fused_hist(_t(M), _t(W), n_bins)
    assert kernels.launches == before  # CPU tensors take the plain version
    assert got.dtype == torch.int64 and got.shape == (n_vecs, n_bins)
    for v in range(n_vecs):
        np.testing.assert_array_equal(got[v].numpy(), np.asarray(want[v]))


@pytest.mark.parametrize("n_words,n_items", [(1, BLOCK), (3, BLOCK), (33, 2 * BLOCK)])
def test_coverage_ref_matches_xla(n_words, n_items):
    jax = pytest.importorskip("jax")
    from panacus_tpu.ops.engine import coverage_from_membership

    M, _ = _inputs(n_words, n_items, 34, 1, "ones")
    want = np.asarray(coverage_from_membership(jax.device_put(M)))
    got = hk.coverage(_t(M))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.bitwise_count(M).astype(np.int32).sum(axis=0)
    )


@pytest.mark.parametrize(
    "n_words,n_items,n_bins,n_vecs,style", WIDE_CASES, ids=_ids(WIDE_CASES)
)
def test_fused_hist_ref_past_tpu_limits(n_words, n_items, n_bins, n_vecs, style):
    M, W = _inputs(n_words, n_items, n_bins, n_vecs, style)
    got = hk.fused_hist(_t(M), _t(W), n_bins)
    for v in range(n_vecs):
        np.testing.assert_array_equal(got[v].numpy(), _oracle_hist(M, W[v], n_bins))
    if style == "max":
        assert int(got.sum()) >= 2**31


HIST_THREADS, HIST_WARPS, MAX_STEPS = 256, 8, 256  # csrc/hist.cu


def _fused_hist_limbs(M: torch.Tensor, W: torch.Tensor, n_bins: int, grid_blocks: int):
    """fused_hist_warp_kernel's arithmetic in plain PyTorch: quad q goes
    to thread q % (blocks * 256) of a grid of at least n_quads / (256 *
    MAX_STEPS) blocks, and its 4 items' weights, as 16-bit halves, into
    the 32-bit limb sums of that thread's warp (which must not leave 32
    bits: lo unsigned, hi signed); the warps' limbs recombine in int64."""
    n_vecs, n_items = W.shape
    n_quads = n_items // 4
    blocks = max(grid_blocks, -(-n_quads // (HIST_THREADS * MAX_STEPS)))
    warp = (torch.arange(n_quads) % (blocks * HIST_THREADS)) // 32
    warp = warp.repeat_interleave(4)
    cov = hk.coverage_ref(M).long()
    keep = cov < n_bins
    n_warps = blocks * HIST_WARPS
    out = torch.zeros((n_vecs, n_bins), dtype=torch.int64)
    for v in range(n_vecs):
        w = W[v].long()
        key = (warp * n_bins + cov)[keep]
        lo = torch.zeros(n_warps * n_bins, dtype=torch.int64).index_add_(0, key, (w & 0xFFFF)[keep])
        hi = torch.zeros(n_warps * n_bins, dtype=torch.int64).index_add_(0, key, (w >> 16)[keep])
        assert int(lo.max()) < 2**32 and -(2**31) <= int(hi.min()) <= int(hi.max()) < 2**31
        out[v] = (lo + hi * 65536).view(n_warps, n_bins).sum(0)
    return out


# the cases whose histograms the per-warp limbs hold (n_vecs * n_bins * 64
# bytes <= 48 KB)
LIMB_CASES = [c for c in PALLAS_CASES + WIDE_CASES if c[2] * c[3] * 64 <= 48 * 1024]


@pytest.mark.parametrize(
    "n_words,n_items,n_bins,n_vecs,style", LIMB_CASES, ids=_ids(LIMB_CASES)
)
def test_fused_hist_limbs_match_plain_and_pallas(n_words, n_items, n_bins, n_vecs, style):
    """The per-warp limb scheme, emulated on a grid of 1 block (so up to
    MAX_STEPS steps a thread land in one warp's limbs), equals the plain
    version and, on the TPU kernel's own cases, the Pallas kernel in
    interpret mode."""
    M, W = _inputs(n_words, n_items, n_bins, n_vecs, style)
    got = _fused_hist_limbs(_t(M), _t(W), n_bins, grid_blocks=1)
    assert torch.equal(got, hk.fused_hist_ref(_t(M), _t(W), n_bins))
    if (n_words, n_items, n_bins, n_vecs, style) in PALLAS_CASES:
        jax = pytest.importorskip("jax")
        from panacus_tpu.ops import pallas_kernels as pk

        want = pk.hist_pallas_host(jax.device_put(M), list(W), n_bins, interpret=True)
        for v in range(n_vecs):
            np.testing.assert_array_equal(got[v].numpy(), np.asarray(want[v]))


def test_fused_hist_limbs_at_their_bound():
    """One warp's limbs at their most: 2^18 items (256 steps of a 1-block
    grid's threads) at weight 2^31 - 1, all in one bin."""
    n_items = 1 << 18
    M = torch.full((1, n_items), -1, dtype=torch.int32)
    W = torch.full((1, n_items), 2**31 - 1, dtype=torch.int32)
    got = _fused_hist_limbs(M, W, 34, grid_blocks=1)
    assert int(got[0, 32]) == n_items * (2**31 - 1)
    assert torch.equal(got, hk.fused_hist_ref(M, W, 34))


def test_wrappers_reject_bad_operands():
    M = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        hk.coverage(M.to(torch.int64))
    with pytest.raises(ValueError):
        hk.fused_hist(M, torch.zeros((1, 4), dtype=torch.int32), 10)
    with pytest.raises(ValueError):
        hk.fused_hist(M, torch.zeros((1, 8), dtype=torch.int64), 10)
    with pytest.raises(ValueError):
        hk.fused_hist(M, torch.zeros((1, 8), dtype=torch.int32), 0)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (no CUDA device here)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n_words,n_items,n_bins,n_vecs,style",
    PALLAS_CASES + WIDE_CASES,
    ids=_ids(PALLAS_CASES + WIDE_CASES),
)
def test_kernels_match_plain_on_cuda(
    cuda_device, n_words, n_items, n_bins, n_vecs, style
):
    M_np, W_np = _inputs(n_words, n_items, n_bins, n_vecs, style)
    M, W = _t(M_np).to(cuda_device), _t(W_np).to(cuda_device)
    before = dict(kernels.launches)
    got = hk.fused_hist(M, W, n_bins)
    cov = hk.coverage(M)
    torch.cuda.synchronize()
    assert kernels.launches["pt_fused_hist"] == before["pt_fused_hist"] + 1
    assert kernels.launches["pt_coverage"] == before["pt_coverage"] + 1
    assert torch.equal(got, hk.fused_hist_ref(M, W, n_bins))
    assert torch.equal(cov, hk.coverage_ref(M))
    for v in range(n_vecs):
        np.testing.assert_array_equal(
            got[v].cpu().numpy(), _oracle_hist(M_np, W_np[v], n_bins)
        )


@pytest.mark.cuda
@pytest.mark.parametrize("n_items", [1 << 20, (1 << 29) + 4096], ids=["2^20", "2^29"])
def test_fused_hist_one_bin_max_weights_on_cuda(cuda_device, n_items):
    """Every item in the same bin at weight 2^31 - 1, two vectors: each
    warp's limb sums take their most; at 2^29 items a thread would take
    more than 256 grid-stride steps on one wave of blocks, so the launch
    adds blocks."""
    n_words = 3 if n_items < 1 << 28 else 1
    M = torch.full((n_words, n_items), -1, dtype=torch.int32, device=cuda_device)
    M[:, -4096:] = 0
    n_vecs = 2 if n_items < 1 << 28 else 1
    W = torch.full((n_vecs, n_items), 2**31 - 1, dtype=torch.int32, device=cuda_device)
    n_bins = 32 * n_words + 2
    got = hk.fused_hist(M, W, n_bins)
    torch.cuda.synchronize()
    want = torch.zeros((n_vecs, n_bins), dtype=torch.int64, device=cuda_device)
    want[:, 32 * n_words] = (n_items - 4096) * (2**31 - 1)
    want[:, 0] = 4096 * (2**31 - 1)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_fused_hist_path_width_on_cuda(cuda_device):
    """3 words, two vectors (ones and weights below 2^31), 2^22 items."""
    rng = np.random.default_rng(22)
    M_np = rng.integers(0, 2**32, size=(3, 1 << 22), dtype=np.uint32)
    M_np[-1] &= (1 << 26) - 1
    W_np = np.stack([np.ones(1 << 22, dtype=np.int32),
                     rng.integers(0, 2**31, 1 << 22).astype(np.int32)])
    M, W = _t(M_np).to(cuda_device), _t(W_np).to(cuda_device)
    got = hk.fused_hist(M, W, 92)
    torch.cuda.synchronize()
    assert torch.equal(got, hk.fused_hist_ref(M, W, 92))
    for v in range(2):
        np.testing.assert_array_equal(got[v].cpu().numpy(), _oracle_hist(M_np, W_np[v], 92))


@pytest.mark.cuda
def test_fused_hist_global_bins_on_cuda(cuda_device):
    """n_vecs * n_bins * 8 bytes beyond a block's shared memory: the kernel
    accumulates straight into global memory."""
    M_np, W_np = _inputs(2, BLOCK, 40000, 1, "wide")
    M, W = _t(M_np).to(cuda_device), _t(W_np).to(cuda_device)
    got = hk.fused_hist(M, W, 40000)
    assert torch.equal(got, hk.fused_hist_ref(M, W, 40000))


@pytest.mark.cuda
def test_membership_stream_on_cuda(cuda_device):
    """Rows fed through pinned host rows and side-stream copies give the
    same engine as the CPU stream (one word left unfed stays zero)."""
    n_items, n_groups = 50000, 90
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 2**32, size=(3, n_items + 1), dtype=np.uint32)
    rows[2] &= (1 << 26) - 1
    rows[:, 0] = 0
    engines = []
    for dev in (torch.device("cpu"), cuda_device):
        s = MembershipStream(n_items, n_groups, dev)
        for word in (0, 2):
            r = s.host_row(word)
            r[: n_items + 1] = rows[word]
            s.feed(word, r)
        engines.append(s.finalize())
    cpu, gpu = engines
    bp = rng.integers(1, 1 << 20, n_items + 1)
    bp[0] = 0
    for a, b in zip(cpu.hist_multi([None, bp]), gpu.hist_multi([None, bp])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(cpu.coverage(), gpu.coverage())
    assert isinstance(gpu, CountingEngine) and all(m.is_cuda for m in gpu.shards)
