"""panacus_torch probe kernels against the TPU kernels they replace.

The TPU kernels live in measurement scripts that run their CLIs when
imported (scripts/kernel_probe.py) or build 1 GiB inputs first
(scripts/kernel_interleave.py, bench.py:_xor_read_bw), so their definitions
are taken from the source with `ast` and executed in a namespace of small
shapes, each file in its own namespace, and run in Pallas interpret mode
on the CPU. The port's plain versions (what the wrappers run for CPU
tensors) must equal them exactly:

- K0 bench.py `run` (in _xor_read_bw)          == xor_fold
- P1-P3 kernel_probe.py pc_only/pcl_only/pcm_only,
  P7 kernel_interleave.py _simple(_pc_kernel | _pcx_kernel | _pcm_kernel)
                                                == word_fold
- P4-P6 kernel_probe.py coarse/fh2/fhm,
  P8 kernel_interleave.py _fh2(n_limbs, mxu_cov) == limb_hist, once the
  TPU output's lo/hi 16-bit planes are recombined

The TPU chains vary the weights per pass as `w + i`; here the JAX kernels
get the salted weights and the port the salt. The tests marked `cuda`
launch the kernels of csrc/probe.cu against the plain versions and skip
without a card; run them there with
`PANACUS_TEST_TPU=1 python -m pytest -m cuda tests/test_torch_probe.py`.
"""

from __future__ import annotations

import ast
import functools
import os

import numpy as np
import pytest
import torch

from panacus_torch import probe
from panacus_torch.ops import hist_kernels as hk
from panacus_torch.ops import kernels
from panacus_torch.ops import probe_kernels as pk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 16384  # panacus_tpu.ops.pallas_kernels.BLOCK_ITEMS
FINE = 32  # panacus_tpu.ops.pallas_kernels.FINE

KERNEL_PROBE = (
    "scripts/kernel_probe.py",
    None,
    ("_pc_kernel", "pc_only", "_pcl_kernel", "pcl_only", "_pcm_kernel", "pcm_only",
     "_coarse_kernel", "coarse", "_fh2_kernel", "fh2", "_fhm_kernel", "fhm"),
)
KERNEL_INTERLEAVE = (
    "scripts/kernel_interleave.py",
    "_load_probe_funcs",
    ("_pc_kernel", "_pcx_kernel", "_pcm_kernel", "_simple", "_fh2_kernel", "_fh2"),
)
BENCH_READ = ("bench.py", "_xor_read_bw", ("kern", "run"))


def _definitions(path: str, inside, names):
    """The function definitions `names` of `path` (at module level, or in
    the body of the function `inside`), compiled as one module."""
    with open(os.path.join(ROOT, path), encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    body = tree.body
    if inside is not None:
        (outer,) = [
            n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == inside
        ]
        body = outer.body
    found = [n for n in body if isinstance(n, ast.FunctionDef) and n.name in names]
    assert sorted(n.name for n in found) == sorted(names), path
    return compile(ast.Module(body=found, type_ignores=[]), path, "exec")


@functools.lru_cache(maxsize=None)
def _tpu(source, n_words: int, n_items: int, n_bins: int) -> dict:
    """The namespace holding one script's kernels at this shape."""
    import jax
    import jax.experimental.pallas as pl
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    ns = dict(
        jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, functools=functools, B=B,
        FINE=FINE, n_words=n_words, n_items=n_items, n_bins=n_bins,
    )
    exec(_definitions(*source), ns)
    return ns


def _interpret(fn, *args) -> np.ndarray:
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*args))


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32/int32 numpy -> int32 torch, same bits."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _inputs(n_words, n_items, n_vecs, w_hi, seed):
    rng = np.random.default_rng(seed)
    M = rng.integers(0, 2**32, size=(n_words, n_items), dtype=np.uint32)
    W = rng.integers(0, w_hi, size=(n_vecs, n_items), dtype=np.int64).astype(np.int32)
    return M, W


def _salted(W: np.ndarray, salt: int) -> np.ndarray:
    """W + salt with int32 wrap, as the TPU chain's `w + i`."""
    return (W.astype(np.int64) + salt).astype(np.uint32).view(np.int32)


def _planes(out: np.ndarray, n_rows: int, n_coarse: int) -> np.ndarray:
    """The TPU's [2 * n_rows * n_coarse, 32] lo/hi planes -> int64
    [n_rows, 32 * n_coarse] histograms."""
    nr = n_rows * n_coarse
    H = out[:nr].astype(np.int64) + (out[nr:].astype(np.int64) << 16)
    return H.reshape(n_rows, n_coarse * FINE)


# -- K0: the raw-read control ----------------------------------------------------


@pytest.mark.parametrize(
    "n_words,n_blocks,salt", [(3, 2, 0), (2, 3, 7), (4, 2, -(2**31) + 3)]
)
def test_xor_fold_matches_bench_read(n_words, n_blocks, salt):
    n_items = n_blocks * B
    M, W = _inputs(n_words, n_items, 1, 2**31, 10 + n_words)
    ns = _tpu(BENCH_READ, n_words, n_items, 0)
    want = _interpret(ns["run"], M, _salted(W, salt).view(np.uint32))
    before = dict(kernels.launches)
    got = pk.xor_fold(_t(M), _t(W), salt)
    assert kernels.launches == before  # CPU tensors take the plain version
    assert got.dtype == torch.int32 and got.shape == (1, 1)
    np.testing.assert_array_equal(got.numpy(), want)


# -- P1-P3, P7: the popcount folds ------------------------------------------------

# variant -> (script, function, the port's op and route)
WORD_FOLDS = {
    "pc": (KERNEL_PROBE, "pc_only", "popc", False),
    "pcl": (KERNEL_PROBE, "pcl_only", "popc", False),
    "pcm": (KERNEL_PROBE, "pcm_only", "popc", True),
    "pc-interleave": (KERNEL_INTERLEAVE, "_pc_kernel", "popc", False),
    "pcx-interleave": (KERNEL_INTERLEAVE, "_pcx_kernel", "cast", False),
    "pcm-interleave": (KERNEL_INTERLEAVE, "_pcm_kernel", "popc", True),
}


@pytest.mark.parametrize("variant", sorted(WORD_FOLDS))
@pytest.mark.parametrize("n_words,n_blocks,salt", [(3, 2, 5), (2, 4, -1)])
def test_word_fold_matches_probe(variant, n_words, n_blocks, salt):
    source, name, op, mma_cov = WORD_FOLDS[variant]
    n_items = n_blocks * B
    M, W = _inputs(n_words, n_items, 1, 2**31, 20 + n_words)
    ns = _tpu(source, n_words, n_items, 0)
    fn = ns[name] if source is KERNEL_PROBE else ns["_simple"](ns[name])
    want = _interpret(fn, M, _salted(W, salt))
    got = pk.word_fold(_t(M), _t(W), salt, op, mma_cov)
    assert got.dtype == torch.int32 and got.shape == (1, B)
    np.testing.assert_array_equal(got.numpy(), want)
    if op == "cast":  # the sums over words wrap in int32
        assert (M.astype(np.int64).sum(axis=0) >= 2**31).any()


# -- P4-P6, P8: the limb histograms -----------------------------------------------

# variant -> (script, function or _fh2's mxu_cov, weight side, mma_cov)
LIMB_HISTS = {
    "old": (KERNEL_PROBE, "coarse", "coarse", False),
    "fh2": (KERNEL_PROBE, "fh2", "fine", False),
    "fhm": (KERNEL_PROBE, "fhm", "fine", True),
    "fh2-interleave": (KERNEL_INTERLEAVE, False, "fine", False),
    "fhm-interleave": (KERNEL_INTERLEAVE, True, "fine", True),
}


@pytest.mark.parametrize("variant", sorted(LIMB_HISTS))
@pytest.mark.parametrize("n_limbs", [1, 2, 3])
@pytest.mark.parametrize("n_vecs", [1, 2])
def test_limb_hist_matches_probe(variant, n_limbs, n_vecs):
    source, fn_or_mxu, side, mma_cov = LIMB_HISTS[variant]
    n_words, n_items = 3, 2 * B
    n_bins = 32 * n_words + 2
    salt = 3 - n_vecs * 1000  # some weights go negative: bytes of the wrap
    M, W = _inputs(n_words, n_items, n_vecs, 1 << 24, 30 + n_limbs + 10 * n_vecs)
    ns = _tpu(source, n_words, n_items, n_bins)
    if source is KERNEL_PROBE:
        want = _interpret(ns[fn_or_mxu], M, _salted(W, salt), n_bins, n_limbs)
    else:
        want = _interpret(ns["_fh2"](n_limbs, fn_or_mxu), M, _salted(W, salt))
    n_coarse = pk.n_coarse_for(n_bins)
    got = pk.limb_hist(_t(M), _t(W), n_bins, n_limbs, salt, side, mma_cov)
    assert got.dtype == torch.int64 and got.shape == (n_limbs * n_vecs, n_coarse * FINE)
    np.testing.assert_array_equal(got.numpy(), _planes(want, n_limbs * n_vecs, n_coarse))


@pytest.mark.parametrize("n_words,n_vecs", [(1, 1), (3, 2), (33, 1)])
def test_limb_hist_recombines_to_fused_hist(n_words, n_vecs):
    """sum_j limb_hist[j V + v] << 8 j == the port's K1 histogram for
    weights below 2^24 (the cur variants against the limb ones)."""
    n_items = B + 4096
    n_bins = 32 * n_words + 2
    M, W = _inputs(n_words, n_items, n_vecs, 1 << 24, 40 + n_words)
    H = pk.limb_hist(_t(M), _t(W), n_bins, 3)
    got = pk.recombine(H, n_vecs, 3)
    want = hk.fused_hist_ref(_t(M), _t(W), n_bins)
    assert torch.equal(got[:, :n_bins], want)
    assert not got[:, n_bins:].any()  # no coverage past 32 n_words


def test_probe_parity_and_variants_on_cpu():
    M, w = probe.make_inputs(torch.device("cpu"), 3, 2 * B, 0)
    assert probe.parity(M, w, mma_cov=False) and probe.parity(M, w, mma_cov=True)
    # every timed variant runs its pass (same result for the same salt
    # whatever the route: the route flags change only the kernel)
    outs = {v: probe.pass_fn(v, M, w)(1) for v in probe.VARIANTS if v not in probe.CHECKS}
    assert torch.equal(outs["pc"], outs["pcm"]) and torch.equal(outs["pc"], outs["pcl"])
    assert torch.equal(outs["fh23"], outs["old3"]) and torch.equal(outs["fh23"], outs["fhm3"])
    assert torch.equal(outs["cur1"], outs["cur3"])
    assert outs["read"].shape == (1, 1) and outs["pcx"].shape == (1, B)


def test_probe_run_and_summary_on_cpu():
    M, w = probe.make_inputs(torch.device("cpu"), 2, B, 1)
    lines = []
    times = probe.run(["read", "pc", "parity"], 1, M, w, out=lines.append)
    assert set(times) == {"read", "pc"} and all(t[0] > 0 for t in times.values())
    assert "parity fh2 vs current: True" in lines
    med = probe.summary(times, probe.pass_bytes(M, w), out=lines.append)
    assert set(med) == {"read", "pc"}
    assert any(l.startswith("  read:") and "1.000 of read" in l for l in lines)


def test_probe_routes_name_every_variant():
    """Every timed variant resolves to one route of ROUTES, and its plain
    pass equals its wrapper's pass (on the CPU, the same function)."""
    M, w = probe.make_inputs(torch.device("cpu"), 2, B + 64, 5)
    timed = [v for v in probe.VARIANTS if v not in probe.CHECKS]
    assert {probe.ALIASES.get(v, v) for v in timed} == set(probe.ROUTES)
    assert set(probe.ALIASES.values()) <= set(probe.ROUTES)
    for v in timed:
        assert torch.equal(probe.pass_fn(v, M, w)(3), probe.pass_fn(v, M, w, plain=True)(3)), v


def test_probe_cur_reads_salted_weights():
    """pass s of a cur variant takes the weights plus s, as every other
    variant's kernel does inside."""
    M, w = probe.make_inputs(torch.device("cpu"), 2, B, 6)
    n_bins = probe.n_bins_for(2)
    fn = probe.pass_fn("cur2", M, w)
    for s in (0, 7):
        assert torch.equal(fn(s), hk.fused_hist_ref(M, w + s, n_bins))


def test_probe_times_each_call_once(monkeypatch):
    """Aliases of one call are timed once and reported from that timing."""
    calls = []

    def fake(fn, k, device):
        calls.append(k)
        return 1e-3 * len(calls)

    monkeypatch.setattr(probe, "pass_seconds", fake)
    M, w = probe.make_inputs(torch.device("cpu"), 2, B, 7)
    times = probe.run(["pc", "pcl", "cur1", "cur2", "cur3", "read"], 2, M, w, out=lambda s: None)
    assert len(calls) == 2 * 3
    assert times["pc"] is times["pcl"] and times["cur1"] is times["cur3"]
    assert times["read"] == [3e-3, 6e-3]


def test_probe_pass_work_at_the_probe_shape():
    """pt_limb_hist at 3 limbs on 32 x 2^23: 2 * 36 * 32 * 2^23 * 3 int8
    products (36 coarse bins of 1026 bins padded to 1152); every variant
    reads M and the weights once."""
    M = torch.empty((32, 1 << 23), dtype=torch.int32, device="meta")
    w = torch.empty((1, 1 << 23), dtype=torch.int32, device="meta")
    read = probe.pass_bytes(M, w)
    assert read == (33 << 23) * 4
    assert probe.pass_work("fh23", M, w) == (read + 3 * 1152 * 8, 2 * 36 * 32 * (1 << 23) * 3, True)
    assert probe.pass_work("old1", M, w)[1] == 2 * 36 * 32 * (1 << 23)
    assert probe.pass_work("read", M, w) == (read + 4, (1 << 23) * 33, False)
    assert probe.pass_work("pcl", M, w) == (read + 4 * B, (1 << 23) * 64, False)
    assert probe.pass_work("cur3", M, w) == (read + 1026 * 8, (1 << 23) * 65, False)


def test_probe_slope_must_grow(monkeypatch):
    """A chain whose time does not grow with its length gives no number."""
    monkeypatch.setattr(probe, "_chain_seconds", lambda fn, k, device: 1.0)
    with pytest.raises(probe.ProbeError):
        probe.pass_seconds(lambda s: None, 4, torch.device("cpu"))


def test_wrappers_reject_bad_operands():
    M = torch.zeros((2, 8), dtype=torch.int32)
    w = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        pk.xor_fold(M, torch.zeros((2, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        pk.word_fold(M, w.to(torch.int64))
    with pytest.raises(ValueError):
        pk.word_fold(M, w, op="cast", mma_cov=True)
    with pytest.raises(ValueError):
        pk.limb_hist(M, w, 66, n_limbs=5)
    with pytest.raises(ValueError):
        pk.limb_hist(M, w, 66, weight_side="middle")
    with pytest.raises(ValueError):  # 240 coarse bins: past a byte's rows
        pk.limb_hist(M, w, 240 * 32 + 1)
    with pytest.raises(ValueError):  # more words than two stages hold
        pk.limb_hist(torch.zeros((129, 8), dtype=torch.int32), w, 66)
    with pytest.raises(ValueError):  # too many product tiles per block
        pk.limb_hist(M, torch.zeros((3, 8), dtype=torch.int32), 32 * 32 + 2, 3)


# -- pt_limb_hist's operand registers, emulated ------------------------------


def _byte_ne80(x, key, small):
    """csrc/probe.cu:byte_ne80 on Python ints of 32 bits: bit 7 of a byte
    set where x and key differ there (small: every byte below 128)."""
    d = x ^ key
    t = (d + 0x7F7F7F7F) if small else (((d & 0x7F7F7F7F) + 0x7F7F7F7F) | d)
    return t & 0xFFFFFFFF


def _onehot(x, key, small, sel=None):
    """onehot (sel None: bytes of 1) or onehot_sel (the bytes of sel where
    the byte of x equals the key's; prmt's sign mode as * 0xFF)."""
    eq = (~_byte_ne80(x, key, small) >> 7) & 0x01010101
    return eq if sel is None else (eq * 0xFF) & sel


def _bytes(x):
    return [(x >> (8 * b)) & 0xFF for b in range(4)]


@pytest.mark.parametrize("n_words,n_limbs,side", [(3, 2, "fine"), (3, 3, "coarse"),
                                                  (40, 1, "fine"), (40, 2, "coarse"),
                                                  (120, 1, "fine"), (120, 1, "coarse")])
def test_limb_hist_operand_registers(n_words, n_limbs, side):
    """One 256-item stage of pt_limb_hist: the packed quads (coarse bin, 127
    or 255 past the slice; fine bin; limb bytes of the salted weights), each
    lane's A and B registers built by byte compares as the kernel builds
    them (the shorter compare up to 112 coarse bins, 120 words past it), and
    m16n8k32 products by the PTX fragment layout, equal limb_hist_ref."""
    n_items, hi, salt = 256, 244, -5  # 12 items past the slice's end
    M, W = _inputs(n_words, n_items, 1, 2**31, 70 + n_words)
    n_bins = 32 * n_words + 2
    n_coarse = pk.n_coarse_for(n_bins)
    coarse_pad = (n_coarse + 15) // 16 * 16
    cov = np.array([sum(bin(int(m)).count("1") for m in M[:, i]) for i in range(n_items)])
    ws = _salted(W, salt)[0].view(np.uint32).astype(np.uint64)
    small = coarse_pad <= 112
    past = 127 if small else 255
    coarse = np.where(np.arange(n_items) < hi, np.minimum(cov >> 5, past), past)

    def quads(b):  # item bytes -> one word per quad
        b = np.asarray(b, dtype=np.uint64).reshape(-1, 4)
        return b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16 | b[:, 3] << 24

    cq, fq = quads(coarse), quads(cov & 31)
    lq = [quads((ws >> (8 * j)) & 0xFF) for j in range(n_limbs)]
    H = np.zeros((n_limbs, coarse_pad, FINE), dtype=np.int64)
    for st in range(8):  # k32 steps
        for l in range(n_limbs):
            for mt in range(coarse_pad // 16):
                for nh in range(2):
                    A = np.zeros((16, 32), dtype=np.int64)
                    B = np.zeros((32, 16), dtype=np.int64)
                    for lane in range(32):
                        gid, tig = lane >> 2, lane & 3
                        q = [8 * st + tig, 8 * st + 4 + tig]
                        cqs = [int(cq[k]) for k in q]
                        fqs = [int(fq[k]) for k in q]
                        rk = [(16 * mt + gid + 8 * e) * 0x01010101 for e in (0, 1)]
                        ck = [(16 * nh + gid + 8 * e) * 0x01010101 for e in (0, 1)]
                        sel = [int(lq[l][q[h]]) for h in (0, 1)]
                        for h in (0, 1):  # items 4 tig + .. and 16 + 4 tig + ..
                            for e in (0, 1):  # rows gid, gid + 8; n8 tiles 0, 1
                                if side == "coarse":
                                    a = _onehot(cqs[h], rk[e], small, sel[h])
                                    b = _onehot(fqs[h], ck[e], True)
                                else:
                                    a = _onehot(cqs[h], rk[e], small)
                                    b = _onehot(fqs[h], ck[e], True, sel[h])
                                k0 = 16 * h + 4 * tig
                                A[gid + 8 * e, k0 : k0 + 4] = _bytes(a)
                                B[k0 : k0 + 4, 8 * e + gid] = _bytes(b)
                    H[l, 16 * mt : 16 * mt + 16, 16 * nh : 16 * nh + 16] += A @ B
    got = H[:, :n_coarse].reshape(n_limbs, n_coarse * FINE)
    want = pk.limb_hist_ref(_t(M[:, :hi]), _t(W[:, :hi]), n_bins, n_limbs, salt)
    np.testing.assert_array_equal(got, want.numpy())


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (no CUDA device here)")
    return torch.device("cuda")


def _on(dev, *arrays):
    return [_t(a).to(dev) for a in arrays]


# (n_words, n_items): whole blocks, a ragged last block, fewer items than a
# block, more than 32 words (two k32 steps of the tensor-core coverage)
CUDA_SHAPES = [(32, 4 * B), (3, 2 * B + 4 * 37), (5, 1000), (40, B + 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_words,n_items", CUDA_SHAPES)
def test_folds_match_plain_on_cuda(cuda_device, n_words, n_items):
    M_np, W_np = _inputs(n_words, n_items, 1, 2**31, 50)
    M, W = _on(cuda_device, M_np, W_np)
    for salt in (0, 2**31 - 1, -5):  # W + salt wraps negative
        before = dict(kernels.launches)
        got = pk.xor_fold(M, W, salt)
        torch.cuda.synchronize()
        assert kernels.launches["pt_xor_fold"] == before["pt_xor_fold"] + 1
        assert torch.equal(got, pk.xor_fold_ref(M, W, salt))
        for op, mma in (("popc", False), ("popc", True), ("cast", False)):
            got = pk.word_fold(M, W, salt, op, mma)
            want = pk.word_fold_ref(M, W, salt, op, mma)
            assert torch.equal(got, want), (op, mma, salt)
            if op == "cast":
                assert (want < 0).any()  # the int32 sums wrapped


@pytest.mark.cuda
@pytest.mark.parametrize("n_words,n_items", CUDA_SHAPES)
@pytest.mark.parametrize("n_vecs", [1, 2])
def test_limb_hist_matches_plain_on_cuda(cuda_device, n_words, n_items, n_vecs):
    n_bins = min(32 * n_words + 2, 1026)
    M_np, W_np = _inputs(n_words, n_items, n_vecs, 2**31, 60 + n_vecs)
    M, W = _on(cuda_device, M_np, W_np)
    for n_limbs in (1, 2, 3, 4):
        for side, mma in (("coarse", False), ("fine", False), ("fine", True)):
            if n_limbs * n_vecs * ((pk.n_coarse_for(n_bins) + 15) // 16) * 2 > pk.MAX_UNITS:
                continue
            for salt in (-7, 2**31 - 5):  # both wrap some weights negative
                got = pk.limb_hist(M, W, n_bins, n_limbs, salt, side, mma)
                want = pk.limb_hist_ref(M, W, n_bins, n_limbs, salt, side, mma)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (n_limbs, side, mma, salt)


@pytest.mark.cuda
def test_limb_hist_at_the_slice_cap_on_cuda(cuda_device):
    """2^24 items on at most one block per slice: two slices of exactly 2^23
    items, 2^15 stages of 256 each. Every weight byte is 255 and every
    coverage 4, so one bin per limb sums 255 * 2^23 per slice (just below
    2^31: the eight warps' int32 sums of a block meet in one shared int32,
    still exact) and 255 * 2^24 in all."""
    n_items = 1 << 24
    M = torch.full((1, n_items), 0x0F, dtype=torch.int32, device=cuda_device)
    W = torch.full((1, n_items), 0x00FFFFFF, dtype=torch.int32, device=cuda_device)
    for side, mma in (("coarse", False), ("fine", False), ("fine", True)):
        got = pk.limb_hist(M, W, 34, 3, 0, side, mma, _max_blocks=1)
        torch.cuda.synchronize()
        assert got[:, 4].tolist() == [255 * n_items] * 3
        assert int(got.sum()) == 3 * 255 * n_items
        assert torch.equal(got, pk.limb_hist_ref(M, W, 34, 3, 0, side, mma))


@pytest.mark.cuda
def test_probe_on_cuda(cuda_device):
    M, w = probe.make_inputs(cuda_device, 32, 1 << 20, 0)
    assert probe.parity(M, w, mma_cov=False) and probe.parity(M, w, mma_cov=True)
    times = probe.run(["read", "pc", "fh23"], 1, M, w, out=lambda s: None)
    assert all(t[0] > 0 for t in times.values())
    assert probe.read_ceiling_bps(cuda_device, 32, 1 << 20) > 0
