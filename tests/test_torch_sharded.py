"""The port's engine split over several devices, against panacus_tpu's.

The counterpart of tests/test_sharded_dispatch.py and
tests/test_gspmd_engine.py. panacus_tpu shards its engine over the 8
virtual CPU devices of tests/conftest.py; the port's CountingEngine is
given a tuple of k CPU devices (one item shard each, k in 1, 2, 3, 8) and
must give exactly the JAX engine's coverage, hist, hist_multi (all-ones
and bp-sized weights), ordered growth (more than 32 groups) and
similarity. Further:

- a k-shard MembershipStream equals build_from_host_matrix;
- each plain kernel twin sees one shard's columns, and only partials of
  n_bins, n_groups or (32 n_words)^2 values come back (the twins are
  wrapped here), the counterpart of panacus_tpu's collective-free check;
- CountingEngine.build from (item, group) pairs equals panacus_tpu's bit
  for bit, duplicates and group 31 of a word included;
- histgrowth, ordered-histgrowth and similarity through the port's
  pipeline on 4 CPU shards equal panacus_tpu's CLI on the graphs of
  tests/test_torch_slice.py (the dryrun graph, make_graph at 3000 nodes);
- testgraphs.dryrun_multichip passes on 8 CPU shards.

Inputs come from seeded numpy. The tests marked `cuda` hold shards on the
card against one device on the card.
"""

from __future__ import annotations

import contextlib
import functools
import io

import numpy as np
import pytest
import torch

from panacus_torch.ops import group_kernels as gk
from panacus_torch.ops import hist_kernels as hk
from panacus_torch.ops.engine import (
    ITEM_ALIGN,
    CountingEngine,
    MembershipStream,
    as_devices,
)
from test_torch_slice import graphs  # noqa: F401 (fixture)

CPU = torch.device("cpu")
SHARDS = [1, 2, 3, 8]
N_ITEMS, N_GROUPS = 3001, 70  # three words; group 63 % 32 == 31 is used
QC = [(0.0, 1), (0.5, 1), (1.0, 1), (0.0, 2), (0.5, 2), (1.0, 2)]


def _pairs(rng, n_items: int, n_groups: int, n_pairs: int):
    """Random occurrence pairs with duplicates, every group and items
    1..n_items."""
    items = rng.integers(1, n_items + 1, size=n_pairs).astype(np.int64)
    groups = rng.integers(0, n_groups, size=n_pairs).astype(np.int64)
    items[:n_groups], groups[:n_groups] = 1 + np.arange(n_groups), np.arange(n_groups)
    return items, groups


def _host_matrix(items, groups, n_words: int, n_items_pad: int) -> np.ndarray:
    M = np.zeros((n_words, n_items_pad), dtype=np.uint32)
    np.bitwise_or.at(M, (groups >> 5, items), np.uint32(1) << (groups & 31).astype(np.uint32))
    return M


def _port_matrix(eng: CountingEngine) -> np.ndarray:
    """The engine's shards side by side, as uint32 on the host."""
    return np.concatenate([m.cpu().numpy() for m in eng.shards], axis=1).view(np.uint32)


@functools.lru_cache(maxsize=None)
def _inputs():
    """(items, groups, bp weights, ordered-growth weights), from a seed."""
    rng = np.random.default_rng(8)
    items, groups = _pairs(rng, N_ITEMS, N_GROUPS, 40_000)
    bp = rng.integers(1, 1 << 20, N_ITEMS + 1)
    bp[0] = 0
    w_ord = rng.integers(0, 1000, N_ITEMS + 1)
    w_ord[0] = 0
    return items, groups, bp, w_ord


@functools.lru_cache(maxsize=None)
def _case():
    """(bp weights, ordered weights, results of panacus_tpu's engine on the
    same pairs, sharded over the suite's 8 devices)."""
    import jax

    from panacus_tpu.ops.engine import CountingEngine as JaxEngine
    from panacus_tpu.ops.engine import item_mesh_of

    items, groups, bp, w_ord = _inputs()
    jeng = JaxEngine(N_ITEMS, N_GROUPS)
    jeng.build_from_host_matrix(_host_matrix(items, groups, jeng.n_words, jeng.n_items_pad))
    assert len(jax.devices()) == 8 and item_mesh_of(jeng.M) is not None
    want = {
        "coverage": jeng.coverage(),
        "hist": jeng.hist(),
        "hist_multi": jeng.hist_multi([None, bp]),
        "ordered": [jeng.ordered_growth(w_ord, q, c) for q, c in QC],
        "similarity": jeng.similarity(bp),
    }
    return bp, w_ord, want


def _engine(devices) -> CountingEngine:
    """The engine of _inputs' pairs, adopted from the host-packed M."""
    items, groups, *_ = _inputs()
    eng = CountingEngine(N_ITEMS, N_GROUPS, devices)
    return eng.build_from_host_matrix(
        _host_matrix(items, groups, eng.n_words, eng.n_items_pad)
    )


@pytest.mark.parametrize("k", SHARDS)
def test_shards_split_the_item_axis(k):
    eng = _engine((CPU,) * k)
    assert eng.devices == (CPU,) * k and len(eng.shards) == k
    assert eng.n_items_pad % (ITEM_ALIGN * k) == 0
    for m, (lo, hi) in zip(eng.shards, eng.bounds):
        assert m.shape == (eng.n_words, hi - lo) and m.is_contiguous()
        assert hi - lo == eng.shard_items and eng.shard_items % ITEM_ALIGN == 0
    items, groups, *_ = _inputs()
    want = _host_matrix(items, groups, eng.n_words, eng.n_items_pad)
    np.testing.assert_array_equal(_port_matrix(eng), want)


@pytest.mark.parametrize("k", SHARDS)
def test_coverage_and_hists_match_jax(k):
    pytest.importorskip("jax")
    bp, _, want = _case()
    eng = _engine((CPU,) * k)
    np.testing.assert_array_equal(eng.coverage(), want["coverage"])
    np.testing.assert_array_equal(eng.hist(), want["hist"])
    got = eng.hist_multi([None, bp])
    assert all(h.dtype == np.int64 and len(h) == N_GROUPS + 1 for h in got)
    for g, w in zip(got, want["hist_multi"]):
        np.testing.assert_array_equal(g, w)
    assert got[0].sum() == N_ITEMS and got[1].sum() == bp.sum()


@pytest.mark.parametrize("k", SHARDS)
def test_ordered_growth_matches_jax(k):
    pytest.importorskip("jax")
    _, w_ord, want = _case()
    eng = _engine((CPU,) * k)
    for (q, c), w in zip(QC, want["ordered"]):
        got = eng.ordered_growth(w_ord, q, c)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, w, err_msg=f"q={q} c={c}")


@pytest.mark.parametrize("k", SHARDS)
def test_similarity_matches_jax(k):
    pytest.importorskip("jax")
    bp, _, want = _case()
    np.testing.assert_array_equal(_engine((CPU,) * k).similarity(bp), want["similarity"])


@pytest.mark.parametrize("k", [2, 3])
def test_membership_stream_on_shards_equals_host_matrix(k):
    """A stream fed word by word (one word left unfed) gives the engine that
    build_from_host_matrix gives on the same shards."""
    rng = np.random.default_rng(k)
    s = MembershipStream(N_ITEMS, N_GROUPS, (CPU,) * k)
    M = np.zeros((s.engine.n_words, s.engine.n_items_pad), dtype=np.uint32)
    M[(0, 2), 1 : N_ITEMS + 1] = rng.integers(0, 2**32, (2, N_ITEMS), dtype=np.uint32)
    M[2] &= np.uint32((1 << (N_GROUPS % 32)) - 1)
    for word in (2, 0):
        row = s.host_row(word)
        row[:] = M[word]
        s.feed(word, row)
    eng = s.finalize()
    want = CountingEngine(N_ITEMS, N_GROUPS, (CPU,) * k).build_from_host_matrix(M)
    assert len(eng.shards) == k
    for a, b in zip(eng.shards, want.shards):
        assert torch.equal(a, b)
    w = np.ones(N_ITEMS + 1, np.int64)
    w[0] = 0
    np.testing.assert_array_equal(eng.hist(), want.hist())
    np.testing.assert_array_equal(eng.ordered_growth(w, 0.5, 1), want.ordered_growth(w, 0.5, 1))


def test_kernels_see_one_shard_and_return_partials(monkeypatch):
    """Each ops function the engine calls (the kernel's wrapper, which runs
    its plain twin on the CPU) is called once per shard, on that shard's
    own tensor (its columns only) with that shard's weights, and hands back
    a partial of n_bins, n_groups or (32 n_words)^2 values (coverage: the
    shard's items)."""
    *_, bp, w_ord = _inputs()
    k = 3
    eng = _engine((CPU,) * k)
    seen = []
    mod = {"coverage": hk, "fused_hist": hk, "ordered_growth": gk, "similarity": gk}

    def spy(name, fn):
        def wrapped(M, *args):
            out = fn(M, *args)
            seen.append((name, M, args, out))
            return out

        return wrapped

    for name, m in mod.items():
        monkeypatch.setattr(m, name, spy(name, getattr(m, name)))
    eng.coverage()
    eng.hist_multi([None, bp])
    eng.ordered_growth(w_ord, 0.5, 2)
    eng.similarity(bp)
    g_pad = 32 * eng.n_words
    sizes = {
        "coverage": (eng.shard_items,),
        "fused_hist": (2, N_GROUPS + 2),
        "ordered_growth": (N_GROUPS,),
        "similarity": (g_pad, g_pad),
    }
    assert len(seen) == k * len(sizes)
    for name, size in sizes.items():
        calls = [c for c in seen if c[0] == name]
        assert len(calls) == k, name
        for s, (_, M, args, out) in enumerate(calls):
            assert M is eng.shards[s] and M.shape == (eng.n_words, eng.shard_items)
            if args:  # the weights: the shard's items only
                assert args[0].shape[-1] == eng.shard_items, (name, args[0].shape)
            assert tuple(out.shape) == size, (name, out.shape)
            if name != "coverage":
                assert out.dtype == torch.int64


@pytest.mark.parametrize(
    "n_groups,k,dedup", [(32, 1, True), (64, 3, True), (70, 2, True), (90, 8, False)]
)
def test_build_from_pairs_matches_jax(n_groups, k, dedup):
    """build from occurrence pairs equals panacus_tpu's CountingEngine.build
    bit for bit: duplicated pairs, pairs in no order, item 0 (the sentinel
    column), and group 31 of every word (the int32 sign bit)."""
    pytest.importorskip("jax")
    from panacus_tpu.ops.engine import CountingEngine as JaxEngine

    rng = np.random.default_rng(n_groups)
    n_items = 5000
    items, groups = _pairs(rng, n_items, n_groups, 30_000)
    high = np.arange(31, n_groups, 32)
    items = np.concatenate([items, np.zeros(3, np.int64), np.full(len(high), n_items)])
    groups = np.concatenate([groups, [0, 5, 31], high])
    if dedup:  # duplicated pairs, in no order
        items, groups = np.concatenate([items, items[:500]]), np.concatenate([groups, groups[:500]])
        perm = rng.permutation(len(items))
        items, groups = items[perm], groups[perm]
    else:  # distinct pairs, sorted, as panacus_tpu's build takes them
        key = np.unique(items * n_groups + groups)
        items, groups = key // n_groups, key % n_groups
    want = np.asarray(JaxEngine(n_items, n_groups).build(items, groups, dedup=dedup).M)
    eng = CountingEngine(n_items, n_groups, (CPU,) * k).build(items, groups, dedup=dedup)
    got = _port_matrix(eng)
    np.testing.assert_array_equal(got[:, : n_items + 1], want[:, : n_items + 1])
    assert not got[:, n_items + 1 :].any() and not want[:, n_items + 1 :].any()
    assert (got[high >> 5, n_items] >> 31).all()  # group 31 of a word: the sign bit
    one = CountingEngine(n_items, n_groups, CPU).build(items, groups, dedup=dedup)
    np.testing.assert_array_equal(eng.hist(), one.hist())


def test_build_rejects_pairs_out_of_range():
    eng = CountingEngine(10, 3, (CPU,) * 2)
    for items, groups in (([11], [0]), ([-1], [0]), ([1], [3]), ([1], [-1]), ([1, 2], [0])):
        with pytest.raises(ValueError):
            eng.build(np.array(items), np.array(groups))
    eng.build(np.array([], np.int64), np.array([], np.int64))
    assert not _port_matrix(eng).any()


def test_as_devices():
    assert as_devices(CPU) == (CPU,) and as_devices("cpu") == (CPU,)
    assert as_devices([CPU, "cpu"]) == (CPU, CPU)
    with pytest.raises(ValueError):
        as_devices(())


COMMANDS = [
    ["histgrowth", "-c", "all", "-S", "-q", "0,0.5,1", "-l", "0,1,2"],
    ["histgrowth", "-c", "bp", "-S", "-s", "{subset}"],
    ["ordered-histgrowth", "-c", "edge", "-S", "-q", "0,0.5,1", "-l", "1,1,2"],
    ["ordered-histgrowth", "-c", "bp", "-H", "-q", "0,1", "-l", "1,2"],
    ["similarity", "-c", "node", "-H"],
]


@pytest.mark.parametrize("graph", ["dryrun", "bench"])
@pytest.mark.parametrize("argv", COMMANDS, ids=["_".join(c[:3]) for c in COMMANDS])
def test_cli_on_four_cpu_shards_matches_jax(capsys, graphs, argv, graph):  # noqa: F811
    """The port's CLI with M split over (cpu,) * 4 gives panacus_tpu's TSV
    (the graphs of tests/test_torch_slice.py)."""
    pytest.importorskip("jax")
    from panacus_torch.cli import run_cli as torch_cli
    from panacus_tpu.cli import run_cli as jax_cli

    argv = [a.format(subset=graphs / "subset.bed") for a in argv] + [str(graphs / f"{graph}.gfa")]
    assert jax_cli(argv) == 0
    want = capsys.readouterr().out
    assert torch_cli(argv, devices=(CPU,) * 4) == 0
    got = capsys.readouterr().out

    def body(out):
        return [l for l in out.splitlines() if not l.startswith("#")]

    assert len(body(want)) > 4 and body(got) == body(want)


def test_pipeline_splits_every_engine(monkeypatch, graphs):  # noqa: F811
    """Every engine the pipeline builds lives on the tuple it was given."""
    from panacus_torch import stream
    from panacus_torch.cli import run_cli

    built = []
    real = stream.MembershipStream

    def spy(*args):
        s = real(*args)
        built.append(s.engine)
        return s

    monkeypatch.setattr(stream, "MembershipStream", spy)
    with contextlib.redirect_stdout(io.StringIO()):
        argv = ["histgrowth", "-c", "all", str(graphs / "dryrun.gfa")]
        assert run_cli(argv, devices=(CPU,) * 3) == 0
    assert len(built) == 2 and all(e.devices == (CPU,) * 3 for e in built)
    assert all(len(e.shards) == 3 for e in built)


def test_dryrun_multichip_on_eight_cpu_shards():
    from panacus_torch.testgraphs import dryrun_multichip

    out = dryrun_multichip((CPU,) * 8)
    assert out.startswith("dryrun_multichip ok: 8 shards on 1 distinct device(s)")


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (no CUDA device here)")
    return torch.device("cuda", 0)


def _card_shards(cuda_device):
    """Four shards on the first card, and one on each card where there are
    several."""
    n = torch.cuda.device_count()
    out = [(cuda_device,) * 4]
    if n > 1:
        out.append(tuple(torch.device("cuda", i) for i in range(n)))
    return out


@pytest.mark.cuda
def test_shards_on_the_card_equal_one_device(cuda_device):
    *_, bp, w_ord = _inputs()
    one = _engine(cuda_device)
    for devs in _card_shards(cuda_device):
        eng = _engine(devs)
        assert [m.device for m in eng.shards] == list(devs)
        np.testing.assert_array_equal(eng.coverage(), one.coverage())
        for a, b in zip(eng.hist_multi([None, bp]), one.hist_multi([None, bp])):
            np.testing.assert_array_equal(a, b)
        for q, c in QC:
            np.testing.assert_array_equal(
                eng.ordered_growth(w_ord, q, c), one.ordered_growth(w_ord, q, c)
            )
        np.testing.assert_array_equal(eng.similarity(bp), one.similarity(bp))


@pytest.mark.cuda
def test_stream_and_build_on_card_shards(cuda_device):
    """A stream on card shards equals the CPU stream; build from pairs on
    card shards equals the CPU build."""
    rng = np.random.default_rng(3)
    items, groups = _pairs(rng, N_ITEMS, N_GROUPS, 40_000)
    cpu = CountingEngine(N_ITEMS, N_GROUPS, CPU).build(items, groups)
    want = _port_matrix(cpu)
    for devs in _card_shards(cuda_device):
        eng = CountingEngine(N_ITEMS, N_GROUPS, devs).build(items, groups)
        np.testing.assert_array_equal(_port_matrix(eng)[:, : N_ITEMS + 1], want[:, : N_ITEMS + 1])
        s = MembershipStream(N_ITEMS, N_GROUPS, devs)
        for word in range(s.engine.n_words):
            row = s.host_row(word)
            row[: N_ITEMS + 1] = want[word, : N_ITEMS + 1]
            s.feed(word, row)
        streamed = s.finalize()
        np.testing.assert_array_equal(streamed.hist(), cpu.hist())
        np.testing.assert_array_equal(streamed.coverage(), cpu.coverage())
