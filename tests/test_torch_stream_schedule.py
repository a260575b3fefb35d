"""The streamed build's schedule: the port's one (serial, fused) schedule
against panacus_tpu's streamed build under each of its schedules.

panacus_torch.stream.streamed_total_abaci tokenizes and packs every slab on
one thread (the JAX package's serial schedule; its pipelined two-thread
schedule is not ported, see the module docstring). On the CPU the port
must give what panacus_tpu's streamed build gives, serial or pipelined
(PANACUS_TPU_STREAM_SERIAL), exactly: the hists and per-item coverage of
every count type, paths_len, the path order and groups, and every path's
slice of the item tables; and the histgrowth TSVs apart from `#` lines.
Graphs: testgraphs.make_graph at 3000 nodes with 90 paths (-H: 90 groups,
3 slabs) and with 300 paths (300 groups, 10 slabs), plain and as one gzip
member, for -c all, node only and edge only. A tokenizer that bails makes
the build return None and discard its half-fed streams. A torch.profiler
run of `histgrowth -c all` finds the phase scopes of runtime.phase_timer
and one `build.tokenize` and one `build.pack` scope a slab. On the card,
the 10-slab build's M equals the CPU's.
"""

from __future__ import annotations

import logging

import numpy as np
import pytest
import torch

from panacus_torch import stream, testgraphs
from panacus_torch.cli import run_cli as torch_cli
from panacus_torch.ops.engine import MembershipStream

HG = ["histgrowth", "-H", "-q", "0,0.5,1", "-l", "0,1,2"]
COUNTS = {"all": ("node", "bp", "edge"), "node": ("node",), "edge": ("edge",)}
JAX_SCHEDULES = {"serial": "1", "pipelined": "0"}  # PANACUS_TPU_STREAM_SERIAL


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_schedule")
    out = {}
    for n_paths in (90, 300):
        gfa = str(d / f"g{n_paths}.gfa")
        testgraphs.make_graph(gfa, n_nodes=3000, n_paths=n_paths)
        out[(n_paths, False)] = gfa
        out[(n_paths, True)] = testgraphs.write_gzip(gfa, gfa + ".gz")
    return out


def _port_build(gfa, counts, device=torch.device("cpu")):
    from panacus_torch.gfa import GraphStorage
    from panacus_torch.mask import GraphMask, GraphMaskParameters
    from panacus_torch.utils import CountType

    cts = [CountType[c.upper()] for c in counts]
    g = GraphStorage(gfa, index_edges="edge" in counts)
    mask = GraphMask.from_datamgr(GraphMaskParameters(groupby_haplotype=True), g)
    return g, stream.streamed_total_abaci(g, mask, cts, (device,))


def _jax_build(gfa, counts):
    from panacus_tpu.gfa import GraphStorage
    from panacus_tpu.mask import GraphMask, GraphMaskParameters
    from panacus_tpu.stream import streamed_total_abaci
    from panacus_tpu.utils import CountType

    cts = [CountType[c.upper()] for c in counts]
    g = GraphStorage(gfa, index_edges="edge" in counts)
    mask = GraphMask.from_datamgr(GraphMaskParameters(groupby_haplotype=True), g)
    return g, streamed_total_abaci(g, mask, cts)


def _hists(abaci, construct_hists):
    hists = construct_hists(abaci)
    return {
        ct.name: (np.asarray(hists[ct]), np.asarray(ab.countable))
        for ct, ab in abaci.items()
    }


def _paths_len(itemized):
    return {str(seg): v for seg, v in itemized.paths_len.items()}


def _slices(g, itemized):
    n = len(g.path_segments)
    return [[np.asarray(t.path_slice(p)) for p in range(n)] for t in itemized.item_tables]


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
@pytest.mark.parametrize("counts", list(COUNTS), ids=[f"c_{c}" for c in COUNTS])
@pytest.mark.parametrize("n_paths", [90, 300], ids=["3slabs", "10slabs"])
def test_streamed_build_equals_jax(graphs, n_paths, counts, gz, monkeypatch):
    pytest.importorskip("jax")
    from panacus_torch.abacus import construct_hists as port_hists
    from panacus_tpu.abacus import construct_hists as jax_hists

    gfa = graphs[(n_paths, gz)]
    g, res = _port_build(gfa, COUNTS[counts])
    assert res is not None
    abaci, itemized, path_order, groups = res
    assert len(groups) == n_paths
    got = _hists(abaci, port_hists)
    for schedule, env in JAX_SCHEDULES.items():
        monkeypatch.setenv("PANACUS_TPU_STREAM_SERIAL", env)
        jg, jres = _jax_build(gfa, COUNTS[counts])
        assert jres is not None
        want = _hists(jres[0], jax_hists)
        assert got.keys() == want.keys()
        for name, (h, cov) in want.items():
            np.testing.assert_array_equal(got[name][0], h, err_msg=f"{schedule} {name} hist")
            np.testing.assert_array_equal(got[name][1], cov, err_msg=f"{schedule} {name} cov")
        assert _paths_len(itemized) == _paths_len(jres[1])
        assert path_order == jres[2] and groups == jres[3]
        for tab, tab_j in zip(_slices(g, itemized), _slices(jg, jres[1])):
            for s, j in zip(tab, tab_j):
                np.testing.assert_array_equal(s, j)


def _body(out: str) -> str:
    return "".join(l for l in out.splitlines(True) if not l.startswith("#"))


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
@pytest.mark.parametrize("counts", list(COUNTS), ids=[f"c_{c}" for c in COUNTS])
@pytest.mark.parametrize("n_paths", [90, 300], ids=["3slabs", "10slabs"])
def test_tsv_equals_jax_under_each_of_its_schedules(
    graphs, n_paths, counts, gz, capsys, monkeypatch
):
    pytest.importorskip("jax")
    from panacus_tpu.cli import run_cli as jax_cli

    argv = HG + ["-c", counts, graphs[(n_paths, gz)]]
    monkeypatch.setenv("PANACUS_TORCH_DEVICE", "cpu")
    assert torch_cli(argv) == 0
    got = _body(capsys.readouterr().out)
    assert f"\n{n_paths}\t" in got  # a row for every group count
    for schedule, env in JAX_SCHEDULES.items():
        monkeypatch.setenv("PANACUS_TPU_STREAM_SERIAL", env)
        assert jax_cli(argv) == 0
        assert _body(capsys.readouterr().out) == got, schedule


@pytest.mark.parametrize("threads", ["1", "2", "8"])
def test_tsv_at_each_thread_count(graphs, threads, capsys, monkeypatch, caplog):
    """`-t 1`, `-t 2` and `-t 8` take the streamed build and give
    panacus_tpu's TSV."""
    pytest.importorskip("jax")
    from panacus_tpu.cli import run_cli as jax_cli

    monkeypatch.setenv("PANACUS_TORCH_DEVICE", "cpu")
    argv = HG + ["-c", "all", "-t", threads, graphs[(300, False)]]
    with caplog.at_level(logging.INFO, logger="panacus"):
        caplog.clear()
        assert torch_cli(argv) == 0
    got = _body(capsys.readouterr().out)
    assert "streamed membership build: 10 slabs" in caplog.text
    assert jax_cli(argv) == 0
    assert _body(capsys.readouterr().out) == got


def _flaky(monkeypatch, bail_at):
    """all_path_item_runs returns None on its bail_at-th call."""
    from panacus_torch.gfa import GraphStorage

    calls = []
    real = GraphStorage.all_path_item_runs

    def flaky(self, path_indices=None, pack=None):
        calls.append(1)
        return None if len(calls) == bail_at else real(self, path_indices, pack)

    monkeypatch.setattr(GraphStorage, "all_path_item_runs", flaky)
    return calls


@pytest.mark.parametrize("counts", ["all", "node", "edge"])
def test_tokenizer_bail_returns_none(graphs, monkeypatch, counts):
    """all_path_item_runs returning None on the second slab: the build
    returns None (the classic itemizer runs) and discards every stream it
    made."""
    discarded = []
    real = MembershipStream.discard

    def discard(self):
        discarded.append(self)
        real(self)

    monkeypatch.setattr(MembershipStream, "discard", discard)
    calls = _flaky(monkeypatch, 2)
    _, res = _port_build(graphs[(300, False)], COUNTS[counts])
    assert res is None
    assert len(calls) == 2
    # node-only and all make a node stream; the edge stream exists once
    # the edge index was ready before the bail
    assert 1 <= len(discarded) <= (1 if counts != "all" else 2)
    assert all(s._M_host is None for s in discarded)


def test_bail_then_classic_cli_equals_streamed(graphs, monkeypatch, capsys):
    """Through the CLI, a bail falls back to the classic itemizer, whose
    TSV equals the streamed one."""
    monkeypatch.setenv("PANACUS_TORCH_DEVICE", "cpu")
    argv = HG + ["-c", "all", graphs[(300, False)]]
    assert torch_cli(argv) == 0
    want = _body(capsys.readouterr().out)
    calls = _flaky(monkeypatch, 3)
    assert torch_cli(argv) == 0
    assert _body(capsys.readouterr().out) == want
    assert len(calls) >= 3


def test_profiler_finds_phase_and_slab_scopes(graphs, monkeypatch, capsys):
    """A torch.profiler run of a CPU `histgrowth -c all`: the phase scopes
    of phase_timer and the `build.tokenize` and `build.pack` scopes of
    every slab, on the thread of `abaci_by_total`."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setenv("PANACUS_TORCH_DEVICE", "cpu")
    argv = HG + ["-c", "all", graphs[(300, False)]]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch_cli(argv) == 0
    capsys.readouterr()
    threads = {}
    for e in prof.events():
        threads.setdefault(e.name, set()).add(e.thread)
    for phase in ("index", "abaci_by_total", "hists", "growth"):
        assert phase in threads, sorted(threads)
    for scope in ("build.tokenize", "build.pack"):
        assert threads.get(scope) == threads["abaci_by_total"], scope
        assert sum(e.name == scope for e in prof.events()) == 10, scope


@pytest.mark.cuda
@pytest.mark.parametrize("counts", list(COUNTS), ids=[f"c_{c}" for c in COUNTS])
def test_streamed_m_on_the_card_equals_the_cpu(graphs, counts):
    """The 10-slab build on cuda:0 (pinned host rows, asynchronous copies)
    gives the CPU build's M on every shard, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (no CUDA device here)")
    gfa = graphs[(300, False)]
    _, cpu = _port_build(gfa, COUNTS[counts])
    _, card = _port_build(gfa, COUNTS[counts], torch.device("cuda", 0))
    assert cpu is not None and card is not None
    for ct in cpu[0]:
        got = [m.cpu() for m in card[0][ct].engine.shards]
        want = cpu[0][ct].engine.shards
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w), ct
