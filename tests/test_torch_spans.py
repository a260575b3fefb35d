"""The port's span record (panacus_torch.runtime.span) on the CPU.

A `histgrowth -c all -H` under torch.profiler records every span of a
command: `command` at the root, the CLI's parse, write and release, the
index's scan, nodes and paths, the L-line indexer's submit and the indexer
on its worker thread, the build's allocations, tokenize, pack, edge pack,
wait and finalize, and the phases, each under its parent, all with one
command id, their counts filled. With no profiler a span records nothing and opens no
record_function, while phase_timer still logs. Every span on the main
thread lies where its record_function twin lies in the profiler's events
(the same clock). A full record counts what it drops, also when more
threads than cores record at once. The two records that
benchmark/harness.py parses keep their form.

Graph: testgraphs.make_graph at 3000 nodes with 300 paths (300 groups, 10
slabs).
"""

from __future__ import annotations

import contextlib
import io
import logging
import os
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from panacus_torch import runtime, testgraphs
from panacus_torch.cli import run_cli
from panacus_torch.gfa import GraphStorage

CPU = (torch.device("cpu"),)
ARGV = ["histgrowth", "-H", "-q", "0,0.5,1", "-l", "0,1,2", "-c", "all"]
N_SLABS = 10

# name -> the name of its parent
PARENTS = {
    "command": None,
    "cli.parse": "command",
    "index": "command",
    "index.scan": "index",
    "index.nodes": "index",
    "index.paths": "index",
    "index.edges": "index",
    "edge_index": "index",
    "abaci_by_total": "command",
    "build.alloc": "abaci_by_total",
    "build.tokenize": "abaci_by_total",
    "build.pack": "abaci_by_total",
    "edge_index.wait": "abaci_by_total",
    "edge_index.adj": "abaci_by_total",
    "build.edge_pack": "abaci_by_total",
    "build.finalize": "abaci_by_total",
    "hists": "command",
    "growth": "command",
    "cli.write": "command",
    "cli.release": "command",
}


@pytest.fixture(scope="module")
def gfa(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("spans") / "g300.gfa")
    testgraphs.make_graph(path, n_nodes=3000, n_paths=300)
    return path


@pytest.fixture(autouse=True)
def fresh_record():
    runtime.reset_spans()
    yield
    runtime.reset_spans()


def _cli(gfa):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run_cli(ARGV + [gfa], devices=CPU) == 0
    return out.getvalue()


def _late_indexer(monkeypatch):
    """Hold the L-line indexer until the last slab is tokenized, and 50 ms
    longer: every edge slab is stashed, and the build waits for the index."""
    go = threading.Event()
    index_edges = GraphStorage._index_edges
    tokenize = GraphStorage.all_path_item_runs
    calls = []

    def held(self, *a, **k):
        assert go.wait(30)
        return index_edges(self, *a, **k)

    def counted(self, *a, **k):
        calls.append(1)
        if len(calls) == N_SLABS:
            threading.Timer(0.05, go.set).start()
        return tokenize(self, *a, **k)

    monkeypatch.setattr(GraphStorage, "_index_edges", held)
    monkeypatch.setattr(GraphStorage, "all_path_item_runs", counted)


def _profiled(gfa):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        text = _cli(gfa)
    return prof, text


def test_a_traced_command_records_every_span(gfa, monkeypatch):
    _late_indexer(monkeypatch)
    _, text = _profiled(gfa)
    got = runtime.spans()
    assert runtime.spans_dropped() == 0
    by_id = {r.id: r for r in got}
    names = {r.name for r in got}
    assert names == set(PARENTS), names ^ set(PARENTS)
    (command,) = [r for r in got if r.name == "command"]
    for r in got:
        want = PARENTS[r.name]
        assert (by_id[r.parent].name if r.parent is not None else None) == want, r
        assert r.command == command.id, r
        assert r.start_ns <= r.end_ns
    main = threading.get_ident()
    for r in got:
        assert (r.thread == main) == (r.name != "edge_index"), r

    def one(name):
        (r,) = [r for r in got if r.name == name]
        return r.counts

    assert one("index.scan")["bytes"] == os.path.getsize(gfa)
    assert one("index.scan")["lines"] > 3000 + 300
    assert one("index.nodes") == {"nodes": 3000}
    assert one("index.paths") == {"paths": 300}
    assert one("edge_index")["edges"] > 0
    assert one("abaci_by_total") == {
        "edge_slabs": N_SLABS,
        "edge_slabs_repacked": N_SLABS,
        "node_slabs": N_SLABS,
        "node_slabs_on_device": 0,  # -c all: the node rows are packed on the host
    }
    assert one("build.edge_pack") == {"slabs": N_SLABS}
    assert one("cli.write") == {"bytes": len(text)}
    for name in ("build.tokenize", "build.pack"):
        slabs = sorted(r.counts["slab"] for r in got if r.name == name)
        assert slabs == list(range(N_SLABS)), name


def test_b_untraced_spans_record_nothing(gfa, monkeypatch, caplog):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with caplog.at_level(logging.INFO, logger="panacus"):
        _cli(gfa)
    assert runtime.spans() == [] and runtime.spans_dropped() == 0
    phases = {r.args[0] for r in caplog.records if r.msg == "phase %s done; time elapsed: %.3fs"}
    assert {"index", "abaci_by_total", "hists", "growth"} <= phases


def test_c_main_thread_spans_sit_on_their_twins(gfa):
    prof, _ = _profiled(gfa)
    main = threading.get_ident()
    spans = sorted((r for r in runtime.spans() if r.thread == main), key=lambda r: r.start_ns)
    assert spans
    twins = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in PARENTS:
            twins.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    worst = 0
    for name in {r.name for r in spans}:
        mine = [(r.start_ns, r.end_ns) for r in spans if r.name == name]
        theirs = sorted(twins.get(name, []))
        assert len(mine) == len(theirs), name
        for (a, b), (ta, tb) in zip(mine, theirs):
            worst = max(worst, abs(a - ta), abs(b - tb))
    assert worst <= 5_000_000, worst


def test_d_a_full_record_counts_its_drops(gfa):
    runtime.reset_spans(capacity=4)
    _profiled(gfa)
    kept = runtime.spans()
    assert len(kept) == 4
    dropped = runtime.spans_dropped()
    assert dropped > 0
    last_kept = max(r.end_ns for r in kept)
    assert runtime.spans_dropped(0, kept[0].start_ns) == 0
    assert runtime.spans_dropped(last_kept, None) == dropped


def test_e_the_harness_records_keep_their_form(gfa, caplog):
    with caplog.at_level(logging.INFO, logger="panacus"):
        _profiled(gfa)
    phases = [r for r in caplog.records if str(r.msg).startswith("phase %s done")]
    assert phases
    for r in phases:
        assert r.msg == "phase %s done; time elapsed: %.3fs"
        name, seconds = r.args
        assert isinstance(name, str) and isinstance(seconds, float)
    builds = [r for r in caplog.records if str(r.msg).startswith("streamed membership build")]
    assert len(builds) == 1
    assert sum(r.args[0] == "abaci_by_total" for r in phases) == 1


def test_f_threads_share_the_record():
    """More threads than cores record at once, switching as often as the
    interpreter lets them: every span is kept or counted as dropped, once."""
    capacity, n_threads, each = 1000, 2 * (os.cpu_count() or 1) + 1, 200
    runtime.reset_spans(capacity=capacity)

    def work():
        for _ in range(each):
            with runtime.span("s", handoff=(None, None)):
                pass

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    kept = runtime.spans()
    assert len(kept) == capacity and None not in kept
    assert len({r.id for r in kept}) == capacity
    assert runtime.spans_dropped() == n_threads * each - capacity
