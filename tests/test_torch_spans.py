"""The port's span record (panacus_torch.runtime.span) on the CPU.

A `histgrowth -c all -H` under torch.profiler records every span of a
command: `command` at the root, the CLI's parse, write and release, the
index's scan, nodes and paths, the L-line indexer's submit and the indexer
on its worker thread, the build's allocations, tokenize, pack, edge pack,
wait and finalize, and the phases, each under its parent, all with one
command id, their counts filled; then a `-c node` with the device route
forced onto the CPU adds the step-list upload on its worker thread
(`index.upload`), the build's stage, parse and wait, and the upload's
counts; a `-c all` on that route counts every edge slab on the device; a `similarity` formats its table in `write.format` under
`cli.write`; a `.gfa.gz` inflates in `index.inflate` under `index`, on
either route, and a plain file opens no such span. With no profiler a span
records nothing and opens no record_function, while phase_timer still
logs. Every span on the main thread lies where its record_function twin
lies in the profiler's events (the same clock). A full record counts what
it drops, also when more threads than cores record at once. The two
records that benchmark/harness.py parses keep their form.

Graph: testgraphs.make_graph at 3000 nodes with 300 paths (300 groups, 10
slabs).
"""

from __future__ import annotations

import contextlib
import gzip
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
    "index.inflate": "index",
    "index.scan": "index",
    "index.nodes": "index",
    "index.paths": "index",
    "index.edges": "index",
    "edge_index": "index",
    "index.upload": "index",
    "abaci_by_total": "command",
    "build.alloc": "abaci_by_total",
    "build.tokenize": "abaci_by_total",
    "build.pack": "abaci_by_total",
    "edge_index.wait": "abaci_by_total",
    "edge_index.adj": "abaci_by_total",
    "build.edge_pack": "abaci_by_total",
    "build.stage": "abaci_by_total",
    "build.parse": "abaci_by_total",
    "build.wait": "abaci_by_total",
    "build.finalize": "abaci_by_total",
    "hists": "command",
    "growth": "command",
    "cli.write": "command",
    "cli.release": "command",
}
# the spans of the device route (a node build, one card), which -c all skips
ROUTE = {"index.upload", "build.stage", "build.parse", "build.wait"}
# the span of a .gfa.gz input alone
GZ = {"index.inflate"}
# spans on a worker thread
WORKER = {"edge_index", "index.upload"}


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


def _cli(gfa, argv=ARGV):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run_cli(argv + [gfa], devices=CPU) == 0
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


def _profiled(gfa, argv=ARGV):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        text = _cli(gfa, argv)
    return prof, text


def _tree(got, want):
    """Every span of one command under its parent, with the command's id,
    on the main thread but for the workers' spans; the names are `want`."""
    assert runtime.spans_dropped() == 0
    by_id = {r.id: r for r in got}
    names = {r.name for r in got}
    assert names == want, names ^ want
    (command,) = [r for r in got if r.name == "command"]
    main = threading.get_ident()
    for r in got:
        assert (by_id[r.parent].name if r.parent is not None else None) == PARENTS[r.name], r
        assert r.command == command.id, r
        assert r.start_ns <= r.end_ns
        assert (r.thread == main) == (r.name not in WORKER), r

    def one(name):
        (r,) = [r for r in got if r.name == name]
        return r.counts

    return one


def test_a_traced_command_records_every_span(gfa, monkeypatch):
    """-c all, then -c node with the device route forced onto the CPU
    (`stream._parses_on`): the step-list upload the index starts, on its
    worker, and the build's stage, parse and wait."""
    from panacus_torch import stream

    _late_indexer(monkeypatch)
    _, text = _profiled(gfa)
    got = runtime.spans()
    one = _tree(got, set(PARENTS) - ROUTE - GZ)

    assert one("index.scan")["bytes"] == os.path.getsize(gfa)
    assert one("index.scan")["lines"] > 3000 + 300
    assert one("index.nodes") == {"nodes": 3000}
    assert one("index.paths") == {"paths": 300}
    assert one("edge_index")["edges"] > 0
    assert one("abaci_by_total") == {
        "edge_slabs": N_SLABS,
        "edge_slabs_repacked": N_SLABS,
        "edge_slabs_on_device": 0,  # the route needs a card: packed on the host
        "node_slabs": N_SLABS,
        "node_slabs_on_device": 0,
        "uploads": 0,
        "uploads_early": 0,
    }
    assert one("build.edge_pack") == {"slabs": N_SLABS}
    assert one("cli.write") == {"bytes": len(text)}
    for name in ("build.tokenize", "build.pack"):
        slabs = sorted(r.counts["slab"] for r in got if r.name == name)
        assert slabs == list(range(N_SLABS)), name

    monkeypatch.setattr(stream, "_parses_on", lambda device: True)
    runtime.reset_spans()
    node = ["histgrowth", "-H", "-q", "0,0.5,1", "-l", "0,1,2", "-c", "node"]
    _, text = _profiled(gfa, node)
    got = runtime.spans()
    one = _tree(got, set(PARENTS) - GZ - {
        "index.edges", "edge_index", "build.tokenize", "build.pack",
        "edge_index.wait", "edge_index.adj", "build.edge_pack"})
    g = GraphStorage(gfa, index_edges=False)
    lists = g._pw_seq_spans
    assert one("index.upload") == {"bytes": int(g._pw_ends[-1] - g._pw_starts[0])}
    assert one("build.stage") == {"bytes": max(e for _, e in lists) - min(b for b, _ in lists)}
    assert one("abaci_by_total") == {
        "node_slabs": N_SLABS,
        "node_slabs_on_device": N_SLABS,
        "uploads": 1,
        "uploads_early": 1,
    }
    assert one("cli.write") == {"bytes": len(text)}


def test_a_device_route_build_counts_its_edge_slabs(gfa, monkeypatch):
    """-c all with the device route forced onto the CPU: every edge slab's
    rows come from the card's pass (`edge_slabs_on_device` equals
    `edge_slabs`, none repacked), with no host tokenize or edge pack, and
    a parse and a wait for the node rows and for the edge rows."""
    from panacus_torch import stream

    monkeypatch.setattr(stream, "_parses_on", lambda device: True)
    _profiled(gfa)
    got = runtime.spans()
    names = [r.name for r in got]
    assert not {"build.tokenize", "build.pack", "build.edge_pack"} & set(names)
    assert names.count("build.parse") == names.count("build.wait") == 2
    (top,) = [r for r in got if r.name == "abaci_by_total"]
    assert top.counts == {
        "edge_slabs": N_SLABS,
        "edge_slabs_repacked": 0,
        "edge_slabs_on_device": N_SLABS,
        "node_slabs": N_SLABS,
        "node_slabs_on_device": N_SLABS,
        "uploads": 1,
        "uploads_early": 1,
    }


@pytest.mark.parametrize("route", ["libdeflate", "zlib"])
def test_a_gz_command_records_its_inflate(gfa, route, tmp_path, monkeypatch, caplog):
    """Two commands on the graph as one gzip member: each has one
    `index.inflate` under its `index`, on the main thread, counting the
    file's size, the inflated length and the route its log line names."""
    from panacus_torch import native

    if route == "zlib":
        monkeypatch.setattr(native, "_DEFLATE", None)
        monkeypatch.setattr(native, "_DEFLATE_TRIED", True)
    elif native._get_libdeflate() is None:
        pytest.skip("no system libdeflate: gz input takes the zlib stream (the zlib case)")
    with open(gfa, "rb") as f:
        data = f.read()
    gz = tmp_path / "g300.gfa.gz"
    gz.write_bytes(gzip.compress(data, compresslevel=1, mtime=0))
    with caplog.at_level(logging.INFO, logger="panacus"), \
            profile(activities=[ProfilerActivity.CPU]):
        texts = [_cli(str(gz)) for _ in range(2)]
    assert texts[0] == texts[1] == _cli(gfa)
    logged = [r.getMessage() for r in caplog.records if r.getMessage().startswith("gz ingest")]
    assert len(logged) == 2 and all(m.startswith(f"gz ingest: inflate by {route}") for m in logged)
    got = runtime.spans()
    assert runtime.spans_dropped() == 0
    by_id = {r.id: r for r in got}
    commands = {r.id for r in got if r.name == "command"}
    inflates = [r for r in got if r.name == "index.inflate"]
    assert len(commands) == 2 and sorted(r.command for r in inflates) == sorted(commands)
    for r in inflates:
        index = by_id[r.parent]
        assert index.name == "index" and index.start_ns <= r.start_ns <= r.end_ns <= index.end_ns
        assert r.thread == threading.get_ident()
        assert r.counts == {"bytes_in": os.path.getsize(gz), "bytes": len(data),
                            "libdeflate": int(route == "libdeflate")}


def test_a_similarity_formats_its_table_in_one_span(gfa):
    """`similarity -c node -H` over the 300 haplotypes: the table's body is
    formatted by one call inside `cli.write`, the span `write.format`, which
    counts the g^2 cells."""
    _, text = _profiled(gfa, ["similarity", "-c", "node", "-H"])
    got = runtime.spans()
    assert runtime.spans_dropped() == 0
    by_id = {r.id: r for r in got}
    (fmt,) = [r for r in got if r.name == "write.format"]
    write = by_id[fmt.parent]
    assert write.name == "cli.write" and fmt.command == write.command
    assert write.start_ns <= fmt.start_ns <= fmt.end_ns <= write.end_ns
    (header,) = [line for line in text.splitlines() if line.startswith("group\t")]
    g = header.count("\t")
    assert g == 300
    assert fmt.counts == {"cells": g * g}


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
