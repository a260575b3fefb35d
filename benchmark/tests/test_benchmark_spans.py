"""The readers of the program's spans (source "program_span") on a synthetic
run: a fake trace window and span records put straight into
panacus_torch.runtime's record."""

import pytest
from conftest import ROOT  # noqa: F401  (puts the repo on sys.path)

from benchmark import harness
from benchmark.trace import Trace
from panacus_torch import runtime

MS = 1_000_000
MAIN, WORKER = 1, 2
WINDOW = (50 * MS, 500 * MS)


def _span(name, id, parent, command, a, b, thread=MAIN, **counts):
    return runtime.SpanRecord(name, id, parent, command, thread, a * MS, b * MS, counts)


def _commands():
    """Two commands inside the window and one after it. The first waited
    for the edge index and packed stashed edge slabs, and its write and
    release overlap; the second did neither."""
    one = [
        _span("cli.parse", 2, 1, 1, 100, 102),
        _span("index.scan", 4, 3, 1, 102, 110, bytes=10, lines=4),
        _span("edge_index", 5, 3, 1, 125, 160, WORKER, edges=7),
        _span("index", 3, 1, 1, 102, 130),
        _span("build.tokenize", 7, 6, 1, 131, 140, slab=0),
        _span("build.tokenize", 8, 6, 1, 141, 150, slab=1),
        _span("edge_index.wait", 9, 6, 1, 150, 160),
        _span("build.edge_pack", 10, 6, 1, 160, 165, slabs=1),
        _span("abaci_by_total", 6, 1, 1, 130, 180, edge_slabs=3, edge_slabs_repacked=1),
        _span("cli.write", 11, 1, 1, 185, 190, bytes=100),
        _span("cli.release", 12, 1, 1, 188, 195),
        _span("command", 1, None, 1, 100, 200),
    ]
    two = [
        _span("index.scan", 102, 101, 100, 300, 306),
        _span("edge_index", 103, 101, 100, 305, 315, WORKER),
        _span("index", 101, 100, 100, 300, 308),
        _span("build.tokenize", 105, 104, 100, 310, 320, slab=0),
        _span("abaci_by_total", 104, 100, 100, 308, 330, edge_slabs=3, edge_slabs_repacked=0),
        _span("cli.write", 106, 100, 100, 390, 392),
        _span("command", 100, None, 100, 300, 400),
    ]
    after = [
        _span("index.scan", 202, 201, 200, 600, 900),
        _span("edge_index.wait", 203, 201, 200, 600, 900),
        _span("index", 201, 200, 200, 600, 900),
        _span("command", 200, None, 200, 600, 1000),
    ]
    return one + two + after


# what each reader gives for _commands(), worked by hand
EXPECTED = {
    "scan_ms": (8 + 6) / 2,
    "tokenize_ms": (9 + 9 + 10) / 2,
    "write_ms": (5 + 2) / 2,
    # the first: 100 less (2 + 28 + 50 + 10), the write and release counted
    # once; the second: 100 less (8 + 22 + 2)
    "command_self_ms": (10 + 68) / 2,
    "edge_index_ms.all": (35 + 10) / 2,
    "edge_wait_ms.all": (10 + 0) / 2,
    "edge_pack_ms.all": (5 + 0) / 2,
    "edge_repack_share.all": 100 * (1 + 0) / (3 + 3),
}


@pytest.fixture(autouse=True)
def fresh_record():
    runtime.reset_spans()
    yield
    runtime.reset_spans()


def _record(spans, capacity=runtime.SPAN_CAPACITY):
    runtime.reset_spans(capacity)
    for s in spans:
        runtime._keep(s)


def _run(window=WINDOW, traced=True):
    trace = Trace([], [], *window) if traced else None
    return harness.Run(cell=None, inputs=None, commands=[], window_s=1.0, trace=trace)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_sums_the_window_by_command(name):
    _record(_commands())
    got = harness.read_metric(name, _run())
    assert isinstance(got, float)
    assert got == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_drop_in_the_window_gives_none(name):
    spans = _commands()
    _record(spans, capacity=len(spans) - 5)  # the second command's root and the third drop
    assert runtime.spans_dropped(*WINDOW) > 0
    assert harness.read_metric(name, _run()) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_drop_outside_the_window_is_no_fault(name):
    spans = _commands()
    _record(spans + [_span("cli.parse", 300, None, 300, 2000, 2001)], capacity=len(spans))
    assert runtime.spans_dropped() == 1 and runtime.spans_dropped(*WINDOW) == 0
    assert harness.read_metric(name, _run()) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_no_trace_or_no_command_gives_none(name):
    _record(_commands())
    assert harness.read_metric(name, _run(traced=False)) is None
    assert harness.read_metric(name, _run(window=(1100 * MS, 1200 * MS))) is None
    _record([s for s in _commands() if s.name != "command"])
    assert harness.read_metric(name, _run()) is None


def test_a_program_without_a_span_record_gives_none(monkeypatch):
    _record(_commands())
    monkeypatch.delattr(runtime, "spans")
    for name in EXPECTED:
        assert harness.read_metric(name, _run()) is None
