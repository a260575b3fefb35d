"""The readers of the gz front end's span `index.inflate`, `inflate_ms`,
`inflate_mbps` and `inflate_share`, on synthetic span records: two commands
in the window, each inflating its .gfa.gz under `index`, and one after the
window. A program whose inflate opens no span (or one without the count
`bytes_in`) gives None, as do a run with no trace and a drop in the window."""

import pytest
from conftest import ROOT  # noqa: F401  (puts the repo on sys.path)

from benchmark import harness
from panacus_torch import runtime
from test_benchmark_spans import WINDOW, _record, _run, _span

INFLATE = ("inflate_ms", "inflate_mbps", "inflate_share")
MB = 1_000_000


@pytest.fixture(autouse=True)
def fresh_record():
    runtime.reset_spans()
    yield
    runtime.reset_spans()


def _commands(counted=True):
    """Inflates of 60 and 40 ms (120 and 100 MB) in commands of 100 ms each;
    a third command after the window. `counted`: the spans carry the
    inflate's counts, as the program that opens the span gives them."""
    def inflate(id, parent, command, a, b, n):
        counts = dict(bytes_in=n // 4, bytes=n, libdeflate=0) if counted else {}
        return _span("index.inflate", id, parent, command, a, b, **counts)

    return [
        inflate(3, 2, 1, 103, 163, 120 * MB),
        _span("index.scan", 4, 2, 1, 163, 170, bytes=120 * MB, lines=9),
        _span("index", 2, 1, 1, 102, 190),
        _span("command", 1, None, 1, 100, 200),
        inflate(103, 102, 100, 301, 341, 100 * MB),
        _span("index", 102, 100, 100, 300, 350),
        _span("command", 100, None, 100, 300, 400),
        inflate(203, 202, 200, 601, 900, 100 * MB),
        _span("index", 202, 200, 200, 600, 950),
        _span("command", 200, None, 200, 600, 1000),
    ]


def test_the_readers_on_synthetic_spans():
    _record(_commands())
    got = {name: harness.read_metric(name, _run()) for name in INFLATE}
    assert got == pytest.approx({
        "inflate_ms": (60 + 40) / 2,
        "inflate_mbps": (120 + 100) / ((60 + 40) / 1e3),
        "inflate_share": 100.0 * (60 + 40) / (100 + 100),
    }, rel=1e-12)


@pytest.mark.parametrize("name", INFLATE)
def test_without_the_inflate_counts_the_reader_gives_none(name):
    """The parent's program (no span), a span without `bytes_in`, no trace,
    or a drop inside the window: None, and no raise."""
    _record([s for s in _commands() if s.name != "index.inflate"])
    assert harness.read_metric(name, _run()) is None
    _record(_commands(counted=False))
    assert harness.read_metric(name, _run()) is None
    _record(_commands())
    assert harness.read_metric(name, _run(traced=False)) is None
    spans = _commands()
    _record(spans, capacity=len(spans) - 4)
    assert runtime.spans_dropped(*WINDOW) > 0
    assert harness.read_metric(name, _run()) is None
