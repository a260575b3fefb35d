"""The readers of the streamed build's device route, `stage_ms` and
`device_parse_share`, on synthetic span records (the helpers of
test_benchmark_spans.py): the first command staged two chunks and parsed
its three node slabs on the card, the second built on the host."""

import pytest
from conftest import ROOT  # noqa: F401  (puts the repo on sys.path)

from benchmark import harness
from panacus_torch import runtime
from test_benchmark_spans import MS, WINDOW, _record, _run, _span


def _commands(device_second=False):
    one = [
        _span("index", 2, 1, 1, 100, 110),
        _span("build.alloc", 4, 3, 1, 110, 112),
        _span("build.stage", 5, 3, 1, 112, 118, bytes=800),
        _span("build.parse", 6, 3, 1, 118, 119),
        _span("build.stage", 7, 3, 1, 119, 123, bytes=500),
        _span("build.parse", 8, 3, 1, 123, 124),
        _span("build.wait", 9, 3, 1, 124, 126),
        _span("abaci_by_total", 3, 1, 1, 110, 130, node_slabs=3, node_slabs_on_device=3),
        _span("command", 1, None, 1, 100, 200),
    ]
    two = [
        _span("build.tokenize", 103, 102, 100, 310, 320, slab=0),
        _span("abaci_by_total", 102, 100, 100, 308, 330, node_slabs=3,
              node_slabs_on_device=3 if device_second else 0),
        _span("command", 100, None, 100, 300, 400),
    ]
    return one + two


@pytest.fixture(autouse=True)
def fresh_record():
    runtime.reset_spans()
    yield
    runtime.reset_spans()


def test_stage_ms_is_the_mean_a_command():
    _record(_commands())
    assert harness.read_metric("stage_ms", _run()) == pytest.approx((6 + 4) / 2, rel=1e-12)
    _record([s for s in _commands() if s.name != "build.stage"])  # every build on the host
    assert harness.read_metric("stage_ms", _run()) == 0.0


def test_device_parse_share_counts_the_slabs():
    _record(_commands())
    assert harness.read_metric("device_parse_share", _run()) == pytest.approx(50.0)
    _record(_commands(device_second=True))
    assert harness.read_metric("device_parse_share", _run()) == pytest.approx(100.0)


@pytest.mark.parametrize("name", ["stage_ms", "device_parse_share"])
def test_a_program_without_the_route_gives_none(name):
    """A parent that parses on the host opens no `build.stage` and counts no
    node slabs: the reader gives None and does not raise."""
    spans = [
        s._replace(counts={k: v for k, v in s.counts.items() if not k.startswith("node_slabs")})
        for s in _commands() if not s.name.startswith("build.")
    ]
    _record(spans)
    assert harness.read_metric(name, _run()) is None


@pytest.mark.parametrize("name", ["stage_ms", "device_parse_share"])
def test_no_trace_or_a_drop_gives_none(name):
    _record(_commands())
    assert harness.read_metric(name, _run(traced=False)) is None
    spans = _commands()
    _record(spans, capacity=len(spans) - 2)
    assert runtime.spans_dropped(*WINDOW) > 0
    assert harness.read_metric(name, _run()) is None
    assert MS == 1_000_000
