"""The reader of the similarity table's formatting, `format_ms`, on
synthetic span records (the commands of test_benchmark_spans.py): the
first command formatted a 90 x 90 table in 3 ms of its 5-ms `cli.write`,
the second in 1 ms; the command after the window is not read. A program
that formats the table cell by cell opens no `write.format` and gives
None."""

import pytest
from conftest import ROOT  # noqa: F401  (puts the repo on sys.path)

from benchmark import harness
from panacus_torch import runtime
from test_benchmark_spans import WINDOW, _commands, _record, _run, _span


@pytest.fixture(autouse=True)
def fresh_record():
    runtime.reset_spans()
    yield
    runtime.reset_spans()


def _formatted():
    """_commands() with a `write.format` in each command, in the order the
    spans end, as the record keeps them."""
    spans = _commands() + [
        _span("write.format", 13, 11, 1, 186, 189, cells=8100),
        _span("write.format", 107, 106, 100, 390, 391, cells=8100),
        _span("write.format", 204, 200, 200, 900, 990, cells=8100),
    ]
    return sorted(spans, key=lambda s: s.end_ns)


def test_format_ms_is_the_mean_a_command():
    _record(_formatted())
    got = harness.read_metric("format_ms", _run())
    assert isinstance(got, float)
    assert got == pytest.approx((3 + 1) / 2, rel=1e-12)


def test_a_command_that_formats_nothing_reads_zero():
    """One command of the window formatted its table, the other wrote a
    table of another kind: the mean a command halves."""
    _record([s for s in _formatted() if s.id != 107])
    assert harness.read_metric("format_ms", _run()) == pytest.approx(3 / 2, rel=1e-12)


def test_a_program_without_the_span_gives_none():
    """The parent formats cell by cell: no span carries `cells`, and the
    reader gives None and does not raise, also with no trace or a drop."""
    _record(_commands())
    assert harness.read_metric("format_ms", _run()) is None
    _record(_formatted())
    assert harness.read_metric("format_ms", _run(traced=False)) is None
    spans = _formatted()
    _record(spans, capacity=len(spans) - 6)
    assert runtime.spans_dropped(*WINDOW) > 0
    assert harness.read_metric("format_ms", _run()) is None
