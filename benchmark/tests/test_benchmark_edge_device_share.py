"""The reader `edge_device_share.all` on synthetic span records (the
helpers of test_benchmark_spans.py): the first command's build wrote its
three edge slabs on the card, the second packed them on the host."""

import pytest
from conftest import ROOT  # noqa: F401  (puts the repo on sys.path)

from benchmark import harness
from panacus_torch import runtime
from test_benchmark_spans import WINDOW, _record, _run, _span

NAME = "edge_device_share.all"


def _commands(second_on_device=False, edges=True):
    edge = dict(edge_slabs=3, edge_slabs_repacked=0) if edges else {}
    return [
        _span("abaci_by_total", 2, 1, 1, 110, 130, node_slabs=3,
              **(dict(edge, edge_slabs_on_device=3) if edges else {})),
        _span("command", 1, None, 1, 100, 200),
        _span("abaci_by_total", 102, 100, 100, 308, 330, node_slabs=3,
              **(dict(edge, edge_slabs_on_device=3 if second_on_device else 0) if edges else {})),
        _span("command", 100, None, 100, 300, 400),
    ]


@pytest.fixture(autouse=True)
def fresh_record():
    runtime.reset_spans()
    yield
    runtime.reset_spans()


def test_the_share_counts_the_edge_slabs():
    _record(_commands())
    assert harness.read_metric(NAME, _run()) == pytest.approx(50.0)
    _record(_commands(second_on_device=True))
    assert harness.read_metric(NAME, _run()) == pytest.approx(100.0)


def test_no_edge_slabs_give_none():
    """Builds that count no edges (node builds): None, not 0."""
    _record(_commands(edges=False))
    assert harness.read_metric(NAME, _run()) is None


def test_a_program_without_the_count_gives_none():
    """A parent that counts edge slabs but not those the card wrote gives
    None and does not raise."""
    spans = [s._replace(counts={k: v for k, v in s.counts.items() if k != "edge_slabs_on_device"})
             for s in _commands()]
    _record(spans)
    assert harness.read_metric(NAME, _run()) is None


def test_no_trace_or_a_drop_gives_none():
    _record(_commands())
    assert harness.read_metric(NAME, _run(traced=False)) is None
    spans = _commands()
    _record(spans, capacity=len(spans) - 2)
    assert runtime.spans_dropped(*WINDOW) > 0
    assert harness.read_metric(NAME, _run()) is None
