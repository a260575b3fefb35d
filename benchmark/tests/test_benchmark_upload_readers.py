"""The readers of the step-list upload that the index starts, `upload_ms`,
and `upload_early_share`, on synthetic span
records (the commands of test_benchmark_parse_readers.py, both parsed on
the card): the first command's index started the upload on its worker and
its build took it; the second's build copied its
step lists itself. A program without the upload's counts gives None."""

import pytest
from conftest import ROOT  # noqa: F401  (puts the repo on sys.path)

from benchmark import harness
from panacus_torch import runtime
from test_benchmark_parse_readers import _commands
from test_benchmark_spans import WINDOW, WORKER, _record, _run, _span

UPLOADS = ("upload_ms", "upload_early_share")


@pytest.fixture(autouse=True)
def fresh_record():
    runtime.reset_spans()
    yield
    runtime.reset_spans()


def _uploads(second=(1, 0)):
    """_commands(device_second=True) with the upload's span (12 ms on the
    first command's worker) and counts; `second`: the second build's
    uploads and uploads_early."""
    counts = {1: dict(uploads=1, uploads_early=1), 100: dict(zip(("uploads", "uploads_early"), second))}
    spans = [
        s._replace(counts={**s.counts, **counts[s.command]}) if s.name == "abaci_by_total" else s
        for s in _commands(device_second=True)
    ]
    return [_span("index.upload", 50, 2, 1, 101, 113, WORKER, bytes=1300)] + spans


def test_the_readers_on_synthetic_spans():
    _record(_uploads())
    got = {name: harness.read_metric(name, _run()) for name in UPLOADS}
    assert got == pytest.approx(
        {"upload_ms": 12 / 2, "upload_early_share": 50.0}, rel=1e-12)


def test_builds_that_upload_nothing_read_zero():
    """Builds that count uploads but made none (the host parsed their step
    lists): no time, no share."""
    spans = [s for s in _uploads(second=(0, 0)) if s.command != 1]
    _record(spans)
    got = {name: harness.read_metric(name, _run()) for name in UPLOADS}
    assert got == {"upload_ms": 0.0, "upload_early_share": 0.0}


@pytest.mark.parametrize("name", UPLOADS)
def test_a_program_without_the_upload_counts_gives_none(name):
    """A parent whose index starts no upload counts no `uploads`: the
    reader gives None and does not raise, also with no trace or a drop."""
    _record(_commands(device_second=True))
    assert harness.read_metric(name, _run()) is None
    _record(_uploads())
    assert harness.read_metric(name, _run(traced=False)) is None
    spans = _uploads()
    _record(spans, capacity=len(spans) - 2)
    assert runtime.spans_dropped(*WINDOW) > 0
    assert harness.read_metric(name, _run()) is None
