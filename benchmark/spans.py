"""The program's spans over a traced window, for the readers of metrics/
whose source is "program_span".

panacus_torch.runtime keeps a span record while a profiler is active
(`runtime.spans(start_ns, end_ns)`, `runtime.spans_dropped(...)`), on the
clock of the profiler's host events, so the trace's window selects its
spans. Every command (`cli.run_cli`) is the root span `command`; the spans
it opens, on any thread, carry its id. A reader gets None where there is no
trace, where the program keeps no record, where spans were dropped inside
the window, or where no `command` span lies in it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


def window(run) -> Optional[Tuple[list, Dict[int, object]]]:
    """(the spans of the window's commands, {command id: its `command`
    span}), or None."""
    if run.trace is None:
        return None
    from panacus_torch import runtime

    spans = getattr(runtime, "spans", None)
    if spans is None:
        return None
    a, b = run.trace.start_ns, run.trace.end_ns
    if runtime.spans_dropped(a, b):
        return None
    got = spans(a, b)
    commands = {r.id: r for r in got if r.name == "command"}
    if not commands:
        return None
    return [r for r in got if r.command in commands], commands


def mean_ms(run, name: str) -> Optional[float]:
    """The spans named `name` summed, mean ms a command (0 for a command
    that opened none)."""
    w = window(run)
    if w is None:
        return None
    got, commands = w
    return sum(r.end_ns - r.start_ns for r in got if r.name == name) / 1e6 / len(commands)


def covered_ns(intervals: List[Tuple[int, int]]) -> int:
    """ns that the union of the (start, end) intervals covers."""
    total, reach = 0, None
    for a, b in sorted(intervals):
        if reach is None or a > reach:
            total += b - a
            reach = b
        elif b > reach:
            total += b - reach
            reach = b
    return total


def self_ms(run, name: str = "command") -> Optional[float]:
    """The spans named `name`, each less the union of its children (clipped
    to it), mean ms a command."""
    w = window(run)
    if w is None:
        return None
    got, commands = w
    children: Dict[int, List[Tuple[int, int]]] = {}
    for r in got:
        children.setdefault(r.parent, []).append((r.start_ns, r.end_ns))
    total = 0
    for r in got:
        if r.name == name:
            inside = [(max(a, r.start_ns), min(b, r.end_ns)) for a, b in children.get(r.id, [])]
            total += r.end_ns - r.start_ns - covered_ns([(a, b) for a, b in inside if b > a])
    return total / 1e6 / len(commands)


def count_share(run, name: str, part: str, whole: str) -> Optional[float]:
    """% that the count `part` makes of the count `whole`, each summed over
    the spans named `name`; None where `whole` sums to 0."""
    w = window(run)
    if w is None:
        return None
    got, _ = w
    n = sum(r.counts.get(whole, 0) for r in got if r.name == name)
    if not n:
        return None
    return 100.0 * sum(r.counts.get(part, 0) for r in got if r.name == name) / n
