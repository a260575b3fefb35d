"""Device activity and host scopes of a traced window (torch.profiler).

`Trace.from_profiler` keeps, from the profiler's events, every device
activity (kernels, copies, fills: name, start, end) and every host scope
that a `record_function` opened (the program's phases and slab scopes). The
window is the host scope WINDOW that the harness opens around it. The
device's busy time is the union of its activity; an idle gap is named by
the innermost host scope that was open at its middle, or "outside any
scope".
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, List, Tuple

DEVICE_ACTIVITY = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "benchmark.window"


def _kind(e) -> str:
    """The profiler's activity type of an event. Where torch does not give
    it (2.11 does not), a device-side event that is no annotation counts as
    a kernel; Trace.from_profiler leaves out device-side events that carry a
    host scope's name, the annotations of older versions."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    on_device = str(e.device_type()).endswith("CUDA")
    if e.is_user_annotation():
        return "gpu_user_annotation" if on_device else "user_annotation"
    return "kernel" if on_device else "cpu_op"


@dataclass
class Trace:
    device: List[Tuple[str, int, int]]  # (name, start ns, end ns), by start
    scopes: List[Tuple[str, int, int]]  # host scopes, by start
    start_ns: int
    end_ns: int

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        events = list(prof.profiler.kineto_results.events())
        kinds = [_kind(e) for e in events]
        host_names = {e.name() for e, k in zip(events, kinds) if k == "user_annotation"}
        device, scopes = [], []
        for e, kind in zip(events, kinds):
            span = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            if kind in DEVICE_ACTIVITY and e.name() not in host_names:
                device.append(span)
            elif kind == "user_annotation":
                scopes.append(span)
        device.sort(key=lambda t: t[1])
        scopes.sort(key=lambda t: t[1])
        (start_ns, end_ns), = [(a, b) for name, a, b in scopes if name == WINDOW]
        scopes = [s for s in scopes if s[0] != WINDOW]
        return cls(device, scopes, start_ns, end_ns)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device activity inside the window."""
        out: List[Tuple[int, int]] = []
        for _, a, b in self.device:
            a, b = max(a, self.start_ns), min(b, self.end_ns)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def device_time_s(self, match) -> Tuple[float, int]:
        """(summed seconds, count) of the device activities whose name
        `match(name)` accepts."""
        hits = [b - a for name, a, b in self.device if match(name)]
        return sum(hits) / 1e9, len(hits)

    def top_device_ops(self, k: int = 10) -> List[list]:
        by_name: Dict[str, int] = {}
        for name, a, b in self.device:
            by_name[name] = by_name.get(name, 0) + (b - a)
        top = sorted(by_name.items(), key=lambda t: -t[1])[:k]
        return [[name, ns / 1e9] for name, ns in top]

    def scope_at(self, t: int) -> str:
        """The innermost host scope open at time t (the latest-opened one)."""
        i = bisect.bisect_right([s[1] for s in self.scopes], t)
        for name, a, b in reversed(self.scopes[:i]):
            if a <= t < b:
                return name
        return "outside any scope"

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The k longest idle gaps of the window, named by the host scope at
        each gap's middle."""
        edges = [self.start_ns]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(self.end_ns)
        gaps = [(edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)]
        gaps = sorted((g for g in gaps if g[0] > 0), reverse=True)[:k]
        return [[self.scope_at(a + g // 2), g / 1e9] for g, a in gaps]
