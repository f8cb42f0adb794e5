"""The traced slice of a window: ``torch.profiler`` events, summarised in
memory (nothing is written to disk).

``Trace`` holds what the per-layer readers and the ``breakdown`` need: the
device's operations (kernels, copies, sets) as intervals, the harness's own
search spans, and the host's operators, all on the profiler's clock in
microseconds.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

SPAN = "perfbench.search"
TOP = 10

Interval = Tuple[float, float]


def union(intervals: List[Interval]) -> List[Interval]:
    """Sorted, disjoint cover of ``intervals``."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def covered(cover: List[Interval], lo: float, hi: float) -> float:
    """Length of ``[lo, hi]`` under the disjoint sorted ``cover``."""
    total = 0.0
    i = max(0, bisect.bisect_right(cover, (lo, float("inf"))) - 1)
    while i < len(cover) and cover[i][0] < hi:
        s, e = cover[i]
        total += max(0.0, min(e, hi) - max(s, lo))
        i += 1
    return total


@dataclass
class Trace:
    """One traced slice. ``calls`` are the window's call numbers whose spans
    the slice holds, in order; ``wall_s`` its length on the host clock."""

    device_ops: List[Tuple[float, float, str]]
    spans: List[Interval]
    host_ops: List[Tuple[float, float, str]]
    calls: List[int]
    wall_s: float
    busy: List[Interval] = field(init=False)

    def __post_init__(self):
        self.busy = union([(s, e) for s, e, _ in self.device_ops])
        self.spans.sort()

    @property
    def start(self) -> float:
        return self.spans[0][0] if self.spans else 0.0

    @property
    def end(self) -> float:
        return self.spans[-1][1] if self.spans else 0.0

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(e - s for s, e in self.busy) / 1e6

    def span_device_s(self) -> float:
        """Device-busy seconds inside the harness's search spans."""
        return sum(covered(self.busy, s, e) for s, e in self.spans) / 1e6

    def ops_in_spans(self) -> int:
        """Device operations that started inside a search span."""
        starts = [s for s, _ in self.spans]
        n = 0
        for s, _, _ in self.device_ops:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s <= self.spans[i][1]:
                n += 1
        return n

    def breakdown(self) -> dict:
        """The device operations with the most time, and the idle gaps
        inside the spans' extent by what the host was doing (the innermost
        host operator around each gap's midpoint), seconds each."""
        by_op: dict = {}
        for s, e, name in self.device_ops:
            by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e6
        gaps: dict = {}
        edges = [(self.start, self.start)] + self.busy + [(self.end, self.end)]
        host = sorted(self.host_ops)
        host_starts = [s for s, _, _ in host]
        for (_, prev_end), (nxt, _) in zip(edges, edges[1:]):
            lo, hi = max(prev_end, self.start), min(nxt, self.end)
            if hi <= lo:
                continue
            name = _innermost(host, host_starts, (lo + hi) / 2)
            gaps[name] = gaps.get(name, 0.0) + (hi - lo) / 1e6
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_op), "idle_gaps": top(gaps)}


def _innermost(host, starts, t: float) -> str:
    """Name of the shortest host operator that holds time ``t``; scans back
    over operators that started before it (they are few: one call's)."""
    best: Optional[Tuple[float, str]] = None
    i = bisect.bisect_right(starts, t) - 1
    scanned = 0
    while i >= 0 and scanned < 4096:
        s, e, name = host[i]
        if e >= t and (best is None or e - s < best[0]):
            best = (e - s, name)
        i -= 1
        scanned += 1
    return best[1] if best else "host: outside any operator"


def from_profile(prof, calls: List[int], wall_s: float) -> Trace:
    """The ``Trace`` of a finished ``torch.profiler.profile``. Device events
    that are annotations (a ``record_function`` mirrored on the device's
    timeline) are not operations and are left out."""
    from torch.autograd import DeviceType

    device_ops, spans, host_ops = [], [], []
    for ev in prof.events():
        s, e = float(ev.time_range.start), float(ev.time_range.end)
        annotation = getattr(ev, "is_user_annotation", False) or ev.name == SPAN
        if ev.device_type == DeviceType.CUDA:
            if not annotation and e > s:
                device_ops.append((s, e, ev.name[:120]))
        elif ev.name == SPAN:
            spans.append((s, e))
        elif not annotation:
            host_ops.append((s, e, ev.name[:120]))
    return Trace(device_ops, spans, host_ops, calls, wall_s)
