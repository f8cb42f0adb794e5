"""The traced slice of a window: ``torch.profiler`` events, summarised in
memory (nothing is written to disk).

``Trace`` holds what the per-layer readers and the ``breakdown`` need: the
device's operations (kernels, copies, sets) as intervals, the harness's own
search spans, and the host's operators, all on the profiler's clock in
microseconds; and which device operations a CUDA graph's replay launched.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import List, Tuple

SPAN = "perfbench.search"
TOP = 10
GRAPH_LAUNCH = "cudaGraphLaunch"
# events that the profiler's own event list (``prof.events()``) leaves out
# (``torch.autograd.profiler_util._filter_name``)
FILTERED = frozenset(("[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
                      "profiler::_record_function_enter_new",
                      "profiler::_record_function_exit", "aten::is_leaf",
                      "aten::output_nr", "aten::_version"))
# host operators scanned back from a time for the one that holds it
SCAN = 4096
OUTSIDE = "host: outside any operator"

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
    the slice holds, in order; ``wall_s`` its length on the host clock;
    ``graphed`` the device operations that graph replays launched, and
    ``graph_launches`` the replays the host made (none in a search)."""

    device_ops: List[Tuple[float, float, str]]
    spans: List[Interval]
    host_ops: List[Tuple[float, float, str]]
    calls: List[int]
    wall_s: float
    graphed: List[Interval] = field(default_factory=list)
    graph_launches: int = 0
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

    def graphed_s(self) -> float:
        """Device-busy seconds of the graph replays' operations."""
        return sum(e - s for s, e in union(self.graphed)) / 1e6

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
        holders = Holders(sorted(self.host_ops))
        for (_, prev_end), (nxt, _) in zip(edges, edges[1:]):
            lo, hi = max(prev_end, self.start), min(nxt, self.end)
            if hi <= lo:
                continue
            name = holders.innermost((lo + hi) / 2)
            gaps[name] = gaps.get(name, 0.0) + (hi - lo) / 1e6
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_op), "idle_gaps": top(gaps)}


class Holders:
    """The innermost host operator that holds a time, for many times over
    one list of host operators sorted by start: of the SCAN operators that
    started last before the time, those that have not ended by it, the
    shortest (of equal ones, the latest started). A tree of the latest end
    over each run of operators skips the runs that ended before the time,
    so a lookup visits only the operators that hold it: a traced model call
    holds some hundred thousand idle gaps."""

    def __init__(self, host):
        self.host = host
        self.starts = [s for s, _, _ in host]
        self.size = 1
        while self.size < len(host):
            self.size *= 2
        self.tree = [float("-inf")] * (2 * self.size)
        for j, (_, e, _) in enumerate(host):
            self.tree[self.size + j] = e
        for k in range(self.size - 1, 0, -1):
            self.tree[k] = max(self.tree[2 * k], self.tree[2 * k + 1])

    def innermost(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        lo = max(0, i - SCAN + 1)
        best = None
        todo = [(1, 0, self.size - 1)] if i >= 0 else []
        while todo:
            k, a, b = todo.pop()
            if b < lo or a > i or self.tree[k] < t:
                continue
            if a < b:
                m = (a + b) // 2
                todo += [(2 * k, a, m), (2 * k + 1, m + 1, b)]
                continue
            s, e, name = self.host[a]
            if best is None or (e - s, -a) < best[0]:
                best = ((e - s, -a), name)
        return best[1] if best else OUTSIDE


def from_profile(prof, calls: List[int], wall_s: float) -> Trace:
    """The ``Trace`` of a finished ``torch.profiler.profile``, read from its
    raw events: the operators, names (demangled) and times (on another
    origin) that ``prof.events()`` gives, without building its event tree,
    which takes minutes at a few hundred thousand kernels. (The tree also
    folds an operator's only child of the same name into it; here both stay,
    and an idle gap that either holds takes the one name.) Device events that
    are annotations (a ``record_function`` mirrored on the device's timeline)
    are not operations and are left out. A device operation whose launch's
    correlation id is a ``cudaGraphLaunch``'s is also in ``graphed``."""
    from torch._C import _demangle
    from torch.autograd import DeviceType

    names: dict = {}

    def name_of(raw: str) -> str:
        if raw not in names:
            names[raw] = (_demangle(raw) if len(raw) > 1 else raw)[:120]
        return names[raw]

    device_ops, corr, spans, host_ops, graph_corr = [], [], [], [], set()
    for ev in prof.profiler.kineto_results.events():
        raw = ev.name()
        if raw in FILTERED or getattr(ev, "is_hidden_event", lambda: False)():
            continue
        s, e = ev.start_ns() / 1e3, ev.end_ns() / 1e3
        annotation = ev.is_user_annotation() or raw == SPAN
        if ev.device_type() == DeviceType.CUDA:
            if not annotation and e > s:
                device_ops.append((s, e, name_of(raw)))
                corr.append(ev.correlation_id())
        elif raw == SPAN:
            spans.append((s, e))
        elif not annotation:
            host_ops.append((s, e, name_of(raw)))
            if raw == GRAPH_LAUNCH:
                graph_corr.add(ev.correlation_id())
    graphed = [(s, e) for (s, e, _), c in zip(device_ops, corr) if c in graph_corr]
    return Trace(device_ops, spans, host_ops, calls, wall_s, graphed=graphed,
                 graph_launches=len(graph_corr))
