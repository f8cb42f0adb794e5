"""The program's spans in a traced slice, and what tracing costs.

    python -m perfbench.spans --workload d384-serve8 --seed 11 [--seconds 6]

The program (``semcode_tpu_torch.utils.tracing``) marks each phase of a
call with a ``semcode.*`` span on the profiler's timeline. Here each device
operation is put down to the innermost program span around the host call
that launched it (the device event and the runtime call share the launch's
correlation id), and each idle gap of the slice that no host operator
holds is named ``span: <name>`` after the innermost program span that holds
it. The harness's ``Trace`` does neither yet (PERF.md, Open questions).

On one cell's index, built as a run builds it, ``main`` measures the host
ms a call with the program's spans on (``tracing.enable()``) and off in
turns, call by call, the profiler off; then traced slices with the spans on and with them
kept off under the profiler too: the device's idle share, the launches a
call, the idle gaps by span and the device time by launching span. One JSON
line on standard output.
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import time
import types
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import DeviceType

from . import harness, spec
from .trace import SPAN, TOP, Trace, _innermost, from_profile

PREFIX = "semcode."
OUTSIDE = "host: outside any operator"
Span = Tuple[float, float, str]


def program_spans(prof) -> Dict[int, List[Span]]:
    """The program's host spans by thread: (start, end, name), sorted."""
    out: Dict[int, List[Span]] = {}
    for ev in prof.events():
        if ev.name.startswith(PREFIX) and ev.device_type == DeviceType.CPU:
            out.setdefault(ev.thread, []).append(
                (float(ev.time_range.start), float(ev.time_range.end),
                 ev.name[len(PREFIX):]))
    for spans in out.values():
        spans.sort()
    return out


def innermost(spans: List[Span], t: float) -> Optional[str]:
    """The shortest span of ``spans`` (one thread's, sorted) that holds
    ``t``; spans nest, so it is the last one to start before ``t`` that has
    not ended."""
    i = bisect.bisect_right(spans, (t, float("inf"), "")) - 1
    while i >= 0:
        s, e, name = spans[i]
        if e >= t:
            return name
        i -= 1
    return None


def device_time_by_span(prof) -> Dict[str, float]:
    """Seconds of device operations by the innermost program span around
    their launch (``-`` where none). A device event's ``id`` is its launch's
    correlation id, which the host's runtime call (``cudaLaunchKernel``,
    ``cudaMemcpyAsync``, ...) carries as its own ``id``."""
    by_thread = program_spans(prof)
    runtime = {}
    device = []
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU:
            if ev.name.startswith("cu"):
                runtime[ev.id] = ev
        elif (not getattr(ev, "is_user_annotation", False) and ev.name != SPAN
              and ev.time_range.end > ev.time_range.start):
            device.append(ev)
    out: Dict[str, float] = {}
    for ev in device:
        call = runtime.get(ev.id)
        name = None if call is None else innermost(
            by_thread.get(call.thread, []), float(call.time_range.start))
        key = name or "-"
        out[key] = out.get(key, 0.0) + (ev.time_range.end - ev.time_range.start) / 1e6
    return out


def gaps_by_span(trace: Trace, prof) -> List[list]:
    """``Trace.breakdown``'s idle gaps, a gap that no host operator holds
    named after the innermost program span at its midpoint."""
    spans = [s for per in program_spans(prof).values() for s in per]
    spans.sort()
    host = sorted(trace.host_ops)
    starts = [s for s, _, _ in host]
    gaps: Dict[str, float] = {}
    edges = [(trace.start, trace.start)] + trace.busy + [(trace.end, trace.end)]
    for (_, prev_end), (nxt, _) in zip(edges, edges[1:]):
        lo, hi = max(prev_end, trace.start), min(nxt, trace.end)
        if hi <= lo:
            continue
        mid = (lo + hi) / 2
        name = _innermost(host, starts, mid)
        if name == OUTSIDE:
            held = innermost(spans, mid)
            name = f"span: {held}" if held else OUTSIDE
        gaps[name] = gaps.get(name, 0.0) + (hi - lo) / 1e6
    return [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]]


def alternating(call, batches, seconds: float, device, tracing) -> dict:
    """Host ms of each call in a closed loop of ``seconds``, the program's
    spans on for every other call (the host's drift falls on both alike)."""
    ms: dict = {"off": [], "on": []}
    t_end, n = time.perf_counter() + seconds, 0
    while time.perf_counter() < t_end:
        on = bool(n % 2)
        tracing.enable(on)
        t0 = time.perf_counter()
        call(batches[n % len(batches)])
        ms["on" if on else "off"].append(1e3 * (time.perf_counter() - t0))
        n += 1
    tracing.enable(False)
    harness.sync(device)
    return ms


def traced_slice(call, batches, seconds: float, device):
    """A slice under ``torch.profiler``, each call in the harness's span."""
    prof = harness.Tracer.profiler(device)
    harness.sync(device)
    prof.start()
    t0 = time.perf_counter()
    n = 0
    while n < 3 or time.perf_counter() - t0 < seconds:
        with torch.profiler.record_function(SPAN):
            call(batches[n % len(batches)])
        n += 1
    harness.sync(device)
    wall = time.perf_counter() - t0
    prof.stop()
    return prof, from_profile(prof, list(range(n)), wall)


def measure(cell: spec.Cell, seed: int, seconds: float, device) -> dict:
    from semcode_tpu_torch.utils import tracing

    setup = harness.build(cell, seed, device)
    call = harness.search_call(setup.index, cell.traffic)
    batches = harness.batches_of(setup.pool, int(cell.traffic["batch"]))
    harness.warm(call, batches, device)
    harness.Tracer.prime(device)
    out: dict = {"workload": cell.name, "seed": seed, "build": tracing.snapshot()["spans"]}
    # the profiler off: spans on for every other call
    tracing.reset()
    ms = alternating(call, batches, seconds, device, tracing)
    tot = tracing.snapshot()["spans"]["ivf.search"]
    out["host_ms"] = {side: {"calls": len(v), "median": statistics.median(v),
                             "mean": statistics.fmean(v)} for side, v in ms.items()}
    out["span_ms_on"] = 1e3 * tot["seconds"] / tot["count"]
    # traced slices with the spans on, and kept off under the profiler
    real = tracing._profiler
    slices: dict = {"on": [], "off": []}
    for turn in range(6):
        on = not turn % 2
        tracing._profiler = real if on else types.SimpleNamespace(_is_profiler_enabled=False)
        try:
            prof, trace = traced_slice(call, batches, harness.TRACE_SECONDS, device)
        finally:
            tracing._profiler = real
        got = {"idle_share": 100.0 * (1.0 - trace.busy_s() / trace.wall_s),
               "launches_per_call": trace.ops_in_spans() / len(trace.spans),
               "calls": len(trace.spans)}
        if on:
            by_span = device_time_by_span(prof)
            spent = trace.span_device_s()
            got["topk_share"] = 100.0 * by_span.get("topk", 0.0) / spent if spent else None
            got["device_s_by_span"] = sorted(([k, v] for k, v in by_span.items()),
                                             key=lambda kv: -kv[1])[:TOP]
            got["idle_gaps"] = gaps_by_span(trace, prof)
            got["parent_idle_gaps"] = trace.breakdown()["idle_gaps"]
        slices["on" if on else "off"].append(got)
    out["traced"] = slices
    out["device"] = harness.device_info(device, cell.chips)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m perfbench.spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    result = measure(spec.load(args.workload), args.seed, args.seconds,
                     torch.device(args.device))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
