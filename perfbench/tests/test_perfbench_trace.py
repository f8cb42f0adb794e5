"""The traced slice: ``trace.from_profile`` reads from the profiler's raw
events what its event list holds; ``trace.Holders`` finds, for any time,
the host operator a plain scan finds, and a slice of a traced model call's
size is put down to names in seconds."""

import bisect
import random
import time

import pytest
import torch

from perfbench import trace


def innermost(host, starts, t):
    """The plain scan: of the SCAN host operators that started last before
    ``t``, the shortest that holds it (of equal ones, the latest started)."""
    best = None
    i = bisect.bisect_right(starts, t) - 1
    scanned = 0
    while i >= 0 and scanned < trace.SCAN:
        s, e, name = host[i]
        if e >= t and (best is None or e - s < best[0]):
            best = (e - s, name)
        i -= 1
        scanned += 1
    return best[1] if best else trace.OUTSIDE


def ops(rng, n):
    """Nested and overlapping host operators, with ties of duration."""
    out, t = [], 0.0
    for _ in range(n):
        t += rng.choice([0.5, 1.0, 3.0])
        out.append((t, t + rng.choice([1.0, 2.0, 2.0, 8.0, 50.0, 5000.0]), f"op{rng.randrange(40)}"))
    return sorted(out)


def test_holders_name_what_the_scan_names():
    rng = random.Random(3)
    for n in (1, 7, 300, 9000):
        host = ops(rng, n)
        starts = [s for s, _, _ in host]
        holders = trace.Holders(host)
        end = host[-1][1] + 10
        for _ in range(2000):
            t = rng.uniform(-5, end)
            assert holders.innermost(t) == innermost(host, starts, t), (n, t)
        for s, e, _ in host[:200]:
            for t in (s, e):
                assert holders.innermost(t) == innermost(host, starts, t)


def test_a_model_calls_slice_is_read_in_seconds():
    """Three calls of 191 graph replays of 1,095 kernels each, the host's
    launches between them: the breakdown takes seconds, not minutes."""
    dev, host, t = [], [], 0.0
    for _ in range(3):
        for _ in range(191):
            host.append((t, t + 400.0, "cudaGraphLaunch"))
            for k in range(1095):
                dev.append((t + 1.0, t + 3.5, f"k{k % 40}"))
                t += 3.3
    sl = trace.Trace(dev, [(0.0, t)], host, [0, 1, 2], t / 1e6)
    t0 = time.perf_counter()
    gaps = dict(sl.breakdown()["idle_gaps"])
    assert time.perf_counter() - t0 < 60
    assert set(gaps) <= {"cudaGraphLaunch", trace.OUTSIDE}


def from_events(prof):
    """The slice as the profiler's event list (``prof.events()``) gives it."""
    spans, host = [], []
    for ev in prof.events():
        s, e = float(ev.time_range.start), float(ev.time_range.end)
        if ev.name == trace.SPAN:
            spans.append((s, e))
        elif not ev.is_user_annotation:
            host.append((s, e, ev.name[:120]))
    return sorted(spans), sorted(host)


def test_the_raw_events_are_what_the_event_list_holds():
    """A CPU profile with the harness's spans and a nested annotation: the
    same spans and host operators, names and lengths, on one shifted origin."""
    x = torch.randn(64, 64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with torch.profiler.record_function(trace.SPAN):
                with torch.profiler.record_function("inner"):
                    bits = (x @ x).view(torch.int32)
                    torch.topk(torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits), 5)
                x.add_(1).clamp_(max=3)
    got = trace.from_profile(prof, [0, 1, 2], 0.01)
    spans, host = from_events(prof)
    assert len(got.spans) == len(spans) == 3 and got.device_ops == [] and got.graphed == []
    # the event list keeps whole microseconds
    shift = got.spans[0][0] - spans[0][0]
    flat = lambda iv: [t for s, e, *_ in iv for t in (s, e)]
    assert flat(got.spans) == pytest.approx([t + shift for t in flat(spans)], abs=1.0)
    # the event list folds an operator's only child of its own name into it
    # (aten::bitwise_xor with a scalar calls aten::bitwise_xor): the raw
    # events keep it, inside its twin
    mine = sorted(got.host_ops)
    held = {(round(s - shift), round(e - shift), n) for s, e, n in mine}
    extra = [op for op in mine
             if not any(abs(op[0] - shift - s) <= 1 and abs(op[1] - shift - e) <= 1 and op[2] == n
                        for s, e, n in host)]
    assert len(mine) == len(host) + len(extra) and len(held) >= len(host)
    assert [n for _, _, n in extra] == ["aten::bitwise_xor"] * 3
    for s, e, n in extra:
        assert any(n == n2 and s2 <= s and e <= e2 and (s2, e2) != (s, e) for s2, e2, n2 in mine)
    for s, e, n in host:
        assert any(abs(s + shift - s2) <= 1 and abs(e + shift - e2) <= 1 and n == n2
                   for s2, e2, n2 in mine), n
    assert "aten::topk" in {n for _, _, n in mine}
    assert not any(n.startswith("profiler::") for _, _, n in mine)
