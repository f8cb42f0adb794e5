"""The readers of the program's own span totals (``perfbench/program.py``):
hand-computed values, None on a program without them, the traced tiny
cell's line, and the program's spans left out of the profiler's ``Trace``."""

import json
import math
import time

import pytest
import torch

from perfbench import harness, program, spec
from perfbench.tests.tiny import make_root
from perfbench.trace import SPAN, from_profile
from semcode_tpu_torch.utils import tracing

NEW = ("host_ms_per_call.serve", "kmeans_s", "layout_s")


class Ctx:
    """A ``ReadContext`` with a traced slice of ``calls`` spans."""

    def __init__(self, calls: int):
        self.trace = type("T", (), {"spans": [(0.0, 1.0)] * calls})()


@pytest.fixture
def clean():
    tracing.reset()
    yield
    tracing.reset()


def test_readers_on_hand_made_totals(clean):
    for seconds in (0.0012, 0.0018, 0.0030):
        tracing._add("ivf.search", seconds)
    tracing._add("ivf.build.kmeans", 0.75)
    tracing._add("ivf.build.layout", 1.25)
    tracing._add("ivf.build.layout", 0.25)
    assert program.host_ms_per_call(Ctx(3)) == pytest.approx(2.0)
    assert program.kmeans_seconds(Ctx(3)) == pytest.approx(0.75)
    assert program.layout_seconds(Ctx(3)) == pytest.approx(1.5)
    # no traced call: nothing to divide
    assert program.host_ms_per_call(Ctx(0)) is None


def test_readers_find_nothing_where_the_program_records_nothing(clean, monkeypatch):
    assert all(read(Ctx(3)) is None for read in (
        program.host_ms_per_call, program.kmeans_seconds, program.layout_seconds))
    # an older program: the tracing module has no snapshot
    monkeypatch.delattr(tracing, "snapshot")
    tracing._add("ivf.search", 0.001)
    assert program.host_ms_per_call(Ctx(1)) is None


def test_each_new_metric_has_its_reader():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    names = {m["name"]: m for m in bench["per_layer"]}
    cell = spec.load("d384-serve8")
    for name in NEW:
        assert names[name]["source"] == "program_span"
        assert callable(cell.reader(name))


def test_traced_tiny_line_carries_the_program_metrics(tmp_path, clean):
    root = make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            m["workloads"].append("tiny-serve8")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load("tiny-serve8", root)
    assert [m["name"] for m in cell.per_layer] == list(NEW)
    result = harness.run_cell(cell, 2**31 + 7, 1.5, True, torch.device("cpu"),
                              time.perf_counter())
    assert result["correct"] is True
    for name in NEW:
        value = result["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
    # the search spans held the traced calls alone
    assert tracing.snapshot()["spans"]["ivf.search"]["count"] <= result["attempted"] // 8


def test_program_spans_are_not_operations_of_the_trace():
    """Under a profiler the program's spans are on; the ``Trace`` leaves
    them out, as it leaves out its own search span, and keeps every
    operator."""
    from semcode_tpu_torch.index.scan import stable_topk

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        with torch.profiler.record_function(SPAN):
            stable_topk(torch.randn(4, 64), 5)
    events = [e.name for e in p.events()]
    assert tracing.PREFIX + "topk" in events
    trace = from_profile(p, [0], 0.001)
    assert len(trace.spans) == 1 and trace.device_ops == []
    ops = sorted(n for _, _, n in trace.host_ops)
    assert ops == sorted(n for n in events if n != SPAN and not n.startswith(tracing.PREFIX))
    assert "aten::topk" in ops


# -- perfbench.spans: device time and idle gaps put down to program spans ------


def event(name, start, end, device="CPU", id=0, thread=1, annotation=False):
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, device_type=getattr(DeviceType, device), id=id,
                           thread=thread, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


class Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_innermost_span_of_a_time():
    from perfbench.spans import innermost

    found = [(0.0, 10.0, "a"), (2.0, 5.0, "b"), (6.0, 9.0, "c")]
    assert [innermost(found, t) for t in (1, 3, 5.5, 7, 11)] == ["a", "b", "a", "c", None]


def test_device_time_goes_to_the_span_around_its_launch():
    from perfbench.spans import device_time_by_span

    prof = Prof([
        event("semcode.a", 0, 10), event("semcode.b", 2, 5),
        event("aten::mm", 2.5, 4, id=7),                 # an operator: ids may collide
        event("cudaLaunchKernel", 3, 3.5, id=7),
        event("cudaLaunchKernel", 6, 6.5, id=8),
        event("kernel_b", 4, 6, device="CUDA", id=7),
        event("kernel_a", 7, 10, device="CUDA", id=8),
        event("kernel_unlaunched", 11, 12, device="CUDA", id=9),
        event("semcode.a", 0, 10, device="CUDA", id=1, annotation=True),
        event(SPAN, 0, 12, device="CUDA", id=2),
    ])
    got = {k: round(v * 1e6, 6) for k, v in device_time_by_span(prof).items()}
    assert got == {"b": 2.0, "a": 3.0, "-": 1.0}


def test_gaps_outside_operators_are_named_by_span():
    from perfbench.spans import gaps_by_span
    from perfbench.trace import Trace

    trace = Trace(device_ops=[(1.0, 2.0, "k")], spans=[(0.0, 10.0)],
                  host_ops=[(2.0, 4.0, "aten::x")], calls=[0], wall_s=1e-5)
    prof = Prof([event("semcode.a", 0, 10), event("semcode.b", 5, 9)])
    got = {k: round(v * 1e6, 6) for k, v in gaps_by_span(trace, prof)}
    assert got == {"span: a": 1.0, "span: b": 8.0}
    # with no program span the gaps keep the trace's own names
    plain = {k: round(v * 1e6, 6) for k, v in gaps_by_span(trace, Prof([]))}
    assert plain == {k: round(v * 1e6, 6) for k, v in trace.breakdown()["idle_gaps"]}
