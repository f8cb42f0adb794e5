"""The port's spans and counters (semcode_tpu_torch/utils/tracing.py).

- off: one shared no-op, no totals;
- on: totals and nesting under threads, and on a profiler's timeline;
- the IVF index's search spans by route, its route counters and its build
  phases; the pipeline's ``StageTimer`` as it was, its stages as spans.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from semcode_tpu_torch.utils import tracing
from semcode_tpu_torch.utils.tracing import StageTimer

P = tracing.PREFIX


@pytest.fixture(autouse=True)
def clean():
    tracing.enable(False)
    tracing.reset()
    yield
    tracing.enable(False)
    tracing.reset()


def spans_of(prof):
    """(name, start, end, thread) of the program's spans in a profile."""
    return [(e.name[len(P):], e.time_range.start, e.time_range.end, e.thread)
            for e in prof.events() if e.name.startswith(P)]


def holds(outer, inner) -> bool:
    return (outer[3] == inner[3] and outer[1] <= inner[1]
            and inner[2] <= outer[2])


def chain(found, names):
    """True when spans named ``names`` nest, each inside the one before."""
    def down(parent, rest):
        if not rest:
            return True
        return any(s[0] == rest[0] and holds(parent, s) and down(s, rest[1:])
                   for s in found)
    return any(s[0] == names[0] and down(s, names[1:]) for s in found)


def test_off_is_one_shared_noop():
    a, b = tracing.span("ivf.search"), tracing.span("scan.select", 3)
    assert a is b
    with a:
        with tracing.span("topk"):
            pass
    assert tracing.snapshot()["spans"] == {}


def test_counters_are_always_on():
    tracing.count("x")
    tracing.count("x", 4)
    tracing.count("y", 2)
    assert tracing.snapshot()["counters"] == {"x": 5, "y": 2}
    tracing.reset()
    assert tracing.snapshot() == {"counters": {}, "spans": {}}


def test_on_totals_and_nesting_under_threads():
    """More threads than cores and a short switch interval: a lost update
    to a total or a counter would show in the counts."""
    tracing.enable()
    n_threads, reps = min((os.cpu_count() or 2) + 2, 16), 200
    barrier = threading.Barrier(n_threads)

    def work(i):
        barrier.wait(timeout=30)
        for _ in range(reps):
            with tracing.span("outer"):
                with tracing.span("inner", i % 2):
                    tracing.count("done")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    snap = tracing.snapshot()
    assert snap["counters"] == {"done": n_threads * reps}
    assert snap["spans"]["outer"]["count"] == n_threads * reps
    n_odd = n_threads // 2
    assert snap["spans"]["inner@1"]["count"] == n_odd * reps
    assert snap["spans"]["inner@0"]["count"] == (n_threads - n_odd) * reps
    inner_s = snap["spans"]["inner@0"]["seconds"] + snap["spans"]["inner@1"]["seconds"]
    assert 0 < inner_s <= snap["spans"]["outer"]["seconds"]


def test_spans_nest_on_the_profilers_timeline():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with tracing.span("outer"):
                with tracing.span("inner", 0):
                    torch.ones(4).sum()
                with tracing.span("inner", 1):
                    pass
    found = spans_of(prof)
    outers = [s for s in found if s[0] == "outer"]
    inners = [s for s in found if s[0].startswith("inner@")]
    assert len(outers) == 3 and len(inners) == 6
    # each inner span lies inside exactly one outer span
    assert all(sum(holds(o, s) for o in outers) == 1 for s in inners)


def test_a_span_under_the_profiler_is_on_without_enable():
    assert tracing.span("a") is tracing.span("b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.span("a") is not tracing.span("b")
        with record_function("caller"):
            with tracing.span("a", "x"):
                pass
    assert tracing.span("a") is tracing.span("b")
    assert [s[0] for s in spans_of(prof)] == ["a@x"]
    assert tracing.snapshot()["spans"]["a@x"]["count"] == 1


def test_phase_keeps_its_total_while_off():
    with tracing.phase("build", 1):
        pass
    assert tracing.snapshot()["spans"]["build@1"]["count"] == 1


def test_span_events_are_told_apart():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("a"):
            torch.ones(3).sum()
    keys = {e.key: tracing.is_span_event(e) for e in prof.key_averages()}
    assert keys[P + "a"] is True
    assert keys["aten::sum"] is False


def test_stage_timer_output_is_unchanged():
    timer = StageTimer()
    with timer.stage("embed"):
        with timer.stage("inner"):
            pass
    with timer.stage("embed"):
        pass
    out = timer.as_dict()
    assert list(out) == ["inner", "embed"]
    assert all(isinstance(v, float) and v >= 0 and round(v, 3) == v for v in out.values())
    assert out["embed"] >= out["inner"]
    # off, its stages leave no span totals; on, each is a span stage.<name>
    assert tracing.snapshot()["spans"] == {}
    tracing.enable()
    with timer.stage("rerank"):
        pass
    assert tracing.snapshot()["spans"]["stage.rerank"]["count"] == 1
    assert set(timer.as_dict()) == {"inner", "embed", "rerank"}


# -- the IVF index --------------------------------------------------------------


@pytest.fixture(scope="module")
def index():
    from semcode_tpu_torch.index.ivf import IVFIndex

    rng = np.random.default_rng(0)
    x = rng.standard_normal((768, 128)).astype(np.float32)
    tracing.reset()
    idx = IVFIndex(128, nlist=8, nprobe=2, dtype="int8", kmeans_iters=2,
                   device="cpu")
    with idx.bulk(expected_rows=len(x)):
        idx.add(x[:512])
        idx.add(x[512:])
    built = tracing.snapshot()
    return idx, torch.from_numpy(x[:4]), built


def test_bulk_records_its_phases(index):
    _, _, built = index
    spans = built["spans"]
    for name in ("ivf.build.kmeans", "ivf.build.layout", "ivf.build.pack",
                 "ivf.build.layout.candidates", "ivf.build.layout.assign"):
        assert spans[name]["count"] == 1 and spans[name]["seconds"] > 0, name
    assert spans["ivf.add"]["count"] == 2
    assert spans["ivf.build.layout"]["seconds"] >= spans["ivf.build.layout.assign"]["seconds"]
    assert built["counters"]["ivf.layout_rebuild"] == 1
    assert "ivf.route.exact" not in built["counters"]


@pytest.mark.parametrize("mode,path", [
    ("exact", ["ivf.search", "ivf.exact", "scan.select@0", "topk"]),
    ("ivf", ["ivf.search", "ivf.probe", "ivf.probe.select", "topk"]),
])
def test_search_spans_nest_by_route(index, mode, path):
    idx, q, _ = index
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        idx.search_device(q, 5, mode=mode)
    found = spans_of(prof)
    assert chain(found, path), [s[0] for s in found]
    names = {s[0] for s in found}
    other = "ivf.probe" if mode == "exact" else "ivf.exact"
    assert other not in names
    if mode == "exact":
        assert {"scan.quantize", "scan.rescore@0", "scan.merge"} <= names
    else:
        assert {"ivf.probe.scan@0", "ivf.probe.merge", "ivf.rescore"} <= names
    # no pending tail, no pending span
    assert "ivf.pending" not in names


def test_route_counters_count_each_call_once(index):
    idx, q, _ = index
    for _ in range(3):
        idx.search_device(q, 5, mode="exact")
    for _ in range(2):
        idx.search_device(q, 5, mode="ivf")
    idx.search(q.numpy(), 5, mode="ivf")
    idx.search_device_batched(q[None], 5, mode="exact")
    idx.search_device_batched(q[None], 5, mode="probe")
    counters = tracing.snapshot()["counters"]
    assert counters["ivf.route.exact"] == 4
    assert counters["ivf.route.probe"] == 4
    # the searches were not traced
    assert tracing.snapshot()["spans"] == {}


def test_enabled_search_totals_without_a_profiler(index):
    idx, q, _ = index
    tracing.enable()
    for _ in range(3):
        idx.search_device(q, 5, mode="exact")
    spans = tracing.snapshot()["spans"]
    assert spans["ivf.search"]["count"] == spans["ivf.exact"]["count"] == 3
    assert spans["ivf.search"]["seconds"] >= spans["ivf.exact"]["seconds"] > 0
    # the shard's selection and its rescore each take one top-k a call
    assert spans["topk"]["count"] == 6


def test_pending_span_only_with_a_pending_tail(monkeypatch):
    from semcode_tpu_torch.index.ivf import IVFIndex

    rng = np.random.default_rng(1)
    x = rng.standard_normal((320, 128)).astype(np.float32)
    idx = IVFIndex(128, nlist=4, nprobe=2, kmeans_iters=2, device="cpu")
    idx.add(x[:256])
    q = torch.from_numpy(x[:2])
    tracing.enable()
    idx.search_device(q, 5, mode="exact")
    assert "ivf.pending" not in tracing.snapshot()["spans"]
    # past the threshold, inserts land in the pending tail
    monkeypatch.setattr(IVFIndex, "PENDING_THRESHOLD_BYTES", 0)
    idx.add(x[256:])
    assert idx._pend is not None
    idx.search_device(q, 5, mode="exact")
    idx.search_device_batched(q[None], 5, mode="exact")
    assert tracing.snapshot()["spans"]["ivf.pending"]["count"] == 2
