"""The exact route's CUDA graph (``index/scan.ExactRoute.scan``,
``_ScanGraphs``): graphed answers against the eager path's, bit for bit.

The ``cuda``-marked tests need an NVIDIA card and nvcc and skip without
them. This file imports nothing of JAX, so it runs on a card host that has
no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_scan_graph.py -q

On the CPU the graph never engages (the CPU tests below), and the cache's
policy (eager calls up to a key's capture, a snapshot swap, the LRU, the
pools' byte bound, failed captures) is held with a stand-in capture and
replay that run the step eagerly. Most tests capture a key at its second
call; one holds the default count.
"""

import threading

import numpy as np
import pytest
import torch

from semcode_tpu_torch.index import scan
from semcode_tpu_torch.index.flat import FlatIndex
from semcode_tpu_torch.index.ivf import IVFIndex
from semcode_tpu_torch.index.scan import ExactRoute, _ScanGraphs
from semcode_tpu_torch.ops import scan_top2
from semcode_tpu_torch.utils import tracing

GRAPH_COUNTERS = ("scan.graph.capture", "scan.graph.replay", "scan.graph.eager")


@pytest.fixture()
def cuda(monkeypatch):
    """The card, with keys captured at their second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    monkeypatch.setattr(scan, "SCAN_CAPTURE_CALLS", 2)
    return torch.device("cuda")


def _counters(*names):
    c = tracing.snapshot()["counters"]
    return tuple(c.get(n, 0) for n in names)


def _moved(before, names=GRAPH_COUNTERS):
    return tuple(a - b for a, b in zip(_counters(*names), before))


def _rows(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((64, d)).astype(np.float32)
    x = centers[rng.integers(0, 64, n)]
    x += 0.3 * rng.standard_normal(x.shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _queries(x, n, seed):
    rng = np.random.default_rng(seed)
    q = x[:n] + 0.05 * rng.standard_normal((n, x.shape[1])).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _same(a, b):
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
    assert torch.equal(a[1], b[1])


def _eager(route, monkeypatch, *args, **kw):
    """The call with the graph turned away: today's eager code."""
    with monkeypatch.context() as m:
        m.setattr(ExactRoute, "_graphed", lambda *_: False)
        return route.scan(*args, **kw)


# -- on the CPU ----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["flat", "ivf"])
@pytest.mark.parametrize("allow", [None, [1]])
def test_cpu_never_engages_the_graph(kind, allow):
    """On the CPU every call runs the eager code: the counters of the graph
    do not move, the route's cache stays empty, and repeated calls give the
    same bits as the step called directly."""
    x = _rows(2048, 128, 1)
    tags = (np.arange(2048) % 4).astype(np.int32)
    if kind == "flat":
        idx = FlatIndex(128, dtype="int8", device="cpu")
    else:
        idx = IVFIndex(128, nlist=16, nprobe=4, dtype="int8", device="cpu")
    idx.add(x, tags=tags)
    q = torch.from_numpy(_queries(x, 8, 2))
    before = _counters(*GRAPH_COUNTERS)
    rows = idx._ensure_device()
    outs = [idx._route.scan(idx.mesh, rows, q, 10, allow) for _ in range(3)]
    assert _moved(before) == (0, 0, 0)
    assert not idx._route._graphs.graphs
    direct = scan.exact_scan(
        idx.mesh, rows.fvecs, rows.fnorms, rows.fvalid, rows.fscales,
        rows.frescore, q, 10, 128, "ip", "int8", score_dtype="float32",
        tags=rows.ftags if allow else None,
        allow=scan.allow_device(allow, "cpu"), rescore_width=32)
    for out in outs:
        _same(out, direct)


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_snapshot_tensors_are_the_routes_operands(kind):
    """The identity a graph keys on is the six exact-route fields' shard
    tensors, for the flat index's ``ExactRows`` and for the IVF index's
    snapshot (which carries more fields: the layout, the centroids)."""
    x = _rows(1024, 128, 5)
    if kind == "flat":
        idx = FlatIndex(128, dtype="int8", rescore_mode="residual", device="cpu")
    else:
        idx = IVFIndex(128, nlist=8, nprobe=2, dtype="int8", rescore_mode="residual",
                       device="cpu")
    idx.add(x)
    snap = idx._ensure_device()
    got = scan._snapshot_tensors(idx.mesh, snap)
    fields = (snap.fvecs, snap.fnorms, snap.fvalid, snap.fscales) + tuple(
        snap.frescore) + (snap.ftags,)
    assert len(got) == 7 and all(g is f.shard(0) for g, f in zip(got, fields))


def test_graphed_is_false_off_the_card():
    """The graph's conditions on a CPU call, and on a batched one."""
    idx = FlatIndex(128, dtype="int8", device="cpu")
    idx.add(_rows(512, 128, 3))
    rows = idx._ensure_device()
    q = torch.from_numpy(_queries(_rows(512, 128, 3), 4, 4))
    assert not idx._route._graphed(idx.mesh, rows, q, rows.fvecs.shard_rows, 10, 128,
                                   32, "float32")
    before = _counters(*GRAPH_COUNTERS)
    s, i = idx.search_device_batched(torch.stack([q, q]), 10)
    assert s.shape == (2, 4, 10) and _moved(before) == (0, 0, 0)


class _StandIn:
    """A graph that runs the step eagerly: the cache's policy alone."""

    fail = False
    bytes = 10

    def capture(graphs, entry, q, allow, run):
        if _StandIn.fail:
            entry.failed = True
        else:
            entry.graph, entry.run, entry.bytes = "captured", run, _StandIn.bytes

    def replay(graphs, entry, q, allow, counter):
        tracing.count(counter)
        return entry.run(q, allow)


@pytest.fixture()
def stand_in(monkeypatch):
    _StandIn.fail, _StandIn.bytes = False, 10
    monkeypatch.setattr(scan, "SCAN_CAPTURE_CALLS", 2)
    monkeypatch.setattr(_ScanGraphs, "_capture", _StandIn.capture)
    monkeypatch.setattr(_ScanGraphs, "_replay", _StandIn.replay)
    return _StandIn


def _step(q, allow):
    return q.sum(dim=1), torch.zeros(q.shape[0], dtype=torch.int64)


def _snap(n=2):
    return tuple(torch.zeros(1) for _ in range(n))


def test_cache_captures_on_the_second_call(stand_in):
    graphs, snap = _ScanGraphs(), _snap()
    q = torch.ones(4, 8)
    before = _counters(*GRAPH_COUNTERS)
    for _ in range(5):
        out = graphs.scan(snap, ("k",), q, None, _step)
        assert torch.equal(out[0], torch.full((4,), 8.0))
    assert _moved(before) == (1, 3, 1)
    assert list(graphs.graphs) == [("k",)]
    assert graphs.graphs[("k",)].graph == "captured"


def test_cache_captures_after_its_calls_on_a_snapshot(stand_in, monkeypatch):
    """With the default count, a key's first 15 calls on a snapshot run
    eagerly and its 16th captures; on a new snapshot the count starts over,
    so a snapshot that serves fewer calls never pays a capture."""
    monkeypatch.setattr(scan, "SCAN_CAPTURE_CALLS", 16)
    graphs, snap = _ScanGraphs(), _snap()
    q = torch.ones(2, 8)
    before = _counters(*GRAPH_COUNTERS)
    for _ in range(20):
        graphs.scan(snap, ("k",), q, None, _step)
    assert _moved(before) == (1, 4, 15)
    for _ in range(10):
        snap = _snap()
        for _ in range(8):
            graphs.scan(snap, ("k",), q, None, _step)
    assert _moved(before) == (1, 4, 95)


def test_cache_drops_its_graphs_on_a_new_snapshot(stand_in):
    graphs, old, new = _ScanGraphs(), _snap(), _snap()
    q = torch.ones(2, 8)
    for _ in range(3):
        graphs.scan(old, ("k",), q, None, _step)
    held = graphs.graphs[("k",)]
    before = _counters(*GRAPH_COUNTERS)
    graphs.scan(new, ("k",), q, None, _step)
    assert graphs.graphs[("k",)] is not held and _moved(before) == (0, 0, 1)
    graphs.scan(new, ("k",), q, None, _step)
    graphs.scan(new, ("k",), q, None, _step)
    assert _moved(before) == (1, 1, 1)
    # a snapshot that differs in one tensor (a remove's new liveness) is new
    graphs.scan(new[:1] + _snap(1), ("k",), q, None, _step)
    assert _moved(before) == (1, 1, 2)


def test_cache_holds_its_snapshot_weakly(stand_in):
    """The graphs keep no snapshot alive, and a snapshot made after the old
    one died is new to them, whatever ids its tensors reuse."""
    graphs, q = _ScanGraphs(), torch.ones(2, 8)
    snap = _snap()
    ref = __import__("weakref").ref(snap[0])
    for _ in range(2):
        graphs.scan(snap, ("k",), q, None, _step)
    del snap
    assert ref() is None
    before = _counters(*GRAPH_COUNTERS)
    graphs.scan(_snap(), ("k",), q, None, _step)
    assert _moved(before) == (0, 0, 1)


def test_cache_keeps_the_most_recent_keys(stand_in, monkeypatch):
    monkeypatch.setattr(scan, "SCAN_GRAPHS", 2)
    graphs, snap = _ScanGraphs(), _snap()
    for key in ("a", "b", "c"):
        for _ in range(2):
            graphs.scan(snap, (key,), torch.ones(1, 8), None, _step)
    assert list(graphs.graphs) == [("b",), ("c",)]
    graphs.scan(snap, ("b",), torch.ones(1, 8), None, _step)  # b most recent
    before = _counters(*GRAPH_COUNTERS)
    graphs.scan(snap, ("a",), torch.ones(1, 8), None, _step)  # a new entry; c leaves
    graphs.scan(snap, ("a",), torch.ones(1, 8), None, _step)  # captured
    assert list(graphs.graphs) == [("b",), ("a",)]
    assert _moved(before) == (1, 0, 1)


def test_cache_bounds_its_graphs_bytes(stand_in, monkeypatch):
    """Past ``SCAN_GRAPH_BYTES`` in the pools, the least recently used
    graphs go and the newest stays, even alone over the bound."""
    monkeypatch.setattr(scan, "SCAN_GRAPH_BYTES", 25)
    graphs, snap = _ScanGraphs(), _snap()
    for key in ("a", "b"):
        for _ in range(2):
            graphs.scan(snap, (key,), torch.ones(1, 8), None, _step)
    assert list(graphs.graphs) == [("a",), ("b",)]
    graphs.scan(snap, ("a",), torch.ones(1, 8), None, _step)  # a most recent
    for _ in range(2):
        graphs.scan(snap, ("c",), torch.ones(1, 8), None, _step)
    assert list(graphs.graphs) == [("a",), ("c",)]
    stand_in.bytes = 40
    for _ in range(2):
        graphs.scan(snap, ("d",), torch.ones(1, 8), None, _step)
    assert list(graphs.graphs) == [("d",)]


def test_cache_runs_a_failed_key_eagerly(stand_in):
    stand_in.fail = True
    graphs, snap = _ScanGraphs(), _snap()
    q = torch.ones(3, 8)
    before = _counters(*GRAPH_COUNTERS)
    for _ in range(6):
        out = graphs.scan(snap, ("k",), q, None, _step)
        assert torch.equal(out[0], torch.full((3,), 8.0))
    entry = graphs.graphs[("k",)]
    assert entry.failed and entry.graph is None
    assert _moved(before) == (0, 0, 6)


@pytest.mark.parametrize("n,bucket", [(1, 1), (5, 5), (16, 16), (17, 32), (64, 64),
                                      (300, 512), (512, 512), (513, 1024)])
def test_query_buckets(n, bucket):
    assert scan._q_bucket(n) == bucket


def test_batcher_sizes_make_few_keys():
    """The API's micro-batcher sends 1 to 64 queries a group: 18 buckets."""
    assert len({scan._q_bucket(n) for n in range(1, 65)}) == 18


# -- on the card ---------------------------------------------------------------

_BUILT = {}


def _flat(device, metric, tier):
    """A 65,536 x 384 int8 flat index on the card (1% tagged 1), built once
    a (metric, tier)."""
    key = (metric, tier)
    if key not in _BUILT:
        x = _rows(65536, 384, 11)
        tags = (np.arange(65536) % 100 == 7).astype(np.int32)
        idx = FlatIndex(384, metric=metric, dtype="int8", rescore_mode=tier,
                        device=device)
        idx.add(x, tags=tags)
        _BUILT[key] = (idx, x)
    idx, x = _BUILT[key]
    idx._route._graphs = _ScanGraphs()
    return idx, x


@pytest.mark.cuda
@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("allow", [None, [1]])
@pytest.mark.parametrize("k,width", [(10, 0), (21, 64)])
@pytest.mark.parametrize("nq", [8, 512])
@pytest.mark.parametrize("tier", ["f32", "residual"])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_graphed_scan_equals_eager(cuda, monkeypatch, metric, tier, nq, k, width,
                                   allow, merged):
    """Eager, then the capturing call (the warm-up's answer), then replays:
    every answer equals the eager path's bit for bit. ``width`` 64 is the
    top-W slice's widest on the kernel route."""
    idx, x = _flat(cuda, metric, tier)
    idx.rescore_width = width
    try:
        q = torch.from_numpy(_queries(x, nq, nq + k)).to(cuda)
        rows = idx._ensure_device()
        assert isinstance(rows.frescore, tuple) == (tier == "residual")
        args = (idx.mesh, rows, q, k, allow)
        eager = _eager(idx._route, monkeypatch, *args, merged=merged)
        before = _counters(*GRAPH_COUNTERS)
        for _ in range(5):
            _same(idx._route.scan(*args, merged=merged), eager)
        assert _moved(before) == (1, 3, 1)
    finally:
        idx.rescore_width = 0


@pytest.mark.cuda
@pytest.mark.parametrize("allow", [None, [1]])
@pytest.mark.parametrize("nq", [1, 5, 13, 17, 100, 300])
@pytest.mark.parametrize("tier", ["f32", "residual"])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_padded_buckets_equal_eager(cuda, monkeypatch, metric, tier, nq, allow):
    """A Q past 16 replays its power-of-two bucket's graph on padded rows,
    one up to 16 its own: either way the answers equal the eager call's on
    the Q rows alone, bit for bit."""
    idx, x = _flat(cuda, metric, tier)
    q = torch.from_numpy(_queries(x, nq, nq + 7)).to(cuda)
    rows = idx._ensure_device()
    args = (idx.mesh, rows, q, 10, allow)
    eager = _eager(idx._route, monkeypatch, *args)
    for _ in range(4):
        _same(idx._route.scan(*args), eager)
    (entry,) = idx._route._graphs.graphs.values()
    assert entry.q.shape[0] == scan._q_bucket(nq) and entry.graph is not None


@pytest.mark.cuda
def test_flat_recaptures_after_add_and_remove(cuda):
    """An add and a remove each hand the route a new snapshot: its graphs
    go, the key is captured again, and the replays see the new rows and
    miss the tombstoned ones."""
    x = _rows(8192, 128, 21)
    idx = FlatIndex(128, dtype="int8", device=cuda)
    idx.add(x)
    new = _rows(64, 128, 22)
    q = torch.from_numpy(new[:8]).to(cuda)
    for _ in range(3):
        idx.search_device(q, 10)
    assert len(idx._route._graphs.graphs) == 1
    ids = idx.add(new)
    before = _counters(*GRAPH_COUNTERS)
    for _ in range(3):
        _, got = idx.search_device(q, 10)
        assert torch.equal(got[:, 0].cpu(), torch.from_numpy(ids[:8]))
    assert _moved(before) == (1, 1, 1)
    idx.remove(ids[:8])
    before = _counters(*GRAPH_COUNTERS)
    for _ in range(3):
        _, got = idx.search_device(q, 10)
        assert not np.isin(got.cpu().numpy(), ids[:8]).any()
    assert _moved(before) == (1, 1, 1)


@pytest.mark.cuda
def test_ivf_recaptures_after_a_fold(cuda):
    """The IVF index's exact route: rows in the pending tail are merged
    after the replay (the snapshot stays, so the graph does); the fold that
    a full tail makes swaps the snapshot, and the key is captured again."""
    x = _rows(4096, 128, 31)
    idx = IVFIndex(128, nlist=16, nprobe=4, dtype="int8", device=cuda)
    idx.add(x)
    idx.PENDING_THRESHOLD_BYTES = 0
    idx.PENDING_CAP = 256
    first, second = _rows(128, 128, 32), _rows(256, 128, 33)
    q1 = torch.from_numpy(first[:8]).to(cuda)
    q2 = torch.from_numpy(second[:8]).to(cuda)
    for _ in range(3):
        idx.search_device(q1, 10, mode="exact")
    ids1 = idx.add(first)
    assert idx._pend is not None
    before = _counters(*GRAPH_COUNTERS)
    _, got = idx.search_device(q1, 10, mode="exact")
    assert torch.equal(got[:, 0].cpu(), torch.from_numpy(ids1[:8]))
    assert _moved(before) == (0, 1, 0)
    ids2 = idx.add(second)  # 128 + 256 > 256: the tail folds first
    before = _counters(*GRAPH_COUNTERS)
    for _ in range(3):
        _, got = idx.search_device(q1, 10, mode="exact")
        assert torch.equal(got[:, 0].cpu(), torch.from_numpy(ids1[:8]))
        _, got = idx.search_device(q2, 10, mode="exact")
        assert torch.equal(got[:, 0].cpu(), torch.from_numpy(ids2[:8]))
    assert _moved(before) == (1, 4, 1)


@pytest.mark.cuda
def test_graphs_lru_on_the_card(cuda, monkeypatch):
    monkeypatch.setattr(scan, "SCAN_GRAPHS", 2)
    idx, x = _flat(cuda, "ip", "f32")
    qs = {n: torch.from_numpy(_queries(x, n, n)).to(cuda) for n in (8, 16, 32)}
    eager = {n: _eager(idx._route, monkeypatch, idx.mesh, idx._ensure_device(), q, 10)
             for n, q in qs.items()}
    for n in (8, 16, 32):
        for _ in range(3):
            _same(idx.search_device(qs[n], 10), eager[n])
    assert [key[0] for key in idx._route._graphs.graphs] == [16, 32]
    before = _counters(*GRAPH_COUNTERS)
    for _ in range(3):
        _same(idx.search_device(qs[8], 10), eager[8])
    assert _moved(before) == (1, 1, 1)
    assert [key[0] for key in idx._route._graphs.graphs] == [32, 8]


@pytest.mark.cuda
@pytest.mark.parametrize("keys", ["one", "two"])
def test_two_threads_replay(cuda, monkeypatch, keys):
    """Two threads, each on its own stream, replay 100 times each with their
    own queries, through one key or through two: every answer is the
    thread's own."""
    idx, x = _flat(cuda, "ip", "f32")
    qa = torch.from_numpy(_queries(x, 8, 41)).to(cuda)
    qb = torch.from_numpy(_queries(x[4096:], 8 if keys == "one" else 64, 42)).to(cuda)
    rows = idx._ensure_device()
    want = {id(q): _eager(idx._route, monkeypatch, idx.mesh, rows, q, 10) for q in (qa, qb)}
    for q in (qa, qb):
        for _ in range(2):
            idx.search_device(q, 10)
    graphs = [e.graph for e in idx._route._graphs.graphs.values()]
    assert len(graphs) == (1 if keys == "one" else 2) and all(graphs)
    errors = []

    def reader(q):
        try:
            with torch.cuda.stream(torch.cuda.Stream(cuda)):
                for _ in range(100):
                    out = idx.search_device(q, 10)
                    torch.cuda.current_stream(cuda).synchronize()
                    _same(out, want[id(q)])
        except AssertionError as exc:  # reported below, with the thread's name
            errors.append(exc)

    threads = [threading.Thread(target=reader, args=(q,)) for q in (qa, qb)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors


@pytest.mark.cuda
def test_keys_replay_in_turns(cuda, monkeypatch):
    """Graphs of three keys replayed in turns with new queries each time and
    read only after the next key's replay: each answer is its own call's."""
    idx, x = _flat(cuda, "l2", "residual")
    rows = idx._ensure_device()
    sizes = (8, 64, 512)
    for n in sizes:
        q = torch.from_numpy(_queries(x, n, n)).to(cuda)
        for _ in range(2):
            idx.search_device(q, 10)
    outs = []
    for turn in range(3):
        for n in sizes:
            q = torch.from_numpy(_queries(x[turn * 1000:], n, 100 + turn)).to(cuda)
            outs.append((q, idx.search_device(q, 10)))
    for q, out in outs:
        _same(out, _eager(idx._route, monkeypatch, idx.mesh, rows, q, 10))


@pytest.mark.cuda
def test_pool_bytes_bound_the_graphs_on_the_card(cuda, monkeypatch):
    """Each graph's pool is measured at capture (the allocator's segments in
    it); past the bound the older graph goes."""
    idx, x = _flat(cuda, "ip", "residual")
    qs = [torch.from_numpy(_queries(x, n, n)).to(cuda) for n in (8, 512)]
    for q in qs:
        for _ in range(2):
            idx.search_device(q, 10)
    entries = list(idx._route._graphs.graphs.values())
    assert len(entries) == 2 and all(e.bytes > 0 for e in entries)
    assert entries[1].bytes > entries[0].bytes
    monkeypatch.setattr(scan, "SCAN_GRAPH_BYTES", entries[1].bytes)
    q = torch.from_numpy(_queries(x, 64, 64)).to(cuda)
    for _ in range(2):
        idx.search_device(q, 10)
    assert [key[0] for key in idx._route._graphs.graphs] == [64]


@pytest.mark.cuda
def test_replays_are_counted_by_the_replay_counter_alone(cuda, monkeypatch):
    """A replay launches nothing through the kernel's wrapper: it moves
    ``scan.graph.replay`` and one ``scan.graph`` span, and neither
    ``scan.select.kernel`` nor ``scan_topk.launches``; the capturing call
    counts what an eager call counts."""
    idx, x = _flat(cuda, "ip", "residual")
    q = torch.from_numpy(_queries(x, 512, 51)).to(cuda)

    def counts():
        return (_counters("scan.select.kernel")[0], scan_top2.scan_topk.launches)

    c0 = counts()
    idx.search_device(q, 10)  # the key's first call: eager
    per_call = tuple(b - a for a, b in zip(c0, counts()))
    assert per_call[0] == 1 and per_call[1] >= 1
    c1 = counts()
    idx.search_device(q, 10)  # the capture
    assert tuple(b - a for a, b in zip(c1, counts())) == per_call
    tracing.enable()
    try:
        spans0 = tracing.snapshot()["spans"].get("scan.graph", {"count": 0})["count"]
        c2, before = counts(), _counters(*GRAPH_COUNTERS)
        for _ in range(4):
            idx.search_device(q, 10)
        assert counts() == c2 and _moved(before) == (0, 4, 0)
        assert tracing.snapshot()["spans"]["scan.graph"]["count"] == spans0 + 4
    finally:
        tracing.enable(False)


@pytest.mark.cuda
def test_a_failed_capture_stays_eager(cuda, monkeypatch):
    """A step that cannot be captured (a host copy inside it) leaves its key
    eager from then on, with the eager answers."""
    idx, x = _flat(cuda, "ip", "f32")
    q = torch.from_numpy(_queries(x, 8, 61)).to(cuda)
    want = _eager(idx._route, monkeypatch, idx.mesh, idx._ensure_device(), q, 10)
    real = scan.exact_scan

    def copying(*args, **kw):
        out = real(*args, **kw)
        if torch.cuda.is_current_stream_capturing():
            out[0].cpu()
        return out

    monkeypatch.setattr(scan, "exact_scan", copying)
    before = _counters(*GRAPH_COUNTERS)
    for _ in range(5):
        _same(idx.search_device(q, 10), want)
    assert _moved(before) == (0, 0, 5)
    (entry,) = idx._route._graphs.graphs.values()
    assert entry.failed and entry.graph is None
