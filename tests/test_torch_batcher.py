"""Dynamic micro-batching of concurrent /query requests, on the port.

The cases of ``tests/integration/test_query_batching.py`` on
``semcode_tpu_torch.api``; the batcher's grouping and ``split`` sub-groups
held equal to the JAX package's on the same queue; and 16 concurrent
``/query`` requests over a real CPU store answered as 16 serial
``pipeline.query`` calls answer them.
"""

import asyncio
import threading
import time

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from semcode_tpu_torch.api.main import create_app
from semcode_tpu_torch.settings import AppSettings


class BatchTrackingPipeline:
    def __init__(self):
        self.single_calls = 0
        self.batch_calls = []

    def query(self, question, top_k=None, filters=None):
        self.single_calls += 1
        return {"answer": f"single:{question}", "sources": [], "meta": {}}

    def query_batch(self, questions, top_k=None, filters=None):
        self.batch_calls.append(len(questions))
        return [
            {"answer": f"batched:{q}", "sources": [], "meta": {}}
            for q in questions
        ]


def _run(app, scenario):
    async def go():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            return await scenario(client)
        finally:
            await client.close()

    return asyncio.run(go())


def test_concurrent_queries_get_batched(tmp_path):
    pipeline = BatchTrackingPipeline()
    cfg = AppSettings(workspace_root=tmp_path, api_batch_window_ms=25.0,
                      api_batch_max=16)

    async def scenario(client):
        responses = await asyncio.gather(
            *[client.post("/query", json={"question": f"q{i}"}) for i in range(8)]
        )
        return [r.status for r in responses], [await r.json() for r in responses]

    statuses, bodies = _run(create_app(config=cfg, device="cpu", pipeline=pipeline),
                            scenario)
    assert all(s == 200 for s in statuses)
    # every question answered with ITS result, not a neighbor's
    for i, body in enumerate(bodies):
        assert body["answer"].endswith(f":q{i}")
    assert pipeline.batch_calls and max(pipeline.batch_calls) >= 2


def test_list_valued_filters_do_not_strand_requests(tmp_path):
    """List filter values ({"repo": ["a","b"]}) must resolve, not strand
    the caller behind a dead batcher worker."""
    pipeline = BatchTrackingPipeline()

    async def scenario(client):
        r = await asyncio.wait_for(
            client.post("/query", json={
                "question": "q",
                "filters": {"repo": ["a", "b"], "language": "python"},
            }),
            timeout=10,
        )
        return r.status, await r.json()

    status, body = _run(
        create_app(config=AppSettings(workspace_root=tmp_path), device="cpu",
                   pipeline=pipeline),
        scenario)
    assert status == 200 and body["answer"] == "single:q"


def test_overloaded_queue_sheds_load_with_503(tmp_path):
    """Beyond api_queue_max pending queries the server answers 503
    immediately instead of queueing unboundedly."""
    block = threading.Event()

    class SlowPipeline(BatchTrackingPipeline):
        def query(self, question, top_k=None, filters=None):
            block.wait(5)
            return super().query(question, top_k=top_k, filters=filters)

        def query_batch(self, questions, top_k=None, filters=None):
            block.wait(5)
            return super().query_batch(questions, top_k=top_k, filters=filters)

    cfg = AppSettings(workspace_root=tmp_path, api_queue_max=2,
                      api_max_workers=1, api_batch_window_ms=1.0,
                      api_query_timeout_s=30.0)

    async def scenario(client):
        try:
            tasks = [asyncio.create_task(
                client.post("/query", json={"question": f"q{i}"}))
                for i in range(12)]
            await asyncio.sleep(0.5)  # let the queue fill while blocked
            block.set()
            return sorted(r.status for r in await asyncio.gather(*tasks))
        finally:
            block.set()

    statuses = _run(create_app(config=cfg, device="cpu", pipeline=SlowPipeline()),
                    scenario)
    assert 503 in statuses and 200 in statuses, statuses


def test_query_timeout_returns_504(tmp_path):
    class HangingPipeline(BatchTrackingPipeline):
        def query(self, question, top_k=None, filters=None):
            time.sleep(3)
            return super().query(question, top_k=top_k, filters=filters)

        def query_batch(self, questions, top_k=None, filters=None):
            time.sleep(3)
            return super().query_batch(questions, top_k=top_k, filters=filters)

    cfg = AppSettings(workspace_root=tmp_path, api_query_timeout_s=0.5)

    async def scenario(client):
        r = await client.post("/query", json={"question": "slow"})
        return r.status, await r.text()

    status, text = _run(
        create_app(config=cfg, device="cpu", pipeline=HangingPipeline()), scenario)
    assert status == 504, text


@pytest.mark.parametrize("split", [1, 2, 3])
def test_grouping_and_split_match_jax(split):
    """One window of 13 requests over three (top_k, filters) groups: both
    packages' batchers run the same calls with the same questions."""
    from concurrent.futures import ThreadPoolExecutor

    from semcode_tpu.api.batcher import QueryBatcher as JaxBatcher
    from semcode_tpu_torch.api.batcher import QueryBatcher

    class Recorder:
        def __init__(self):
            self.calls = []
            self.lock = threading.Lock()

        def query(self, question, top_k=None, filters=None):
            with self.lock:
                self.calls.append(("query", (question,), top_k, filters))
            return {"answer": question}

        def query_batch(self, questions, top_k=None, filters=None):
            with self.lock:
                self.calls.append(("batch", tuple(questions), top_k, filters))
            return [{"answer": q} for q in questions]

    requests = ([(f"a{i}", 5, None) for i in range(8)]
                + [(f"b{i}", 3, {"repo": ["x", "y"]}) for i in range(4)]
                + [("c0", 5, {"language": "python"})])

    def run(cls):
        rec = Recorder()
        with ThreadPoolExecutor(max_workers=4) as pool:
            batcher = cls(rec, pool, max_batch=64, window_ms=50.0, split=split)

            async def go():
                return await asyncio.gather(*[
                    batcher.query(q, top_k=k, filters=f) for q, k, f in requests])

            answers = asyncio.run(go())
        assert [a["answer"] for a in answers] == [q for q, _, _ in requests]
        return sorted(rec.calls, key=repr)

    calls = run(QueryBatcher)
    assert calls == run(JaxBatcher)
    sizes = sorted(len(c[1]) for c in calls)
    want = {1: [1, 4, 8], 2: [1, 2, 2, 4, 4], 3: [1, 2, 3, 3, 4]}[split]
    assert sizes == want


def test_queue_full_raises_overloaded():
    from concurrent.futures import ThreadPoolExecutor

    from semcode_tpu_torch.api.batcher import BatcherOverloaded, QueryBatcher

    with ThreadPoolExecutor(max_workers=1) as pool:
        batcher = QueryBatcher(BatchTrackingPipeline(), pool, window_ms=50.0,
                               queue_max=2)

        async def go():
            tasks = [asyncio.ensure_future(batcher.query(f"q{i}")) for i in range(3)]
            done = await asyncio.gather(*tasks, return_exceptions=True)
            return done

        out = asyncio.run(go())
    assert isinstance(out[2], BatcherOverloaded)
    assert [o["answer"] for o in out[:2]] == ["batched:q0", "batched:q1"]


# -- a real store on the CPU -----------------------------------------------------


@pytest.fixture(scope="module")
def real_pipeline(tmp_path_factory):
    from semcode_tpu_torch.embeddings.hash_embedder import HashEmbeddings
    from semcode_tpu_torch.embeddings.providers import EmbeddingPayload
    from semcode_tpu_torch.index.store import VectorStore
    from semcode_tpu_torch.rag import SemanticSearchPipeline

    cfg = AppSettings(workspace_root=tmp_path_factory.mktemp("ws"),
                      embedding_dimension=128,
                      index_kind="flat", rag_query_cache_size=0,
                      api_batch_window_ms=20.0, api_batch_max=64)
    emb = HashEmbeddings(dim=128, device="cpu")
    rng = np.random.default_rng(0)
    verbs = ("parse", "build", "merge", "scan", "flush", "encode")
    texts = [
        f"def {verbs[i % 6]}_item_{i}(arg):\n    return compute_{i}(arg) "
        + " ".join(f"tok{int(t)}" for t in rng.integers(0, 40, 6))
        for i in range(300)
    ]
    store = VectorStore(cfg, device="cpu")
    store.upsert_embeddings([
        EmbeddingPayload(id=f"c{i}", text=texts[i], vector=v,
                         metadata={"repo": f"r{i % 3}", "path": f"f{i}.py",
                                   "language": "python"})
        for i, v in enumerate(emb.embed_documents(texts))
    ])
    return cfg, SemanticSearchPipeline(config=cfg, vector_store=store,
                                       embeddings=emb, device="cpu")


def test_batched_answers_equal_serial(real_pipeline):
    """16 concurrent /query requests ride micro-batches (query_batch) and
    still answer exactly as 16 serial pipeline.query calls."""
    cfg, pipeline = real_pipeline
    questions = [f"{v} item {i} compute tok{i}" for i, v in
                 enumerate(("parse", "build", "merge", "scan") * 4)]
    serial = [pipeline.query(q, top_k=5) for q in questions]
    calls = []
    batch = pipeline.query_batch

    def tracking(qs, **kw):
        calls.append(len(qs))
        return batch(qs, **kw)

    pipeline.query_batch = tracking
    try:
        async def scenario(client):
            rs = await asyncio.gather(*[
                client.post("/query", json={"question": q, "top_k": 5})
                for q in questions])
            return [(r.status, await r.json()) for r in rs]

        out = _run(create_app(config=cfg, device="cpu", pipeline=pipeline), scenario)
    finally:
        del pipeline.query_batch
    assert calls and max(calls) >= 2
    assert [s for s, _ in out] == [200] * 16
    for (_, got), want in zip(out, serial):
        assert got["sources"]
        assert [(s["path"], s["score"]) for s in got["sources"]] == [
            (s["path"], s["score"]) for s in want["sources"]]
        assert got["answer"] == want["answer"]


def test_filtered_batches_equal_serial(real_pipeline):
    cfg, pipeline = real_pipeline
    questions = [f"merge item {i} tok{i}" for i in range(6)]
    filters = {"repo": ["r0", "r2"]}
    batched = pipeline.query_batch(questions, top_k=4, filters=filters)
    for q, b in zip(questions, batched):
        single = pipeline.query(q, top_k=4, filters=filters)
        assert b["sources"] and all(s["repo"] in ("r0", "r2") for s in b["sources"])
        assert [s["path"] for s in b["sources"]] == [
            s["path"] for s in single["sources"]]


def test_searches_read_consistent_snapshots_during_upserts():
    """The API's threads search while an ingest upserts: every search sees
    one generation of the index and of the lexical fingerprints (the four
    fingerprint arrays a reader builds are always the same length) and
    returns top_k hits. Writes grow both the index and the fingerprints
    several times over."""
    import sys

    from semcode_tpu_torch.embeddings.providers import EmbeddingPayload
    from semcode_tpu_torch.index.store import VectorStore

    cfg = AppSettings(workspace_root=None, embedding_dimension=32,
                      index_kind="flat")
    store = VectorStore(cfg, device="cpu")
    rng = np.random.default_rng(1)

    def payloads(lo, n):
        vecs = rng.standard_normal((n, 32)).astype(np.float32)
        return [EmbeddingPayload(id=f"p{lo + i}", text=f"def fn_{lo + i}(): tok{i}",
                                 vector=vecs[i],
                                 metadata={"repo": "r", "path": f"f{lo + i}.py",
                                           "language": "python"})
                for i in range(n)]

    store.upsert_embeddings(payloads(0, 40))
    queries = rng.standard_normal((4, 32)).astype(np.float32)
    errors, shapes = [], set()
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            try:
                hits = store.search_batch(queries, top_k=5,
                                          query_texts=["fn tok1"] * 4)
                assert all(len(h) == 5 for h in hits)
                dev = store._lex.device_arrays(0)
                shapes.add(tuple(int(a.shape[0]) for a in dev))
            except Exception as exc:  # noqa: BLE001 — reported below
                errors.append(repr(exc))
                return

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=reader, daemon=True) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        for lo in range(40, 40 + 24 * 40, 40):
            store.upsert_embeddings(payloads(lo, 40))
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert shapes and all(len(set(s)) == 1 for s in shapes), shapes
    assert store.count() == 1000
    # no reader installed a mirror older than the last write
    lex = store._lex
    for got, want in zip(lex.device_arrays(0), (lex._ids, lex._w, lex._len, lex._sym)):
        np.testing.assert_array_equal(got.take(np.arange(got.rows)).numpy(), want)
