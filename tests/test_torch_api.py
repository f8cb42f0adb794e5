"""The API server (semcode_tpu_torch/api) against the JAX package's.

- stub contract: both packages' ``create_app`` over the same stub indexer
  and pipeline answer every route with equal status and JSON (``/stats``
  by its keys; job ids, clocks and durations masked);
- real engines: a JAX store self-ingested from ``semcode_tpu/index`` and
  saved is served by both apps over the one workspace: the same ``/query``
  paths (scores within 1e-5), ``/repos`` and ``/chunks``;
- the JAX file's endpoint cases on the port (``/compact``,
  ``/chunks/delete``, ``DELETE /repos``, the ephemeral workspace,
  telemetry off, warmup once), and a kernel failure answered with 502.
"""

import asyncio
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = ("semcode_tpu", "semcode_tpu_torch")
AUTH = {"X-API-Key": "secret"}
# fields that differ between two runs of the same scenario
_VOLATILE = {"id", "created_at", "updated_at", "duration_ms", "timestamp",
             "total_duration_ms", "avg_duration_ms", "last_timestamp"}


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _stubs(pkg, repo_root: Path):
    RepositoryRecord = _mod(pkg, "storage").RepositoryRecord
    RepositoryMetadata = _mod(pkg, "ingestion").RepositoryMetadata
    IndexingResult = _mod(pkg, "services.indexer").IndexingResult

    class StubRegistry:
        def list(self):
            return [RepositoryRecord(name="demo", languages=["python"],
                                     chunk_count=12)]

    class StubIngestion:
        workspace = repo_root / "ws"

    class StubIndexer:
        registry = StubRegistry()
        ingestion_manager = StubIngestion()
        vector_store = None

        def index_repository(self, paths, name, force=False, ignore_dirs=None,
                             callbacks=None):
            if callbacks and callbacks.stage:
                callbacks.stage("chunking")
                callbacks.stage("done")
            repo = RepositoryMetadata(name=name, path=repo_root / name,
                                      languages=["python"])
            return IndexingResult(repository=repo, chunk_count=3,
                                  embedded_count=3, upserted=True,
                                  languages=["python"])

        def remove_repository(self, name):
            return name == "demo"

    class StubPipeline:
        def query(self, question, top_k=None, filters=None):
            if question == "boom":
                raise RuntimeError("engine exploded")
            return {
                "answer": f"answer to: {question}",
                "sources": [{"path": "a.py", "repo": "demo",
                             "language": "python", "score": 0.9,
                             "snippet": "def a(): pass"}],
                "meta": {"fallback_used": True, "reason": "no_llm_configured"},
            }

    return StubIndexer(), StubPipeline()


async def _fetch(client, method, path, **kw):
    resp = await client.request(method, path, **kw)
    if resp.content_type == "application/json":
        return resp.status, await resp.json()
    return resp.status, await resp.text()


def _mask(value):
    if isinstance(value, dict):
        return {k: ("*" if k in _VOLATILE else _mask(v)) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_mask(v) for v in value]
    return value


async def _wait_job(client, job_id):
    for _ in range(200):
        status, body = await _fetch(client, "GET", f"/jobs/{job_id}", headers=AUTH)
        if body["status"] in ("completed", "failed"):
            return status, body
        await asyncio.sleep(0.02)
    raise AssertionError("job never finished")


async def _jobs(client, src_root):
    body = {"name": "demo", "root": str(src_root), "include": ["src"]}
    out = [await _fetch(client, "POST", "/jobs/ingest", json=body, headers=AUTH)]
    out.append(await _wait_job(client, out[0][1]["id"]))
    out.append(await _fetch(client, "GET", "/jobs", headers=AUTH))
    out.append(await _fetch(client, "GET", "/jobs/nonexistent", headers=AUTH))
    return out


async def _telemetry(client, src_root):
    await client.post("/query", json={"question": "q1"}, headers=AUTH)
    await client.post("/query", json={"question": "boom"}, headers=AUTH)
    return [await _fetch(client, "GET", "/telemetry", headers=AUTH)]


def _ingest_bodies(src_root):
    good = {"name": "demo", "root": str(src_root), "include": ["src"]}
    return [good, {**good, "include": []}, {**good, "include": ["nope"]},
            {"root": str(src_root), "include": ["src"]},
            {**good, "root": str(src_root / "missing")}]


# (name, scenario): a scenario is a list of requests, or a coroutine function
ROUTES = [
    ("healthz", [("GET", "/healthz", {})]),
    ("auth", [("GET", "/repos", {}),
              ("GET", "/repos", {"headers": {"X-API-Key": "wrong"}}),
              ("POST", "/query", {"json": {"question": "q"}}),
              ("GET", "/telemetry", {}),
              ("GET", "/repos", {"headers": AUTH})]),
    ("repos", [("GET", "/repos", {"headers": AUTH})]),
    ("ingest", "ingest"),
    ("jobs", _jobs),
    ("query", [("POST", "/query", {"json": {"question": "what is a?"}, "headers": AUTH}),
               ("POST", "/query", {"json": {"question": " "}, "headers": AUTH}),
               ("POST", "/query", {"json": {"question": "boom"}, "headers": AUTH}),
               ("POST", "/query", {"data": "not json", "headers": AUTH})]),
    ("query_validation",
     [("POST", "/query", {"json": {"question": "q", "top_k": bad}, "headers": AUTH})
      for bad in (0, -1, "ten", 2.5, [3], 10**9)]
     + [("POST", "/query", {"json": {"question": "q", "filters": f}, "headers": AUTH})
        for f in ("repo", {"repo": {"a": 1}}, {"repo": ["a", {"b": 2}]})]
     + [("POST", "/query", {"json": {"question": "q", "top_k": 3,
                                     "filters": {"repo": ["a", "b"]}},
                            "headers": AUTH})]),
    ("telemetry", _telemetry),
    ("delete_repo", [("DELETE", "/repos/demo", {"headers": AUTH}),
                     ("DELETE", "/repos/nope", {"headers": AUTH})]),
    ("engine_routes_without_store",
     [("POST", "/compact", {"headers": AUTH}),
      ("GET", "/chunks", {"headers": AUTH}),
      ("POST", "/chunks/delete", {"json": {"filters": {"repo": "a"}}, "headers": AUTH})]),
    ("webui", [("GET", "/", {})]),
    ("unknown_route", [("GET", "/nope", {"headers": AUTH}),
                       ("PUT", "/query", {"headers": AUTH})]),
]


def _serve(pkg, tmp_path, scenario, **cfg_kw):
    create_app = _mod(pkg, "api.main").create_app
    AppSettings = _mod(pkg, "settings").AppSettings
    src_root = tmp_path / "repos"
    (src_root / "src").mkdir(parents=True, exist_ok=True)
    indexer, pipeline = _stubs(pkg, src_root)
    cfg = AppSettings(workspace_root=tmp_path / pkg, api_key="secret", **cfg_kw)

    async def go():
        app = create_app(config=cfg, indexer=indexer, pipeline=pipeline)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            if scenario == "ingest":
                return [await _fetch(client, "POST", "/ingest", json=b, headers=AUTH)
                        for b in _ingest_bodies(src_root)]
            if callable(scenario):
                return await scenario(client, src_root)
            return [await _fetch(client, m, p, **kw) for m, p, kw in scenario]
        finally:
            await client.close()

    return asyncio.run(go())


@pytest.mark.parametrize("name,scenario", ROUTES, ids=[r[0] for r in ROUTES])
def test_stub_contract_matches_jax(tmp_path, name, scenario):
    jax_out, port_out = (_serve(pkg, tmp_path, scenario) for pkg in PACKAGES)
    assert [s for s, _ in port_out] == [s for s, _ in jax_out]
    if name == "telemetry":
        # the port's /telemetry adds its engine's spans and counters
        engine = port_out[0][1].pop("engine")
        assert set(engine) == {"counters", "spans"}
    assert _mask(port_out) == _mask(jax_out)


def test_stats_keys_match_jax(tmp_path):
    scenario = [("GET", "/stats", {"headers": AUTH})]
    (js, jbody), = _serve("semcode_tpu", tmp_path, scenario)
    (ps, pbody), = _serve("semcode_tpu_torch", tmp_path, scenario)
    assert js == ps == 200
    assert set(pbody) == set(jbody) == {"index", "devices", "backend"}
    assert pbody["index"] == jbody["index"] == {}
    if torch.cuda.is_available():
        assert pbody["backend"] == "cuda"
    else:
        assert pbody == {"index": {}, "devices": ["cpu"], "backend": "cpu"}


def test_telemetry_disabled_matches_jax(tmp_path):
    scenario = [("GET", "/telemetry", {"headers": AUTH})]
    outs = [_serve(pkg, tmp_path, scenario, telemetry_enabled=False)
            for pkg in PACKAGES]
    assert outs[0] == outs[1] and outs[1][0][0] == 404


# -- real engines over one workspace -------------------------------------------

QUESTIONS = [
    "lock-free device snapshot of the index",
    "where is top_k validated for search requests",
    "how are tombstoned rows compacted",
    "device BM25 rerank of the candidate window",
    "int8 quantization of corpus rows",
    "flat index promoted to IVF at a row threshold",
    "save and load a store snapshot",
    "filtered search with repository tags",
]


@pytest.fixture(scope="module")
def shared_workspace(tmp_path_factory):
    """A JAX store self-ingested from semcode_tpu/index and saved."""
    from semcode_tpu.services import IndexerService
    from semcode_tpu.settings import AppSettings

    ws = tmp_path_factory.mktemp("shared") / "ws"
    cfg = AppSettings(workspace_root=ws, index_kind="flat",
                      rag_query_cache_size=0)
    IndexerService(config=cfg).index_repository(
        [ROOT / "semcode_tpu" / "index"], "index")
    return ws


def _serve_real(pkg, ws, requests):
    """``requests`` against ``pkg``'s app over the workspace ``ws``: the
    port on the CPU, the JAX package on a one-device mesh (the port's one
    card; a sharded scan merges its shards' candidates in another order)."""
    create_app = _mod(pkg, "api.main").create_app
    AppSettings = _mod(pkg, "settings").AppSettings
    cfg = AppSettings(workspace_root=ws, index_kind="flat", api_warmup=False,
                      rag_query_cache_size=0)
    if pkg == "semcode_tpu_torch":
        kw = {"device": "cpu"}
    else:
        import jax
        from semcode_tpu.index.store import VectorStore as JaxStore
        from semcode_tpu.parallel.mesh import make_mesh
        from semcode_tpu.services import IndexerService as JaxIndexer

        mesh1 = make_mesh((1,), ("data",), devices=jax.devices()[:1])
        kw = {"indexer": JaxIndexer(config=cfg, auto_connect=False,
                                    vector_store=JaxStore(cfg, mesh=mesh1))}

    async def go():
        client = TestClient(TestServer(create_app(config=cfg, **kw)))
        await client.start_server()
        try:
            return [await _fetch(client, m, p, **k) for m, p, k in requests]
        finally:
            await client.close()

    return asyncio.run(go())


def test_real_engines_serve_the_same_answers(shared_workspace):
    requests = [("POST", "/query", {"json": {"question": q, "top_k": 5}})
                for q in QUESTIONS]
    requests += [("GET", "/repos", {}),
                 ("GET", "/chunks?limit=7&include_text=1", {}),
                 ("GET", "/chunks?repo=index&path=index/flat.py", {})]
    jax_out = _serve_real("semcode_tpu", shared_workspace, requests)
    port_out = _serve_real("semcode_tpu_torch", shared_workspace, requests)
    assert [s for s, _ in port_out] == [s for s, _ in jax_out] == [200] * len(requests)
    n = len(QUESTIONS)
    for (_, want), (_, got) in zip(jax_out[:n], port_out[:n]):
        assert got["sources"], got
        assert [s["path"] for s in got["sources"]] == [
            s["path"] for s in want["sources"]]
        np.testing.assert_allclose(
            [s["score"] for s in got["sources"]],
            [s["score"] for s in want["sources"]], rtol=0, atol=1e-5)
        strip = [{k: v for k, v in s.items() if k != "score"}
                 for s in got["sources"]]
        assert strip == [{k: v for k, v in s.items() if k != "score"}
                         for s in want["sources"]]
        assert got["answer"] == want["answer"]
    assert port_out[n:] == jax_out[n:]
    assert port_out[n + 1][1] and len(port_out[n + 1][1]) == 7


# -- the JAX file's endpoint cases, on the port --------------------------------


def _port_store(tmp_path, n, repos=("r",), **cfg_kw):
    from semcode_tpu_torch.embeddings.providers import EmbeddingPayload
    from semcode_tpu_torch.index.store import VectorStore
    from semcode_tpu_torch.settings import AppSettings

    cfg = AppSettings(workspace_root=tmp_path, embedding_dimension=16,
                      **{"index_kind": "flat", "index_dtype": "float32", **cfg_kw})
    store = VectorStore(cfg, device="cpu")
    rng = np.random.default_rng(0)
    store.upsert_embeddings([
        EmbeddingPayload(
            id=f"p{i}", text=f"t{i}",
            vector=rng.standard_normal(16).astype(np.float32),
            metadata={"repo": repos[i * len(repos) // n], "path": f"f{i}",
                      "language": "python"},
        )
        for i in range(n)
    ])
    return cfg, store


def _run_port(cfg, store, scenario):
    from semcode_tpu_torch.api.main import create_app
    from semcode_tpu_torch.services.indexer import IndexerService

    indexer = IndexerService(config=cfg, vector_store=store, device="cpu")

    async def go():
        client = TestClient(TestServer(create_app(config=cfg, indexer=indexer,
                                                  device="cpu")))
        await client.start_server()
        try:
            return await scenario(client)
        finally:
            await client.close()

    return asyncio.run(go())


def test_compact_endpoint(tmp_path):
    cfg, store = _port_store(tmp_path, 24)
    store.delete([f"p{i}" for i in range(6)])

    async def scenario(client):
        r = await client.post("/compact")
        assert r.status == 200 and await r.json() == {"reclaimed": 6, "rows": 18}
        r2 = await client.post("/compact")
        assert (await r2.json())["reclaimed"] == 0

    _run_port(cfg, store, scenario)


def test_chunks_listing_and_delete_endpoints(tmp_path):
    cfg, store = _port_store(tmp_path, 16, repos=("ra", "rb"))

    async def scenario(client):
        r = await client.get("/chunks?repo=ra&limit=3&include_text=1")
        body = await r.json()
        assert r.status == 200 and len(body) == 3
        assert all(e["repo"] == "ra" for e in body)
        assert body[0]["text"].startswith("t")
        r = await client.post("/chunks/delete", json={"filters": {"repo": "ra"}})
        body = await r.json()
        assert r.status == 200 and body["deleted"] == 8 and body["rows"] == 8
        r = await client.post("/chunks/delete", json={"filters": {}})
        assert r.status == 400
        r = await client.get("/chunks?limit=x")
        assert r.status == 400

    _run_port(cfg, store, scenario)


def test_stats_reports_the_engine(tmp_path):
    cfg, store = _port_store(tmp_path, 8)

    async def scenario(client):
        r = await client.get("/stats")
        return r.status, await r.json()

    status, body = _run_port(cfg, store, scenario)
    assert status == 200
    assert body["backend"] == "cpu" and body["devices"] == ["cpu"]
    assert body["index"]["rows"] == 8 and body["index"]["kind"] == "flat"


def test_telemetry_serves_the_engines_route_counters(tmp_path):
    cfg, store = _port_store(tmp_path, 64, index_kind="ivf", index_nlist=4,
                             index_nprobe=2, api_warmup=False)

    async def scenario(client):
        before = (await (await client.get("/telemetry")).json())["engine"]
        r = await client.post("/query", json={"question": "t3", "top_k": 3})
        assert r.status == 200 and (await r.json())["sources"]
        after = (await (await client.get("/telemetry")).json())["engine"]
        return before, after

    before, after = _run_port(cfg, store, scenario)
    assert store.stats()["kind"] == "ivf"
    routes = ("ivf.route.exact", "ivf.route.probe")
    took = sum(after["counters"].get(r, 0) - before["counters"].get(r, 0)
               for r in routes)
    assert took == 1
    assert set(after) == {"counters", "spans"}


def test_delete_repo(tmp_path):
    from semcode_tpu_torch.api.main import create_app
    from semcode_tpu_torch.settings import AppSettings

    indexer, pipeline = _stubs("semcode_tpu_torch", tmp_path)
    removed = []
    indexer.remove_repository = lambda name: removed.append(name) or name == "demo"

    async def go():
        cfg = AppSettings(workspace_root=tmp_path, api_key="secret")
        client = TestClient(TestServer(create_app(config=cfg, indexer=indexer,
                                                  pipeline=pipeline)))
        await client.start_server()
        try:
            resp = await client.delete("/repos/demo", headers=AUTH)
            assert resp.status == 200 and await resp.json() == {"removed": "demo"}
            resp = await client.delete("/repos/nope", headers=AUTH)
            assert resp.status == 404
        finally:
            await client.close()

    asyncio.run(go())
    assert removed == ["demo", "nope"]


def test_create_app_ephemeral_workspace(tmp_path):
    """workspace_root=None (the ephemeral in-memory mode): the app starts
    and keeps its jobs in memory."""
    from semcode_tpu_torch.api.main import create_app
    from semcode_tpu_torch.settings import AppSettings

    indexer, pipeline = _stubs("semcode_tpu_torch", tmp_path)
    app = create_app(config=AppSettings(workspace_root=None, api_key="secret"),
                     indexer=indexer, pipeline=pipeline)

    async def go():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            assert (await client.get("/healthz")).status == 200
            r = await client.post("/query", json={"question": "hi"}, headers=AUTH)
            assert r.status == 200
        finally:
            await client.close()

    asyncio.run(go())
    assert app["jobs"]._journal_path is None


def test_startup_warmup_fires_once_on_populated_store():
    """The warmup thread connects the store, builds the kernel libraries a
    card would need (none here) and runs one query, only on a populated
    store and only with api_warmup on."""
    import time as _time

    from semcode_tpu_torch.api.main import create_app
    from semcode_tpu_torch.settings import AppSettings

    class Pipe:
        def __init__(self):
            self.calls = []

        def query(self, q, top_k=None, filters=None):
            self.calls.append(q)
            return {"answer": "", "sources": [], "meta": {}}

    class Store:
        def __init__(self, n):
            self._n = n
            self.connected = False

        def connect(self):
            self.connected = True

        def count(self):
            return self._n if self.connected else 0

    class Idx:
        registry = None
        ingestion_manager = None

        def __init__(self, n):
            self.vector_store = Store(n)

        def index_repository(self, *args, **kwargs):
            raise AssertionError("warmup must not ingest")

    async def scenario(n_rows, warmup, expect_called):
        pipe = Pipe()
        app = create_app(config=AppSettings(workspace_root=None, api_warmup=warmup),
                         indexer=Idx(n_rows), pipeline=pipe)
        client = TestClient(TestServer(app))
        await client.start_server()
        t = app.get("warmup_thread")
        if t is not None:
            await asyncio.get_event_loop().run_in_executor(
                None, lambda: t.join(timeout=5))
            assert not t.is_alive()
        deadline = _time.time() + 5
        while expect_called and not pipe.calls and _time.time() < deadline:
            await asyncio.sleep(0.02)
        assert len(pipe.calls) == int(expect_called)
        assert (t is None) == (not warmup)
        await client.close()

    asyncio.run(scenario(100, True, True))
    asyncio.run(scenario(0, True, False))
    asyncio.run(scenario(100, False, False))


def test_build_kernels_picks_the_configured_libraries(monkeypatch):
    """On a CUDA store the warmup builds top2_scan for the kernel route and
    ivf_scan for the IVF kinds; on the CPU it builds nothing."""
    from semcode_tpu_torch.api.main import build_kernels
    from semcode_tpu_torch.ops import ivf_scan, scan_top2
    from semcode_tpu_torch.settings import AppSettings

    loaded = []
    monkeypatch.setattr(scan_top2, "load_library", lambda: loaded.append("top2"))
    monkeypatch.setattr(ivf_scan, "load_library", lambda: loaded.append("ivf"))

    class Store:
        device = torch.device("cuda")

    cases = [
        (dict(index_kind="flat", index_scan_impl="pallas"), ["top2_scan"]),
        (dict(index_kind="flat", index_scan_impl="auto"), []),
        (dict(index_kind="auto", index_scan_impl="pallas"), ["top2_scan", "ivf_scan"]),
        (dict(index_kind="ivf", index_scan_impl="xla"), ["ivf_scan"]),
    ]
    for kw, want in cases:
        assert build_kernels(AppSettings(**kw), Store()) == want
    assert loaded == ["top2", "top2", "ivf", "ivf"]
    cpu_store = type("CpuStore", (), {"device": torch.device("cpu")})()
    assert build_kernels(AppSettings(index_scan_impl="pallas"), cpu_store) == []
    assert build_kernels(AppSettings(), object()) == []


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_kernel_failure_answers_502(tmp_path, batched):
    """A kernel that fails to build or launch fails the request (502); any
    other retrieval failure still degrades to the extractive fallback."""
    from semcode_tpu_torch.api.main import create_app
    from semcode_tpu_torch.ops.build import KernelError
    from semcode_tpu_torch.rag import SemanticSearchPipeline
    from semcode_tpu_torch.settings import AppSettings

    class Emb:
        def embed_query(self, text):
            return [0.0] * 4

        def embed_queries(self, texts):
            return [[0.0] * 4 for _ in texts]

    class FailingStore:
        version = 0

        def __init__(self, exc):
            self.exc = exc

        def search(self, *a, **kw):
            raise self.exc

        def search_batch(self, *a, **kw):
            raise self.exc

    cfg = AppSettings(workspace_root=None, rag_query_cache_size=0,
                      api_batch_window_ms=50.0 if batched else 0.0)
    n = 4 if batched else 1

    async def go(exc):
        pipe = SemanticSearchPipeline(config=cfg, vector_store=FailingStore(exc),
                                      embeddings=Emb())
        indexer, _ = _stubs("semcode_tpu_torch", tmp_path)
        client = TestClient(TestServer(create_app(config=cfg, indexer=indexer,
                                                  pipeline=pipe)))
        await client.start_server()
        try:
            resps = await asyncio.gather(*[
                client.post("/query", json={"question": f"q{i}"}) for i in range(n)])
            return [(r.status, await r.json()) for r in resps]
        finally:
            await client.close()

    out = asyncio.run(go(KernelError("top2_scan kernel launch failed: CUDA error 700")))
    assert [s for s, _ in out] == [502] * n
    assert all("CUDA error 700" in body["detail"] for _, body in out)
    out = asyncio.run(go(ValueError("transient")))
    assert [s for s, _ in out] == [200] * n
    assert all(body["meta"]["reason"] == "no_results" for _, body in out)


def test_missing_compiler_is_a_kernel_error(monkeypatch, tmp_path):
    """A machine without nvcc fails the build with KernelError (so a query
    answers 502), not with an error the pipeline would degrade."""
    from semcode_tpu_torch.ops import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc", lambda: str(tmp_path / "no-nvcc"))
    with pytest.raises(build.KernelError, match="cannot run"):
        build.build_library("top2_scan")
