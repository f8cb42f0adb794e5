"""VectorStore and the main path: semcode_tpu_torch against semcode_tpu.

A small repository is ingested through both packages' IndexerService (the
JAX store on a 1-device mesh, the port on the CPU) and ten questions go
through both RAG pipelines: the hits (ids, paths, order) must be the same
and scores within 1e-5. Snapshots saved by either store load in the other.
"""

import shutil
from pathlib import Path

import jax
import numpy as np
import pytest

from semcode_tpu.embeddings.providers import EmbeddingPayload as JaxPayload
from semcode_tpu.index.store import VectorStore as JaxStore
from semcode_tpu.parallel.mesh import make_mesh
from semcode_tpu.rag import SemanticSearchPipeline as JaxPipeline
from semcode_tpu.services import IndexerService as JaxIndexer
from semcode_tpu.settings import AppSettings as JaxSettings
from semcode_tpu_torch.embeddings.providers import EmbeddingPayload
from semcode_tpu_torch.index.store import VectorStore
from semcode_tpu_torch.rag import SemanticSearchPipeline
from semcode_tpu_torch.services import IndexerService
from semcode_tpu_torch.settings import AppSettings

ROOT = Path(__file__).resolve().parents[1]
SOURCES = [
    "semcode_tpu/chunking/chunker.py",
    "semcode_tpu/chunking/symbols.py",
    "semcode_tpu/index/rerank.py",
    "semcode_tpu/storage/registry.py",
    "semcode_tpu/logger.py",
    "semcode_tpu/utils/tracing.py",
]
QUESTIONS = [
    "how are code files split into chunks",
    "where is scan_symbols defined",
    "lexical rerank of candidate hits with bm25",
    "repository registry json persistence",
    "structured logging with key value pairs",
    "stage timer for per-stage timings",
    "symbol for a line span",
    "normalize a symbol name for matching",
    "file lock around the registry",
    "redirect logging to a file",
]


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh((1,), ("data",), devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    base = tmp_path_factory.mktemp("src")
    for rel in SOURCES:
        dst = base / "pkg" / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(ROOT / rel, dst)
    return base / "pkg"


def _settings(cls, ws, **kw):
    # short chunks: ~60 rows from six files
    base = dict(workspace_root=ws, index_kind="flat", rag_query_cache_size=0,
                chunk_max_lines=40)
    return cls(**{**base, **kw})


def _ingest_both(tmp_path, mesh1, repo, **kw):
    jcfg = _settings(JaxSettings, tmp_path / "jax", **kw)
    tcfg = _settings(AppSettings, tmp_path / "torch", **kw)
    jsvc = JaxIndexer(config=jcfg, vector_store=JaxStore(jcfg, mesh=mesh1))
    tsvc = IndexerService(config=tcfg, device="cpu")
    jres = jsvc.index_repository([repo], "pkg")
    tres = tsvc.index_repository([repo], "pkg")
    assert tres.chunk_count == jres.chunk_count > 10
    jp = JaxPipeline(config=jcfg, vector_store=jsvc.vector_store,
                     embeddings=jsvc.embeddings)
    tp = SemanticSearchPipeline(config=tcfg, vector_store=tsvc.vector_store,
                                embeddings=tsvc.embeddings, device="cpu")
    return jsvc, tsvc, jp, tp


def _hits(results):
    return [[(s["path"], s["score"]) for s in r["sources"]] for r in results]


def _assert_same_hits(a, b):
    assert len(a) == len(b)
    for ha, hb in zip(a, b):
        assert [p for p, _ in hb] == [p for p, _ in ha]
        np.testing.assert_allclose([s for _, s in hb], [s for _, s in ha],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scan_impl", ["auto", "pallas"])
def test_main_path_matches_reference(tmp_path, mesh1, repo, scan_impl):
    jsvc, tsvc, jp, tp = _ingest_both(tmp_path, mesh1, repo,
                                      index_scan_impl=scan_impl)
    ja = jp.query_batch(QUESTIONS, top_k=5)
    ta = tp.query_batch(QUESTIONS, top_k=5)
    _assert_same_hits(_hits(ja), _hits(ta))
    for r in ta:
        assert r["sources"] and r["meta"]["reason"] == "no_llm_configured"
        assert r["answer"].startswith("No LLM answer available")
    assert [r["answer"] for r in ta] == [r["answer"] for r in ja]
    # single-query path (embed_query_device + search_batch_device)
    _assert_same_hits(_hits([jp.query(QUESTIONS[1], top_k=5)]),
                      _hits([tp.query(QUESTIONS[1], top_k=5)]))


def test_snapshots_cross_load(tmp_path, mesh1, repo):
    jsvc, tsvc, jp, tp = _ingest_both(tmp_path, mesh1, repo)
    ref = _hits(jp.query_batch(QUESTIONS, top_k=5))
    # JAX snapshot -> port store (reloaded stores use the host rerank until
    # the next mutation, in both packages)
    jsnap = JaxStore(jsvc.config, mesh=mesh1).snapshot_dir()
    tcfg = _settings(AppSettings, tmp_path / "torch", index_snapshot_dir=jsnap)
    t_from_j = VectorStore(tcfg, device="cpu")
    t_from_j.connect()
    assert t_from_j.count() == jsvc.vector_store.count()
    jcfg2 = _settings(JaxSettings, tmp_path / "jax", index_snapshot_dir=jsnap)
    j_reloaded = JaxStore(jcfg2, mesh=mesh1)
    j_reloaded.connect()
    a = _hits(JaxPipeline(config=jcfg2, vector_store=j_reloaded,
                          embeddings=jsvc.embeddings).query_batch(QUESTIONS, top_k=5))
    b = _hits(SemanticSearchPipeline(config=tcfg, vector_store=t_from_j,
                                     embeddings=tsvc.embeddings,
                                     device="cpu").query_batch(QUESTIONS, top_k=5))
    _assert_same_hits(a, b)
    # port snapshot -> JAX store
    tsnap = tsvc.vector_store.snapshot_dir()
    j_from_t = JaxStore(_settings(JaxSettings, tmp_path / "jx",
                                  index_snapshot_dir=tsnap), mesh=mesh1)
    j_from_t.connect()
    assert j_from_t.count() == tsvc.vector_store.count()
    assert j_from_t.stats()["kind"] == "flat"
    assert sorted(j_from_t._id_to_row) == sorted(tsvc.vector_store._id_to_row)
    assert len(ref) == len(QUESTIONS)


def _payloads(cls, rng, n, prefix, repo, dim=32):
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    return [
        cls(id=f"{prefix}{i}", text=f"text {i} {repo}", vector=vecs[i],
            metadata={"repo": repo, "path": f"{prefix}{i}.py",
                      "language": "python"})
        for i in range(n)
    ], vecs


def test_filters_delete_compact_match(tmp_path, mesh1):
    rng = np.random.default_rng(0)
    kw = dict(embedding_dimension=32, index_dtype="int8",
              index_auto_compact_ratio=0.0)
    j = JaxStore(_settings(JaxSettings, tmp_path / "j", **kw), mesh=mesh1)
    t = VectorStore(_settings(AppSettings, tmp_path / "t", **kw), device="cpu")
    for cls, store in ((JaxPayload, j), (EmbeddingPayload, t)):
        r = np.random.default_rng(0)
        pa, va = _payloads(cls, r, 40, "a", "repo_a")
        pb, _ = _payloads(cls, r, 40, "b", "repo_b")
        store.upsert_embeddings(pa + pb)
        store.upsert_embeddings(pa[:5])  # idempotent update
        store.delete([f"a{i}" for i in range(0, 40, 3)])
    q = va[:4]
    for filters in (None, {"repo": "repo_a"}, {"repo": ["repo_b"]},
                    {"path": "b7.py"}):
        hj = j.search_batch(q, top_k=6, filters=filters)
        ht = t.search_batch(q, top_k=6, filters=filters)
        assert [[h.id for h in hs] for hs in ht] == [[h.id for h in hs] for hs in hj]
    assert t.compact() == j.compact() > 0
    hj = j.search_batch(q, top_k=6)
    ht = t.search_batch(q, top_k=6)
    assert [[h.id for h in hs] for hs in ht] == [[h.id for h in hs] for hs in hj]
    assert t.list_chunks({"repo": "repo_b"}, limit=5) == j.list_chunks(
        {"repo": "repo_b"}, limit=5)
    st, sj = t.stats(), j.stats()
    assert {k: st[k] for k in sj} == sj


def test_ivf_is_not_ported(tmp_path):
    rng = np.random.default_rng(1)
    auto = VectorStore(_settings(AppSettings, tmp_path / "a", index_kind="auto",
                                 embedding_dimension=32, index_ivf_min_size=64),
                       device="cpu")
    payloads, _ = _payloads(EmbeddingPayload, rng, 64, "c", "r")
    auto.upsert_embeddings(payloads[:63])  # below the threshold: flat
    assert auto.stats()["kind"] == "flat"
    with pytest.raises(NotImplementedError, match="IVF is not ported"):
        auto.upsert_embeddings(payloads[63:])
    assert auto.count() == 63  # nothing was written
    ivf = VectorStore(_settings(AppSettings, tmp_path / "i", index_kind="ivf",
                                embedding_dimension=32), device="cpu")
    with pytest.raises(NotImplementedError, match="IVF is not ported"):
        ivf.connect()


def test_reload_keeps_index_options(tmp_path):
    """The reference's load passes only the dtype to the index, reverting
    scan_impl and the rescore options; the port keeps the settings'."""
    rng = np.random.default_rng(2)
    cfg = _settings(AppSettings, tmp_path, embedding_dimension=128,
                    index_scan_impl="pallas", index_rescore_width=-1)
    store = VectorStore(cfg, device="cpu")
    payloads, _ = _payloads(EmbeddingPayload, rng, 20, "c", "r", dim=128)
    store.upsert_embeddings(payloads)
    store.save()
    again = VectorStore(cfg, device="cpu")
    again.connect()
    assert again._index.scan_impl == "pallas"
    assert again._index.rescore_width == -1
