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


def test_ivf_store_matches_reference(tmp_path, mesh1, repo):
    kw = dict(index_kind="ivf", index_nlist=4, index_nprobe=2)
    jsvc, tsvc, jp, tp = _ingest_both(tmp_path, mesh1, repo, **kw)
    assert tsvc.vector_store.stats() == jsvc.vector_store.stats()
    assert tsvc.vector_store.stats()["kind"] == "ivf"
    _assert_same_hits(_hits(jp.query_batch(QUESTIONS, top_k=5)),
                      _hits(tp.query_batch(QUESTIONS, top_k=5)))
    _assert_same_hits(_hits([jp.query(QUESTIONS[2], top_k=5)]),
                      _hits([tp.query(QUESTIONS[2], top_k=5)]))


def _ids(hits_batch):
    return [[h.id for h in hs] for hs in hits_batch]


def test_auto_promotion_and_ivf_upserts(tmp_path, mesh1):
    """auto: flat below index_ivf_min_size, IVF from it on (rows renumbered,
    lexical fingerprints remapped); IVF upserts tombstone and re-add."""
    kw = dict(embedding_dimension=32, index_kind="auto", index_ivf_min_size=64,
              index_nlist=4, index_nprobe=4, index_auto_compact_ratio=0.0)
    j = JaxStore(_settings(JaxSettings, tmp_path / "j", **kw), mesh=mesh1)
    t = VectorStore(_settings(AppSettings, tmp_path / "t", **kw), device="cpu")
    texts = ["text 3 repo_a", "text 70 repo_b", "text 12"]
    for cls, store in ((JaxPayload, j), (EmbeddingPayload, t)):
        r = np.random.default_rng(0)
        pa, va = _payloads(cls, r, 40, "a", "repo_a")
        pb, _ = _payloads(cls, r, 40, "b", "repo_b")
        store.upsert_embeddings(pa[:23] + pb[:40])  # 63 rows: still flat
        assert store.stats()["kind"] == "flat"
        store.upsert_embeddings(pa[23:24])  # reaches 64: promoted
        assert store.stats()["kind"] == "ivf"
        store.upsert_embeddings(pa[24:] + pa[:5])  # new rows + re-adds
        store.delete([f"b{i}" for i in range(0, 40, 4)])
    assert t.stats() == j.stats()
    assert t.stats()["tombstones"] == 15
    assert sorted(t._id_to_row.items()) == sorted(j._id_to_row.items())
    q = va[:3]
    for filters in (None, {"repo": "repo_b"}):
        assert _ids(t.search_batch(q, top_k=6, filters=filters)) == _ids(
            j.search_batch(q, top_k=6, filters=filters))
    # with query texts: the device BM25 rerank reads remapped fingerprints
    ht = t.search_batch(q, top_k=6, query_texts=texts)
    hj = j.search_batch(q, top_k=6, query_texts=texts)
    assert _ids(ht) == _ids(hj)
    np.testing.assert_allclose([h.score for hs in ht for h in hs],
                               [h.score for hs in hj for h in hs], rtol=1e-5)
    assert t.compact() == j.compact() == 15
    assert _ids(t.search_batch(q, top_k=6)) == _ids(j.search_batch(q, top_k=6))


def test_ivf_snapshots_cross_load(tmp_path, mesh1):
    """kind="ivf" snapshots load in either package with the saved centroids
    (same cluster layout, so the probing path agrees too) and the live rows
    renumbered densely."""
    kw = dict(embedding_dimension=128, index_kind="ivf", index_nlist=4,
              index_nprobe=2, index_auto_compact_ratio=0.0)
    j = JaxStore(_settings(JaxSettings, tmp_path / "j", **kw), mesh=mesh1)
    t = VectorStore(_settings(AppSettings, tmp_path / "t", **kw), device="cpu")
    for cls, store in ((JaxPayload, j), (EmbeddingPayload, t)):
        r = np.random.default_rng(3)
        pa, va = _payloads(cls, r, 300, "a", "repo_a", dim=128)
        store.upsert_embeddings(pa)
        store.delete([f"a{i}" for i in range(0, 300, 7)])
        store.save()
    q = va[:6]

    def reload(cls, cfg_cls, snap, **extra):
        cfg = _settings(cfg_cls, tmp_path / "x", index_snapshot_dir=snap, **kw)
        store = cls(cfg, **extra)
        store.connect()
        return store

    t_from_j = reload(VectorStore, AppSettings, j.snapshot_dir(), device="cpu")
    j_from_t = reload(JaxStore, JaxSettings, t.snapshot_dir(), mesh=mesh1)
    for src, dst in ((j, t_from_j), (t, j_from_t)):
        assert dst.stats()["kind"] == "ivf" and dst.count() == src.count()
        np.testing.assert_array_equal(dst._index.centroids, src._index.centroids)
        assert sorted(dst._id_to_row) == sorted(src._id_to_row)
        assert _ids(dst.search_batch(q, top_k=8)) == _ids(src.search_batch(q, top_k=8))
    # both packages reloading one snapshot hold one layout: the probing
    # path itself agrees
    j_again = reload(JaxStore, JaxSettings, j.snapshot_dir(), mesh=mesh1)
    assert t_from_j._index.cmax == j_again._index.cmax
    sa, ia = j_again._index.search(q, k=8, mode="ivf")
    sb, ib = t_from_j._index.search(q, k=8, mode="ivf")
    np.testing.assert_array_equal(ib, ia)
    np.testing.assert_allclose(sb, sa, rtol=1e-5, atol=1e-5)


def test_search_passes_nprobe(tmp_path):
    kw = dict(embedding_dimension=128, index_kind="ivf", index_nlist=8,
              index_nprobe=1)
    store = VectorStore(_settings(AppSettings, tmp_path, **kw), device="cpu")
    payloads, vecs = _payloads(EmbeddingPayload, np.random.default_rng(4), 400,
                               "c", "r", dim=128)
    store.upsert_embeddings(payloads)
    seen = []
    real = store._index.search

    def spy(q, k=10, nprobe=None, mode="auto", allow_tags=None):
        seen.append(nprobe)
        return real(q, k=k, nprobe=nprobe, mode=mode, allow_tags=allow_tags)

    store._index.search = spy
    full = store.search(vecs[0], top_k=5, nprobe=8)
    default = store.search(vecs[0], top_k=5)
    assert seen == [8, None]
    assert full[0].id == "c0" and default
    # every cluster probed: the probing path returns the exact top-k
    s, ids = real(vecs[:4], k=5, nprobe=8, mode="ivf")
    se, ie = real(vecs[:4], k=5, mode="exact")
    np.testing.assert_array_equal(ids, ie)


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


def _bulk_store(cls, tmp_path, index_kind, mesh1=None, payload=EmbeddingPayload):
    kw = dict(embedding_dimension=32, index_auto_compact_ratio=0.0)
    if index_kind == "ivf":
        kw.update(index_kind="ivf", index_nlist=16, index_nprobe=16)
    cfg = _settings(cls, tmp_path, **kw)
    store = (JaxStore(cfg, mesh=mesh1) if cls is JaxSettings
             else VectorStore(cfg, device="cpu"))
    rng = np.random.default_rng(11)
    p1, v1 = _payloads(payload, rng, 150, "a", "r1")
    p2, v2 = _payloads(payload, rng, 250, "b", "r2")
    store.upsert_embeddings(p1)
    store.upsert_embeddings(p2)
    return store, v1, v2


@pytest.mark.parametrize("index_kind", ["flat", "ivf"])
def test_search_bulk_matches_search_batch(tmp_path, index_kind):
    """search_bulk (chunked device dispatch) returns search_batch's hits,
    with a padded tail (13 queries in batches of 8), under filters, and
    after deletions (on IVF, live rows keep ids past the shrunken size)."""
    store, v1, v2 = _bulk_store(AppSettings, tmp_path, index_kind)
    q = np.concatenate([v1[:7], v2[150:156]])
    for filters in (None, {"repo": "r2"}):
        bulk = store.search_bulk(q, top_k=3, filters=filters, batch_q=8,
                                 chunk_batches=2)
        ref = store.search_batch(q, top_k=3, filters=filters)
        assert len(bulk) == len(ref) == 13
        assert _ids(bulk) == _ids(ref)
        for hb, hr in zip(bulk, ref):
            np.testing.assert_allclose([h.score for h in hb], [h.score for h in hr],
                                       rtol=1e-5)
            assert filters is None or all(h.repo == "r2" for h in hb)
    assert _ids(store.search_bulk(q[:7], top_k=1))[0] == ["a0"]
    store.delete_repo("r1")
    assert store.count() == 250
    q = v2[150:163]
    ref = store.search_batch(q, top_k=3)
    assert all(h and h[0].id == f"b{150 + i}" for i, h in enumerate(ref))
    assert _ids(store.search_bulk(q, top_k=3, batch_q=8, chunk_batches=2)) == _ids(ref)


def test_search_bulk_refuses_other_dims(tmp_path):
    store, _, _ = _bulk_store(AppSettings, tmp_path, "flat")
    with pytest.raises(ValueError, match="dim mismatch"):
        store.search_bulk(np.zeros((8, 48), dtype=np.float32), top_k=3)
    empty = VectorStore(_settings(AppSettings, tmp_path / "e", embedding_dimension=32),
                        device="cpu")
    assert empty.search_bulk(np.zeros((3, 32), np.float32), top_k=3) == [[], [], []]


@pytest.mark.parametrize("index_kind", ["flat", "ivf"])
def test_search_bulk_matches_reference(tmp_path, mesh1, index_kind):
    """The same store contents and queries through both packages' bulk
    search: the same ids, scores within 1e-5."""
    j, v1, v2 = _bulk_store(JaxSettings, tmp_path / "j", index_kind, mesh1, JaxPayload)
    t, _, _ = _bulk_store(AppSettings, tmp_path / "t", index_kind)
    q = np.concatenate([v1[:9], v2[:12]])
    for filters in (None, {"repo": "r1"}):
        hj = j.search_bulk(q, top_k=4, filters=filters, batch_q=8, chunk_batches=2)
        ht = t.search_bulk(q, top_k=4, filters=filters, batch_q=8, chunk_batches=2)
        assert _ids(ht) == _ids(hj)
        for a, b in zip(hj, ht):
            np.testing.assert_allclose([h.score for h in b], [h.score for h in a],
                                       rtol=1e-5, atol=1e-5)
