"""The row-sharded engine: semcode_tpu_torch against semcode_tpu at one mesh.

The JAX package runs on its 8 virtual CPU devices (``tests/conftest.py``),
on ``mesh8`` and on the ``(2, 4)`` ``("dcn", "data")`` mesh; the port on
``make_mesh(..., devices=[cpu] * 8)`` of the same shape. The row layout, the
kernel route's 2-per-block survivors, IVF's ``nlist`` rounding and cluster
ownership and the merge's tie order all depend on the shard count, so each
package is held to the other at the SAME mesh. Inputs come from numpy
seeds. Required: equal ids; int8 scores from integer arithmetic (no rescore
tier) bit for bit; f32-rescored and bf16/f32 scores within rtol 1e-5, ids
equal wherever neighbouring scores stand more than 1e-5 apart.
"""

import shutil
from pathlib import Path

import jax
import numpy as np
import pytest

from semcode_tpu.embeddings.providers import EmbeddingPayload as JaxPayload
from semcode_tpu.index.flat import FlatIndex as JaxFlat
from semcode_tpu.index.ivf import IVFIndex as JaxIVF
from semcode_tpu.index.store import VectorStore as JaxStore
from semcode_tpu.parallel.mesh import make_mesh as jax_mesh
from semcode_tpu.rag import SemanticSearchPipeline as JaxPipeline
from semcode_tpu.services import IndexerService as JaxIndexer
from semcode_tpu.settings import AppSettings as JaxSettings
from semcode_tpu_torch.embeddings.providers import EmbeddingPayload
from semcode_tpu_torch.index.flat import FlatIndex
from semcode_tpu_torch.index.ivf import IVFIndex
from semcode_tpu_torch.index.store import VectorStore
from semcode_tpu_torch.parallel.mesh import make_mesh
from semcode_tpu_torch.rag import SemanticSearchPipeline
from semcode_tpu_torch.services import IndexerService
from semcode_tpu_torch.settings import AppSettings

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"8": ((8,), ("data",)), "2x4": ((2, 4), ("dcn", "data"))}


@pytest.fixture(scope="module")
def meshes():
    out = {name: (jax_mesh(*spec), make_mesh(*spec, devices=["cpu"] * 8))
           for name, spec in MESHES.items()}
    out["1"] = (jax_mesh((1,), ("data",), devices=jax.devices()[:1]),
                make_mesh((1,), ("data",), devices=["cpu"]))
    return out


def _same(js, ji, ts, ti, exact=False, tol=1e-5):
    """Ids equal wherever the reference's neighbouring scores stand more
    than ``tol`` apart (a near-tie may swap: f32 sums in another order);
    scores bit for bit (``exact``) or within rtol ``tol``."""
    if exact:
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(ti, ji)
        return
    np.testing.assert_allclose(ts, js, rtol=tol, atol=tol)
    gap = np.abs(np.diff(js, axis=1)) > tol
    apart = np.ones(js.shape, dtype=bool)
    apart[:, 1:] &= gap
    apart[:, :-1] &= gap
    np.testing.assert_array_equal(ti[apart], ji[apart])


def _rows(seed, n, d):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[100:120] = x[300:320]  # exact duplicates on both sides of a shard edge
    tags = rng.integers(0, 3, n).astype(np.int32)
    q = x[rng.choice(n, 12, replace=False)] + 0.05 * rng.standard_normal(
        (12, d)).astype(np.float32)
    q[0] = x[305]
    return x, tags, q


# -- FlatIndex -------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["8", "2x4"])
@pytest.mark.parametrize("scan_impl", ["xla", "pallas"])
@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_flat_matches_reference(meshes, mesh, scan_impl, metric, dtype):
    jm, tm = meshes[mesh]
    x, tags, q = _rows(len(dtype) + len(metric), 1000, 128)
    kw = dict(metric=metric, dtype=dtype, scan_impl=scan_impl)
    j, t = JaxFlat(128, mesh=jm, **kw), FlatIndex(128, mesh=tm, **kw)
    for idx in (j, t):
        idx.add(x, tags)
        idx.remove(np.arange(0, 1000, 9))
    assert t.n_shards == j.n_shards == 8 and t.capacity == j.capacity
    _same(*j.search(q, 10), *t.search(q, 10))
    _same(*j.search(q, 10, allow_tags=[1, 2]), *t.search(q, 10, allow_tags=[1, 2]))
    # the merged pool holds n_shards x k_shard: k past a shard's rows
    _same(*j.search(q[:3], 200), *t.search(q[:3], 200))


@pytest.mark.parametrize("mesh", ["8", "2x4"])
@pytest.mark.parametrize("scan_impl", ["xla", "pallas"])
def test_flat_int8_scores_bit_for_bit(meshes, mesh, scan_impl):
    """Without a rescore tier the int8 scores are the integer products
    rescaled in f32: the same bits in both packages."""
    jm, tm = meshes[mesh]
    x, tags, q = _rows(5, 1500, 128)
    kw = dict(dtype="int8", scan_impl=scan_impl, rescore_mode="off")
    j, t = JaxFlat(128, mesh=jm, **kw), FlatIndex(128, mesh=tm, **kw)
    for idx in (j, t):
        idx.add(x, tags)
    _same(*j.search(q, 16), *t.search(q, 16), exact=True)
    _same(*j.search(q, 16, allow_tags=[0]), *t.search(q, 16, allow_tags=[0]),
          exact=True)


@pytest.mark.parametrize("mesh", ["8", "2x4"])
def test_flat_updates_compaction_and_device_search(meshes, mesh):
    jm, tm = meshes[mesh]
    x, tags, q = _rows(9, 700, 128)
    kw = dict(dtype="int8", rescore_mode="residual")
    j, t = JaxFlat(128, mesh=jm, **kw), FlatIndex(128, mesh=tm, **kw)
    for idx in (j, t):
        idx.add(x[:400], tags[:400])
        idx.add(x[400:], tags[400:])  # grows: every shard's range moves
        idx.update_rows(np.arange(10, 20), x[600:610])
        idx.remove(np.arange(0, 700, 5))
    _same(*j.search(q, 10), *t.search(q, 10))
    jn, jr = j.compacted()
    tn, tr = t.compacted()
    np.testing.assert_array_equal(tr, jr)
    assert tn.capacity == jn.capacity
    _same(*jn.search(q, 10), *tn.search(q, 10))
    # device entry points: the merged pool of min(k, shard rows) per shard
    import jax.numpy as jnp
    import torch

    js, ji = jn.search_device(jnp.asarray(np.pad(q, ((0, 4), (0, 0)))), 10)
    ts, ti = tn.search_device(torch.from_numpy(np.pad(q, ((0, 4), (0, 0)))), 10)
    _same(np.asarray(js)[:12], np.asarray(ji)[:12], ts.numpy()[:12], ti.numpy()[:12])
    qs = np.stack([q[:8], q[4:]])
    js, ji = jn.search_device_batched(jnp.asarray(qs), 10)
    ts, ti = tn.search_device_batched(torch.from_numpy(qs), 10)
    for b in range(2):
        _same(np.asarray(js)[b], np.asarray(ji)[b], ts.numpy()[b], ti.numpy()[b])


@pytest.mark.parametrize("src,dst", [("8", "1"), ("1", "8"), ("8", "2x4")])
def test_flat_state_loads_across_shard_counts(meshes, src, dst):
    """A state saved at one shard count loads at another in both packages,
    and each package then answers as the other does at that mesh."""
    x, tags, q = _rows(13, 900, 128)
    kw = dict(dtype="int8", scan_impl="pallas")
    saved = JaxFlat(128, mesh=meshes[src][0], **kw)
    saved.add(x, tags)
    saved.remove(np.arange(3, 900, 11))
    state = saved.state_dict()
    tsaved = FlatIndex(128, mesh=meshes[src][1], **kw)
    tsaved.add(x, tags)
    tsaved.remove(np.arange(3, 900, 11))
    tstate = tsaved.state_dict()
    for key in state:
        np.testing.assert_array_equal(np.asarray(tstate[key]), np.asarray(state[key]))
    jm, tm = meshes[dst]
    j = JaxFlat.from_state(tstate, mesh=jm, **kw)
    t = FlatIndex.from_state(state, mesh=tm, **kw)
    _same(*j.search(q, 10), *t.search(q, 10))


# -- IVFIndex --------------------------------------------------------------------


def _ivf_pair(meshes, mesh, x, tags, nlist, nprobe, **kw):
    """Both packages on one trained layout: the JAX index trains, the port
    loads its state (k-means sums in another order otherwise)."""
    jm, tm = meshes[mesh]
    j0 = JaxIVF(128, nlist=nlist, nprobe=nprobe, mesh=jm, **kw)
    j0.add(x, tags)
    state = j0.state_dict()
    return (JaxIVF.from_state(state, mesh=jm, **kw),
            IVFIndex.from_state(state, mesh=tm, **kw))


@pytest.mark.parametrize("mesh", ["8", "2x4"])
@pytest.mark.parametrize("use_pallas", ["always", "never"])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_ivf_matches_reference(meshes, mesh, use_pallas, dtype):
    x, tags, q = _rows(len(dtype), 1200, 128)
    j, t = _ivf_pair(meshes, mesh, x, tags, nlist=12, nprobe=3, dtype=dtype,
                     use_pallas=use_pallas)
    assert t.nlist == j.nlist == 16 and t.cmax == j.cmax  # rounded to 8 shards
    for mode in ("ivf", "exact"):
        _same(*j.search(q, 10, mode=mode), *t.search(q, 10, mode=mode))
    for idx in (j, t):
        idx.remove(np.arange(0, 1200, 4))
    _same(*j.search(q, 10, mode="ivf"), *t.search(q, 10, mode="ivf"))
    _same(*j.search(q, 10, allow_tags=[2]), *t.search(q, 10, allow_tags=[2]))


@pytest.mark.parametrize("mesh", ["8", "2x4"])
def test_ivf_pending_batched_and_compaction(meshes, mesh):
    import jax.numpy as jnp
    import torch

    x, tags, q = _rows(21, 1600, 128)
    j, t = _ivf_pair(meshes, mesh, x[:1200], tags[:1200], nlist=16, nprobe=4,
                     dtype="int8", use_pallas="always")
    for idx in (j, t):
        idx.PENDING_THRESHOLD_BYTES = 0  # streaming adds land in the tail
        idx.add(x[1200:], tags[1200:])
        assert idx._pend is not None
        idx.remove(np.array([1250, 5, 1300]))
    for mode in ("ivf", "exact"):
        _same(*j.search(q, 10, mode=mode), *t.search(q, 10, mode=mode))
    qs = np.stack([q[:8], q[4:]])
    for mode in ("probe", "exact"):
        js, ji = j.search_device_batched(jnp.asarray(qs), 10, mode=mode)
        ts, ti = t.search_device_batched(torch.from_numpy(qs), 10, mode=mode)
        for b in range(2):
            _same(np.asarray(js)[b], np.asarray(ji)[b], ts.numpy()[b],
                  ti.numpy()[b])
    js, ji = j.search_device(jnp.asarray(q[:8]), 10, mode="ivf")
    ts, ti = t.search_device(torch.from_numpy(q[:8]), 10, mode="ivf")
    _same(np.asarray(js), np.asarray(ji), ts.numpy(), ti.numpy())
    jn, jr = j.compacted()
    tn, tr = t.compacted()
    np.testing.assert_array_equal(tr, jr)
    assert tn.cmax == jn.cmax
    np.testing.assert_array_equal(tn._loc[: tn._n_rows], jn._loc[: jn._n_rows])
    _same(*jn.search(q, 10, mode="ivf"), *tn.search(q, 10, mode="ivf"))


# -- VectorStore -----------------------------------------------------------------

SOURCES = [
    "semcode_tpu/index/rerank.py",
    "semcode_tpu/index/lexical.py",
    "semcode_tpu/storage/registry.py",
    "semcode_tpu/logger.py",
    "semcode_tpu/utils/tracing.py",
    "semcode_tpu/parallel/mesh.py",
]
QUESTIONS = [
    "lexical rerank of candidate hits with bm25",
    "where is hierarchical_topk_merge defined",
    "repository registry json persistence",
    "structured logging with key value pairs",
    "stage timer for per-stage timings",
    "gather fingerprint rows by global row id",
    "mesh shape strings",
    "file lock around the registry",
]


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    base = tmp_path_factory.mktemp("src")
    for rel in SOURCES:
        dst = base / "pkg" / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(ROOT / rel, dst)
    return base / "pkg"


def _settings(cls, ws, **kw):
    base = dict(workspace_root=ws, index_kind="flat", rag_query_cache_size=0,
                chunk_max_lines=30)
    return cls(**{**base, **kw})


def _hits(results):
    return [[(s["path"], s["score"]) for s in r["sources"]] for r in results]


def _assert_same_hits(a, b):
    assert len(a) == len(b)
    for ha, hb in zip(a, b):
        assert [p for p, _ in hb] == [p for p, _ in ha]
        np.testing.assert_allclose([s for _, s in hb], [s for _, s in ha],
                                   rtol=1e-5, atol=1e-5)


def _pipelines(tmp_path, meshes, mesh, repo, **kw):
    jm, tm = meshes[mesh]
    jcfg = _settings(JaxSettings, tmp_path / "jax", **kw)
    tcfg = _settings(AppSettings, tmp_path / "torch", **kw)
    jsvc = JaxIndexer(config=jcfg, vector_store=JaxStore(jcfg, mesh=jm))
    tsvc = IndexerService(config=tcfg, vector_store=VectorStore(tcfg, mesh=tm),
                          device="cpu")
    assert (tsvc.index_repository([repo], "pkg").chunk_count
            == jsvc.index_repository([repo], "pkg").chunk_count > 20)
    jp = JaxPipeline(config=jcfg, vector_store=jsvc.vector_store,
                     embeddings=jsvc.embeddings)
    tp = SemanticSearchPipeline(config=tcfg, vector_store=tsvc.vector_store,
                                embeddings=tsvc.embeddings, device="cpu")
    return jsvc, tsvc, jp, tp


@pytest.mark.parametrize("mesh", ["8", "2x4"])
@pytest.mark.parametrize("scan_impl", ["auto", "pallas"])
def test_store_device_rerank_matches_reference(tmp_path, meshes, mesh, repo,
                                               scan_impl):
    jsvc, tsvc, jp, tp = _pipelines(tmp_path, meshes, mesh, repo,
                                    index_scan_impl=scan_impl)
    store = tsvc.vector_store
    assert store._lex is not None and store._lex.mesh is meshes[mesh][1]
    assert store._lex._row_multiple == 128  # lcm(8 shards x 8, 128)
    _assert_same_hits(_hits(jp.query_batch(QUESTIONS, top_k=5)),
                      _hits(tp.query_batch(QUESTIONS, top_k=5)))
    _assert_same_hits(_hits([jp.query(QUESTIONS[1], top_k=5)]),
                      _hits([tp.query(QUESTIONS[1], top_k=5)]))


def test_store_filters_and_ivf_on_eight_shards(tmp_path, meshes):
    jm, tm = meshes["8"]
    kw = dict(embedding_dimension=128, index_kind="auto", index_ivf_min_size=200,
              index_nlist=6, index_nprobe=3, index_auto_compact_ratio=0.0)
    j = JaxStore(_settings(JaxSettings, tmp_path / "j", **kw), mesh=jm)
    t = VectorStore(_settings(AppSettings, tmp_path / "t", **kw), mesh=tm)
    for cls, store in ((JaxPayload, j), (EmbeddingPayload, t)):
        rng = np.random.default_rng(2)
        vecs = rng.standard_normal((300, 128)).astype(np.float32)
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
        store.upsert_embeddings([
            cls(id=f"c{i}", text=f"text {i}", vector=vecs[i],
                metadata={"repo": f"r{i % 2}", "path": f"c{i}.py",
                          "language": "python"})
            for i in range(300)
        ])
        store.delete([f"c{i}" for i in range(0, 300, 6)])
    assert t.stats() == j.stats() and t.stats()["kind"] == "ivf"
    assert t._index.nlist == j._index.nlist == 8
    q = vecs[1:7]
    for filters in (None, {"repo": "r1"}):
        hj = j.search_batch(q, top_k=6, filters=filters)
        ht = t.search_batch(q, top_k=6, filters=filters)
        assert [[h.id for h in hs] for hs in ht] == [[h.id for h in hs] for hs in hj]


def _reload(cls, cfg_cls, tmp_path, snap, mesh, name):
    # default index options: the reference's load keeps only the dtype
    # (ROADMAP Queue 3), so any other option would part the packages
    cfg = _settings(cfg_cls, tmp_path / name, index_snapshot_dir=snap)
    store = cls(cfg, mesh=mesh)
    store.connect()
    return store, cfg


def test_snapshots_cross_load_across_shard_counts(tmp_path, meshes, repo):
    """Snapshots written by either package at 8 shards load in the other at
    8 and at 1. A reloaded store reranks on the host until its first write
    (both packages), so its window depends on the shard count: the port
    reproduces the reference at each mesh, including the sharded reload's
    other hits after the top ranks (ROADMAP Queue 3)."""
    jsvc, tsvc, jp, tp = _pipelines(tmp_path, meshes, "8", repo)
    for store in (jsvc.vector_store, tsvc.vector_store):
        store.save()
    answers = {}
    for name in ("8", "1"):
        jm, tm = meshes[name]
        for label, snap in (("jax", jsvc.vector_store.snapshot_dir()),
                            ("torch", tsvc.vector_store.snapshot_dir())):
            tag = f"{name}{label}"
            j, jcfg = _reload(JaxStore, JaxSettings, tmp_path, snap, jm, "j" + tag)
            t, tcfg = _reload(VectorStore, AppSettings, tmp_path, snap, tm, "t" + tag)
            assert t._lex is None and j._lex is None
            assert t.count() == j.count() == tsvc.vector_store.count()
            ja = _hits(JaxPipeline(config=jcfg, vector_store=j,
                                   embeddings=jsvc.embeddings)
                       .query_batch(QUESTIONS, top_k=5))
            ta = _hits(SemanticSearchPipeline(config=tcfg, vector_store=t,
                                              embeddings=tsvc.embeddings,
                                              device="cpu")
                       .query_batch(QUESTIONS, top_k=5))
            _assert_same_hits(ja, ta)
            answers[(name, label)] = [[p for p, _ in h] for h in ta]
    # either package's snapshot gives the same answers at one mesh
    assert answers[("8", "jax")] == answers[("8", "torch")]
    assert answers[("1", "jax")] == answers[("1", "torch")]
    # the sharded reload serves another window than the one-shard reload
    assert answers[("8", "jax")] != answers[("1", "jax")]
