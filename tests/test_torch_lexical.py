"""Device lexical rerank: semcode_tpu_torch against semcode_tpu.

The same numpy windows go through JAX ``bm25_blend`` and the port's. The
blend ORDER must be identical — including windows with exact ties (equal
dense scores, duplicated fingerprints), where the stable two-key sort
decides — with and without the learned MaxSim table; the final scores
agree within 1e-5 (f32 sums in another order). Fingerprint featurization
is a copy and must be identical.
"""

import jax
import numpy as np
import pytest
import torch

from semcode_tpu.index import lexical as jl
from semcode_tpu.parallel.mesh import make_mesh
from semcode_tpu_torch.index import lexical as tl
from semcode_tpu_torch.models.term_reranker import default_asset_path, load_table

DOCS = [
    {"text": "def parse_config(path):\n    return read_toml(path)",
     "symbol": "parse_config", "path": "semcode/settings.py"},
    {"text": "class VectorStore:\n    def upsert(self, rows): ...",
     "symbol": "VectorStore", "path": "index/store.py"},
    {"text": "", "symbol": None, "path": None},
    {"text": "retry failed requests with backoff " * 40,
     "symbol": "retry_request", "path": "net/retry.py"},
]
QUERIES = ["where is parse_config defined", "vector store upsert rows",
           "retry requests", None]


def _window(seed, q=5, w=24, k=16, t=6, vocab=40):
    rng = np.random.default_rng(seed)
    voc = np.arange(1000, 1000 + vocab, dtype=np.int32)
    g_ids = rng.choice(voc, (q, w, k)).astype(np.int32)
    g_ids[:, :, k - 3:] = -1  # padding slots
    g_w = rng.integers(1, 5, (q, w, k)).astype(np.float32)
    g_len = rng.integers(10, 60, (q, w)).astype(np.float32)
    dense = np.round(rng.random((q, w)), 2).astype(np.float32)  # many ties
    dense[:, 4] = dense[:, 3]  # exact dense ties ...
    g_ids[:, 4], g_w[:, 4], g_len[:, 4] = g_ids[:, 3], g_w[:, 3], g_len[:, 3]
    dense[0, -3:] = jl._NEG_INF  # dead slots
    q_ids = rng.choice(voc, (q, t)).astype(np.int32)
    q_ids[1, 2:] = -1
    q_ids[4, :] = -1  # a text-less query: dense order survives
    g_sym = np.full((q, w), -1, np.int32)
    g_sym[0, 7] = 5
    q_sym = np.full((q, 3), -1, np.int32)
    q_sym[0, 0] = 5
    return g_ids, g_w, g_len, g_sym, dense, q_ids, q_sym


def _table(n=64, d=8, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((n, d)).astype(np.float32)
    return t / np.linalg.norm(t, axis=1, keepdims=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("learned", [False, True])
@pytest.mark.parametrize("sym_bonus", [0.0, 1.0])
def test_bm25_blend_order_identical(seed, learned, sym_bonus):
    g_ids, g_w, g_len, g_sym, dense, q_ids, q_sym = _window(seed)
    table = _table(seed=seed) if learned else None
    jf, jo = jl.bm25_blend(
        g_ids, g_w, g_len, g_sym, dense, q_ids, np.float32(0.8),
        np.float32(sym_bonus), q_sym,
        None if table is None else jax.numpy.asarray(table),
        np.float32(0.8) if learned else None,
    )
    t = torch.from_numpy
    tf, to = tl.bm25_blend(
        t(g_ids), t(g_w), t(g_len), t(g_sym), t(dense), t(q_ids), 0.8,
        sym_bonus, t(q_sym), None if table is None else t(table),
        0.8 if learned else None,
    )
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    jf = np.asarray(jf)
    live = np.isfinite(jf)
    np.testing.assert_array_equal(np.isfinite(tf.numpy()), live)
    np.testing.assert_allclose(tf.numpy()[live], jf[live], rtol=1e-5, atol=1e-5)


def test_blend_chunks_by_query():
    """More queries than one blend chunk: same order as the reference."""
    g_ids, g_w, g_len, g_sym, dense, q_ids, q_sym = _window(7, q=tl._BLEND_CHUNK * 2 + 3)
    _, jo = jl.bm25_blend(g_ids, g_w, g_len, g_sym, dense, q_ids,
                          np.float32(0.5), np.float32(0.0), q_sym)
    t = torch.from_numpy
    _, to = tl.bm25_blend(t(g_ids), t(g_w), t(g_len), t(g_sym), t(dense),
                          t(q_ids), 0.5, 0.0, t(q_sym))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def test_featurization_identical():
    for kterms in (8, jl.DEFAULT_KTERMS):
        a = jl.featurize_docs(DOCS, kterms=kterms)
        b = tl.featurize_docs(DOCS, kterms=kterms)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
    np.testing.assert_array_equal(tl.featurize_queries(QUERIES),
                                  jl.featurize_queries(QUERIES))
    np.testing.assert_array_equal(tl.featurize_query_symbols(QUERIES),
                                  jl.featurize_query_symbols(QUERIES))


def test_rerank_device_matches_reference():
    mesh1 = make_mesh((1,), ("data",), devices=jax.devices()[:1])
    rng = np.random.default_rng(3)
    metas = DOCS * 8
    ja = jl.LexicalFingerprints(mesh1, 128)
    ta = tl.LexicalFingerprints(128, device="cpu")
    rows = np.arange(len(metas))
    ja.set_rows(rows, metas)
    ta.set_rows(rows, metas)
    ids = np.stack([rng.permutation(len(metas))[:12] for _ in QUERIES])
    ids[0, -2:] = -1
    scores = np.where(ids >= 0, rng.random(ids.shape), jl._NEG_INF).astype(np.float32)
    q_ids = jl.featurize_queries(QUERIES)
    q_sym = jl.featurize_query_symbols(QUERIES)
    table = load_table(default_asset_path())
    assert table is not None, "the shipped term-reranker table must load"
    for tab in (None, table):
        js, ji = jl.rerank_device(
            mesh1, ja.device_arrays(0), scores, ids, q_ids, q_sym=q_sym,
            weight=0.8, sym_bonus=1.0,
            table=None if tab is None else jax.numpy.asarray(tab),
            learned_weight=0.8,
        )
        ts, ti = tl.rerank_device(
            ta.device_arrays(0), scores, ids, q_ids, q_sym=q_sym, weight=0.8,
            sym_bonus=1.0, table=None if tab is None else torch.from_numpy(tab),
            learned_weight=0.8,
        )
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_fingerprints_set_rows_and_remap():
    mesh1 = make_mesh((1,), ("data",), devices=jax.devices()[:1])
    ja = jl.LexicalFingerprints(mesh1, 128, kterms=16)
    ta = tl.LexicalFingerprints(128, kterms=16, device="cpu")
    for fp in (ja, ta):
        fp.set_rows(np.arange(4), DOCS)
        fp.device_arrays(0)
        fp.set_rows(np.array([1]), DOCS[3:])  # device mirror in lockstep
        fp.remap(np.array([2, -1, 0, 1]))
    for k in ("_ids", "_w", "_len", "_sym"):
        np.testing.assert_array_equal(getattr(ta, k), getattr(ja, k))
    dev = ta.device_arrays(0)
    for arr, host in zip(dev, (ta._ids, ta._w, ta._len, ta._sym)):
        np.testing.assert_array_equal(arr.numpy(), host)
