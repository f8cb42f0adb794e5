"""The port's ``tpu-hybrid`` provider against the JAX package's, on the CPU.

- the hybrid vectors (documents, one query, a batch of queries), the
  adaptive per-query weights, the identifier detector and the signature
  equal the JAX package's (vectors at per-row cosine >= 0.999: the encoder
  half runs in bf16 in both);
- both factories build ``tpu-encoder`` and ``tpu-hybrid`` from one
  settings object;
- end to end on ``semcode_tpu/index``: both packages ingest through
  ``IndexerService`` into an int8 flat store (full-matrix route; the JAX
  store on one device) and answer 16 frozen questions through
  ``query_batch``; the top-10 paths are equal wherever neighbouring scores
  differ by more than 1e-3.

Run as a script, the same recipe covers the whole frozen set over
``semcode_tpu/`` (181 chunks, 102 questions) in both packages and prints
each package's MRR@10 and recall@10 (the JAX figure is the reference that
``chip_smoke.py`` phase 6b holds the card to):

    JAX_PLATFORMS=cpu python tests/test_torch_hybrid.py
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
FROZEN = ROOT / "tests" / "fixtures" / "frozen_queries.json"

if __name__ == "__main__":  # the script form: the repo root on the path
    sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

from chip_smoke import apart_paths_equal, rank_metrics  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def frozen_queries(n=None):
    data = json.loads(FROZEN.read_text())["queries"][:n]
    return [q["query"] for q in data], [q["relevant_paths"] for q in data]


def frozen_run(pkg, workspace, include, questions):
    """``pkg``'s IndexerService ingests ``ROOT/include`` with tpu-hybrid into
    an int8 flat store on the full-matrix route; the pipeline answers
    ``questions`` in one ``query_batch`` (extractive fallback). The port
    runs on the CPU, the JAX package on one CPU device."""
    if pkg == "semcode_tpu_torch":
        from semcode_tpu_torch.rag import SemanticSearchPipeline
        from semcode_tpu_torch.services import IndexerService
        from semcode_tpu_torch.settings import AppSettings

        kw = {"device": "cpu"}
    else:
        from semcode_tpu.index.store import VectorStore
        from semcode_tpu.parallel.mesh import make_mesh
        from semcode_tpu.rag import SemanticSearchPipeline
        from semcode_tpu.services import IndexerService
        from semcode_tpu.settings import AppSettings

        kw = {}
    cfg = AppSettings(
        workspace_root=workspace,
        embedding_provider="tpu-hybrid",
        index_kind="flat",
        index_dtype="int8",
        index_scan_impl="xla",
        rag_provider="fallback",
        rag_query_cache_size=0,
    )
    if pkg == "semcode_tpu":
        mesh1 = make_mesh((1,), ("data",), devices=jax.devices()[:1])
        svc = IndexerService(config=cfg, vector_store=VectorStore(cfg, mesh=mesh1))
    else:
        svc = IndexerService(config=cfg, **kw)
    res = svc.index_repository([ROOT / include], Path(include).name)
    pipe = SemanticSearchPipeline(config=cfg, vector_store=svc.vector_store,
                                  embeddings=svc.embeddings, **kw)
    return res, svc, pipe.query_batch(questions, top_k=10)


# -- the provider -----------------------------------------------------------------


def _settings(pkg, **kw):
    mod = __import__(f"{pkg}.settings", fromlist=["AppSettings"])
    return mod.AppSettings(workspace_root=None, **kw)


@pytest.fixture(scope="module")
def hybrids():
    from semcode_tpu.embeddings import EmbeddingProviderFactory as J
    from semcode_tpu_torch.embeddings import EmbeddingProviderFactory as T

    jh = J.create(_settings("semcode_tpu", embedding_provider="tpu-hybrid"))
    th = T.create(_settings("semcode_tpu_torch", embedding_provider="tpu-hybrid"),
                  device="cpu")
    return jh, th


QUERIES = [
    "where is the flat index defined",
    "quantize_rows_device",
    "how does searchBatch rank hits",
    "VectorStore and IVFIndex",
    "store.search_batch( with filters",
    "what happens when the store promotes to IVF",
    "",
]


def _row_cos(a, b):
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def test_hybrid_matches_jax(hybrids):
    from semcode_tpu.embeddings.providers import _query_has_identifier as jid
    from semcode_tpu_torch.embeddings.providers import (
        HybridEmbeddings,
        _query_has_identifier as tid,
    )

    jh, th = hybrids
    assert isinstance(th, HybridEmbeddings)
    assert th.signature == jh.signature
    assert th.signature.startswith("hybrid:w0.4:[hash-v") and "]+[encoder:" in th.signature
    assert th.dim == jh.dim == 768
    for q in QUERIES:
        assert tid(q) == jid(q)
        assert th._query_weight(q) == jh._query_weight(q)
    assert {th._query_weight(q) for q in QUERIES} == {0.25, 0.55}
    docs = [(ROOT / "semcode_tpu" / "index" / "flat.py").read_text()[:6000],
            "def parse_config(path):\n    return toml.load(path)\n", ""]
    got = np.asarray(th.embed_documents(docs), np.float32)
    want = np.asarray(jh.embed_documents(docs), np.float32)
    assert got.shape == want.shape == (3, 768)
    # the hash half is the same projection in both packages
    np.testing.assert_allclose(got[:, :384], want[:, :384], rtol=0, atol=1e-5)
    assert _row_cos(got, want).min() >= 0.999
    np.testing.assert_allclose(np.linalg.norm(got[:2], axis=1), 1.0, atol=1e-5)
    got_q = np.asarray(th.embed_queries(QUERIES), np.float32)
    want_q = np.asarray(jh.embed_queries(QUERIES), np.float32)
    assert _row_cos(got_q[:-1], want_q[:-1]).min() >= 0.999
    np.testing.assert_allclose(got_q[:, :384], want_q[:, :384], rtol=0, atol=1e-5)
    one = np.asarray(th.embed_query(QUERIES[1]), np.float32)
    np.testing.assert_array_equal(one, got_q[1])  # batch-invariant
    assert _row_cos(one[None], np.asarray([jh.embed_query(QUERIES[1])]))[0] >= 0.999


@pytest.mark.parametrize("adaptive", [True, False])
def test_hybrid_weights_follow_settings(hybrids, adaptive):
    from semcode_tpu_torch.embeddings.providers import HybridEmbeddings

    _, th = hybrids
    h = HybridEmbeddings(th.hash, th.encoder, w_encoder=0.7, adaptive=adaptive)
    from semcode_tpu.embeddings.providers import HybridEmbeddings as JH

    jh = JH(th.hash, th.encoder, w_encoder=0.7, adaptive=adaptive)
    assert h.signature == jh.signature
    for q in QUERIES:
        assert h._query_weight(q) == jh._query_weight(q)
    v = np.asarray(h.embed_query("where is quantize_rows_device"), np.float32)
    w = h._query_weight("where is quantize_rows_device")
    assert w == pytest.approx(0.55 if adaptive else 0.7)
    np.testing.assert_allclose(np.linalg.norm(v[:384]), np.sqrt(1 - w), atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(v[384:]), np.sqrt(w), atol=1e-5)


def test_factory_builds_the_encoder_provider(hybrids):
    from semcode_tpu_torch.embeddings import EmbeddingProviderFactory
    from semcode_tpu_torch.models.encoder import EncoderEmbeddings

    _, th = hybrids
    enc = EmbeddingProviderFactory.create(
        _settings("semcode_tpu_torch", embedding_provider="tpu-encoder"), device="cpu")
    assert isinstance(enc, EncoderEmbeddings) and enc.device.type == "cpu"
    assert enc.signature == th.encoder.signature and enc.dim == 384
    with pytest.raises(ValueError, match="embedding.dimension = 384"):
        EmbeddingProviderFactory.create(_settings(
            "semcode_tpu_torch", embedding_provider="tpu-encoder",
            embedding_dimension=256), device="cpu")


# -- end to end -------------------------------------------------------------------


def test_ingest_and_query_match_jax(tmp_path):
    questions, _ = frozen_queries(16)
    jres, _, want = frozen_run("semcode_tpu", tmp_path / "jax", "semcode_tpu/index",
                               questions)
    tres, svc, got = frozen_run("semcode_tpu_torch", tmp_path / "port",
                                "semcode_tpu/index", questions)
    assert tres.chunk_count == jres.chunk_count > 30
    assert svc.vector_store.dim == 768
    for q, g, w in zip(questions, got, want):
        assert g["sources"], q
        assert apart_paths_equal(g, w, 1e-3), (
            q, [s["path"] for s in g["sources"]], [s["path"] for s in w["sources"]])
        np.testing.assert_allclose([s["score"] for s in g["sources"]],
                                   [s["score"] for s in w["sources"]], atol=5e-3)


def test_api_warms_the_encoder_and_serves_hybrid(tmp_path):
    """The server loads and runs the encoder in its startup warmup, then
    ingests and answers ``POST /query`` over a 768-d hybrid store."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from semcode_tpu_torch.api.main import create_app, warm_encoder
    from semcode_tpu_torch.embeddings.providers import HybridEmbeddings
    from semcode_tpu_torch.settings import AppSettings

    src = tmp_path / "repo" / "src"
    src.mkdir(parents=True)
    (src / "config.py").write_text(
        "def parse_config(path):\n    '''Read the TOML config.'''\n"
        "    return open(path).read()\n")
    (src / "store.py").write_text("class Store:\n    def add(self, row):\n"
                                  "        self.rows.append(row)\n")
    cfg = AppSettings(workspace_root=tmp_path / "ws", index_kind="flat",
                      embedding_provider="tpu-hybrid", rag_query_cache_size=0)
    app = create_app(config=cfg, device="cpu")
    assert not warm_encoder(AppSettings(workspace_root=None), app["pipeline"])

    async def go():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            r = await client.post("/ingest", json={
                "name": "demo", "root": str(tmp_path / "repo"), "include": ["src"]})
            assert r.status == 200, await r.text()
            r = await client.post("/query", json={"question": "where is parse_config",
                                                  "top_k": 2})
            return r.status, await r.json()
        finally:
            await client.close()  # the cleanup waits for the warmup

    status, body = asyncio.run(go())
    assert not app["warmup_thread"].is_alive()
    warm = app["pipeline"]._embeddings
    assert isinstance(warm, HybridEmbeddings) and warm.dim == 768
    assert status == 200 and body["sources"][0]["path"] == "src/config.py"
    assert app["indexer"].vector_store.dim == 768


def _jax_tool(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_eval_heldout_matches_jax(monkeypatch):
    """The tool's recipe equals the JAX tool's (tpu-hash: the same vectors
    in both packages, so equal reports); tpu-hybrid runs through it."""
    from semcode_tpu_torch.tools import eval_heldout

    monkeypatch.setenv("SEMCODE_TORCH_DEVICE", "cpu")
    corpus = str(ROOT / "semcode_tpu" / "api")
    got = eval_heldout.run([corpus], ["tpu-hash", "tpu-hybrid"], max_per_kind=6)
    jtool = _jax_tool("eval_heldout")
    metas = jtool.chunk_corpus(corpus, jtool.corpus_dir(corpus))
    want = jtool.evaluate(metas, "tpu-hash", 6, {})
    g = got[f"{corpus}/tpu-hash"]
    assert g["device"] == "cpu"
    assert g["n_chunks"] == want["n_chunks"] == len(metas) > 10
    assert g["n_queries"] == want["n_queries"] > 10
    for key in ("mrr@10", "recall@1", "recall@5", "recall@10"):
        assert abs(g[key] - want[key]) <= 1e-4, key
    h = got[f"{corpus}/tpu-hybrid"]
    assert h["n_queries"] == g["n_queries"] and 0.5 < h["mrr@10"] <= 1.0
    assert eval_heldout.parse_overrides(["a=1", "b=x", "c=[1]"]) == {
        "a": 1, "b": "x", "c": [1]}
    with pytest.raises(SystemExit):
        eval_heldout.corpus_dir(str(ROOT / "no-such-corpus"))


def test_rerank_lab_variants_match_jax(tmp_path, monkeypatch):
    import pickle

    from semcode_tpu_torch.tools import rerank_lab

    monkeypatch.setenv("SEMCODE_TORCH_DEVICE", "cpu")
    path = rerank_lab.build(str(ROOT / "semcode_tpu" / "index"), "tpu-hash", 6,
                            cache=tmp_path)
    assert path == tmp_path / "index.tpu-hash.pkl"
    with open(path, "rb") as f:
        records = pickle.load(f)
    assert len(records) > 10 and all(len(r["hits"]) > 20 for r in records)
    jtool = _jax_tool("rerank_lab")
    from semcode_tpu.index.rerank import rerank_hits

    want = {
        "dense-only": lambda q, hits, top_k: hits[:top_k],
        "host d20 (shipped defaults)":
            lambda q, hits, top_k: rerank_hits(q, hits[: top_k * 20], top_k, weight=0.8),
        "device-sim K256 d20 sym0.75": jtool.trunc_bm25(0.8, 20, 256, sym_bonus=0.75),
    }
    got = rerank_lab.variants()
    assert sorted(got) == sorted(want)
    for name in want:
        assert rerank_lab.score(records, got[name]) == jtool.score(records, want[name]), name


def main() -> int:
    import tempfile

    questions, labels = frozen_queries()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for pkg in ("semcode_tpu", "semcode_tpu_torch"):
            res, _, results = frozen_run(pkg, Path(tmp) / pkg, "semcode_tpu",
                                         questions)
            mrr, recall = rank_metrics(results, labels)
            out[pkg] = {"chunks": res.chunk_count, "mrr@10": round(mrr, 4),
                        "recall@10": round(recall, 4)}
            print(f"[frozen tpu-hybrid] {pkg}: {out[pkg]}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
