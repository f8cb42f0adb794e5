"""Rerank-variant laboratory: iterate second-stage scoring offline.

Counterpart of the JAX package's ``tools/rerank_lab.py``.

Stage 1 (slow, cached): chunk + embed a held-out corpus, retrieve a DEEP
dense candidate window per self-labelled query with reranking OFF, and
pickle the windows (query, relevant ids, candidate hits with dense scores)
under the git-ignored ``build/rerank_lab/``.

Stage 2 (fast): score rerank variants on the cached windows — no
re-embedding, no re-scanning — and report MRR@10/recall@10 per variant.
A variant is any callable (query_text, hits, top_k) -> reordered hits.

    python -m semcode_tpu_torch.tools.rerank_lab --corpus aiohttp --build
    python -m semcode_tpu_torch.tools.rerank_lab --corpus aiohttp

It runs on CUDA unless ``SEMCODE_TORCH_DEVICE=cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import pickle
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

CACHE = Path(__file__).resolve().parents[2] / "build" / "rerank_lab"
WINDOW = 200  # deep dense window: variants choose their own depth <= this


def build(corpus: str, provider: str, max_per_kind: int,
          cache: Path = CACHE, device=None) -> Path:
    from ..embeddings import EmbeddingProviderFactory
    from ..embeddings.providers import EmbeddingPayload, embedding_text
    from ..eval import generate_queries
    from ..index.store import VectorStore
    from ..settings import settings
    from .eval_heldout import chunk_corpus, corpus_dir

    metas = chunk_corpus(corpus, corpus_dir(corpus))
    cfg = settings.model_copy(
        update={
            "embedding_provider": provider,
            "search_rerank_weight": 0.0,  # raw dense windows
            "search_top_k_max": max(WINDOW, settings.search_top_k_max),
        }
    )
    emb = EmbeddingProviderFactory.create(cfg, device=device)
    dim = len(emb.embed_query("probe"))
    store = VectorStore(
        cfg.model_copy(
            update={
                "embedding_dimension": dim,
                "index_snapshot_dir": None,
                "workspace_root": None,
            }
        ),
        dim=dim,
        device=device,
    )
    texts = [
        embedding_text(
            m.get("text") or "", symbol=m.get("symbol"), path=m.get("path")
        )
        for _, m in metas
    ]
    t0 = time.perf_counter()
    payloads = []
    bs = max(1, cfg.embedding_batch_size)
    for lo in range(0, len(texts), bs):
        vecs = emb.embed_documents(texts[lo : lo + bs])
        for (pid, meta), v in zip(metas[lo : lo + bs], vecs):
            payloads.append(EmbeddingPayload(pid, meta.get("text") or "", v, meta))
    store.upsert_embeddings(payloads)
    print(f"embedded {len(payloads)} chunks in {time.perf_counter() - t0:.1f}s",
          flush=True)
    queries = generate_queries(metas, max_per_kind=max_per_kind)
    records = []
    t0 = time.perf_counter()
    for lo in range(0, len(queries), 64):
        chunk = queries[lo : lo + 64]
        qtexts = [q.text for q in chunk]
        if hasattr(emb, "embed_queries"):
            qvecs = emb.embed_queries(qtexts)
        else:
            qvecs = [emb.embed_query(t) for t in qtexts]
        hits_batch = store.search_batch(
            np.asarray(qvecs, dtype=np.float32), top_k=WINDOW
        )
        for q, hits in zip(chunk, hits_batch):
            records.append(
                {
                    "query": q.text,
                    "kind": q.kind,
                    "relevant": set(q.relevant),
                    "relevant_paths": set(q.relevant_paths),
                    "hits": hits,
                }
            )
    print(f"retrieved {len(records)} windows in {time.perf_counter() - t0:.1f}s",
          flush=True)
    cache.mkdir(parents=True, exist_ok=True)
    out = cache_path(corpus, provider, cache)
    with open(out, "wb") as f:
        pickle.dump(records, f)
    print(f"cached -> {out}", flush=True)
    return out


def cache_path(corpus: str, provider: str, cache: Path = CACHE) -> Path:
    """The windows' file: named by the corpus's last path part, so a
    directory corpus never writes outside ``cache``."""
    return cache / f"{Path(corpus).name or 'corpus'}.{provider}.pkl"


def score(records, rerank_fn, top_k: int = 10):
    """MRR@10 / recall@10 of a variant over cached windows."""
    ranks = []
    kinds = []
    for rec in records:
        hits = rerank_fn(rec["query"], rec["hits"], top_k)
        rank = np.inf
        for pos, hit in enumerate(hits[:top_k], start=1):
            if hit.id in rec["relevant"] or (
                rec["relevant_paths"]
                and any(
                    (hit.path or "") == p or (hit.path or "").endswith("/" + p)
                    for p in rec["relevant_paths"]
                )
            ):
                rank = pos
                break
        ranks.append(rank)
        kinds.append(rec["kind"])
    r = np.asarray(ranks)
    out = {
        "mrr@10": float(np.mean(np.where(r <= 10, 1.0 / r, 0.0))),
        "recall@10": float(np.mean(r <= 10)),
        "n": int(r.size),
    }
    for kind in sorted(set(kinds)):
        sel = np.asarray([k == kind for k in kinds])
        rr = r[sel]
        out[kind] = round(float(np.mean(np.where(rr <= 10, 1.0 / rr, 0.0))), 4)
    return out


def variants():
    """The variants the JAX tool scores, by name."""
    from ..index.rerank import rerank_hits

    def host(w, depth):
        def fn(q, hits, top_k):
            return rerank_hits(q, hits[: top_k * depth], top_k, weight=w)

        return fn

    return {
        "dense-only": lambda q, hits, top_k: hits[:top_k],
        # host() uses the REAL rerank_hits, so it carries the shipped
        # sym_bonus default — the honest host-vs-device comparison
        "host d20 (shipped defaults)": host(0.8, 20),
        "device-sim K256 d20 sym0.75": trunc_bm25(0.8, 20, 256, sym_bonus=0.75),
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", default="aiohttp")
    ap.add_argument("--provider", default="tpu-hybrid")
    ap.add_argument("--build", action="store_true")
    ap.add_argument("--max-per-kind", type=int, default=150)
    args = ap.parse_args(argv)

    path = cache_path(args.corpus, args.provider)
    if args.build or not path.exists():
        path = build(args.corpus, args.provider, args.max_per_kind)
    with open(path, "rb") as f:  # a cache this tool wrote
        records = pickle.load(f)
    for name, fn in variants().items():
        print(f"{name:34s} {score(records, fn)}", flush=True)
    return 0


def trunc_bm25(
    weight: float,
    depth: int,
    kterms: int,
    tmax: int = 64,
    fusion: str = "minmax",  # minmax | rrf
    sym_bonus: float = 0.0,  # add to lex when the query names the doc symbol
):
    """Numpy simulation of the device rerank using the REAL fingerprint
    featurizer (index/lexical.featurize_doc): window BM25 over the
    fingerprint terms only, min-max blend with dense."""
    from ..index import rerank as rr
    from ..index.lexical import featurize_doc, symbol_hash, term_hash

    _fp_cache: dict = {}

    def doc_fp(hit):
        key = (hit.id, len(hit.text or ""))
        out = _fp_cache.get(key)
        if out is None:
            ids, w, length = featurize_doc(
                hit.text,
                (hit.metadata or {}).get("symbol"),
                hit.path,
                kterms=kterms,
            )
            keep = ids >= 0
            out = (
                ids[keep].astype(np.int64),
                np.asarray(w[keep], dtype=np.float32),
                np.float32(length),
            )
            _fp_cache[key] = out
        return out

    K1, B = 1.2, 0.75

    def fn(query, hits, top_k):
        hits = hits[: top_k * depth]
        if weight <= 0.0 or len(hits) <= 1 or not query:
            return hits[:top_k]
        q_tokens = set(rr.tokenize(query, limit=64))
        if not q_tokens:
            return hits[:top_k]
        q_ids = np.asarray(
            sorted(term_hash(t) for t in q_tokens), dtype=np.int64
        )[:tmax]
        n = len(hits)
        fps = [doc_fp(h) for h in hits]
        lengths = np.asarray([f[2] for f in fps])
        avg_len = float(lengths.mean())
        # tf[w, t]: fingerprint weight of query term t in doc w
        tf = np.zeros((n, q_ids.size), dtype=np.float32)
        for wi, (ids, wts, _) in enumerate(fps):
            m = ids[:, None] == q_ids[None, :]
            tf[wi] = (wts[:, None] * m).sum(axis=0)
        df = (tf > 0).sum(axis=0)
        idf = np.log1p((n - df + 0.5) / (df + 0.5))
        denom = tf + K1 * (1.0 - B + B * lengths[:, None] / avg_len)
        lex = (idf[None, :] * tf * (K1 + 1.0) / np.maximum(denom, 1e-9)).sum(axis=1)
        if sym_bonus > 0.0:
            qset = {term_hash(c) for c in rr.query_symbol_candidates(query)}
            max_idf = float(idf.max()) if idf.size else 1.0
            for wi, h in enumerate(hits):
                sh = symbol_hash((h.metadata or {}).get("symbol"))
                if sh >= 0 and sh in qset:
                    lex[wi] += sym_bonus * max_idf

        dense = np.asarray([h.score for h in hits], dtype=np.float64)
        fin = np.isfinite(dense)
        if not fin.all():
            dense = np.where(fin, dense, dense[fin].min() if fin.any() else 0.0)

        if fusion == "rrf":
            rd = np.empty(n)
            rd[np.argsort(-dense, kind="stable")] = np.arange(n)
            rl = np.empty(n)
            rl[np.argsort(-lex, kind="stable")] = np.arange(n)
            final = (1.0 - weight) / (60.0 + rd) + weight / (60.0 + rl)
        else:
            def mm(x):
                span = float(x.max() - x.min())
                return np.zeros_like(x) if span <= 1e-12 else (x - x.min()) / span

            final = (1.0 - weight) * mm(dense) + weight * mm(lex)
        order = np.lexsort((-lex, -final))
        return [hits[i] for i in order[:top_k]]

    return fn


if __name__ == "__main__":
    sys.exit(main())
