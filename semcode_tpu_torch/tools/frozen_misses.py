"""Per-query diagnosis of the frozen hand-labelled retrieval set.

Counterpart of the JAX package's ``tools/frozen_misses.py``; it takes
``corpus_dir`` and ``chunk_corpus`` from ``tools/eval_heldout.py``, as the
JAX tool does. Builds an in-memory store over the
repository's own ``semcode_tpu/`` tree (or the aiohttp package) through the
production embedding path (``eval.build_eval_store``), runs the frozen
queries (``tests/fixtures/frozen_queries.json``), and prints the rank of
the first relevant hit per query plus the top hits for every miss:

    SEMCODE_TORCH_DEVICE=cpu python -m semcode_tpu_torch.tools.frozen_misses
    python -m semcode_tpu_torch.tools.frozen_misses --provider tpu-hash --worst 15

It runs on CUDA unless ``SEMCODE_TORCH_DEVICE=cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[2]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--provider", default="tpu-hash")
    ap.add_argument("--worst", type=int, default=20,
                    help="how many worst-ranked queries to detail")
    ap.add_argument("--set", action="append", default=[],
                    help="settings override key=value (repeatable)")
    ap.add_argument("--fixture",
                    default=None,
                    help="frozen query set to score (default: the corpus's "
                         "canonical fixture; pass a historical label "
                         "version extracted from git for labels-only "
                         "delta isolation)")
    ap.add_argument("--corpus", default="semcode_tpu",
                    help="semcode_tpu (this repo) or aiohttp (the external "
                         "frozen set, tests/fixtures/"
                         "frozen_queries_aiohttp.json)")
    args = ap.parse_args(argv)

    from ..eval import build_eval_store, load_frozen_queries
    from ..settings import settings
    from .eval_heldout import chunk_corpus, corpus_dir, parse_overrides

    overrides = parse_overrides(args.set)

    if args.corpus == "semcode_tpu":
        root = REPO_ROOT / "semcode_tpu"
        fixture_name = "frozen_queries.json"
    elif args.corpus == "aiohttp":
        root = corpus_dir("aiohttp")
        fixture_name = "frozen_queries_aiohttp.json"
    else:
        print(f"unknown corpus {args.corpus!r}", file=sys.stderr)
        return 2
    metas = chunk_corpus(args.corpus, root)
    # frozen labels carry the package prefix (ingest root = package parent)
    for _, m in metas:
        m["path"] = f"{args.corpus}/" + m["path"]
    if args.fixture is None:
        args.fixture = str(REPO_ROOT / "tests" / "fixtures" / fixture_name)
    cfg = settings.model_copy(
        update={"embedding_provider": args.provider, **overrides}
    )
    # shared production-path recipe (eval.build_eval_store)
    store, emb = build_eval_store(metas, cfg)

    queries = load_frozen_queries(args.fixture)
    rows: List[tuple] = []
    B = 32
    for lo in range(0, len(queries), B):
        chunk = queries[lo : lo + B]
        texts_q = [q.text for q in chunk]
        embed_queries = getattr(emb, "embed_queries", None)
        if embed_queries is not None:
            qvecs = embed_queries(texts_q)
        else:
            qvecs = [emb.embed_query(t) for t in texts_q]
        hits_b = store.search_batch(
            np.asarray(qvecs, dtype=np.float32),
            top_k=10,
            query_texts=texts_q,
        )
        for q, hits in zip(chunk, hits_b):
            rank = np.inf
            for pos, hit in enumerate(hits, start=1):
                if q.matches(hit):
                    rank = pos
                    break
            rows.append((rank, q, hits))

    ranks = np.asarray([r for r, _, _ in rows])
    mrr = float(np.mean(np.where(ranks <= 10, 1.0 / ranks, 0.0)))
    print(
        f"frozen n={len(rows)} mrr@10={mrr:.4f} "
        f"r@1={float(np.mean(ranks <= 1)):.4f} "
        f"r@5={float(np.mean(ranks <= 5)):.4f} "
        f"r@10={float(np.mean(ranks <= 10)):.4f} "
        f"device={store.device}",
        flush=True,
    )
    rows.sort(key=lambda t: -t[0])
    for rank, q, hits in rows[: args.worst]:
        want = ",".join(p.split("/")[-1] for p in q.relevant_paths)
        print(f"\nrank={rank:<4} want={want}\n  q: {q.text}")
        for h in hits[:3]:
            meta = h.metadata or {}
            print(
                f"    got {h.path}:{meta.get('start_line')}"
                f" sym={meta.get('symbol')} score={h.score:.3f}"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
