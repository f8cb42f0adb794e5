"""Per-query diagnosis of the frozen hand-labelled retrieval set.

Counterpart of the JAX package's ``tools/frozen_misses.py``, with the two
helpers it takes from ``tools/eval_heldout.py`` (``corpus_dir``,
``chunk_corpus``) copied here. Builds an in-memory store over the
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
import fnmatch
import hashlib
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[2]


def corpus_dir(name: str) -> Path:
    """The source tree of a named corpus: ``aiohttp`` (the installed
    package), or any directory."""
    if name == "aiohttp":
        import aiohttp

        return Path(aiohttp.__file__).parent
    p = Path(name)
    if p.is_dir():
        return p
    raise SystemExit(f"unknown corpus {name!r} (not a directory)")


def chunk_corpus(name: str, root: Path):
    """-> list of (payload_id, metadata) with indexer-parity metadata."""
    from ..chunking import CodeChunker
    from ..cli import CHUNK_SUFFIXES
    from ..ingestion.manager import DEFAULT_IGNORE_PATTERNS

    chunker = CodeChunker()
    files = [
        f
        for f in sorted(root.rglob("*"))
        if f.is_file()
        and f.suffix in CHUNK_SUFFIXES
        and not any(
            fnmatch.fnmatch(part, pat)
            for part in f.relative_to(root).parts
            for pat in DEFAULT_IGNORE_PATTERNS
        )
    ]
    metas = []
    span_seen: dict = {}
    for chunk in chunker.chunk_repository(root, files):
        rel = str(Path(chunk.path).relative_to(root))
        span_key = f"{name}:{rel}:{chunk.start_line}:{chunk.end_line}"
        ordinal = span_seen.get(span_key, 0)
        span_seen[span_key] = ordinal + 1
        cid = hashlib.md5(
            (span_key + (f"#{ordinal}" if ordinal else "")).encode()
        ).hexdigest()
        metas.append(
            (
                cid,
                {
                    "repo": name,
                    "path": rel,
                    "language": chunk.language,
                    "start_line": chunk.start_line,
                    "end_line": chunk.end_line,
                    "symbol": chunk.symbol,
                    "text": chunk.content,
                },
            )
        )
    return metas


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

    overrides: Dict[str, object] = {}
    for kv in args.set:
        k, _, v = kv.partition("=")
        try:
            vv = json.loads(v)
        except json.JSONDecodeError:
            vv = v
        overrides[k] = vv

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
