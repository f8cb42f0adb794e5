"""Held-out retrieval-quality harness (reproducible).

Counterpart of the JAX package's ``tools/eval_heldout.py``. Chunks one or
more source trees DIRECTLY (no workspace ceremony), builds an in-memory
VectorStore per provider through the production embedding path
(``eval.build_eval_store``: doc-side expansion via
``providers.embedding_text``, exactly what the indexer embeds), generates
self-labelled queries (``eval/quality.py``), and scores MRR@10 / recall@k:

    python -m semcode_tpu_torch.tools.eval_heldout --corpus aiohttp
    python -m semcode_tpu_torch.tools.eval_heldout --corpus aiohttp \\
        --provider tpu-hybrid --provider tpu-hash

The corpora: ``aiohttp`` (the installed package), ``reference`` (the
source tree named by ``$SEMCODE_REFERENCE_SRC``), ``both``, or any
directory. It runs on CUDA unless ``SEMCODE_TORCH_DEVICE=cpu`` asks for
the CPU.
"""

from __future__ import annotations

import argparse
import fnmatch
import hashlib
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

REFERENCE_ENV = "SEMCODE_REFERENCE_SRC"


def corpus_dir(name: str) -> Path:
    """The source tree of a named corpus: ``aiohttp`` (the installed
    package), ``reference`` (``$SEMCODE_REFERENCE_SRC``), or any directory."""
    if name == "aiohttp":
        import aiohttp

        return Path(aiohttp.__file__).parent
    if name == "reference":
        ref = os.environ.get(REFERENCE_ENV)
        if not ref or not Path(ref).is_dir():
            raise SystemExit(
                f"corpus 'reference' needs ${REFERENCE_ENV} set to the "
                "reference project's source directory"
            )
        return Path(ref)
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


def evaluate(metas, provider: str, max_per_kind: int, overrides: dict,
             device=None) -> dict:
    """One provider over one chunked corpus: the quality report, with the
    seconds spent embedding the corpus (``embed_s``) and scoring the
    queries (``eval_s``)."""
    from ..eval import build_eval_store, evaluate_store, generate_queries
    from ..settings import settings

    cfg = settings.model_copy(update={"embedding_provider": provider, **overrides})
    t0 = time.perf_counter()
    store, emb = build_eval_store(metas, cfg, device=device)
    embed_s = time.perf_counter() - t0
    queries = generate_queries(metas, max_per_kind=max_per_kind)
    t0 = time.perf_counter()
    report = evaluate_store(store, emb, provider_name=provider, queries=queries)
    out = report.as_dict()
    out["embed_s"] = round(embed_s, 3)
    out["eval_s"] = round(time.perf_counter() - t0, 3)
    out["n_chunks"] = len(metas)
    out["device"] = str(store.device)
    return out


def run(corpora: Sequence[str], providers: Sequence[str], *,
        max_per_kind: int = 150, overrides: Optional[dict] = None,
        device=None) -> Dict[str, dict]:
    """``{"<corpus>/<provider>": report}`` for every pair."""
    results = {}
    for name in corpora:
        metas = chunk_corpus(name, corpus_dir(name))
        for prov in providers:
            r = evaluate(metas, prov, max_per_kind, dict(overrides or {}),
                         device=device)
            results[f"{name}/{prov}"] = r
            print(
                f"[{name}/{prov}] chunks={r['n_chunks']} n={r['n_queries']} "
                f"mrr@10={r['mrr@10']} r@5={r['recall@5']} "
                f"r@10={r['recall@10']} (embed {r['embed_s']}s, eval "
                f"{r['eval_s']}s, {r['device']})",
                flush=True,
            )
    return results


def parse_overrides(pairs: List[str]) -> dict:
    overrides: dict = {}
    for kv in pairs:
        k, _, v = kv.partition("=")
        try:
            overrides[k] = json.loads(v)
        except json.JSONDecodeError:
            overrides[k] = v
    return overrides


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", default="both",
                    help="aiohttp | reference | both | <dir>")
    ap.add_argument("--provider", action="append", default=None)
    ap.add_argument("--max-per-kind", type=int, default=150)
    ap.add_argument("--set", action="append", default=[],
                    help="settings override key=value (repeatable)")
    args = ap.parse_args(argv)
    names = ["aiohttp", "reference"] if args.corpus == "both" else [args.corpus]
    results = run(names, args.provider or ["tpu-hybrid"],
                  max_per_kind=args.max_per_kind,
                  overrides=parse_overrides(args.set))
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
