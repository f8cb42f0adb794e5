"""Command-line interface.

Counterpart of ``semcode_tpu/cli.py``: ``ingest`` (tree preview,
confirmation, 4-bar rich progress over copy/chunk/embed/upsert), ``query``,
``list``, ``remove``, ``chunks``, ``compact``, ``workspace``, ``stats`` and
``version``, on argparse + rich. The engine runs on CUDA; set
``SEMCODE_TORCH_DEVICE=cpu`` to run it on the CPU. ``serve``, ``eval``,
``train``, ``train-rerank`` and ``train-lm`` are not ported yet and say so.

Run as ``python -m semcode_tpu_torch.cli`` or the ``semcode-tpu-torch``
console script.
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import sys
from pathlib import Path
from typing import List, Optional, Sequence

from .chunking.chunker import CHUNKABLE_SUFFIXES
from .ingestion import DEFAULT_IGNORE_PATTERNS
from .logger import configure_logging, redirect_logging_to_file
from .version import get_version

CHUNK_SUFFIXES = CHUNKABLE_SUFFIXES


def _collect_files(
    paths: Sequence[Path],
    ignore_patterns: Sequence[str],
    suffix_filter: Optional[Sequence[str]] = None,
) -> List[Path]:
    """Files that will be copied/chunked (reference cli.py:49-72)."""
    out: List[Path] = []
    for base in paths:
        for p in sorted(base.rglob("*")):
            if not p.is_file():
                continue
            rel_parts = p.relative_to(base).parts
            if any(
                fnmatch.fnmatch(part, pat)
                for part in rel_parts
                for pat in ignore_patterns
            ):
                continue
            if suffix_filter and p.suffix.lower() not in suffix_filter:
                continue
            out.append(p)
    return out


def _render_directory_tree(
    root: Path, ignore_patterns: Sequence[str], depth: int = 2
) -> str:
    """Two-level preview of what will be ingested (reference cli.py:75-108)."""
    lines: List[str] = []

    def walk(d: Path, level: int, prefix: str) -> None:
        if level > depth:
            return
        entries = sorted(
            e
            for e in d.iterdir()
            if not any(fnmatch.fnmatch(e.name, pat) for pat in ignore_patterns)
        )
        for i, e in enumerate(entries):
            connector = "└── " if i == len(entries) - 1 else "├── "
            lines.append(f"{prefix}{connector}{e.name}{'/' if e.is_dir() else ''}")
            if e.is_dir() and level < depth:
                extension = "    " if i == len(entries) - 1 else "│   "
                walk(e, level + 1, prefix + extension)

    walk(root, 1, "")
    return "\n".join(lines) if lines else "(empty)"


# -- commands -------------------------------------------------------------------


def cmd_version(_args) -> int:
    print(f"semcode-tpu-torch {get_version()}")
    return 0


def cmd_workspace(_args) -> int:
    from .settings import settings

    print(Path(settings.workspace_root).resolve())
    return 0


def cmd_list(_args) -> int:
    from .storage import RepositoryRegistry

    registry = RepositoryRegistry()
    records = registry.list()
    if not records:
        print("No repositories ingested yet.")
        return 0
    for rec in records:
        langs = ",".join(rec.languages) if rec.languages else "-"
        print(f"{rec.name:<24} chunks={rec.chunk_count or 0:<8} languages={langs}")
    return 0


def cmd_ingest(args) -> int:
    configure_logging(enable_console=False)
    root = Path(args.root)
    include_dirs = [s.strip() for s in args.include.split(",") if s.strip()]
    user_ignore = [s.strip() for s in (args.ignore or "").split(",") if s.strip()]
    ignore_dirs = list(dict.fromkeys((*DEFAULT_IGNORE_PATTERNS, *user_ignore)))

    if not root.exists():
        print(f"[ERROR] Root path not found: {root}", file=sys.stderr)
        return 2
    selected: List[Path] = []
    for folder in include_dirs:
        candidate = root / folder
        if not candidate.exists():
            print(f"[ERROR] Included folder not found: {candidate}", file=sys.stderr)
            return 2
        selected.append(candidate)
    if not selected:
        print("[ERROR] No include directories were resolved.", file=sys.stderr)
        return 2

    if args.log:
        log_path = (root / "ingestion.log").resolve()
        redirect_logging_to_file(log_path)
        print(f"Logging detailed output to {log_path}")

    print(f"Planned ingestion tree for repository '{args.name}' (depth=2):")
    print(f"Root: {root.resolve()}")
    for folder in selected:
        print(f"\n[{folder}]")
        print(_render_directory_tree(folder, ignore_dirs))
    print(f"\nIgnoring directories: {', '.join(ignore_dirs)}")

    if not args.yes:
        reply = input("Proceed with ingestion? [Y/n] ").strip().lower()
        if reply and reply not in ("y", "yes"):
            print("Ingestion aborted.")
            return 0

    copy_files = _collect_files(selected, ignore_dirs)
    chunk_files = _collect_files(selected, ignore_dirs, suffix_filter=CHUNK_SUFFIXES)

    from rich.progress import (
        BarColumn,
        Progress,
        TaskProgressColumn,
        TextColumn,
        TimeElapsedColumn,
    )

    from .services import IndexerService, IndexingCallbacks

    service = IndexerService()
    with Progress(
        TextColumn("[progress.description]{task.description}"),
        BarColumn(),
        TaskProgressColumn(),
        TimeElapsedColumn(),
    ) as progress:
        t_copy = progress.add_task("copy", total=max(len(copy_files), 1))
        t_chunk = progress.add_task("chunk", total=max(len(chunk_files), 1))
        t_embed = progress.add_task("embed", total=1)
        t_upsert = progress.add_task("upsert", total=1)

        callbacks = IndexingCallbacks(
            copy=lambda p: progress.advance(t_copy),
            chunk=lambda p: progress.advance(t_chunk),
            embed_progress=lambda done, total: progress.update(
                t_embed, completed=done, total=total
            ),
            upsert_progress=lambda done, total: progress.update(
                t_upsert, completed=done, total=total
            ),
        )
        result = service.index_repository(
            selected,
            args.name,
            force=args.force,
            ignore_dirs=user_ignore,
            callbacks=callbacks,
        )
        progress.update(t_copy, completed=len(copy_files))
        progress.update(t_chunk, completed=len(chunk_files))

    extra = ""
    if result.reused_count:
        extra += f", {result.reused_count} reused (unchanged)"
    if result.pruned_count:
        extra += f", {result.pruned_count} stale pruned"
    print(
        f"Ingested '{args.name}': {result.chunk_count} chunks, "
        f"{result.embedded_count} embedded{extra}, "
        f"upserted={'yes' if result.upserted else 'NO (engine unavailable)'}, "
        f"languages={','.join(result.languages) or '-'}"
    )
    return 0


def cmd_query(args) -> int:
    configure_logging(enable_console=False)
    from .rag import SemanticSearchPipeline

    def _multi(v):
        # comma-separated = multi-select (compiles to a device allow list)
        return [s.strip() for s in v.split(",") if s.strip()] if "," in v else v

    filters = {}
    if args.repo:
        filters["repo"] = _multi(args.repo)
    if args.language:
        filters["language"] = _multi(args.language)
    pipeline = SemanticSearchPipeline()
    result = pipeline.query(
        args.question, top_k=args.top_k, filters=filters or None
    )
    if args.json:
        print(json.dumps(result, indent=2))
        return 0
    print(result["answer"])
    if result["sources"]:
        print("\nSources:")
        for i, s in enumerate(result["sources"], 1):
            print(f"  {i}. {s['repo']}/{s['path']} (score={s['score']:.4f})")
    return 0


def cmd_remove(args) -> int:
    configure_logging(enable_console=False)
    from .services import IndexerService

    service = IndexerService()
    if service.remove_repository(args.name):
        print(f"Removed repository '{args.name}'.")
        return 0
    print(f"Repository '{args.name}' not found.", file=sys.stderr)
    return 1


def cmd_chunks(args) -> int:
    """List stored chunks (introspection parity with GET /chunks)."""
    configure_logging(enable_console=False)
    from .index.store import VectorStore

    store = VectorStore()
    store.connect()
    filters = {
        k: v
        for k, v in (
            ("repo", args.repo),
            ("language", args.language),
            ("path", args.path),
        )
        if v
    }
    rows = store.list_chunks(
        filters or None, offset=args.offset, limit=args.limit
    )
    if args.json:
        print(json.dumps(rows, indent=2))
        return 0
    if not rows:
        print("No chunks." if not args.offset else "No chunks at this offset.")
        return 0
    for c in rows:
        span = f"{c['start_line']}-{c['end_line']}"
        sym = f"  [{c['symbol']}]" if c.get("symbol") else ""
        print(f"{c['repo']}/{c['path']}:{span}{sym}")
    return 0


def cmd_compact(_args) -> int:
    """Reclaim tombstoned rows and persist the compacted snapshot."""
    configure_logging(enable_console=False)
    from .index.store import VectorStore

    store = VectorStore()
    store.connect()
    reclaimed = store.compact()
    if reclaimed:
        store.save()
        print(f"Compacted: reclaimed {reclaimed} tombstoned rows "
              f"({store.count()} live).")
    else:
        print("Nothing to compact.")
    return 0


def cmd_stats(_args) -> int:
    configure_logging(enable_console=False)
    from .embeddings import EmbeddingProviderFactory
    from .index.store import VectorStore
    from .settings import settings

    store = VectorStore()
    store.connect()
    stats = store.stats()
    stats["device"] = str(store.device)
    stats["embedding_provider"] = settings.embedding_provider
    try:
        EmbeddingProviderFactory.create(settings)
    except Exception as exc:
        stats["embedding_provider_error"] = str(exc)
    print(json.dumps(stats, indent=2))
    return 0


# subcommands of the JAX package's CLI that need modules not ported yet
_NOT_PORTED = {
    "serve": "Run the API server",
    "eval": "Measure retrieval quality on an ingested repo",
    "train": "Contrastive-train the encoder",
    "train-rerank": "Train the learned term-embedding rerank channel",
    "train-lm": "Train the answer decoder",
}


def _not_ported(name: str, what: str):
    def run(_args) -> int:
        print(
            f"[ERROR] '{name}' ({what}) is not ported to the PyTorch engine "
            "yet; use the JAX package's CLI (python -m semcode_tpu.cli)",
            file=sys.stderr,
        )
        return 2

    return run


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="semcode-tpu-torch",
        description="Semantic code search engine (PyTorch/CUDA port)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("ingest", help="Ingest subdirectories from a root path")
    p.add_argument("--name", "-n", required=True, help="Repository label")
    p.add_argument(
        "--include", "-I", required=True, help="Comma-separated dirs under --root"
    )
    p.add_argument("--root", "-r", default=".", help="Root directory")
    p.add_argument("--force", action="store_true", help="Overwrite existing copies")
    p.add_argument(
        "--ignore", "-i", default=None, help="Comma-separated extra ignores"
    )
    p.add_argument(
        "--log", action="store_true", help="Redirect logs to ingestion.log"
    )
    p.add_argument("--yes", "-y", action="store_true", help="Skip confirmation")
    p.set_defaults(func=cmd_ingest)

    p = sub.add_parser("query", help="Ask a question over the indexed corpus")
    p.add_argument("question")
    p.add_argument("--top-k", "-k", type=int, default=None)
    p.add_argument("--repo", default=None, help="Filter by repository")
    p.add_argument("--language", default=None, help="Filter by language")
    p.add_argument("--json", action="store_true", help="Print full JSON response")
    p.set_defaults(func=cmd_query)

    p = sub.add_parser("list", help="List ingested repositories")
    p.set_defaults(func=cmd_list)

    p = sub.add_parser("remove", help="Remove a repository and its vectors")
    p.add_argument("name")
    p.set_defaults(func=cmd_remove)

    p = sub.add_parser("workspace", help="Print the workspace path")
    p.set_defaults(func=cmd_workspace)

    p = sub.add_parser("stats", help="Print index/engine statistics")
    p.set_defaults(func=cmd_stats)

    p = sub.add_parser(
        "compact", help="Reclaim tombstoned index rows and persist"
    )
    p.set_defaults(func=cmd_compact)

    p = sub.add_parser("chunks", help="List stored chunks")
    p.add_argument("--repo", default=None)
    p.add_argument("--language", default=None)
    p.add_argument("--path", default=None)
    p.add_argument("--offset", type=int, default=0)
    p.add_argument("--limit", type=int, default=50)
    p.add_argument("--json", action="store_true")
    p.set_defaults(func=cmd_chunks)

    for name, what in _NOT_PORTED.items():
        p = sub.add_parser(name, help=f"{what} (not ported yet)")
        p.add_argument("rest", nargs=argparse.REMAINDER)
        p.set_defaults(func=_not_ported(name, what))

    p = sub.add_parser("version", help="Show version")
    p.set_defaults(func=cmd_version)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
