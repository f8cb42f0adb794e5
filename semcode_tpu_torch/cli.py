"""Command-line interface.

Counterpart of ``semcode_tpu/cli.py``: ``ingest`` (tree preview,
confirmation, 4-bar rich progress over copy/chunk/embed/upsert), ``query``,
``list``, ``remove``, ``chunks``, ``compact``, ``workspace``, ``stats``,
``serve`` (the API server), ``eval`` (retrieval quality), ``train`` (the
encoder's contrastive trainer), ``train-rerank`` (the term reranker's table),
``train-lm`` (the answer decoder) and ``version``, on argparse + rich. The
engine and the trainers run on CUDA; set ``SEMCODE_TORCH_DEVICE=cpu`` to run
them on the CPU.

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


def cmd_serve(_args) -> int:
    from .api.main import run

    run()
    return 0


def cmd_eval(args) -> int:
    """Score embedding providers on self-labelled queries from the corpus.

    The store must be populated with the SAME provider being scored (vectors
    are compared in its space), so each provider gets its own in-memory
    re-index of the snapshot corpus texts.
    """
    configure_logging()
    from .eval import (
        build_eval_store,
        evaluate_store,
        generate_queries,
        load_frozen_queries,
    )
    from .index.store import VectorStore
    from .settings import settings

    base = VectorStore()
    base.connect()
    if base.count() == 0:
        print("index is empty; ingest a repository first", file=sys.stderr)
        return 1
    filters = {"repo": args.repo} if args.repo else None
    metas = [
        (pid, meta)
        for pid, meta in base.iter_payload_meta()
        if not args.repo or meta.get("repo") == args.repo
    ]
    if not metas:
        print(f"no chunks found for repo {args.repo!r}", file=sys.stderr)
        return 1
    queries = generate_queries(metas, max_per_kind=args.max_per_kind)
    if args.frozen:
        # hand-labelled path-relevance queries: scanner-independent numbers,
        # reported separately as by_kind["frozen"] in the output
        queries = queries + load_frozen_queries(args.frozen)
    providers = args.provider or [settings.embedding_provider]
    results = []
    for name in providers:
        cfg = settings.model_copy(update={"embedding_provider": name})
        # shared recipe (eval.build_eval_store): embed through the
        # PRODUCTION path — the indexer embeds symbol/stem-expanded text
        # (embedding_text), not the raw chunk, and the eval must measure
        # the exact vectors serving produces
        store, emb = build_eval_store(metas, cfg, device=base.device)
        report = evaluate_store(
            store, emb, provider_name=name, queries=queries, filters=filters
        )
        results.append(report.as_dict())
    print(json.dumps(results, indent=2))
    return 0


def _chunk_dirs(from_dirs: str) -> list:
    """Chunk arbitrary source trees directly (no workspace ingestion):
    training corpora are throwaway reads, and the held-out serving repo
    must never enter this list."""
    from .chunking import CodeChunker

    chunks: list = []
    chunker = CodeChunker()
    for d in from_dirs.split(","):
        root = Path(d.strip()).resolve()
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
        before = len(chunks)
        chunks.extend(chunker.chunk_repository(root, files))
        print(f"  {root}: {len(files)} files, {len(chunks)-before} chunks")
    return chunks


def _workspace_chunks(repo: str):
    """Chunks of one ingested repository, or of all (``repo == "all"``);
    None when ``repo`` is not in the workspace."""
    from .ingestion import RepositoryIngestionManager

    manager = RepositoryIngestionManager()
    repos = {r.name: r for r in manager.list_ingested()}
    if repo != "all" and repo not in repos:
        print(f"[ERROR] repository '{repo}' not in workspace", file=sys.stderr)
        return None
    chunks = []
    for name, record in sorted(repos.items()):
        if repo in ("all", name):
            chunks.extend(manager.chunk_repository(record))
    return chunks


def _print_step(step: int, steps: int, metrics) -> None:
    if step % max(1, steps // 20) == 0 or step == steps:
        print(
            f"step {step}/{steps} "
            f"loss={float(metrics['loss']):.4f} "
            f"acc={float(metrics['accuracy']):.3f}"
        )


def _train_mesh(settings):
    """The trainers' mesh, as the JAX CLI builds it: data-parallel over
    every local device (``[mesh] shape`` overrides; on the CPU it is the
    shard count, default one)."""
    from .device import resolve_device
    from .parallel.mesh import get_mesh, local_devices

    device = resolve_device()
    shape = settings.mesh_shape or str(len(local_devices(device)))
    return get_mesh(shape, ("data",), device=device)


def cmd_train(args) -> int:
    """Contrastive-train the encoder on an ingested repository's chunks
    (or on source trees, ``--from``)."""
    configure_logging()
    from .models.data import PairBatcher
    from .models.encoder import EncoderConfig, encoder_state_to_jax
    from .models.tokenizer import HashingTokenizer
    from .models.train import (
        ContrastiveTrainer,
        save_params,
        warmup_cosine_decay_schedule,
    )
    from .settings import settings

    if args.from_dirs:
        chunks = _chunk_dirs(args.from_dirs)
        source = args.from_dirs
    elif args.repo:
        chunks = _workspace_chunks(args.repo)
        if chunks is None:
            return 2
        source = args.repo
    else:
        print("[ERROR] pass --repo or --from", file=sys.stderr)
        return 2
    if args.max_chunks and len(chunks) > args.max_chunks:
        import random

        random.Random(0).shuffle(chunks)
        chunks = chunks[: args.max_chunks]
    texts = [c.content for c in chunks]
    print(f"training on {len(texts)} chunks from '{source}'")

    tokenizer = HashingTokenizer(max_len=args.seq_len)
    cfg = EncoderConfig.preset(
        args.preset, vocab_size=tokenizer.vocab_size, max_len=args.seq_len
    )
    lr = args.lr
    if args.warmup > 0:
        lr = warmup_cosine_decay_schedule(
            0.0, args.lr, args.warmup, max(args.steps, args.warmup + 1)
        )
    trainer = ContrastiveTrainer(cfg, _train_mesh(settings), learning_rate=lr)
    params, opt_state = trainer.init_state(seed=0)
    batcher = PairBatcher(
        texts,
        tokenizer,
        seq_len=args.seq_len,
        batch_size=args.batch_size,
        symbols=[c.symbol for c in chunks],
        languages=[c.language for c in chunks],
    )
    for step, batch in enumerate(batcher.batches(args.steps), 1):
        params, opt_state, metrics = trainer.train_step(params, opt_state, batch)
        _print_step(step, args.steps, metrics)
    out = Path(args.out or Path(settings.workspace_root) / "encoder")
    save_params(encoder_state_to_jax(trainer.gather(params), cfg), cfg, out)
    print(f"saved encoder checkpoint to {out}")
    print(
        "use it with: [embedding] provider='tpu-encoder' and "
        f"[encoder] weights_path='{out}'"
    )
    return 0


def cmd_train_rerank(args) -> int:
    """Train the learned term-embedding MaxSim rerank channel
    (models/term_reranker.py) on external corpora chunks."""
    configure_logging()
    from .device import resolve_device
    from .models.term_reranker import (
        DEFAULT_DIM,
        build_pairs,
        featurize_pairs,
        save_table,
        train_term_table,
    )
    from .settings import settings

    if not args.from_dirs:
        print("[ERROR] pass --from <dirs>", file=sys.stderr)
        return 2
    device = resolve_device()
    chunks = _chunk_dirs(args.from_dirs)
    metas = [
        (
            f"c{i}",
            {
                "text": c.content,
                "symbol": c.symbol,
                "path": str(getattr(c, "path", "") or ""),
                "language": c.language,
            },
        )
        for i, c in enumerate(chunks)
    ]
    pairs = build_pairs(metas, max_per_kind=args.max_per_kind)
    print(f"{len(chunks)} chunks -> {len(pairs)} (query, chunk) pairs")
    feats = featurize_pairs(pairs)
    table = train_term_table(
        feats,
        dim=args.dim or DEFAULT_DIM,
        steps=args.steps,
        batch_size=args.batch_size,
        lr=args.lr,
        seed=args.seed,
        device=device,
    )
    out = Path(args.out or Path(settings.workspace_root) / "term-reranker.npz")
    save_table(table, out)
    print(f"saved term-reranker table to {out}")
    return 0


def cmd_train_lm(args) -> int:
    """Next-token-train the tpu-lm answer decoder on ingested chunks."""
    configure_logging()
    from .models.decoder import DecoderConfig, decoder_state_to_jax
    from .models.tokenizer import ByteTokenizer
    from .models.train_lm import (
        LMTrainer,
        WindowBatcher,
        build_qa_texts,
        save_lm_params,
    )
    from .settings import settings

    chunks = _workspace_chunks(args.repo)
    if chunks is None:
        return 2
    texts = [c.content for c in chunks]
    print(f"training LM on {len(texts)} chunks from '{args.repo}'")

    tokenizer = ByteTokenizer(max_len=args.seq_len)
    cfg = DecoderConfig.preset(
        args.preset, vocab_size=tokenizer.vocab_size, max_len=max(args.seq_len, 1024)
    )
    trainer = LMTrainer(cfg, _train_mesh(settings), learning_rate=args.lr)
    params, opt_state = trainer.init_state(seed=0)
    # QA-grammar examples derived from the corpus: the fraction of training
    # that makes chat decoding produce answers instead of code continuation
    # noise (models/train_lm.build_qa_texts)
    qa_texts = build_qa_texts(chunks) if args.qa_mix > 0 else []
    if qa_texts:
        print(f"QA mix: {len(qa_texts)} examples at {args.qa_mix:.0%}")
    batcher = WindowBatcher(
        texts, tokenizer, seq_len=args.seq_len, batch_size=args.batch_size,
        anchored_texts=qa_texts, anchored_frac=args.qa_mix,
    )
    for step, batch in enumerate(batcher.batches(args.steps), 1):
        params, opt_state, metrics = trainer.train_step(params, opt_state, batch)
        _print_step(step, args.steps, metrics)
    out = Path(args.out or Path(settings.workspace_root) / "lm")
    save_lm_params(decoder_state_to_jax(trainer.gather(params)), cfg, out)
    print(f"saved LM checkpoint to {out}")
    print(f"use it with: [rag] provider='tpu-lm', weights_path='{out}'")
    return 0


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

    p = sub.add_parser("serve", help="Run the API server")
    p.set_defaults(func=cmd_serve)

    p = sub.add_parser(
        "eval", help="Measure retrieval quality (MRR/recall) on an ingested repo"
    )
    p.add_argument("--repo", help="Restrict to one ingested repo (default: all)")
    p.add_argument(
        "--provider",
        action="append",
        help="Embedding provider(s) to score (default: configured provider)",
    )
    p.add_argument("--max-per-kind", type=int, default=150)
    p.add_argument(
        "--frozen",
        nargs="?",
        const=str(
            Path(__file__).resolve().parents[1]
            / "tests" / "fixtures" / "frozen_queries.json"
        ),
        help="Also score a frozen hand-labelled query set (JSON with "
        "file-path relevance; default: the in-repo fixture). Its metrics "
        "appear under by_kind['frozen'] and are comparable across "
        "chunker/scanner generations.",
    )
    p.set_defaults(func=cmd_eval)

    p = sub.add_parser(
        "train", help="Contrastive-train the encoder on an ingested repo"
    )
    p.add_argument(
        "--repo", default=None, help="Repo name, or 'all' (workspace chunks)"
    )
    p.add_argument(
        "--from",
        dest="from_dirs",
        default=None,
        help=(
            "Comma-separated source directories to chunk directly for "
            "training (no workspace ingestion; the generalization recipe "
            "trains on several OTHER codebases and holds the serving repo "
            "out entirely)"
        ),
    )
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--preset", default="mini")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup", type=int, default=0, help="LR warmup steps")
    p.add_argument("--out", default=None)
    p.add_argument(
        "--max-chunks", type=int, default=0, help="Cap training chunks (0 = all)"
    )
    p.set_defaults(func=cmd_train)

    p = sub.add_parser(
        "train-rerank",
        help="Train the learned term-embedding rerank channel on "
        "external corpora",
    )
    p.add_argument(
        "--from", dest="from_dirs", required=True,
        help="Comma-separated source directories (hold the serving repo out)",
    )
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--dim", type=int, default=0, help="0 = library default")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--max-per-kind", type=int, default=4000,
        help="Query-generator cap per kind per run (pairs pool size)",
    )
    p.add_argument("--out", default=None)
    p.set_defaults(func=cmd_train_rerank)

    p = sub.add_parser(
        "train-lm", help="Train the tpu-lm answer decoder on an ingested repo"
    )
    p.add_argument("--repo", required=True, help="Repo name, or 'all'")
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--batch-size", type=int, default=32)
    # 512 covers a full QA-grammar example (ctx 200 + question + answer);
    # shorter windows truncate the ANSWER region out of training and chat
    # decoding degenerates (see decoder.QA_CTX_CHARS)
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--preset", default="mini")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--out", default=None)
    p.add_argument(
        "--qa-mix",
        type=float,
        default=0.5,
        help="Fraction of batches drawn from corpus-derived QA-grammar "
        "examples (0 disables; required for coherent chat answers)",
    )
    p.set_defaults(func=cmd_train_lm)

    p = sub.add_parser("version", help="Show version")
    p.set_defaults(func=cmd_version)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
