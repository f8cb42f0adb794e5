"""The ingest pipeline orchestrator.

Parity with the reference IndexerService (reference src/semcode/
services/indexer.py:22-188): copy -> chunk -> embed (batched) -> upsert ->
registry record, with per-stage callbacks for progress UIs, deterministic md5
chunk ids for idempotent re-indexing, and graceful degradation when the vector
engine is unavailable. Every collaborator is constructor-injectable so tests
run hermetically with fakes (the reference's seam pattern, SURVEY.md section
4). The engine difference: embeddings and the index run in-process on the device
instead of behind HTTPS/gRPC, and the index snapshot is persisted after a
successful upsert (the reference relied on Milvus server-side durability).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterable, List, Optional, Sequence

from ..chunking import CodeChunk
from ..device import DeviceLike
from ..embeddings import EmbeddingPayload, EmbeddingProviderFactory
from ..index.store import VectorStore
from ..ingestion import RepositoryIngestionManager, RepositoryMetadata
from ..logger import get_logger
from ..protocols import UpsertStoreLike
from ..settings import AppSettings, settings as default_settings
from ..storage import RepositoryRecord, RepositoryRegistry

log = get_logger("services.indexer")


@dataclass
class IndexingCallbacks:
    """Stage/progress hooks (reference indexer.py:22-28)."""

    copy: Optional[Callable[[Path], None]] = None
    chunk: Optional[Callable[[Path], None]] = None
    stage: Optional[Callable[[str], None]] = None
    embed_progress: Optional[Callable[[int, int], None]] = None
    upsert_progress: Optional[Callable[[int, int], None]] = None


@dataclass
class IndexingResult:
    """Outcome summary (reference indexer.py:31-37)."""

    repository: RepositoryMetadata
    chunk_count: int
    embedded_count: int
    upserted: bool
    languages: List[str] = field(default_factory=list)
    reused_count: int = 0  # chunks skipped: content hash unchanged
    pruned_count: int = 0  # stale stored chunks removed for this repo


class IndexerService:
    """copy -> chunk -> embed -> upsert -> register."""

    def __init__(
        self,
        *,
        config: Optional[AppSettings] = None,
        ingestion_manager: Optional[RepositoryIngestionManager] = None,
        registry: Optional[RepositoryRegistry] = None,
        vector_store: Optional[UpsertStoreLike] = None,
        embeddings=None,
        auto_connect: bool = True,
        device: DeviceLike = None,
    ) -> None:
        self.config = config or default_settings
        self.device = device
        self.ingestion_manager = ingestion_manager or RepositoryIngestionManager(
            config=self.config
        )
        self.registry = registry or RepositoryRegistry(config=self.config)
        self.vector_store = vector_store or VectorStore(
            self.config, device=device
        )
        self._embeddings = embeddings
        self._store_available = True
        if auto_connect:
            try:
                self.vector_store.connect()
            except Exception as exc:  # degrade, don't crash the pipeline
                log.warning("vector_store_unavailable", error=str(exc))
                self._store_available = False

    @property
    def embeddings(self):
        if self._embeddings is None:
            self._embeddings = EmbeddingProviderFactory.create(
                self.config, device=self.device
            )
        return self._embeddings

    # -- pipeline ---------------------------------------------------------------

    def index_repository(
        self,
        paths: Sequence[Path],
        name: str,
        *,
        force: bool = False,
        ignore_dirs: Optional[Iterable[str]] = None,
        callbacks: Optional[IndexingCallbacks] = None,
    ) -> IndexingResult:
        cb = callbacks or IndexingCallbacks()

        def stage(s: str) -> None:
            if cb.stage:
                cb.stage(s)

        stage("copy_started")
        repo = self.ingestion_manager.ingest_sources(
            paths,
            name,
            force=force,
            ignore_dirs=ignore_dirs,
            copy_callback=cb.copy,
        )

        stage("chunking")
        chunks = self.ingestion_manager.chunk_repository(
            repo, progress_callback=cb.chunk
        )

        stage("embedding")
        payloads, reused, current_ids = self._build_payloads(repo, chunks, cb)

        stage("upserting")
        upserted = False
        pruned = 0
        if payloads:
            try:
                self.vector_store.upsert_embeddings(
                    payloads,
                    batch_size=self.config.upsert_batch_size,
                    progress=cb.upsert_progress,
                )
                upserted = True
            except Exception as exc:
                log.warning(
                    "upsert_skipped_store_unavailable",
                    repo=name,
                    error=str(exc),
                )
        if reused and not payloads and self._store_available:
            upserted = True  # fully reused: the store already holds the repo
        if upserted and getattr(self.config, "incremental_reindex", True):
            # prune stored chunks this repo no longer produces (deleted
            # files, shifted spans) — the reference leaked them forever
            pruned = self._prune_stale(name, current_ids)
        stage("persisting")
        if upserted or pruned:
            try:
                self.vector_store.save()
            except Exception as exc:
                log.warning("snapshot_failed", repo=name, error=str(exc))

        stage("registering")
        record = RepositoryRecord(
            name=name,
            revision=self._detect_revision(paths),
            languages=repo.languages,
            language_summary=", ".join(repo.languages) or None,
            chunk_count=len(chunks),
            collection="semcode_chunks",
        )
        self.registry.register(record)
        stage("done")
        log.info(
            "repository_indexed",
            repo=name,
            chunks=len(chunks),
            embedded=len(payloads),
            reused=reused,
            pruned=pruned,
            upserted=upserted,
        )
        return IndexingResult(
            repository=repo,
            chunk_count=len(chunks),
            embedded_count=len(payloads),
            upserted=upserted,
            languages=repo.languages,
            reused_count=reused,
            pruned_count=pruned,
        )

    def remove_repository(self, name: str) -> bool:
        """Drop a repo from the registry and delete its vectors."""
        removed = self.registry.remove(name)
        try:
            n = self.vector_store.delete_repo(name)
            if n:
                self.vector_store.save()
        except Exception as exc:
            log.warning("delete_repo_vectors_failed", repo=name, error=str(exc))
        return removed

    # -- payloads ----------------------------------------------------------------

    def _build_payloads(
        self,
        repo: RepositoryMetadata,
        chunks: List[CodeChunk],
        cb: IndexingCallbacks,
    ):
        """-> (payloads to embed+upsert, reused count, all current ids).

        Incremental re-index: a chunk whose id already exists in the store
        with the same content hash keeps its stored vector — no re-embedding
        and no upsert. Re-ingesting an unchanged repo embeds nothing."""
        if not chunks:
            return [], 0, []
        incremental = getattr(self.config, "incremental_reindex", True)
        meta_of = getattr(self.vector_store, "get_metadata", lambda _pid: None)
        # vector-generation gate: a stored chunk is only "fresh" if it was
        # embedded under the SAME provider signature (featurizer version,
        # checkpoint fingerprint, hybrid weight, doc expansion) — otherwise
        # an incremental re-ingest would mix incomparable vector generations
        # in one index (see providers.provider_signature)
        from ..embeddings.providers import provider_signature

        embed_sig = provider_signature(self.embeddings)
        span_seen: dict = {}
        entries = []  # (chunk, rel_path, id, content_sha, fresh)
        for chunk in chunks:
            rel_path = self._relative_path(chunk.path, repo.path)
            # id = md5 of repo:path:span (reference indexer.py:186-188) plus a
            # per-span ordinal so char-split pieces of one span stay distinct
            span_key = f"{repo.name}:{rel_path}:{chunk.start_line}:{chunk.end_line}"
            ordinal = span_seen.get(span_key, 0)
            span_seen[span_key] = ordinal + 1
            cid = hashlib.md5(
                (span_key if ordinal == 0 else f"{span_key}:{ordinal}").encode()
            ).hexdigest()
            sha = hashlib.sha1(chunk.content.encode()).hexdigest()[:16]
            fresh = False
            if incremental and self._store_available:
                stored = meta_of(cid)
                fresh = (
                    stored is not None
                    and stored.get("content_sha") == sha
                    and stored.get("embed_sig") == embed_sig
                )
            entries.append((chunk, rel_path, cid, sha, fresh))

        stale = [e for e in entries if not e[4]]
        # the EMBEDDED text prepends symbol + file stem (doc-side expansion,
        # providers.embedding_text); the stored payload text stays raw
        from ..embeddings.providers import embedding_text

        texts = [
            embedding_text(e[0].content, symbol=e[0].symbol, path=e[1])
            for e in stale
        ]
        batch = max(1, self.config.embedding_batch_size)
        vectors: List[List[float]] = []
        total = len(texts)
        for start in range(0, total, batch):
            vectors.extend(self.embeddings.embed_documents(texts[start : start + batch]))
            if cb.embed_progress:
                cb.embed_progress(min(start + batch, total), total)
        payloads: List[EmbeddingPayload] = []
        for (chunk, rel_path, cid, sha, _fresh), vector in zip(stale, vectors):
            payloads.append(
                EmbeddingPayload(
                    id=cid,
                    text=chunk.content,
                    vector=vector,
                    metadata={
                        "repo": repo.name,
                        "path": rel_path,
                        "language": chunk.language,
                        "start_line": chunk.start_line,
                        "end_line": chunk.end_line,
                        "symbol": chunk.symbol,
                        "content_sha": sha,
                        "embed_sig": embed_sig,
                    },
                )
            )
        reused = len(entries) - len(stale)
        return payloads, reused, [e[2] for e in entries]

    def _prune_stale(self, repo_name: str, current_ids: List[str]) -> int:
        """Delete stored chunks of this repo that the current ingest did not
        produce (deleted files, moved spans)."""
        try:
            stored = getattr(self.vector_store, "ids_for_repo", None)
            if stored is None:
                return 0
            stale = set(stored(repo_name)) - set(current_ids)
            if not stale:
                return 0
            n = self.vector_store.delete(sorted(stale))
            log.info("stale_chunks_pruned", repo=repo_name, pruned=n)
            return n
        except Exception as exc:
            log.warning("stale_prune_failed", repo=repo_name, error=str(exc))
            return 0

    @staticmethod
    def _detect_revision(paths: Sequence[Path]) -> Optional[str]:
        """Best-effort git revision of the first source path's repository."""
        for p in paths:
            d = Path(p).resolve()
            while d != d.parent:
                head = d / ".git" / "HEAD"
                if head.is_file():
                    try:
                        ref = head.read_text(encoding="utf-8").strip()
                        if ref.startswith("ref: "):
                            ref_file = d / ".git" / ref[5:]
                            if ref_file.is_file():
                                return ref_file.read_text(encoding="utf-8").strip()[:40]
                            return None
                        return ref[:40]
                    except OSError:
                        return None
                d = d.parent
        return None

    @staticmethod
    def _relative_path(path: Path, root: Path) -> str:
        try:
            return str(Path(path).resolve().relative_to(Path(root).resolve()))
        except ValueError:
            return str(path)
