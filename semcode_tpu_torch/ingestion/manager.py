"""Repository ingestion: plan/execute mirror sync into the workspace.

Capability parity with the reference manager
(reference src/semcode/ingestion/manager.py:24-231) — sources land in
``workspace/<name>`` under default+user ignore patterns with a per-file
callback, languages are detected, and the chunker is driven — but the design
is different. Instead of ``shutil.copytree`` with an ignore hook, ingestion
is split into two phases:

1. **plan**: walk the sources once and compile an :class:`IngestPlan` — the
   exact (src, dst, size, mtime) manifest of files that belong in the
   workspace copy. Ignore patterns are compiled to a single regex and applied
   at every directory level during the walk.
2. **sync**: execute the plan as a *mirror sync*. Unchanged files (same size
   and mtime) are reused instead of re-copied, so re-ingesting a large repo
   after touching one file copies one file; files that vanished from the
   sources are pruned from the workspace copy. ``force=True`` discards the
   existing copy for a full refresh. The reference re-copies everything on
   every ingest and can only refresh via rmtree.

The upfront manifest also gives callers an exact total for progress bars and
makes language detection a byproduct of planning (no second rglob pass).
"""

from __future__ import annotations

import fnmatch
import os
import re
import shutil
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, Tuple

from ..chunking import CodeChunk, CodeChunker, apply_code2prompt_heuristics
from ..chunking.chunker import CHUNKABLE_SUFFIXES, LANGUAGE_BY_SUFFIX
from ..logger import get_logger
from ..settings import AppSettings, settings as default_settings

log = get_logger("ingestion")

DEFAULT_IGNORE_PATTERNS: Sequence[str] = (
    ".*",
    ".git",
    ".hg",
    ".svn",
    ".idea",
    ".vscode",
    ".DS_Store",
    "__pycache__",
    ".mypy_cache",
    ".pytest_cache",
    ".ruff_cache",
    ".venv",
    "venv",
    "node_modules",
    "build*",
    "dist",
    "tmp",
    "vcpkg_installed",
    "CMakeFiles",
)

# suffixes eligible for chunking+indexing (code files only by default; the
# docs/text suffixes in LANGUAGE_BY_SUFFIX are chunkable but opt-in)
SOURCE_SUFFIXES = tuple(
    s
    for s in CHUNKABLE_SUFFIXES
    if LANGUAGE_BY_SUFFIX[s] not in ("text", "markdown")
)

_SAFE_REPO_NAME = re.compile(r"[A-Za-z0-9][A-Za-z0-9._-]*")


def validate_repo_name(name: str) -> str:
    """Reject repo names that are not a single safe path segment.

    Repo names flow (possibly from unauthenticated API bodies) into
    ``workspace/<name>`` and, with ``force=true``, into ``shutil.rmtree`` —
    a traversal like ``../../x`` would escape the workspace and delete an
    arbitrary directory. The reference shares this flaw
    (manager.py:69-83 builds the path unvalidated); we close it instead.
    """
    name = str(name or "").strip()
    if not name or name in (".", "..") or not _SAFE_REPO_NAME.fullmatch(name):
        raise ValueError(
            "repo name must be a single path segment of "
            f"[A-Za-z0-9._-] not starting with '.', got {name!r}"
        )
    return name


def compile_ignore(patterns: Iterable[str]) -> Callable[[str], bool]:
    """Compile fnmatch patterns into one alternation regex, matched per name."""
    pats = [str(p).strip() for p in patterns if str(p).strip()]
    if not pats:
        return lambda name: False
    rx = re.compile("|".join(fnmatch.translate(p) for p in dict.fromkeys(pats)))
    return lambda name: rx.match(name) is not None


@dataclass(frozen=True)
class CopyItem:
    """One file the workspace mirror must contain."""

    src: Path
    dst: Path
    size: int
    mtime_ns: int


@dataclass(frozen=True)
class IngestPlan:
    """Manifest of an ingest: every file that belongs in workspace/<name>."""

    items: Tuple[CopyItem, ...]
    ignored: int  # entries dropped by ignore patterns during the walk

    @property
    def total_bytes(self) -> int:
        return sum(it.size for it in self.items)

    def languages(self) -> List[str]:
        found = set()
        for it in self.items:
            lang = LANGUAGE_BY_SUFFIX.get(it.dst.suffix.lower())
            if lang and lang not in ("text", "markdown"):
                found.add(lang)
        return sorted(found)


@dataclass
class RepositoryMetadata:
    """Descriptor for an ingested repository (reference manager.py:47-54)."""

    name: str
    path: Path
    languages: List[str] = field(default_factory=list)
    description: Optional[str] = None


@dataclass
class SyncStats:
    copied: int = 0
    reused: int = 0
    pruned: int = 0


class RepositoryIngestionManager:
    """Plans and mirrors source trees into the workspace, produces chunks."""

    def __init__(
        self,
        workspace: Optional[Path] = None,
        *,
        config: Optional[AppSettings] = None,
    ) -> None:
        self.config = config or default_settings
        self.workspace = Path(workspace or self.config.workspace_root)
        self.workspace.mkdir(parents=True, exist_ok=True)
        self.chunker = CodeChunker(
            max_lines=self.config.chunk_max_lines,
            max_chars=self.config.chunk_max_chars,
        )
        log.info("workspace_initialized", workspace=str(self.workspace))

    # -- plan --------------------------------------------------------------------

    def plan(
        self,
        sources: Sequence[Path],
        repo_name: str,
        ignore_dirs: Optional[Iterable[str]] = None,
    ) -> IngestPlan:
        """Walk the sources and compile the mirror manifest (no filesystem
        mutation). Directory symlinks are skipped (cycle-safe); file symlinks
        are materialized as their content."""
        if not sources:
            raise ValueError("At least one source path must be provided.")
        repo_name = validate_repo_name(repo_name)
        if isinstance(sources, (str, os.PathLike)):
            # a bare path is a common library-caller slip; iterating it as a
            # sequence would walk its CHARACTERS — "/home/..." starts with
            # "/" and plans an ingest of the whole filesystem
            sources = [sources]
        target = self.workspace / repo_name
        ignored_fn = compile_ignore(
            (*DEFAULT_IGNORE_PATTERNS, *(ignore_dirs or ()))
        )

        items: List[CopyItem] = []
        n_ignored = 0

        def walk(root: Path, dst_root: Path) -> None:
            nonlocal n_ignored
            stack: List[Tuple[Path, Path]] = [(root, dst_root)]
            while stack:
                src_dir, dst_dir = stack.pop()
                try:
                    entries = sorted(os.scandir(src_dir), key=lambda e: e.name)
                except OSError as exc:
                    log.warning("walk_error", path=str(src_dir), error=str(exc))
                    continue
                for entry in entries:
                    if ignored_fn(entry.name):
                        n_ignored += 1
                        continue
                    try:
                        if entry.is_dir(follow_symlinks=False):
                            stack.append(
                                (Path(entry.path), dst_dir / entry.name)
                            )
                        elif entry.is_file():  # follows file symlinks
                            st = entry.stat()
                            items.append(
                                CopyItem(
                                    Path(entry.path),
                                    dst_dir / entry.name,
                                    st.st_size,
                                    st.st_mtime_ns,
                                )
                            )
                        elif entry.is_symlink():
                            log.info("skip_symlink_dir", path=entry.path)
                    except OSError as exc:
                        # files can vanish between scandir and stat (build
                        # outputs, editor temp files); skip, don't abort the
                        # whole ingest plan
                        log.warning(
                            "walk_entry_error", path=entry.path, error=str(exc)
                        )

        for src in sources:
            src = Path(src)
            if not src.exists():
                raise FileNotFoundError(f"Source path not found: {src}")
            src = src.resolve()
            if ignored_fn(src.name):
                n_ignored += 1
                log.info("skip_ignored_source", source=str(src))
                continue
            if src.is_dir():
                walk(src, target / src.name)
            else:
                st = src.stat()
                items.append(
                    CopyItem(src, target / src.name, st.st_size, st.st_mtime_ns)
                )
        # deterministic order; later sources win dst collisions (dict keyed
        # by destination keeps exactly one entry per mirror path)
        by_dst = {it.dst: it for it in items}
        plan = IngestPlan(
            items=tuple(sorted(by_dst.values(), key=lambda it: str(it.dst))),
            ignored=n_ignored,
        )
        log.info(
            "ingest_planned",
            repo=repo_name,
            files=len(plan.items),
            bytes=plan.total_bytes,
            ignored=plan.ignored,
        )
        return plan

    # -- sync --------------------------------------------------------------------

    def ingest_sources(
        self,
        sources: Sequence[Path],
        repo_name: str,
        force: bool = False,
        ignore_dirs: Optional[Iterable[str]] = None,
        copy_callback: Optional[Callable[[Path], None]] = None,
    ) -> RepositoryMetadata:
        """Mirror the sources into workspace/<repo_name>.

        Incremental by default: a file already present with the same size and
        mtime is reused, and workspace files absent from the plan are pruned.
        ``force=True`` discards the existing copy first (full refresh).
        """
        repo_name = validate_repo_name(repo_name)
        plan = self.plan(sources, repo_name, ignore_dirs=ignore_dirs)
        target = self.workspace / repo_name
        # belt and braces on top of the name validation: never rmtree outside
        # the workspace even if a future caller builds the path differently
        if target.resolve().parent != self.workspace.resolve():
            raise ValueError(f"repo target escapes the workspace: {target}")

        if target.exists() and force:
            shutil.rmtree(target)
            log.warning("workspace_copy_removed", target=str(target))
        target.mkdir(parents=True, exist_ok=True)

        stats = self._sync(plan, target)
        if copy_callback:
            for it in plan.items:
                copy_callback(it.dst)

        meta = RepositoryMetadata(
            name=repo_name, path=target, languages=plan.languages()
        )
        log.info(
            "repository_ingested",
            repo=repo_name,
            sources=[str(Path(s).resolve()) for s in sources],
            languages=meta.languages,
            copied=stats.copied,
            reused=stats.reused,
            pruned=stats.pruned,
        )
        return meta

    def _sync(self, plan: IngestPlan, target: Path) -> SyncStats:
        """Make ``target`` contain exactly the plan's files."""
        stats = SyncStats()
        wanted = set()
        made_dirs = set()
        for it in plan.items:
            wanted.add(it.dst)
            try:
                st = it.dst.stat()
                # compare mtime at MICROsecond granularity: copy2's mtime
                # preservation loses sub-microsecond precision on some
                # filesystems (and cross-fs timestamp granularity differs),
                # and an exact st_mtime_ns match would then mark every file
                # stale on every re-ingest, silently degrading the
                # incremental path to a full re-copy
                fresh = st.st_size == it.size and (
                    st.st_mtime_ns // 1000 == it.mtime_ns // 1000
                )
            except OSError:
                fresh = False
            if fresh:
                stats.reused += 1
                continue
            # a path can change TYPE between ingests (refactor turns file
            # 'utils' into package 'utils/' or back): clear whatever blocks
            # the destination, or copy2 would silently write INTO a stale
            # directory / mkdir would raise on a stale file
            if it.dst.is_dir():
                shutil.rmtree(it.dst, ignore_errors=True)
            parent = it.dst.parent
            if parent not in made_dirs:
                blocker = parent
                while not blocker.exists() and blocker != target:
                    blocker = blocker.parent
                if blocker.is_file():
                    blocker.unlink(missing_ok=True)
                parent.mkdir(parents=True, exist_ok=True)
                made_dirs.add(parent)
            shutil.copy2(it.src, it.dst)
            stats.copied += 1
        # prune anything the mirror no longer wants (bottom-up so emptied
        # directories can be removed too)
        for root, dirs, files in os.walk(target, topdown=False):
            root_p = Path(root)
            for f in files:
                p = root_p / f
                if p not in wanted:
                    p.unlink(missing_ok=True)
                    stats.pruned += 1
            for d in dirs:
                p = root_p / d
                try:
                    p.rmdir()  # only succeeds when empty
                except OSError:
                    pass
        return stats

    # -- enumeration -----------------------------------------------------------------

    def list_ingested(self) -> List[RepositoryMetadata]:
        repos: List[RepositoryMetadata] = []
        if not self.workspace.exists():
            return repos
        for entry in sorted(self.workspace.iterdir()):
            if entry.is_dir() and entry.name != "index":
                repos.append(
                    RepositoryMetadata(
                        name=entry.name,
                        path=entry,
                        languages=self._detect_languages(entry),
                    )
                )
        return repos

    def iter_source_files(self, repo: RepositoryMetadata) -> Iterator[Path]:
        for path in sorted(repo.path.rglob("*")):
            if path.is_file() and path.suffix.lower() in SOURCE_SUFFIXES:
                yield path

    # -- chunking ---------------------------------------------------------------------

    def chunk_repository(
        self,
        repo: RepositoryMetadata,
        progress_callback: Optional[Callable[[Path], None]] = None,
    ) -> List[CodeChunk]:
        files = list(self.iter_source_files(repo))
        log.info("chunking_repository", repo=repo.name, files=len(files))
        chunks = self.chunker.chunk_repository(
            repo.path, files, on_file=progress_callback
        )
        refined = apply_code2prompt_heuristics(chunks)
        log.info("chunks_ready", repo=repo.name, chunks=len(refined))
        return refined

    @staticmethod
    def _detect_languages(path: Path) -> List[str]:
        languages = set()
        for file_path in path.rglob("*"):
            lang = LANGUAGE_BY_SUFFIX.get(file_path.suffix.lower())
            if lang and lang not in ("text", "markdown"):
                languages.add(lang)
        return sorted(languages)
