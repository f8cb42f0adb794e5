"""Versioned JSON repository catalogue.

Capability parity with the reference registry (reference src/semcode/
storage/registry.py:21-74) — a catalogue under the workspace mapping repo
name to its record, loaded on init, persisted on every mutation, tolerant of
corrupt files — with a different design:

- records live in a **versioned envelope** ``{"version": 2, "repos": {...}}``
  (bare version-1 mappings are still read), so future schema changes migrate
  instead of breaking;
- a corrupt file is **preserved** (renamed to ``registry.json.corrupt``) for
  the operator rather than silently discarded;
- unknown record keys are dropped on read (forward compatibility with newer
  writers) and each record carries an ``updated_at`` stamp;
- mutations are serialized by a thread lock AND an OS file lock
  (``registry.json.lock``): register/remove re-load the on-disk catalogue
  under the lock, apply the mutation, and write atomically — so an API
  server process and a concurrent CLI invocation can both register repos
  without one whole-file write erasing the other's record. Reads
  (``get``/``list``) serve the last state this process observed (refreshed
  by every mutation); staleness is bounded and crash-free.
"""

from __future__ import annotations

import fcntl
import json
import threading
import time
from dataclasses import asdict, dataclass, field, fields
from pathlib import Path
from typing import Dict, List, Optional

from ..logger import get_logger
from ..settings import AppSettings, settings as default_settings

log = get_logger("storage.registry")

SCHEMA_VERSION = 2


@dataclass
class RepositoryRecord:
    name: str
    revision: Optional[str] = None
    languages: List[str] = field(default_factory=list)
    language_summary: Optional[str] = None
    chunk_count: Optional[int] = None
    collection: Optional[str] = None  # index namespace (was milvus_collection)
    updated_at: Optional[str] = None  # ISO-8601, stamped on register


_RECORD_FIELDS = {f.name for f in fields(RepositoryRecord)}


def _record_from(data: dict) -> RepositoryRecord:
    """Build a record, dropping keys a newer writer may have added."""
    return RepositoryRecord(
        **{k: v for k, v in data.items() if k in _RECORD_FIELDS}
    )


class _FileLock:
    """Tiny flock(2) context manager (POSIX; the deployment targets are
    Linux containers — see Dockerfile)."""

    def __init__(self, path: Path):
        self._path = path
        self._fh = None

    def __enter__(self):
        self._fh = open(self._path, "a+")
        fcntl.flock(self._fh.fileno(), fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        fcntl.flock(self._fh.fileno(), fcntl.LOCK_UN)
        self._fh.close()
        self._fh = None
        return False


class RepositoryRegistry:
    def __init__(
        self,
        registry_path: Optional[Path] = None,
        *,
        config: Optional[AppSettings] = None,
    ) -> None:
        config = config or default_settings
        self.path = Path(
            registry_path or Path(config.workspace_root) / "registry.json"
        )
        self._lock = threading.Lock()
        self._records: Dict[str, RepositoryRecord] = self._read()

    # -- storage ------------------------------------------------------------

    def _read(self) -> Dict[str, RepositoryRecord]:
        try:
            text = self.path.read_text(encoding="utf-8")
        except FileNotFoundError:
            return {}
        except OSError as exc:
            log.warning("registry_unreadable", path=str(self.path), error=str(exc))
            return {}
        try:
            raw = json.loads(text)
            if isinstance(raw, dict) and "repos" in raw:
                repos = raw["repos"]  # versioned envelope (v2+)
            else:
                repos = raw  # bare v1 mapping
            return {name: _record_from(data) for name, data in repos.items()}
        except (json.JSONDecodeError, TypeError, ValueError, AttributeError) as exc:
            backup = self.path.with_suffix(".json.corrupt")
            try:
                self.path.replace(backup)
                log.warning(
                    "registry_corrupt_backed_up",
                    path=str(self.path),
                    backup=str(backup),
                    error=str(exc),
                )
            except OSError:
                log.warning(
                    "registry_corrupt", path=str(self.path), error=str(exc)
                )
            return {}

    def _write(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        envelope = {
            "version": SCHEMA_VERSION,
            "repos": {name: asdict(rec) for name, rec in self._records.items()},
        }
        tmp = self.path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(envelope, indent=2), encoding="utf-8")
        tmp.replace(self.path)

    # -- API ----------------------------------------------------------------

    def _file_lock(self):
        """Exclusive OS lock around read-merge-write mutations: a second
        PROCESS (CLI racing the API server) blocks here instead of
        replacing the file with its stale in-memory snapshot."""
        self.path.parent.mkdir(parents=True, exist_ok=True)
        return _FileLock(self.path.with_suffix(".json.lock"))

    def register(self, record: RepositoryRecord) -> None:
        record.updated_at = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        with self._lock, self._file_lock():
            self._records = self._read()  # merge concurrent writers' records
            self._records[record.name] = record
            self._write()

    def remove(self, name: str) -> bool:
        with self._lock, self._file_lock():
            self._records = self._read()
            if name not in self._records:
                return False
            del self._records[name]
            self._write()
            return True

    def get(self, name: str) -> Optional[RepositoryRecord]:
        return self._records.get(name)

    def list(self) -> List[RepositoryRecord]:
        return sorted(self._records.values(), key=lambda r: r.name)
