"""Durable background-job ledger.

Jobs are modelled as an append-only EVENT JOURNAL folded into immutable
snapshots, not as a dict of mutable records:

- every state change is an event ``(job id, kind, fields, ts)``;
- the current state of a job is the left-fold of its events (``_fold``);
- reads hand out frozen ``JobSnapshot`` values — pollers can never observe
  a half-applied update, and handlers can keep a snapshot across ``await``
  points without it mutating underneath them;
- events are journalled to ``jobs.jsonl`` (JSON lines, append-only), so job
  state SURVIVES RESTARTS: on startup the ledger replays the journal and
  marks jobs that were mid-flight when the process died as ``interrupted``.

Counterpart of ``semcode_tpu/api/jobs.py``, with the same journal format:
one workspace's ``jobs.jsonl`` replays in either package. High-frequency
progress events are folded in memory always but journalled at most once per
second per job, so a 100k-file ingest does not turn the journal into a write
amplifier.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from pathlib import Path
from types import MappingProxyType
from typing import Any, Dict, Iterator, Mapping, Optional

from ..logger import get_logger

log = get_logger("api.jobs")

TERMINAL_STATUSES = frozenset({"completed", "failed", "interrupted"})
_PROGRESS_JOURNAL_INTERVAL_S = 1.0


def _freeze(mapping: Optional[Dict[str, Any]]) -> Mapping[str, Any]:
    return MappingProxyType(dict(mapping or {}))


@dataclass(frozen=True)
class JobSnapshot:
    """Immutable view of one job at a point in its event history."""

    id: str
    type: str
    status: str = "queued"  # queued | running | completed | failed | interrupted
    stage: Optional[str] = None
    progress: Mapping[str, Any] = field(default_factory=lambda: _freeze(None))
    result: Optional[Dict[str, Any]] = None
    error: Optional[str] = None
    metadata: Mapping[str, Any] = field(default_factory=lambda: _freeze(None))
    created_at: float = 0.0
    updated_at: float = 0.0

    @property
    def finished(self) -> bool:
        return self.status in TERMINAL_STATUSES

    def duration_ms(self) -> float:
        return (self.updated_at - self.created_at) * 1000.0


def _fold(snap: JobSnapshot, kind: str, fields: Dict[str, Any], ts: float) -> JobSnapshot:
    """Apply one event to a snapshot, producing the next snapshot."""
    if kind == "status":
        changes: Dict[str, Any] = {"status": fields["status"]}
        if fields.get("stage") is not None:
            changes["stage"] = fields["stage"]
        return replace(snap, updated_at=ts, **changes)
    if kind == "stage":
        return replace(snap, stage=fields["stage"], updated_at=ts)
    if kind == "progress":
        merged = dict(snap.progress)
        merged.update(fields)
        return replace(snap, progress=_freeze(merged), updated_at=ts)
    if kind == "completed":
        return replace(
            snap,
            status="completed",
            stage="done",
            result=fields.get("result"),
            updated_at=ts,
        )
    if kind == "failed":
        return replace(snap, status="failed", error=fields.get("error"), updated_at=ts)
    if kind == "interrupted":
        return replace(
            snap,
            status="interrupted",
            error=fields.get("error", "process exited mid-job"),
            updated_at=ts,
        )
    if kind == "snapshot":
        # journal-compaction record: the whole folded state in one event
        return replace(
            snap,
            status=fields.get("status", snap.status),
            stage=fields.get("stage"),
            progress=_freeze(fields.get("progress")),
            result=fields.get("result"),
            error=fields.get("error"),
            updated_at=ts,
        )
    log.warning("unknown_job_event", kind=kind, job=snap.id)
    return snap


class JobLedger:
    """Event-sourced job registry with optional on-disk journal."""

    def __init__(
        self,
        journal_path: Optional[Path] = None,
        *,
        keep_terminal: int = 512,
    ) -> None:
        self._snaps: "OrderedDict[str, JobSnapshot]" = OrderedDict()
        self._lock = threading.Lock()
        self._keep_terminal = int(keep_terminal)
        self._journal_path = Path(journal_path) if journal_path else None
        self._journal = None
        self._last_progress_write: Dict[str, float] = {}
        if self._journal_path is not None:
            self._journal_path.parent.mkdir(parents=True, exist_ok=True)
            self._replay()
            # compact on startup: rewrite the journal as one folded snapshot
            # line per surviving job (terminal jobs beyond keep_terminal were
            # evicted during replay). Without this the append-only journal
            # grows forever across restarts; with it the size is bounded by
            # keep_terminal + active jobs, and the 'interrupted' verdicts
            # synthesized during replay are persisted as part of the rewrite.
            self._compact_journal()
            self._journal = self._journal_path.open("a", encoding="utf-8")

    # -- event core -----------------------------------------------------------

    def append(self, job_id: str, kind: str, **fields: Any) -> JobSnapshot:
        """Record one event; returns the job's new snapshot."""
        ts = time.time()
        with self._lock:
            snap = self._snaps.get(job_id)
            if snap is None:
                raise KeyError(f"unknown job: {job_id}")
            if snap.finished:
                # terminal states are sticky; late callbacks can't resurrect
                # a job or skew its recorded duration
                return snap
            new = _fold(snap, kind, fields, ts)
            self._snaps[job_id] = new
            self._journal_event({"id": job_id, "kind": kind, "ts": ts, **fields})
        return new

    def create(
        self, job_type: str, metadata: Optional[Dict[str, Any]] = None
    ) -> JobSnapshot:
        ts = time.time()
        snap = JobSnapshot(
            id=uuid.uuid4().hex,
            type=job_type,
            metadata=_freeze(metadata),
            created_at=ts,
            updated_at=ts,
        )
        with self._lock:
            self._snaps[snap.id] = snap
            self._evict_locked()
            self._journal_event(
                {
                    "id": snap.id,
                    "kind": "created",
                    "ts": ts,
                    "type": job_type,
                    "metadata": dict(snap.metadata),
                }
            )
        return snap

    # -- reads ------------------------------------------------------------------

    def get(self, job_id: str) -> Optional[JobSnapshot]:
        with self._lock:
            return self._snaps.get(job_id)

    def list(self) -> Dict[str, JobSnapshot]:
        with self._lock:
            return dict(self._snaps)

    def active(self) -> Iterator[JobSnapshot]:
        with self._lock:
            snaps = list(self._snaps.values())
        return (s for s in snaps if not s.finished)

    # -- convenience event writers (the ingest worker's vocabulary) -------------

    def set_status(
        self, job_id: str, status: str, stage: Optional[str] = None
    ) -> None:
        self.append(job_id, "status", status=status, stage=stage)

    def update_stage(self, job_id: str, stage: str) -> None:
        self.append(job_id, "stage", stage=stage)

    def update_progress(self, job_id: str, **fields: Any) -> None:
        self.append(job_id, "progress", **fields)

    def complete(self, job_id: str, result: Optional[Dict[str, Any]] = None) -> None:
        self.append(job_id, "completed", result=result)

    def fail(self, job_id: str, error: str) -> None:
        self.append(job_id, "failed", error=error)

    # -- journal ------------------------------------------------------------------

    def _journal_event(self, event: Dict[str, Any]) -> None:
        if self._journal is None:
            return
        if event["kind"] == "progress":
            # fold every progress event in memory, journal at most 1/s/job
            last = self._last_progress_write.get(event["id"], 0.0)
            if event["ts"] - last < _PROGRESS_JOURNAL_INTERVAL_S:
                return
            self._last_progress_write[event["id"]] = event["ts"]
        self._write_journal(event)

    def _write_journal(self, event: Dict[str, Any]) -> None:
        try:
            self._journal.write(json.dumps(event, default=str) + "\n")
            self._journal.flush()
        except Exception as exc:  # journal loss degrades durability, not serving
            log.warning("job_journal_write_failed", error=str(exc))

    def _replay(self) -> list:
        """Rebuild snapshots from the journal; returns the interruption events
        synthesized for jobs that were mid-flight when the process died."""
        if not self._journal_path.exists():
            return []
        replayed = 0
        for line in self._journal_path.read_text(encoding="utf-8").splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                event = json.loads(line)
                kind = event.pop("kind")
                job_id = event.pop("id")
                ts = float(event.pop("ts"))
            except (json.JSONDecodeError, KeyError, ValueError):
                continue  # torn tail line from a crash — skip
            if kind == "created":
                self._snaps[job_id] = JobSnapshot(
                    id=job_id,
                    type=event.get("type", "unknown"),
                    metadata=_freeze(event.get("metadata")),
                    created_at=ts,
                    updated_at=ts,
                )
            elif kind == "snapshot":
                base = JobSnapshot(
                    id=job_id,
                    type=event.get("type", "unknown"),
                    metadata=_freeze(event.get("metadata")),
                    created_at=float(event.get("created_at", ts)),
                    updated_at=ts,
                )
                self._snaps[job_id] = _fold(base, "snapshot", event, ts)
            elif job_id in self._snaps:
                self._snaps[job_id] = _fold(self._snaps[job_id], kind, event, ts)
            replayed += 1
        synthesized = []
        now = time.time()
        for job_id, snap in self._snaps.items():
            if not snap.finished:
                self._snaps[job_id] = _fold(
                    snap,
                    "interrupted",
                    {"error": "process exited while the job was in flight"},
                    now,
                )
                synthesized.append(
                    {
                        "id": job_id,
                        "kind": "interrupted",
                        "ts": now,
                        "error": "process exited while the job was in flight",
                    }
                )
        self._evict_locked()
        if replayed:
            log.info(
                "job_journal_replayed",
                events=replayed,
                jobs=len(self._snaps),
                interrupted=len(synthesized),
            )
        return synthesized

    def _compact_journal(self) -> None:
        """Rewrite the journal as folded per-job snapshot lines (atomic)."""
        try:
            tmp = self._journal_path.with_suffix(".tmp")
            with tmp.open("w", encoding="utf-8") as f:
                for snap in self._snaps.values():
                    f.write(
                        json.dumps(
                            {
                                "id": snap.id,
                                "kind": "snapshot",
                                "ts": snap.updated_at,
                                "type": snap.type,
                                "status": snap.status,
                                "stage": snap.stage,
                                "progress": dict(snap.progress),
                                "result": snap.result,
                                "error": snap.error,
                                "metadata": dict(snap.metadata),
                                "created_at": snap.created_at,
                            },
                            default=str,
                        )
                        + "\n"
                    )
            tmp.replace(self._journal_path)
        except Exception as exc:  # compaction failure must not block startup
            log.warning("job_journal_compact_failed", error=str(exc))

    def _evict_locked(self) -> None:
        """Bound memory: drop the oldest TERMINAL jobs beyond keep_terminal."""
        terminal = [j for j, s in self._snaps.items() if s.finished]
        excess = len(terminal) - self._keep_terminal
        for job_id in terminal[:max(excess, 0)]:
            del self._snaps[job_id]
            self._last_progress_write.pop(job_id, None)

    def close(self) -> None:
        if self._journal is not None:
            self._journal.close()
            self._journal = None
