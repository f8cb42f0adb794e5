"""In-memory service telemetry.

Counterpart of ``semcode_tpu/api/telemetry.py`` (stdlib only, copied):
thread-safe ingest/query counters (failures, fallbacks, durations), a
bounded ring buffer of recent events and per-stage serving means, served
by ``GET /telemetry``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, Optional


@dataclass
class IngestStats:
    count: int = 0
    failures: int = 0
    total_duration_ms: float = 0.0
    last_timestamp: Optional[float] = None


@dataclass
class QueryStats:
    count: int = 0
    failures: int = 0
    fallbacks: int = 0
    total_duration_ms: float = 0.0
    last_timestamp: Optional[float] = None


class Telemetry:
    def __init__(self, max_events: int = 50) -> None:
        self._lock = threading.Lock()
        self._ingest = IngestStats()
        self._query = QueryStats()
        self._events: deque = deque(maxlen=max_events)
        # per-stage serving-path attribution (embed/search/rerank/answer...):
        # totals are per BATCH (the micro-batcher executes one device batch
        # for many requests), so the snapshot reports both per-batch and
        # per-query averages
        self._stage_totals: Dict[str, float] = {}
        self._stage_batches: int = 0
        self._stage_queries: int = 0

    def record_query_stages(
        self, timings_ms: Optional[Dict[str, float]], batch_size: int = 1
    ) -> None:
        """Accumulate per-stage timings from one executed query batch."""
        if not timings_ms:
            return
        with self._lock:
            self._stage_batches += 1
            self._stage_queries += max(int(batch_size), 1)
            for k, v in timings_ms.items():
                try:
                    self._stage_totals[k] = self._stage_totals.get(k, 0.0) + float(v)
                except (TypeError, ValueError):
                    continue

    def record_ingest(
        self,
        duration_ms: float,
        ok: bool,
        metadata: Optional[Dict[str, Any]] = None,
    ) -> None:
        with self._lock:
            now = time.time()
            self._ingest.count += 1
            if not ok:
                self._ingest.failures += 1
            self._ingest.total_duration_ms += duration_ms
            self._ingest.last_timestamp = now
            self._events.append(
                {
                    "type": "ingest",
                    "ok": ok,
                    "duration_ms": duration_ms,
                    "timestamp": now,
                    "metadata": metadata or {},
                }
            )

    def record_query(
        self, duration_ms: float, ok: bool, used_fallback: bool
    ) -> None:
        with self._lock:
            now = time.time()
            self._query.count += 1
            if not ok:
                self._query.failures += 1
            if used_fallback:
                self._query.fallbacks += 1
            self._query.total_duration_ms += duration_ms
            self._query.last_timestamp = now
            self._events.append(
                {
                    "type": "query",
                    "ok": ok,
                    "fallback": used_fallback,
                    "duration_ms": duration_ms,
                    "timestamp": now,
                }
            )

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            ing, qry = self._ingest, self._query
            return {
                "ingest": {
                    "count": ing.count,
                    "failures": ing.failures,
                    "total_duration_ms": ing.total_duration_ms,
                    "avg_duration_ms": (
                        ing.total_duration_ms / ing.count if ing.count else 0.0
                    ),
                    "last_timestamp": ing.last_timestamp,
                },
                "query": {
                    "count": qry.count,
                    "failures": qry.failures,
                    "fallbacks": qry.fallbacks,
                    "total_duration_ms": qry.total_duration_ms,
                    "avg_duration_ms": (
                        qry.total_duration_ms / qry.count if qry.count else 0.0
                    ),
                    "last_timestamp": qry.last_timestamp,
                },
                "recent_events": list(self._events),
                "query_stages": {
                    "batches": self._stage_batches,
                    "queries": self._stage_queries,
                    "avg_ms_per_batch": {
                        k: round(v / self._stage_batches, 3)
                        for k, v in self._stage_totals.items()
                    }
                    if self._stage_batches
                    else {},
                    "avg_ms_per_query": {
                        k: round(v / self._stage_queries, 3)
                        for k, v in self._stage_totals.items()
                    }
                    if self._stage_queries
                    else {},
                },
            }
