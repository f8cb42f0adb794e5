"""Dynamic micro-batching for the query endpoint.

Counterpart of ``semcode_tpu/api/batcher.py``. The engine's throughput
scales with batch size (one corpus scan serves a whole batch), so
concurrent ``/query`` requests should ride one device call. Requests
enqueue here; a worker drains the queue in (window, max-batch) chunks,
groups compatible requests (same top_k/filters), and executes each group as
a single ``pipeline.query_batch`` in the thread pool. Latency cost is
bounded by the batching window (a few ms); single in-flight requests are
dispatched immediately.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, List, Optional, Tuple

from ..logger import get_logger

log = get_logger("api.batcher")


class BatcherOverloaded(Exception):
    """Raised when the pending-query bound is exceeded (backpressure)."""


class QueryBatcher:
    def __init__(
        self,
        pipeline,
        executor,
        *,
        max_batch: int = 64,
        window_ms: float = 3.0,
        queue_max: int = 0,  # 0 = unbounded
        split: int = 2,  # concurrent sub-groups per full window (1 = off)
    ):
        self.pipeline = pipeline
        self.executor = executor
        self.max_batch = int(max_batch)
        self.split = max(1, int(split))
        self.window_s = float(window_ms) / 1000.0
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=max(0, int(queue_max)))
        self._worker_task: Optional[asyncio.Task] = None
        # strong refs: an un-referenced asyncio Task may be garbage-collected
        # mid-flight, which would strand its waiters
        self._group_tasks: set = set()

    async def query(
        self,
        question: str,
        top_k: Optional[int] = None,
        filters: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        loop = asyncio.get_event_loop()
        if self._worker_task is None or self._worker_task.done():
            self._worker_task = loop.create_task(self._worker())
        future: asyncio.Future = loop.create_future()
        try:
            # non-blocking: a full queue means the service is saturated and
            # callers should shed load NOW, not line up behind it
            self._queue.put_nowait((question, top_k, self._freeze(filters), future))
        except asyncio.QueueFull:
            raise BatcherOverloaded(
                f"query queue full ({self._queue.maxsize} pending)"
            ) from None
        return await future

    @staticmethod
    def _freeze(filters: Optional[Dict[str, Any]]) -> Tuple:
        # deep-freeze: multi-select filter values arrive as lists and the
        # frozen form is used as a dict key when grouping compatible requests
        return tuple(
            sorted(
                (k, tuple(v) if isinstance(v, list) else v)
                for k, v in (filters or {}).items()
            )
        )

    async def _worker(self) -> None:
        loop = asyncio.get_event_loop()
        while True:
            first = await self._queue.get()
            batch = [first]
            # gather more requests inside the window (or until max_batch);
            # drain already-queued items synchronously first — at saturation
            # a window's worth is usually waiting, and wait_for costs a
            # timer + wrapper task per item on the hot loop
            deadline = loop.time() + self.window_s
            while len(batch) < self.max_batch:
                try:
                    batch.append(self._queue.get_nowait())
                    continue
                except asyncio.QueueEmpty:
                    pass
                timeout = deadline - loop.time()
                if timeout <= 0:
                    break
                try:
                    batch.append(
                        await asyncio.wait_for(self._queue.get(), timeout)
                    )
                except asyncio.TimeoutError:
                    break
            try:
                self._dispatch_groups(loop, batch)
            except Exception as exc:  # pragma: no cover - defensive
                # a worker-level failure must fail the waiters, not strand
                # them: an escaped exception here would kill the worker task
                # while callers await their futures forever
                for item in batch:
                    if not item[3].done():
                        item[3].set_exception(exc)

    def _dispatch_groups(self, loop, batch: List) -> None:
        # group by (top_k, filters) compatibility. Hashing the frozen filters
        # can still fail for exotic values (e.g. dicts nested inside lists,
        # which the API layer rejects but direct callers might pass) — fail
        # only the offending request, never the whole batch window.
        groups: Dict[Tuple, List] = {}
        for item in batch:
            try:
                groups.setdefault((item[1], item[2]), []).append(item)
            except TypeError as exc:
                if not item[3].done():
                    item[3].set_exception(
                        ValueError(f"unhashable filter value: {exc}")
                    )
        for (top_k, frozen), items in groups.items():
            # pipeline host work against device work: a large window runs as
            # `split` concurrent sub-groups, so sub-group A's response
            # assembly/JSON overlaps sub-group B's device scan. One 32-batch
            # at c=32 serializes host-then-device every cycle; two 16-groups
            # measured +36% e2e QPS at identical latency (the device
            # serializes internally either way, the HOST share overlaps).
            n_sub = self.split if len(items) >= 2 * self.split else 1
            size = -(-len(items) // n_sub)
            for lo in range(0, len(items), size):
                task = loop.create_task(
                    self._run_group(loop, top_k, frozen, items[lo : lo + size])
                )
                self._group_tasks.add(task)
                task.add_done_callback(self._group_tasks.discard)

    async def _run_group(self, loop, top_k, frozen, items: List) -> None:
        questions = [it[0] for it in items]
        filters = dict(frozen) if frozen else None
        try:
            if len(items) == 1:
                results = [
                    await loop.run_in_executor(
                        self.executor,
                        lambda: self.pipeline.query(
                            questions[0], top_k=top_k, filters=filters
                        ),
                    )
                ]
            else:
                log.info("query_microbatch", size=len(items))
                results = await loop.run_in_executor(
                    self.executor,
                    lambda: self.pipeline.query_batch(
                        questions, top_k=top_k, filters=filters
                    ),
                )
            for item, result in zip(items, results):
                if not item[3].done():
                    item[3].set_result(result)
        except Exception as exc:
            for item in items:
                if not item[3].done():
                    item[3].set_exception(exc)
