"""Spans and counters of the engine, and per-stage pipeline timing.

One mechanism for the search path, the build path and the pipeline:

- ``span(name)``: a context manager around one phase of a call. Off, the
  default, it costs one flag check and returns a shared no-op: no
  allocation, no clock read, no torch call. It is on after ``enable()`` and
  while a ``torch.profiler`` records. On, it adds its host-clock seconds to
  process-wide totals by name, and while a profiler records it also enters
  ``torch.profiler.record_function("semcode." + name)``, so the phase lies on
  the profiler's timeline beside the device operations it launched. Spans
  nest by containment on their thread; the caller's own span (a request, a
  batch) is the parent that ties one call's spans together.
- ``phase(name)``: a span whose totals are kept while tracing is off too,
  for the build's phases, which run once a build and last seconds.
- ``count(name, n=1)``: process-wide integer counters, always on.
- ``snapshot()``: the counters and the span totals (``GET /telemetry``
  serves it under ``"engine"``).
- ``StageTimer``: one pipeline call's milliseconds by stage, for telemetry
  and response meta; each stage is also a span ``stage.<name>``.

The span names are listed in PERF.md with what reads each.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import ContextManager, Dict, List, Optional

import torch
# the profiler keeps whether it records in this module's plain attribute
# ``_is_profiler_enabled``: reading it is no call into torch
import torch.autograd.profiler as _profiler

PREFIX = "semcode."

_on = False
_lock = threading.Lock()
_counters: Dict[str, int] = {}
_totals: Dict[str, List[float]] = {}  # name -> [count, seconds]


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _Noop()


def _add(name: str, seconds: float) -> None:
    with _lock:
        tot = _totals.get(name)
        if tot is None:
            _totals[name] = [1, seconds]
        else:
            tot[0] += 1
            tot[1] += seconds


class _Span:
    __slots__ = ("name", "annotation", "t0")

    def __init__(self, name: str):
        self.name = name
        self.annotation = (torch.profiler.record_function(PREFIX + name)
                           if _profiler._is_profiler_enabled else None)

    def __enter__(self):
        if self.annotation is not None:
            self.annotation.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        seconds = time.perf_counter() - self.t0
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        _add(self.name, seconds)
        return False


def span(name: str, at: Optional[object] = None):
    """A span around one phase of a call; ``at`` qualifies the name
    (``name@at``: a shard's rank, a library), joined only when on."""
    if not (_on or _profiler._is_profiler_enabled):
        return _NOOP
    return _Span(name if at is None else f"{name}@{at}")


def phase(name: str, at: Optional[object] = None):
    """A span whose host-clock total is kept while tracing is off too."""
    return _Span(name if at is None else f"{name}@{at}")


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process-wide counter ``name`` (always on)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def is_span_event(ev) -> bool:
    """A ``torch.profiler`` event or average that is one of these spans, on
    the host or mirrored on the device's timeline: an annotation, never an
    operation to count or time."""
    return ev.key.startswith(PREFIX)


def enable(on: bool = True) -> None:
    """Turn spans on (or off) for the whole process."""
    global _on
    _on = bool(on)


def snapshot() -> dict:
    """``{"counters": {name: n}, "spans": {name: {"count", "seconds"}}}``."""
    with _lock:
        return {"counters": dict(_counters),
                "spans": {k: {"count": int(c), "seconds": s}
                          for k, (c, s) in _totals.items()}}


def reset() -> None:
    """Forget every counter and span total."""
    with _lock:
        _counters.clear()
        _totals.clear()


class StageTimer:
    """Accumulates wall-clock per stage: ``with timer.stage("embed"): ...``"""

    def __init__(self) -> None:
        self._totals: Dict[str, float] = {}

    @contextmanager
    # annotated as the decorated callable's public type (what callers
    # and runtime checkers see), not the generator convention
    def stage(self, name: str) -> ContextManager[None]:
        start = time.perf_counter()
        try:
            with span("stage." + name):
                yield
        finally:
            elapsed = (time.perf_counter() - start) * 1000.0
            self._totals[name] = self._totals.get(name, 0.0) + elapsed

    def as_dict(self) -> Dict[str, float]:
        return {k: round(v, 3) for k, v in self._totals.items()}
