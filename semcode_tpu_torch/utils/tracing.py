"""Tracing and profiling.

The reference declares langsmith "observability" but never uses it
(SURVEY.md section 5.1); the only timing is duration stamps in telemetry.
Here tracing is first-class:

- ``StageTimer``: lightweight per-stage wall-clock timing for pipelines;
  stages nest, results are a flat dict of milliseconds suitable for telemetry
  or response meta.

(The JAX package's ``profiler_trace`` wraps ``jax.profiler``; device traces
of this engine come from ``torch.profiler`` directly.)
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import ContextManager, Dict


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
            yield
        finally:
            elapsed = (time.perf_counter() - start) * 1000.0
            self._totals[name] = self._totals.get(name, 0.0) + elapsed

    def as_dict(self) -> Dict[str, float]:
        return {k: round(v, 3) for k, v in self._totals.items()}
