"""Timing and settings helpers shared by the tools and ``chip_smoke.py``.

The JAX tools time a "chained" launch: ``lax.scan`` folds CHUNK_B batches
into one dispatch so that a per-launch fee does not become the measurement.
PyTorch launches asynchronously, so the same protocol here is CHUNK_B
back-to-back calls between two CUDA events with one synchronise at the end.
On the CPU the host clock takes the events' place.
"""

from __future__ import annotations

import time
from typing import Callable, Mapping

import torch


def env_number(environ: Mapping[str, str], name: str, default):
    """``environ[name]`` read as the type of ``default`` (int or float)."""
    raw = environ.get(name)
    return default if raw in (None, "") else type(default)(raw)


def device_name(device: torch.device) -> str:
    """What a measurement ran on: the card's name, or ``cpu``."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _group_ms(fn: Callable[[], object], device: torch.device, calls: int) -> float:
    """Milliseconds of ``calls`` back-to-back calls of ``fn``, ending in
    one synchronise: CUDA events on the card, the host clock on the CPU."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) * 1e3


def cuda_ms(fn: Callable[[], object], iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``iters``
    calls after ``warmup`` calls."""
    device = torch.device("cuda", torch.cuda.current_device())
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return _group_ms(fn, device, iters) / iters


def first_call(fn: Callable[[], object], device: torch.device):
    """(result, wall seconds) of one synchronised call: the tools'
    ``compile_s`` (on a process's first launch of a kernel it includes the
    nvcc build)."""
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    return out, time.perf_counter() - t0


def chained_ms(fn: Callable[[], object], device: torch.device, calls: int,
               secs: float) -> float:
    """Mean ms per call of ``fn``: groups of ``calls`` back-to-back calls
    (``_group_ms``), repeated until ``secs`` of wall time have passed, at
    least once."""
    total_ms, n = 0.0, 0
    t0 = time.perf_counter()
    while n == 0 or time.perf_counter() - t0 < secs:
        total_ms += _group_ms(fn, device, calls)
        n += calls
    return total_ms / n
