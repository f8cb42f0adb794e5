"""The seeded corpus and query pool of a cell, made on the device.

A frozen copy of ``semcode_tpu_torch/tools/_corpus.py`` (``mixture_centers``,
``mixture_rows``, ``queries_near``) as of the port's headline bench, so that
a later change to the program cannot move the yardstick. What differs: every
stream is keyed by a seed derived from the run's ``--seed`` (``derive``), the
rows are made chunk by chunk into one tensor, and the noise levels come from
the configuration file.

The shape of difficulty is the JAX package's ``bench.py``: unit rows around
``centers`` Gaussian centres with ``noise`` Gaussian noise, and queries that
are distinct corpus rows with ``query_noise`` noise.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

# streams keyed off one run seed
STREAMS = {"centers": 0, "rows": 1, "queries": 2, "sample": 3}


def derive(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit seed for ``stream`` (chunk ``index``) of run ``seed``: any
    whole number, negative or past 64 bits, maps to a fixed value."""
    ss = np.random.SeedSequence([abs(int(seed)) % (1 << 128), int(seed) < 0,
                                 STREAMS[stream], int(index)])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def mixture_rows(gen: torch.Generator, centers: torch.Tensor, n: int,
                 noise: float) -> torch.Tensor:
    """(n, d) f32 unit rows: a uniformly drawn centre each plus ``noise``
    Gaussian noise, applied in place (two chunk-sized buffers)."""
    assign = torch.randint(0, centers.shape[0], (n,), generator=gen, device=gen.device)
    x = centers[assign]
    eps = torch.randn(n, centers.shape[1], generator=gen, device=gen.device)
    x.add_(eps.mul_(noise))
    del eps
    return x.div_(torch.clamp(x.norm(dim=1, keepdim=True), min=1e-9))


def chunk_bounds(n: int, chunk_rows: int) -> Iterator[Tuple[int, int, int]]:
    """(chunk index, first row, end row) of every chunk."""
    for i, lo in enumerate(range(0, n, chunk_rows)):
        yield i, lo, min(lo + chunk_rows, n)


def make_rows(cfg: dict, seed: int, device: torch.device) -> torch.Tensor:
    """The configuration's (rows, dim) f32 corpus for run ``seed``. Chunk i
    draws from its own generator, so the same seed gives the same bits."""
    n, d = int(cfg["rows"]), int(cfg["dim"])
    centers = torch.randn(int(cfg["centers"]), d, device=device,
                          generator=generator(device, derive(seed, "centers")))
    out = torch.empty(n, d, dtype=torch.float32, device=device)
    for i, lo, hi in chunk_bounds(n, chunk_rows(cfg)):
        gen = generator(device, derive(seed, "rows", i))
        out[lo:hi] = mixture_rows(gen, centers, hi - lo, float(cfg["noise"]))
    return out


def chunk_rows(cfg: dict) -> int:
    """Rows per ingest chunk: at most ``ingest_chunk_bytes`` of f32 rows."""
    return max(1, int(cfg["ingest_chunk_bytes"]) // (4 * int(cfg["dim"])))


def row_tags(cfg: dict) -> np.ndarray:
    """(rows,) int32 tags: 1 on every ``tag_every``-th row (one repository
    in ``tag_every``), 0 elsewhere; all 0 when the configuration tags none."""
    n, every = int(cfg["rows"]), int(cfg.get("tag_every", 0))
    if every <= 0:
        return np.zeros(n, dtype=np.int32)
    return (np.arange(n) % every == 0).astype(np.int32)


def queries_near(gen: torch.Generator, x: torch.Tensor, nq: int,
                 noise: float) -> torch.Tensor:
    """(nq, d) unit queries: distinct corpus rows plus ``noise`` Gaussian
    noise."""
    pick = torch.randperm(x.shape[0], generator=gen, device=gen.device)[:nq]
    q = x[pick] + noise * torch.randn(nq, x.shape[1], generator=gen, device=gen.device)
    return q / torch.clamp(q.norm(dim=1, keepdim=True), min=1e-9)


def make_pool(cfg: dict, traffic: dict, rows: torch.Tensor, seed: int) -> torch.Tensor:
    """The traffic's pool of queries for run ``seed``."""
    gen = generator(rows.device, derive(seed, "queries"))
    return queries_near(gen, rows, int(traffic["pool"]), float(cfg["query_noise"]))
