"""Seeded corpora and the exact oracle shared by the tools, the bench and
chip_smoke.py.

The corpus is the JAX package's ``bench.py`` shape of difficulty: unit rows
around ``max(64, n / 1000)`` Gaussian centers, made on the generator's
device from a seeded ``torch.Generator``. A corpus too large to hold whole
is made in chunks, each from its own generator (``mixture_chunk``).
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

from ..device import f32_matmul


# chunk i of a streamed corpus draws from the generator seeded
# seed * CHUNK_KEYS + i (a CPU generator keeps 32 bits of its seed)
CHUNK_KEYS = 1 << 16


def mixture_centers(gen: torch.Generator, n_centers: int, d: int) -> torch.Tensor:
    """(n_centers, d) f32 Gaussian centers."""
    return torch.randn(n_centers, d, generator=gen, device=gen.device)


def mixture_rows(gen: torch.Generator, centers: torch.Tensor, n: int) -> torch.Tensor:
    """(n, d) f32 unit rows: a uniformly drawn center each plus 0.35
    Gaussian noise. The noise and the norm are applied in place, so a
    3 GB chunk needs two chunk-sized buffers, not four."""
    assign = torch.randint(0, centers.shape[0], (n,), generator=gen, device=gen.device)
    x = centers[assign]
    noise = torch.randn(n, centers.shape[1], generator=gen, device=gen.device)
    x.add_(noise.mul_(0.35))
    del noise
    return x.div_(torch.clamp(x.norm(dim=1, keepdim=True), min=1e-9))


def mixture(gen: torch.Generator, n: int, d: int) -> torch.Tensor:
    """(n, d) f32 unit rows around max(64, n // 1000) Gaussian centers."""
    return mixture_rows(gen, mixture_centers(gen, max(64, n // 1000), d), n)


def mixture_chunk(seed: int, i: int, centers: torch.Tensor, n: int) -> torch.Tensor:
    """Chunk ``i`` (n rows) of a corpus streamed around ``centers``: keyed
    by ``(seed, i)`` alone, so making it again gives the same bits."""
    if not 0 <= i < CHUNK_KEYS:
        raise ValueError(f"chunk index {i} outside [0, {CHUNK_KEYS})")
    gen = torch.Generator(device=centers.device).manual_seed(seed * CHUNK_KEYS + i)
    return mixture_rows(gen, centers, n)


def queries_near(gen: torch.Generator, x: torch.Tensor, nq: int) -> torch.Tensor:
    """(nq, d) unit queries: distinct corpus rows plus 0.05 Gaussian noise."""
    pick = torch.randperm(x.shape[0], generator=gen, device=gen.device)[:nq]
    q = x[pick] + 0.05 * torch.randn(nq, x.shape[1], generator=gen, device=gen.device)
    return q / torch.clamp(q.norm(dim=1, keepdim=True), min=1e-9)


def oracle_parts(parts: Iterable[Tuple[int, torch.Tensor]], q: torch.Tensor,
                 k: int, sub: int = 1 << 18) -> np.ndarray:
    """(Q, k) int64 ids of the exact top-k inner products over row parts
    given as (first id, rows), the parts made as they are consumed: the
    true-f32 product (TF32 held off) of every ``sub``-row slice, its
    ``torch.topk``, and one host merge by score."""
    best_s, best_i = [], []
    for base, rows in parts:
        for lo in range(0, rows.shape[0], sub):
            s = f32_matmul(q, rows[lo:lo + sub].T)
            v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
            best_s.append(v.cpu().numpy())
            best_i.append(i.cpu().numpy() + (base + lo))
    s = np.concatenate(best_s, axis=1)
    i = np.concatenate(best_i, axis=1)
    sel = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(i, sel, axis=1)


def oracle_topk(x: torch.Tensor, q: torch.Tensor, k: int) -> torch.Tensor:
    """``oracle_parts`` over the whole of ``x``, on ``q``'s device."""
    return torch.from_numpy(oracle_parts([(0, x)], q, k)).to(q.device)
