"""Seeded corpora and the exact oracle shared by the tools and chip_smoke.py.

The corpus is the JAX package's ``bench.py`` shape of difficulty: unit rows
around ``max(64, n / 1000)`` Gaussian centers, made on the generator's
device from a seeded ``torch.Generator``.
"""

from __future__ import annotations

import torch

from ..device import f32_matmul


def mixture(gen: torch.Generator, n: int, d: int) -> torch.Tensor:
    """(n, d) f32 unit rows around max(64, n // 1000) Gaussian centers."""
    n_centers = max(64, n // 1000)
    centers = torch.randn(n_centers, d, generator=gen, device=gen.device)
    assign = torch.randint(0, n_centers, (n,), generator=gen, device=gen.device)
    x = centers[assign]
    x.add_(0.35 * torch.randn(n, d, generator=gen, device=gen.device))
    return x / torch.clamp(x.norm(dim=1, keepdim=True), min=1e-9)


def queries_near(gen: torch.Generator, x: torch.Tensor, nq: int) -> torch.Tensor:
    """(nq, d) unit queries: distinct corpus rows plus 0.05 Gaussian noise."""
    pick = torch.randperm(x.shape[0], generator=gen, device=gen.device)[:nq]
    q = x[pick] + 0.05 * torch.randn(nq, x.shape[1], generator=gen, device=gen.device)
    return q / torch.clamp(q.norm(dim=1, keepdim=True), min=1e-9)


def oracle_topk(x: torch.Tensor, q: torch.Tensor, k: int) -> torch.Tensor:
    """(Q, k) ids of the exact top-k inner products, in true f32 (TF32 held
    off), over row chunks of 2**18."""
    best_s, best_i = [], []
    for lo in range(0, x.shape[0], 1 << 18):
        s = f32_matmul(q, x[lo:lo + (1 << 18)].T)
        v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
        best_s.append(v)
        best_i.append(i + lo)
    s = torch.cat(best_s, dim=1)
    i = torch.cat(best_i, dim=1)
    _, sel = torch.topk(s, k, dim=1)
    return torch.gather(i, 1, sel)
