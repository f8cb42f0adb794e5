"""Batched Lloyd's k-means on one device (replicated, as the reference's).

Counterpart of ``semcode_tpu/ops/kmeans.py``: the IVF coarse quantizer is
trained on the device — k-means++ (D^2 sampling) init, then a fixed number
of Lloyd iterations (assignment = one f32 product + argmin, update = a
segment sum of the rows sorted by cluster, empty clusters re-seeded from
pre-drawn sample rows). Training uses a subsample of the corpus (<= 256
points per centroid), and the final full-corpus assignment streams in
batches. Every product runs in true f32 (``f32_matmul``): a TF32 product can
flip an argmin and move a row to another cluster.

Random numbers: the reseed rows come from the same numpy generator as the
reference's; the k-means++ draws come from an explicit ``torch.Generator``
on the CPU, so a build gives the same init on the CPU and on a card (the
reference draws them from ``jax.random``, whose bits no torch generator
reproduces).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, f32_matmul, resolve_device

TRAIN_POINTS_PER_CENTROID = 256


def _assign_step(x: torch.Tensor, centroids: torch.Tensor):
    """Return (assignments, min squared distances) for one batch."""
    # ||x-c||^2 = ||x||^2 - 2 x.c + ||c||^2 ; ||x||^2 is constant per row
    xc = f32_matmul(x, centroids.T)  # (B, K)
    c_sq = torch.sum(centroids * centroids, dim=1)[None, :]
    d2 = c_sq - 2.0 * xc
    mind, assign = torch.min(d2, dim=1)
    mind = mind + torch.sum(x * x, dim=1)
    return assign.to(torch.int32), torch.clamp(mind, min=0.0)


def _kmeanspp_init(x: torch.Tensor, k: int,
                   generator: torch.Generator) -> torch.Tensor:
    """k-means++ (D^2 sampling): each next centroid is a row drawn with
    probability proportional to its squared distance to the nearest centroid
    so far, which keeps a dense region from taking two centroids while a
    real cluster is orphaned. ``generator`` (a CPU generator) supplies the
    first row and the k - 1 uniforms."""
    s = x.shape[0]
    first = int(torch.randint(0, s, (1,), generator=generator))
    uniforms = torch.rand((max(k - 1, 0),), generator=generator,
                          dtype=torch.float32).to(x.device)
    x_sq = torch.sum(x * x, dim=1)
    c = x[first]
    centers = [c]
    mind = torch.clamp(x_sq - 2.0 * f32_matmul(x, c) + torch.sum(c * c), min=0.0)
    for i in range(k - 1):
        idx = _d2_sample(mind, uniforms[i])
        c = x[torch.clamp(idx, 0, s - 1)[0]]
        centers.append(c)
        d2 = torch.clamp(x_sq - 2.0 * f32_matmul(x, c) + torch.sum(c * c), min=0.0)
        mind = torch.minimum(mind, d2)
    return torch.stack(centers)


def _d2_sample(mind: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The row whose share of ``sum(mind)`` holds the uniform ``u``: the
    reference's ``searchsorted(cumsum(mind), u * total)``, on exact int64
    prefix sums of the weights in units of 2^-40 of the total (a float
    cumsum on a card sums in an order that changes from run to run)."""
    total = torch.clamp(torch.sum(mind.to(torch.float64)), min=1e-12)
    w = torch.floor(mind.to(torch.float64) / total * 2.0**40).to(torch.int64)
    prefix = torch.cumsum(w, 0)
    target = torch.floor(u.to(torch.float64) * prefix[-1]).to(torch.int64)
    return torch.searchsorted(prefix, target.reshape(1), right=True)


def _lloyd(x: torch.Tensor, init_centroids: torch.Tensor, iters: int,
           reseed_rows: torch.Tensor) -> torch.Tensor:
    """Lloyd iterations. x: (S, d), init: (K, d), reseed: (iters, K) rows of
    ``x`` that replace the centroids of clusters left empty."""
    k = init_centroids.shape[0]
    centroids = init_centroids.to(torch.float32)
    for i in range(int(iters)):
        xc = f32_matmul(x, centroids.T)
        c_sq = torch.sum(centroids * centroids, dim=1)[None, :]
        assign = torch.argmin(c_sq - 2.0 * xc, dim=1)
        # per-cluster sums over the rows sorted by cluster, each summed in
        # one fixed order: on a card, a scatter-add (float atomics) or the
        # reference's one-hot product (a split-K GEMM over the sample)
        # changes the sums, and so the layout k-means converges to, from run
        # to run
        counts = torch.bincount(assign, minlength=k)
        order = torch.argsort(assign, stable=True)
        sums = torch.segment_reduce(x[order], "sum", lengths=counts, axis=0)
        counts = counts.to(torch.float32)
        new_c = sums / torch.clamp(counts[:, None], min=1.0)
        empty = counts < 0.5
        candidates = x[reseed_rows[i].to(torch.int64)]
        centroids = torch.where(empty[:, None], candidates, new_c)
    return centroids


def _init_generator(seed: int, generator: Optional[torch.Generator]):
    if generator is not None:
        return generator
    return torch.Generator(device="cpu").manual_seed(int(seed))


def kmeans_fit_dev(
    sample_dev: torch.Tensor,
    n_clusters: int,
    *,
    iters: int = 12,
    seed: int = 0,
    generator: Optional[torch.Generator] = None,
) -> np.ndarray:
    """Fit k-means on an already-on-device f32 sample; returns the (K, d)
    centroids on the host. ``generator`` draws the k-means++ init (default:
    a CPU generator seeded with ``seed``)."""
    s, d = sample_dev.shape
    k = int(n_clusters)
    rng = np.random.default_rng(seed)
    if s <= k:
        sample = sample_dev.cpu().numpy().astype(np.float32)
        centroids = np.zeros((k, d), dtype=np.float32)
        centroids[:s] = sample
        if 0 < s < k:
            centroids[s:] = sample[rng.integers(0, s, size=k - s)]
        return centroids
    x = sample_dev.to(torch.float32)
    init = _kmeanspp_init(x, k, _init_generator(seed, generator))
    reseed = rng.integers(0, s, size=(iters, k)).astype(np.int32)
    out = _lloyd(x, init, int(iters), torch.from_numpy(reseed).to(x.device))
    return out.cpu().numpy().astype(np.float32)


def kmeans_fit(
    x: np.ndarray,
    n_clusters: int,
    *,
    iters: int = 12,
    batch_size: int = 131072,
    seed: int = 0,
    tol: float = 1e-4,  # kept for API compatibility; the loop is fixed-length
    device: DeviceLike = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fit k-means; returns (centroids (K,d) f32, assignments (N,) int32)."""
    dev = resolve_device(device)
    x = np.ascontiguousarray(x, dtype=np.float32)
    n, d = x.shape
    k = int(n_clusters)
    rng = np.random.default_rng(seed)
    if n <= k:
        centroids = np.zeros((k, d), dtype=np.float32)
        centroids[:n] = x
        if 0 < n < k:
            centroids[n:] = x[rng.integers(0, n, size=k - n)]
        return centroids, np.arange(n, dtype=np.int32) % max(k, 1)

    # faiss-style training subsample: enough points per centroid, bounded cost
    max_train = k * TRAIN_POINTS_PER_CENTROID
    sample = x[rng.choice(n, size=max_train, replace=False)] if n > max_train else x
    xs = torch.from_numpy(np.ascontiguousarray(sample)).to(dev)
    init = _kmeanspp_init(xs, k, _init_generator(seed, generator))
    reseed = rng.integers(0, sample.shape[0], size=(iters, k)).astype(np.int32)
    centroids = _lloyd(xs, init, int(iters), torch.from_numpy(reseed).to(dev))
    centroids = centroids.cpu().numpy().astype(np.float32)
    return centroids, assign_clusters(x, centroids, batch_size=batch_size,
                                      device=dev)


def assign_clusters(x: np.ndarray, centroids: np.ndarray,
                    batch_size: int = 131072,
                    device: DeviceLike = None) -> np.ndarray:
    """Coarse-quantizer assignment of new vectors (streaming insert path)."""
    dev = resolve_device(device)
    x = np.ascontiguousarray(x, dtype=np.float32)
    c = torch.from_numpy(np.array(centroids, dtype=np.float32)).to(dev)
    out = np.zeros(x.shape[0], dtype=np.int32)
    for b in range(0, x.shape[0], batch_size):
        xb = torch.from_numpy(x[b : b + batch_size]).to(dev)
        assign, _ = _assign_step(xb, c)
        out[b : b + assign.shape[0]] = assign.cpu().numpy()
    return out


def topm_step(x: torch.Tensor, centroids: torch.Tensor, m: int) -> torch.Tensor:
    """Per-row m nearest clusters (monotone in -||x-c||^2), ties to the
    lowest cluster id as ``lax.top_k``."""
    from ..index.scan import stable_topk

    xc = f32_matmul(x, centroids.T)
    c_sq = torch.sum(centroids * centroids, dim=1)[None, :]
    _, idx = stable_topk(xc - 0.5 * c_sq, m)
    return idx.to(torch.int32)


def topm_clusters(x: np.ndarray, centroids: np.ndarray, m: int = 4,
                  batch_size: int = 131072,
                  device: DeviceLike = None) -> np.ndarray:
    """Per-point m nearest clusters (for capacity-balanced assignment)."""
    dev = resolve_device(device)
    x = np.ascontiguousarray(x, dtype=np.float32)
    c = torch.from_numpy(np.array(centroids, dtype=np.float32)).to(dev)
    out = np.zeros((x.shape[0], m), dtype=np.int32)
    for b in range(0, x.shape[0], batch_size):
        xb = torch.from_numpy(x[b : b + batch_size]).to(dev)
        out[b : b + xb.shape[0]] = topm_step(xb, c, m).cpu().numpy()
    return out


def balanced_assign(
    candidates: np.ndarray,
    n_clusters: int,
    cap: int,
    counts: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Greedy capacity-capped assignment with spill to next-nearest cluster.

    Keeps every cluster at <= cap entries so the capacity-padded layout is
    dense (bounded cmax = bounded scan bandwidth), trading a small recall hit:
    a spilled point lands in its 2nd..mth nearest cluster, which a query
    probing nprobe >= 2 clusters usually still reaches. Points whose m
    candidates are ALL full are redistributed to the least-loaded clusters
    (strict cap: they stay reachable through the exact-scan/rescore paths,
    and the padded layout never blows up on hot regions).
    """
    n, m = candidates.shape
    base = (
        counts.astype(np.int64)
        if counts is not None
        else np.zeros(n_clusters, dtype=np.int64)
    )
    assign = candidates[:, 0].astype(np.int32).copy()

    def overflow_points():
        order = np.argsort(assign, kind="stable")
        sorted_assign = assign[order]
        block_start = np.searchsorted(sorted_assign, sorted_assign)
        rank = np.arange(n) - block_start + base[sorted_assign]
        return order[rank >= cap]

    # eviction rounds, fully vectorized: points beyond a cluster's remaining
    # capacity fall through to their next-nearest candidate
    for r in range(1, m):
        evict = overflow_points()
        if evict.size == 0:
            return assign
        assign[evict] = candidates[evict, r]
    # strict pass: pack the remaining overflow into clusters with free space
    evict = overflow_points()
    if evict.size:
        occ = np.bincount(assign, minlength=n_clusters) + base
        free_slots = np.maximum(cap - occ, 0)
        # clusters repeated by their free capacity, least-loaded first
        order = np.argsort(-free_slots, kind="stable")
        targets = np.repeat(order, free_slots[order])
        take = min(evict.size, targets.size)
        assign[evict[:take]] = targets[:take].astype(np.int32)
        # if space genuinely ran out (cap * n_clusters < n), leave the rest
    return assign
