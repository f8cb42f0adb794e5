"""The plain reference that decides ``correct``: exact top-k by float32 inner
product, in plain PyTorch with TF32 held off, and the checks of the index's
quantizer.

It imports nothing of the program and takes nothing the program made: the
rows and queries are the harness's own, made from the seed. The index's
quantizer (its centroids and each row's cluster, copied to the host after
the build) is an output of the program, and is judged here like the
answers: ``quantizer_numbers`` holds it against the rows themselves (each
row in one of its f32-nearest clusters; each centroid at the mean of its
cluster's rows). Only then does it define the IVF answer set
(``probe_table``): an IVF_FLAT search at ``nprobe`` over that quantizer,
whose probed clusters the reference picks itself and whose rows it scores
exactly.

The exact oracle is a frozen copy of ``oracle_parts`` in
``semcode_tpu_torch/tools/_corpus.py`` (chunked true-f32 products, a top-k a
chunk, one merge), kept on the device. ``tf32`` is the control: the same
reference with both operands rounded to TF32 first, the precision just
below the float32 the configurations state.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

NEG = float("-inf")


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32's 10-bit mantissa, to nearest even: what
    the tensor cores read when TF32 is on. Products of two such values are
    exact in f32, so an f32 product of rounded operands is a TF32 product."""
    bits = x.contiguous().view(torch.int32)
    bias = 0x0FFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def f32_product(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``q @ rows.T`` in true float32 (TF32 off for the call)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return q @ rows.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def probe_table(q: torch.Tensor, centroids: np.ndarray, nprobe: int) -> torch.Tensor:
    """(Q, nlist) bool: the ``nprobe`` clusters of highest f32 inner product
    with each query."""
    c = torch.from_numpy(np.ascontiguousarray(centroids, dtype=np.float32)).to(q.device)
    top = torch.topk(f32_product(q, c), nprobe, dim=1).indices
    table = torch.zeros(q.shape[0], c.shape[0], dtype=torch.bool, device=q.device)
    return table.scatter_(1, top, True)


def _merge(best: Optional[Tuple[torch.Tensor, torch.Tensor]], s: torch.Tensor,
           base: int, k: int):
    v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
    i = i + base
    if best is not None:
        v = torch.cat([best[0], v], dim=1)
        i = torch.cat([best[1], i], dim=1)
        v, pos = torch.topk(v, k, dim=1)
        i = torch.gather(i, 1, pos)
    return v, i


def topk(rows: torch.Tensor, q: torch.Tensor, k: int, *,
         allow: Optional[torch.Tensor] = None,
         probes: Optional[torch.Tensor] = None,
         assign: Optional[torch.Tensor] = None,
         control: bool = False, sub: int = 1 << 16) -> dict:
    """Exact top-``k`` of ``q`` (Q, d) over ``rows`` (N, d), in blocks of
    ``sub`` rows. ``allow`` (N,) bool masks rows out of every answer (a tag
    filter). With ``probes`` (Q, nlist) bool and ``assign`` (N,) int64 the
    IVF answer set comes too: the top-``k`` among the rows of each query's
    probed clusters. ``control`` rounds both operands to TF32.

    Returns {"exact": (scores, ids)[, "ivf": (scores, ids)]}, ids int64."""
    qq = tf32(q) if control else q
    exact = ivf = None
    for lo in range(0, rows.shape[0], sub):
        blk = rows[lo:lo + sub]
        s = f32_product(qq, tf32(blk) if control else blk)
        if allow is not None:
            s.masked_fill_(~allow[lo:lo + sub][None, :], NEG)
        exact = _merge(exact, s, lo, k)
        if probes is not None:
            member = probes[:, assign[lo:lo + sub]]
            ivf = _merge(ivf, s.masked_fill_(~member, NEG), lo, k)
    out = {"exact": exact}
    if ivf is not None:
        out["ivf"] = ivf
    return out


def prefix_topk(corpus_top: Tuple[torch.Tensor, torch.Tensor], pool: torch.Tensor,
                qidx: torch.Tensor, writes: torch.Tensor, upto: torch.Tensor, k: int, *,
                base: int, allow: Optional[torch.Tensor] = None, member=None,
                control: bool = False, sub: int = 2048):
    """Exact top-``k`` of each answer over the corpus and a prefix of a
    writer's rows. Answer m asks query ``pool[qidx[m]]``; ``corpus_top``
    (scores, ids), each (M, k), is its top-``k`` over the corpus; it may also
    take the first ``upto[m]`` rows of ``writes`` (W, d), whose ids are
    ``base`` plus their position. ``allow`` (W,) bool masks written rows out
    (a tag filter); ``member(lo, hi)``, where given, returns the (hi - lo, W)
    bool of the written rows answers ``lo:hi`` may take (an IVF answer set).
    ``control`` rounds the operands to TF32, as ``topk`` does.

    Returns (scores, ids), each (M, k), ids int64."""
    qq = tf32(pool) if control else pool
    ww = tf32(writes) if control else writes
    cs, ci = corpus_top
    if writes.shape[0] == 0:
        return cs, ci
    col = torch.arange(writes.shape[0], device=writes.device)
    out_s, out_i = torch.empty_like(cs), torch.empty_like(ci)
    for lo in range(0, qidx.shape[0], sub):
        hi = min(lo + sub, qidx.shape[0])
        s = f32_product(qq[qidx[lo:hi]], ww)
        keep = col[None, :] < upto[lo:hi, None]
        if allow is not None:
            keep &= allow[None, :]
        if member is not None:
            keep &= member(lo, hi)
        v, i = torch.topk(s.masked_fill_(~keep, NEG), min(k, s.shape[1]), dim=1)
        v = torch.cat([cs[lo:hi], v], dim=1)
        i = torch.cat([ci[lo:hi], i + base], dim=1)
        v, pos = torch.topk(v, k, dim=1)
        out_s[lo:hi], out_i[lo:hi] = v, torch.gather(i, 1, pos)
    return out_s, out_i


def quantizer_numbers(rows: torch.Tensor, centroids: np.ndarray, assign: np.ndarray,
                      m: int = 8, sub: int = 1 << 15) -> dict:
    """The index's quantizer held against the rows, as a k-means quantizer
    is defined (squared L2 in true f32):

    - ``assign_off_nearest``: the share of rows not in their nearest
      centroid's cluster;
    - ``assign_far``: the share of rows outside their ``m`` nearest
      centroids' clusters;
    - ``centroid_excess``: by how much the centroids' squared error over
      their clusters' rows exceeds that of the clusters' own means, as a
      share of the latter: sum_j n_j |c_j - mean_j|^2 / sum_i |x_i -
      mean_a(i)|^2 (0 where every centroid is its cluster's mean)."""
    dev = rows.device
    c = torch.from_numpy(np.ascontiguousarray(centroids, dtype=np.float32)).to(dev)
    a = torch.from_numpy(np.ascontiguousarray(assign, dtype=np.int64)).to(dev)
    nlist, m = c.shape[0], min(m, c.shape[0])
    half_sq = 0.5 * (c * c).sum(dim=1)
    off = far = 0
    sums = torch.zeros(c.shape, dtype=torch.float64, device=dev)
    sq = torch.zeros((), dtype=torch.float64, device=dev)
    for lo in range(0, rows.shape[0], sub):
        x, ai = rows[lo:lo + sub], a[lo:lo + sub]
        near = torch.topk(f32_product(x, c) - half_sq[None, :], m, dim=1).indices
        off += int((near[:, 0] != ai).sum())
        far += int((near != ai[:, None]).all(dim=1).sum())
        x64 = x.double()
        sums.index_add_(0, ai, x64)
        sq += (x64 * x64).sum()
    n = torch.bincount(a, minlength=nlist).double()
    mean = sums / n.clamp(min=1.0)[:, None]
    within = sq - (n * (mean * mean).sum(dim=1)).sum()  # sum_i |x_i - mean_a(i)|^2
    shift = (n * ((c.double() - mean) ** 2).sum(dim=1)).sum()
    total = rows.shape[0]
    return {"assign_off_nearest": off / total, "assign_far": far / total,
            "centroid_excess": float(shift / within.clamp(min=1e-30))}


def pair_scores(rows: torch.Tensor, q: torch.Tensor, qi: np.ndarray,
                ids: np.ndarray, sub: int = 1 << 16) -> np.ndarray:
    """(M,) f32 inner products of query ``qi[m]`` with row ``ids[m]``."""
    out = np.empty(len(qi), dtype=np.float32)
    for lo in range(0, len(qi), sub):
        a = torch.from_numpy(qi[lo:lo + sub]).to(q.device)
        b = torch.from_numpy(ids[lo:lo + sub]).to(q.device)
        out[lo:lo + sub] = (q[a] * rows[b]).sum(dim=1).cpu().numpy()
    return out
