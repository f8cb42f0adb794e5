"""Sharded exact-scan step for the flat index and the IVF exact path.

Counterpart of ``semcode_tpu/index/scan.py`` (``_exact_scan_impl``,
125-361). The corpus rows are split over the mesh's row axes
(``parallel/mesh.py``): shard ``s`` owns rows ``[s * shard_rows, (s + 1) *
shard_rows)``, held in its own tensors (``ShardedRows``) on its own device.
Each of this process's shards runs the step below on those tensors, and the
shards' ``(Q, k)`` candidates merge
innermost axis first (``hierarchical_topk_merge``), as the reference's
shard_map body does.

Routes, with the JAX meanings of ``scan_impl``:

- ``pallas``: the fused top-2 kernel (``ops/scan_top2.top2_scan``, the
  Hopper counterpart of the Pallas ``top2_scan_shard``), launched once per
  shard on the shard's rows, then an exact top-``fetch`` over the reduced
  (Q, 2*nb) matrix, padded to ``k``.
- ``xla`` (also what ``auto`` resolves to): an exact top-``fetch`` of the
  scores, by one of two routes that ``select_route`` picks from what the
  call can observe. On a CUDA card, for int8 storage, float32 scores and a
  selection of at most 64 rows (the top-W slice's width when a rescore tier
  slices the fetch, else the fetch): ``ops/scan_top2.scan_topk``, which
  fuses the int8 product, the epilogue, the mask and an exact top-w
  selection in one kernel and never writes the score matrix. Otherwise the
  full (Q, shard_rows) score matrix (``_score_block``) and ``stable_topk``,
  in query chunks so the matrix stays bounded (int8 storage uses
  ``torch._int_mm`` on the card and an exact float64 product on the CPU).
  Both give the same entries in the same order, bit for bit; the counters
  ``scan.select.kernel`` and ``scan.select.matrix`` count shard calls by
  route.

Then, per shard: the top-W gather slice, the fused rescore in true f32 (f32
mirror, or the two-level int8 residual reconstruction) and the shard's
top-k. Every selection goes through ``stable_topk``, whose ties go to the
lowest index like ``jax.lax.top_k`` (corpora with duplicated chunks tie
exactly). The JAX step's ``approx_max_k`` selection exists only on a TPU
and the reference runs exact ``top_k`` everywhere else; this step is always
exact.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.scan_top2 import MAX_WIDTH, NEG, scan_topk, top2_scan
from ..parallel.mesh import (
    Mesh,
    ShardedRows,
    all_reduce_sum,
    hierarchical_topk_merge,
    local_shards,
    n_shards as mesh_shards,
)
from ..utils import tracing

_NEG_F16 = -6.0e4
# bound on the (query chunk x rows) score matrix of the xla route
_SCORE_BLOCK_ELEMS = 1 << 27


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along dim 1 with ``jax.lax.top_k``'s order: values descending,
    ties by the LOWEST index. ``torch.topk`` promises no tie order, so the
    selection runs on int64 keys (order-preserving float bits in the high
    word, the complemented column in the low word), which have no ties."""
    n = x.shape[1]
    k = min(int(k), n)
    with tracing.span("topk"):
        xf = x.to(torch.float32)
        bits = xf.view(torch.int32).to(torch.int64)
        # IEEE total order as signed ints: flip the magnitude bits of negatives
        ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
        col = torch.arange(n, device=x.device, dtype=torch.int64)
        keys = (ordered << 32) | (0xFFFFFFFF - col)
        _, idx = torch.topk(keys, k, dim=1, sorted=True)
        return torch.gather(x, 1, idx), idx


def resolve_rescore_width(rescore_width: int, fetch_width: int, k: int,
                          rescore) -> int:
    """Shared auto policy for the top-W gather slice (scan.py:58-80):

    - explicit ``rescore_width`` > 0: clamp to >= k and use it;
    - ``rescore_width`` < 0 (or no rescore tier): full fetch, no slice;
    - auto (0): max(3k, 32), unless the caller explicitly widened
      ``fetch_width`` (then the full fetch is gathered)."""
    if rescore is None or rescore_width < 0:
        return 0
    if rescore_width > 0:
        return max(rescore_width, k)
    if fetch_width > 0:
        return 0
    return max(3 * k, 32)


def quantize_queries_device(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization of a query batch, on device.

    Returns (int8 values, f32 scales); the same f32 arithmetic as the JAX
    step (which returns the values as exact bf16 integers)."""
    scale = torch.clamp(q.abs().amax(dim=1), min=1e-12) / 127.0
    qq = torch.clamp(torch.round(q / scale[:, None]), -127, 127)
    return qq.to(torch.int8), scale.to(torch.float32)


def _int8_dot(qq: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """(Q, d) int8 x (R, d) int8 -> (Q, R) exact int32 products as f32."""
    n_q, d = qq.shape
    if qq.device.type == "cuda" and d % 8 == 0 and vecs.shape[0] % 8 == 0:
        # cuBLASLt int8 GEMM shape rules: more than 16 rows, multiples of 8
        m = max(24, -(-n_q // 8) * 8)
        a = qq if m == n_q else torch.cat(
            [qq, qq.new_zeros((m - n_q, d))]
        )
        return torch._int_mm(a, vecs.T)[:n_q].to(torch.float32)
    return (qq.to(torch.float64) @ vecs.to(torch.float64).T).to(torch.float32)


def _score_block(qq, vecs, scales_rows, storage, q_scales=None):
    """(Q, d) x (R, d) -> (Q, R) f32 scores for a storage-dtype block."""
    if storage == "int8":
        raw = _int8_dot(qq, vecs)
        return raw * q_scales[:, None] * scales_rows[None, :]
    return qq @ vecs.to(torch.float32).T


def select_route(device_type: str, storage: str, score_dtype: str, width: int,
                 dim: int) -> str:
    """The exact route's select step: ``"kernel"`` (``scan_topk``) on a CUDA
    card for int8 storage, float32 scores, a width of 1 to 64 rows and a
    depth the kernel's 128-byte chunks divide; ``"matrix"`` (``_select_xla``)
    for every other call: bf16/f32 storage (the kernel would round their f32
    products), the f16 score option, wider selections, every CPU call."""
    if (device_type == "cuda" and storage == "int8" and score_dtype == "float32"
            and 1 <= width <= MAX_WIDTH and dim % 128 == 0):
        return "kernel"
    return "matrix"


def _select_xla(qq, q_scales, vecs, nrm, vld, scl, storage, metric, fetch,
                f16: bool):
    """Full-matrix route: scores in query chunks, exact top-``fetch``."""
    n_q, n_rows = qq.shape[0], vecs.shape[0]
    step = max(1, _SCORE_BLOCK_ELEMS // max(n_rows, 1))
    neg = _NEG_F16 if f16 else NEG
    out_s, out_p = [], []
    for lo in range(0, n_q, step):
        hi = min(lo + step, n_q)
        scores = _score_block(
            qq[lo:hi], vecs, scl, storage,
            q_scales[lo:hi] if q_scales is not None else None,
        )
        if metric == "l2":
            scores = 2.0 * scores - nrm[None, :]
        if f16:
            scores = torch.clamp(scores, -2.9e4, 6.0e4).to(torch.float16)
        scores = torch.where(
            vld[None, :], scores, torch.tensor(neg, dtype=scores.dtype,
                                               device=scores.device)
        )
        s, p = stable_topk(scores, fetch)
        out_s.append(s)
        out_p.append(p)
    return torch.cat(out_s), torch.cat(out_p)


def _select_pallas(qq, q_scales, vecs, nrm, vld, scl, storage, metric,
                   fetch, k):
    """Kernel route: per-block top-2, then exact top-``fetch`` of those."""
    n_rows = vecs.shape[0]
    ones = torch.ones((n_rows,), dtype=torch.float32, device=vecs.device)
    mult = scl if storage == "int8" else ones
    if metric == "l2":
        mult = 2.0 * mult
    addv = torch.where(vld, 0.0, NEG).to(torch.float32)
    if metric == "l2":
        addv = addv - nrm
    qk = qq if storage == "int8" else qq.to(torch.bfloat16)
    qsc = (q_scales if storage == "int8"
           else torch.ones((qq.shape[0],), dtype=torch.float32,
                           device=qq.device))
    bm, br = top2_scan(vecs, mult.contiguous(), addv.contiguous(),
                       qk.contiguous(), qsc.contiguous())
    s, sel = stable_topk(bm, min(fetch, bm.shape[1]))
    pos = torch.gather(br, 1, sel).to(torch.int64)
    if s.shape[1] < k:  # tiny indexes: keep downstream widths legal
        pad = k - s.shape[1]
        s = torch.nn.functional.pad(s, (0, pad), value=NEG)
        pos = torch.nn.functional.pad(pos, (0, pad), value=0)
    return s, pos


def exact_scan(
    mesh: Mesh,
    vecs,                      # (R, d) storage dtype
    norms,                     # (R,) f32 row sqnorms (l2)
    valid,                     # (R,) bool liveness
    scales,                    # (R,) f32 int8 row scales (or placeholder)
    rescore,                   # (R, d) f32 mirror, or None
    q: torch.Tensor,           # (Q, d) f32, metric-normalized
    k: int,                    # per-shard result width
    fetch: int,                # per-shard candidate width before rescore
    metric: str,               # ip | cosine | l2
    storage: str,              # int8 | bfloat16 | float32
    k_out: Optional[int] = None,  # merged width (default k)
    score_dtype: str = "float32",
    tags=None,                 # (R,) int32 row tags
    allow: Optional[torch.Tensor] = None,  # (A,) int32 allowed tags (-1 pad)
    scan_impl: str = "xla",
    resid=None,                # (R, d) int8 residual mirror
    rscales=None,              # (R,) f32 residual scales
    rescore_width: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan + select + (rescore) per shard, then the merge; returns
    (scores (Q, k_out) f32, ids (Q, k_out) int64 global rows) on the mesh's
    first local device. For l2, scores are -||q - x||^2. The row operands
    are ``ShardedRows`` (a tensor in global row order is split first)."""
    if k_out is None:
        k_out = k
    n_shards = mesh_shards(mesh)
    vecs, norms, valid, scales, rescore, tags, resid, rscales = (
        None if t is None else ShardedRows.of(mesh, t)
        for t in (vecs, norms, valid, scales, rescore, tags, resid, rscales))
    shard_rows = vecs.shard_rows
    fetch = min(fetch, shard_rows)
    k = min(k, fetch)
    w = int(rescore_width)
    w = max(w, k) if 0 < w < fetch else 0  # 0 = gather the whole fetch
    k_out = min(k_out, k * n_shards)
    f16 = score_dtype == "float16" and scan_impl == "xla"
    neg = _NEG_F16 if f16 else NEG
    if resid is not None and (rescore is not None or storage != "int8"):
        raise ValueError(
            "residual rescore requires int8 storage and excludes the f32 "
            "mirror"
        )
    if scan_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown scan_impl: {scan_impl}")
    q = q.to(torch.float32)
    # the width the select step must return: the top-W slice's, when a
    # rescore tier slices the fetch (the selection is sorted, so its first W
    # are the slice), else the fetch
    width = w if w and (rescore is not None or resid is not None) else fetch
    if storage == "int8":
        with tracing.span("scan.quantize"):
            qq, q_scales = quantize_queries_device(q)
    else:
        qq, q_scales = q, None

    parts = []
    for rank, dev in local_shards(mesh):
        lo = rank * shard_rows

        def rows(t):
            return None if t is None else t.shard(rank)

        v, nrm, vld, scl = rows(vecs), rows(norms), rows(valid), rows(scales)
        if tags is not None:
            vld = vld & (rows(tags)[:, None] == allow.to(dev)[None, :]).any(dim=1)
        with tracing.span("scan.select", rank):
            qq_s = qq.to(dev)
            qs_s = q_scales.to(dev) if q_scales is not None else None
            if scan_impl == "pallas":
                s, pos = _select_pallas(qq_s, qs_s, v, nrm, vld, scl, storage,
                                        metric, fetch, k)
            elif select_route(v.device.type, storage, score_dtype, width,
                              v.shape[1]) == "kernel":
                tracing.count("scan.select.kernel")
                s, pos = scan_topk(v, scl, vld, nrm if metric == "l2" else None,
                                   qq_s, qs_s, width)
            else:
                tracing.count("scan.select.matrix")
                s, pos = _select_xla(qq_s, qs_s, v, nrm, vld, scl, storage,
                                     metric, fetch, f16)
            s = s.to(torch.float32)
        with tracing.span("scan.rescore", rank):
            resc, rsd = rows(rescore), rows(resid)
            if (resc is not None or rsd is not None) and w:
                # top-W gather slice: selection output is sorted by prefilter score
                s = s[:, :w]
                pos = pos[:, :w]
            if resc is not None or rsd is not None:
                # fused exact rescore in true f32: an elementwise product and
                # sum, which no TF32 setting can lower (the reference's HIGHEST
                # einsum)
                if resc is not None:
                    cand = resc[pos]  # (Q, W, d)
                else:
                    cand = (
                        v[pos].to(torch.float32) * scl[pos][:, :, None]
                        + rsd[pos].to(torch.float32) * rows(rscales)[pos][:, :, None]
                    )
                exact = (cand * q.to(dev)[:, None, :]).sum(dim=2)
                if metric == "l2":
                    exact = 2.0 * exact - nrm[pos]
                s = torch.where(s > neg / 2, exact, NEG)
            else:
                s = torch.where(s > neg / 2, s, NEG)
            # the shard's top-k, sorted (the merge takes sorted parts; the
            # reference sorts in its merge, to the same order)
            s, sel = stable_topk(s, min(k, s.shape[1]))
            pos = torch.gather(pos, 1, sel)
        parts.append((s, pos + lo if lo else pos))
    # hierarchical merge: the local shards first, then across processes
    with tracing.span("scan.merge"):
        s, ids = hierarchical_topk_merge(parts, k_out, mesh)
    if metric == "l2":
        s = s - torch.sum(q * q, dim=1, keepdim=True)
    return s, ids


def _rescore_parts(mesh: Mesh, n_rows: int, q, ids, metric, gather):
    """Exact f32 scores of merged candidates by global row id: each shard
    gathers the candidates in its row range from its own tensors
    (``gather(rank, li)`` -> (Q, K, d) rows and (Q, K) norms), scores them,
    and the shards' parts (zero where another shard owns the row) are
    summed, across processes too: the reference's psum. Aligned with ``ids``, not re-sorted; -3e38
    where ids < 0; l2 scores follow -||q-x||^2."""
    n_shards = mesh_shards(mesh)
    shard_rows = n_rows // n_shards
    q = q.to(torch.float32)
    total = None
    for rank, dev in local_shards(mesh):
        lo, hi = rank * shard_rows, (rank + 1) * shard_rows
        ids_d = ids.to(dev).to(torch.int64)
        li = (ids_d - lo if lo else ids_d).clamp(0, shard_rows - 1)
        cand, nrm = gather(rank, li)
        exact = (cand * q.to(dev)[:, None, :]).sum(dim=2)
        if metric == "l2":
            exact = 2.0 * exact - nrm
        # zero where another shard owns the row; a lone shard owns them
        # all (ids < 0 are masked below)
        if n_shards > 1:
            exact = torch.where((ids_d >= lo) & (ids_d < hi), exact, 0.0)
        part = exact.to(mesh.home)
        total = part if total is None else total + part
    total = all_reduce_sum(total, mesh)
    if metric == "l2":
        total = total - torch.sum(q * q, dim=1, keepdim=True)
    return torch.where(ids >= 0, total, NEG)


def rescore_global(mesh: Mesh, frescore, fnorms, q, ids, metric):
    """Exact f32 re-scoring of MERGED candidates identified by global row id
    (scan.py:418-467): the probing path's candidates are owned by cluster,
    not by mirror row range, so each shard gathers the candidates its f32
    mirror range holds and the parts are summed (``_rescore_parts``)."""
    frescore, fnorms = (ShardedRows.of(mesh, t) for t in (frescore, fnorms))

    def gather(rank, li):
        return frescore.shard(rank)[li], fnorms.shard(rank)[li]

    return _rescore_parts(mesh, frescore.rows, q, ids, metric, gather)


def rescore_global_residual(mesh: Mesh, fvecs, fscales, fresid, frscales,
                            fnorms, q, ids, metric):
    """``rescore_global`` for the two-level int8 mirror (scan.py:469-517):
    each shard rebuilds its candidates from the int8 corpus plus the int8
    residual (~16-bit precision) and re-scores them in f32."""
    fvecs, fscales, fresid, frscales, fnorms = (
        ShardedRows.of(mesh, t) for t in (fvecs, fscales, fresid, frscales, fnorms))

    def gather(rank, li):
        cand = (
            fvecs.shard(rank)[li].to(torch.float32)
            * fscales.shard(rank)[li][:, :, None]
            + fresid.shard(rank)[li].to(torch.float32)
            * frscales.shard(rank)[li][:, :, None]
        )
        return cand, fnorms.shard(rank)[li]

    return _rescore_parts(mesh, fvecs.rows, q, ids, metric, gather)


def exact_scan_batched(mesh, vecs, norms, valid, scales, rescore, qs, k,
                       fetch, metric, storage, **kwargs):
    """``exact_scan`` over B query batches (qs: (B, Q, d)); returns
    (scores (B, Q, k), ids (B, Q, k)). The reference folds the batches into
    one dispatch to amortize a per-dispatch fee; here it is a loop."""
    outs = [
        exact_scan(mesh, vecs, norms, valid, scales, rescore, qs[b], k, fetch,
                   metric, storage, **kwargs)
        for b in range(qs.shape[0])
    ]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))
