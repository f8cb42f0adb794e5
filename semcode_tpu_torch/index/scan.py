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
  route (a replayed graph's call is counted by ``scan.graph.replay`` alone).

Then, per shard: the top-W gather slice, the fused rescore in true f32 (f32
mirror, or the two-level int8 residual reconstruction) and the shard's
top-k. Every selection goes through ``stable_topk``, whose ties go to the
lowest index like ``jax.lax.top_k`` (corpora with duplicated chunks tie
exactly). The JAX step's ``approx_max_k`` selection exists only on a TPU
and the reference runs exact ``top_k`` everywhere else; this step is always
exact.

``ExactRoute`` is the one caller of the step for both indexes: it holds an
index's options and decides from them the rescore tier, the candidate
widths, the score dtype and the scan impl, and ``ExactRows`` names the row
operands both indexes hand it. Where a call's device work is a fixed chain
of launches (one CUDA shard in the process, the ``xla`` impl, the kernel
route, an unbatched query), the route replays it as a CUDA graph captured
once a (snapshot, query bucket) key (``_ScanGraphs``): the same kernels on
the same operands, so the same bits, without the host's dispatch of each
launch.
"""

from __future__ import annotations

import collections
import threading
import weakref
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from ..logger import get_logger
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

log = get_logger("index.scan")

_NEG_F16 = -6.0e4
# bound on the (query chunk x rows) score matrix of the xla route
_SCORE_BLOCK_ELEMS = 1 << 27

# above this f32-mirror footprint the fused device rescore falls back to the
# two-level int8 residual mirror (auto mode), and above the residual budget
# to host rescoring (device-memory budget guards, as the reference)
DEVICE_RESCORE_MAX_BYTES = 4 << 30
RESIDUAL_RESCORE_MAX_BYTES = 6 << 30

# the keys an ExactRoute keeps entries for, least recently used dropped first
# (more than a process's calls make: Q's buckets x k x merged x the allow
# list's bucket), and the bytes its graphs' memory pools may hold together
# before the least recently used graphs go (the newest always stays)
SCAN_GRAPHS = 64
SCAN_GRAPH_BYTES = 2 << 30
# a key's calls on one snapshot up to its capture: a capture costs what 10 to
# 40 replays save (PERF.md §6), so a snapshot that serves fewer calls, as
# a flat index's does under a stream of writes, stays eager
SCAN_CAPTURE_CALLS = 16

# The exact scan's row operands, swapped as one tuple: the flat index's
# device snapshot and the IVF index's flat mirror (whose snapshot carries the
# same fields by name). Every field is ShardedRows, split by row:
#   fvecs     (R, d) storage dtype
#   fnorms    (R,) f32 squared norms
#   fvalid    (R,) bool liveness
#   fscales   (R,) f32 int8 row scales; other storage: zeros (IVF) or None
#   frescore  (R, d) f32 mirror, or (int8 residual (R, d), f32 scales (R,)),
#             or None: the fused rescore's tier
#   ftags     (R,) int32 row tags (device-side filtered search)
ExactRows = collections.namedtuple(
    "ExactRows", ["fvecs", "fnorms", "fvalid", "fscales", "frescore", "ftags"]
)


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


def _shard_widths(shard_rows: int, k: int, fetch: int, rescore_width: int,
                  tiered: bool) -> Tuple[int, int, int, int]:
    """``(fetch, k, W, width)`` of one shard call, clamped to its rows: W 0
    gathers the whole fetch; ``width`` is what the select step returns, the
    top-W slice's when a rescore tier slices the fetch (the selection is
    sorted, so its first W are the slice), else the fetch."""
    fetch = min(fetch, shard_rows)
    k = min(k, fetch)
    w = int(rescore_width)
    w = max(w, k) if 0 < w < fetch else 0  # 0 = gather the whole fetch
    return fetch, k, w, (w if w and tiered else fetch)


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
    fetch, k, w, width = _shard_widths(shard_rows, k, fetch, rescore_width,
                                       rescore is not None or resid is not None)
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


def _padded_allow(allow_tags) -> Optional[np.ndarray]:
    """An allowed-tag list as int32, padded to a power-of-two bucket with -1
    sentinels (tags are >= 0, so -1 never matches); None (no filter) stays
    None."""
    if allow_tags is None:
        return None
    a = np.asarray(allow_tags, dtype=np.int32).ravel()
    if a.size == 0:
        raise ValueError("allow_tags must be non-empty (empty = no results)")
    n = 8
    while n < a.size:
        n *= 2
    out = np.full((n,), -1, dtype=np.int32)
    out[: a.size] = a
    return out


def _allow_on(device, allow: Optional[np.ndarray]) -> Optional[torch.Tensor]:
    return None if allow is None else torch.from_numpy(allow).to(device)


def allow_device(allow_tags, device) -> Optional[torch.Tensor]:
    """An allowed-tag list as the scan's int32 operand on ``device``
    (``_padded_allow``'s bucket); None (no filter) stays None."""
    return _allow_on(device, _padded_allow(allow_tags))


def _q_bucket(n: int) -> int:
    """A graph's query rows for a call of ``n`` queries: ``n`` itself up to
    16, else the next power of two. The step's f32 row sums (the rescore's
    and the l2 tail's) take CUDA's reduction, whose block shape follows the
    number of rows summed up to 16 rows and no further: from 16 rows on, a
    query's bits do not depend on how many rows the batch is padded to, and
    below 16 every Q is its own bucket."""
    return n if n <= 16 else 1 << (n - 1).bit_length()


def _snapshot_tensors(mesh: Mesh, rows) -> tuple:
    """The shard tensors that a graph reads of a one-shard ``ExactRows`` (or
    a snapshot with its fields); None for an absent field."""
    rank = local_shards(mesh)[0][0]
    out = []
    for f in (rows.fvecs, rows.fnorms, rows.fvalid, rows.fscales, rows.frescore,
              rows.ftags):
        for t in (f if isinstance(f, tuple) else (f,)):
            out.append(None if t is None else t.shard(rank))
    return tuple(out)


def _pool_bytes(pool) -> int:
    """The bytes of the allocator's segments in a graph's memory pool."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


class _ScanGraph:
    """One key's ``exact_scan`` captured in a CUDA graph over a static query
    buffer of ``_q_bucket`` rows and a static allow list, both allocated in
    the graph's own memory pool as its temporaries and outputs are
    (``bytes``, measured at capture). The first replay fills the whole
    buffer, its pad rows with the call's own queries (so they cost what a
    query costs); later ones copy their Q rows, and the allow list when its
    values change. ``graph`` is None until captured; ``failed`` marks a key
    whose capture raised."""

    def __init__(self):
        self.graph = None
        self.failed = self.filled = False
        self.q = self.allow = self.allow_vals = self.out = None
        self.bytes = self.calls = 0

    def capture(self, run, q: torch.Tensor, allow: Optional[np.ndarray],
                stream) -> None:
        """Capture ``run`` on ``stream``, thread-local, so other threads'
        work goes on; a capture that raised sets ``failed``."""
        graph = torch.cuda.CUDAGraph()
        stream.wait_stream(torch.cuda.current_stream(q.device))
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.q = torch.empty((_q_bucket(q.shape[0]), q.shape[1]),
                                         dtype=torch.float32, device=q.device)
                    if allow is not None:
                        self.allow = torch.empty(allow.shape, dtype=torch.int32,
                                                 device=q.device)
                    self.out = run(self.q, self.allow)
                finally:
                    graph.capture_end()
        except RuntimeError:
            log.warning("scan_graph_capture_failed", queries=q.shape[0],
                        exc_info=True)
            self.failed, self.q, self.allow, self.out = True, None, None, None
            return
        self.graph, self.bytes = graph, _pool_bytes(graph.pool())

    def replay(self, q: torch.Tensor, allow: Optional[np.ndarray]):
        """The captured call on ``q``: fresh copies of its (scores, ids)."""
        n = q.shape[0]
        if self.filled:
            self.q[:n].copy_(q)
        else:
            self.q.copy_(q[torch.arange(self.q.shape[0], device=q.device) % n])
            self.filled = True
        if allow is not None and not np.array_equal(allow, self.allow_vals):
            self.allow.copy_(torch.from_numpy(allow))
            self.allow_vals = allow
        self.graph.replay()
        return tuple(t[:n].clone() for t in self.out)


class _ScanGraphs:
    """An ``ExactRoute``'s graphs, for one snapshot: its tensors are held by
    weak reference and told apart by identity (``ShardedRows`` never swap a
    shard's tensor, so identity fixes every data pointer a graph reads), and
    a call on another snapshot, as after an add, a remove, a fold or a
    growth, drops every graph. A key's calls on a snapshot run eagerly
    until the ``SCAN_CAPTURE_CALLS``-th, which captures; later calls
    replay. At most ``SCAN_GRAPHS`` entries, least recently used dropped
    first, and past ``SCAN_GRAPH_BYTES`` in the graphs' pools the least
    recently used graphs other than the newest go; a key whose capture
    raised runs eagerly while its entry lives.

    Replays run one at a time, in order on the device (``replaying``, and
    each waits on ``done``), so one caller's copy-in, replay and copies out
    never overlap another's. Captures run one at a time too
    (``capturing``, on one side stream), apart from the lock over the
    entries, so a capture holds up no other key's calls.

    Counters: ``scan.graph.capture`` (the capturing call, which also counts
    what an eager call counts), ``scan.graph.replay`` (a replayed call,
    counted by nothing else), ``scan.graph.eager`` (a call that could have
    replayed and did not: a call before the capture, a failed key)."""

    def __init__(self):
        self.lock = threading.Lock()       # the entries and the snapshot
        self.capturing = threading.Lock()
        self.replaying = threading.Lock()
        self.refs: tuple = ()
        self.graphs: "collections.OrderedDict[tuple, _ScanGraph]" = collections.OrderedDict()
        self.stream = None   # the captures' side stream
        self.done = None     # recorded after the last replay's copies out

    def _holds(self, tensors: tuple) -> bool:
        return len(tensors) == len(self.refs) and all(
            t is None if r is None else r() is t for r, t in zip(self.refs, tensors))

    def scan(self, tensors: tuple, key: tuple, q: torch.Tensor,
             allow: Optional[np.ndarray], run):
        """``run(q, allow on the device)`` for this call, or its graph's
        replay; ``tensors`` are the snapshot's (``_snapshot_tensors``)."""
        with self.lock:
            if not self._holds(tensors):
                self.refs = tuple(None if t is None else weakref.ref(t)
                                  for t in tensors)
                self.graphs.clear()
            entry = self.graphs.get(key)
            if entry is None:
                entry = self.graphs[key] = _ScanGraph()
                if len(self.graphs) > SCAN_GRAPHS:
                    self.graphs.popitem(last=False)
            else:
                self.graphs.move_to_end(key)
            entry.calls += 1
        counter = "scan.graph.replay"
        if (entry.graph is None and not entry.failed
                and entry.calls >= SCAN_CAPTURE_CALLS):
            with self.capturing:
                if entry.graph is None and not entry.failed:
                    self._capture(entry, q, allow, run)
                    self._fit(entry)
                    counter = "scan.graph.capture"
        if entry.graph is None:
            tracing.count("scan.graph.eager")
            return run(q, _allow_on(q.device, allow))
        return self._replay(entry, q, allow, counter)

    def _replay(self, entry: _ScanGraph, q, allow, counter: str):
        """``entry``'s replay on the caller's stream, after the last replay
        on whatever stream it ran (one event wait a call, not a test of the
        stream: ``None != stream`` reads False); counted under
        ``counter``."""
        cur = torch.cuda.current_stream(q.device)
        with tracing.span("scan.graph"), self.replaying:
            cur.wait_event(self.done)
            out = entry.replay(q, allow)
            self.done.record(cur)
        tracing.count(counter)
        return out

    def _capture(self, entry: _ScanGraph, q, allow, run) -> None:
        if self.stream is None:
            self.stream = torch.cuda.Stream(q.device)
            self.done = torch.cuda.Event()
            self.done.record(torch.cuda.current_stream(q.device))
        entry.capture(run, q, allow, self.stream)

    def _fit(self, newest: _ScanGraph) -> None:
        """Drop the least recently used graphs but ``newest`` while the
        pools hold more than ``SCAN_GRAPH_BYTES``."""
        with self.lock:
            total = sum(e.bytes for e in self.graphs.values())
            for key in [k for k, e in self.graphs.items() if e.graph is not None]:
                if total <= SCAN_GRAPH_BYTES:
                    break
                if self.graphs[key] is not newest:
                    total -= self.graphs.pop(key).bytes


def route_option(name: str) -> property:
    """An index attribute kept on the index's ``ExactRoute`` (``_route``):
    the route is built once, and a caller that sets ``index.scan_impl``
    after construction still steers it."""
    return property(lambda self: getattr(self._route, name),
                    lambda self, value: setattr(self._route, name, value))


@dataclass
class ExactRoute:
    """The exact route of the flat index and of the IVF index's exact mode:
    its policy (the rescore tier, the candidate widths, the score dtype, the
    scan impl) and its one call of ``exact_scan``, built once from an
    index's options."""

    metric: str                # ip | cosine | l2
    storage: str               # int8 | bfloat16 | float32
    dim: int
    fetch_width: int = 0       # 0 = auto (max(4k, 128)); rescore candidate pool
    rescore_width: int = 0     # top-W gather slice; 0 = auto, -1 = full fetch
    score_dtype: str = "auto"  # auto | float32 | float16
    scan_impl: str = "auto"    # auto | xla | pallas (exact-scan kernel)
    rescore_mode: str = "auto"  # auto | f32 | residual | off
    device_rescore: Optional[bool] = None  # None = auto by memory budget
    _graphs: _ScanGraphs = field(default_factory=_ScanGraphs, init=False,
                                 repr=False, compare=False)

    def __post_init__(self):
        for name, known in (("metric", ("ip", "cosine", "l2")),
                            ("score_dtype", ("auto", "float32", "float16")),
                            ("scan_impl", ("auto", "xla", "pallas")),
                            ("rescore_mode", ("auto", "f32", "residual", "off"))):
            if getattr(self, name) not in known:
                raise ValueError(f"unknown {name}: {getattr(self, name)}")
        self.fetch_width = int(self.fetch_width)
        self.rescore_width = int(self.rescore_width)

    def rescore_kind(self, rows: int) -> str:
        """The fused device rescore's tier for ``rows`` allocated rows:
        'f32' (exact mirror), 'residual' (two-level int8, int8 storage only)
        or 'none' (the reference's flat.py:178-207). An explicit
        ``rescore_mode`` wins, then ``device_rescore``, then the
        device-memory budgets."""
        if self.storage == "float32":
            return "none"  # storage is already exact
        if self.rescore_mode == "off":
            return "none"
        if self.rescore_mode == "f32":
            return "f32"
        if self.rescore_mode == "residual":
            return "residual" if self.storage == "int8" else "f32"
        if self.device_rescore is False:
            return "none"
        if self.device_rescore is True:
            return "f32"
        if rows * self.dim * 4 <= DEVICE_RESCORE_MAX_BYTES:
            return "f32"
        if (self.storage == "int8"
                and rows * (self.dim + 4) <= RESIDUAL_RESCORE_MAX_BYTES):
            return "residual"
        return "none"

    def widths(self, k: int, shard_rows: int, rescore) -> Tuple[int, int]:
        """``(fetch, W)`` for a query width ``k`` over a tier payload
        ``rescore``. ``fetch``, the per-shard candidate pool, over-fetches
        when the fused rescore re-ranks: ``fetch_width`` when set, else
        max(4k, 96) for the residual tier and max(4k, 128) for the f32
        mirror. ``W``, the top-W gather slice (the reference's
        scan.py:58-80): an explicit ``rescore_width`` > 0 clamped to >= k;
        < 0, or no tier, 0 (gather the whole fetch); auto max(3k, 32),
        unless ``fetch_width`` was widened (then the whole fetch)."""
        if rescore is None:
            return min(k, shard_rows), 0
        if self.fetch_width > 0:
            fetch = min(max(self.fetch_width, k), shard_rows)
        else:
            floor = 96 if isinstance(rescore, tuple) else 128
            fetch = min(max(4 * k, floor), shard_rows)
        if self.rescore_width < 0:
            return fetch, 0
        if self.rescore_width > 0:
            return fetch, max(self.rescore_width, k)
        return fetch, 0 if self.fetch_width > 0 else max(3 * k, 32)

    def select_dtype(self, rescore) -> str:
        """The select step's score dtype: fp16 only where the fused f32
        rescore re-orders the fetched candidates; auto is float32 (as the
        reference)."""
        if self.score_dtype == "auto" or rescore is None:
            return "float32"
        return self.score_dtype

    def impl(self) -> str:
        """'pallas' runs the fused top-2 kernel (its plain version on a CPU
        device) when dim % 128 == 0 (the reference's flat.py:405-417);
        everything else, 'auto' included, the 'xla' route."""
        if self.scan_impl == "pallas" and self.dim % 128 == 0:
            return "pallas"
        return "xla"

    def scan(self, mesh: Mesh, rows, q: torch.Tensor, k: int, allow_tags=None,
             *, merged: bool = False, batched: bool = False):
        """The exact scan of ``rows`` (an ``ExactRows``, or a snapshot with
        its fields) for ``q`` (Q, d), or (B, Q, d) when ``batched``,
        metric-normalized on the mesh's home device. The result's width is
        the merged pool's min(k, n_shards * min(k, shard rows)) when
        ``merged`` (the host searches), else min(k, shard rows) (the device
        entries, as the reference's). Returns device (scores, ids).

        On one CUDA shard in this process, unbatched, with the ``xla`` impl
        on the kernel route, the call replays a captured graph of the same
        step (``_ScanGraphs``), keyed on the snapshot, Q's bucket, d, k,
        ``merged``, the widths and the allow list's bucket; every other call
        runs eagerly."""
        shard_rows = rows.fvecs.shard_rows
        k_shard = min(k, shard_rows)
        fetch, w = self.widths(k, shard_rows, rows.frescore)
        residual = isinstance(rows.frescore, tuple)
        resid, rscales = rows.frescore if residual else (None, None)
        score_dtype = self.select_dtype(rows.frescore)
        allow = _padded_allow(allow_tags)

        def run(q, allow_dev):
            fn = exact_scan_batched if batched else exact_scan
            return fn(
                mesh, rows.fvecs, rows.fnorms, rows.fvalid, rows.fscales,
                None if residual else rows.frescore, q, k_shard, fetch,
                self.metric, self.storage,
                k_out=min(k, k_shard * mesh_shards(mesh)) if merged else k_shard,
                score_dtype=score_dtype,
                tags=rows.ftags if allow_tags is not None else None,
                allow=allow_dev,
                scan_impl=self.impl(),
                resid=resid,
                rscales=rscales,
                rescore_width=w,
            )

        if not batched and self._graphed(mesh, rows, q, shard_rows, k_shard,
                                         fetch, w, score_dtype):
            key = (_q_bucket(q.shape[0]), q.shape[1], k, merged, fetch, w,
                   None if allow is None else allow.size)
            return self._graphs.scan(_snapshot_tensors(mesh, rows), key, q,
                                     allow, run)
        return run(q, _allow_on(mesh.home, allow))

    def _graphed(self, mesh: Mesh, rows, q: torch.Tensor, shard_rows: int,
                 k: int, fetch: int, w: int, score_dtype: str) -> bool:
        """Whether an unbatched call replays a graph: queries, one shard in
        this process, on ``q``'s CUDA device, the ``xla`` impl, and the kernel
        route (the matrix route's chunks and host-made constants stay
        eager)."""
        if (not q.is_cuda or not q.shape[0] or mesh.process_count != 1
                or len(local_shards(mesh)) != 1 or self.impl() != "xla"):
            return False
        v = rows.fvecs.shard(0)
        width = _shard_widths(shard_rows, k, fetch, w, rows.frescore is not None)[3]
        return (v.device == q.device
                and select_route("cuda", self.storage, score_dtype, width,
                                 v.shape[1]) == "kernel")
