"""IVF_FLAT-equivalent ANN index, sharded over a device mesh.

Counterpart of ``semcode_tpu/index/ivf.py``. The cluster lists are split
over the mesh's row axes (``parallel/mesh.py``) in contiguous blocks of
``nlist // n_shards`` clusters (``nlist`` rounds up to a multiple of the
shard count), and the flat mirror by rows as the flat index is; each
shard's clusters and mirror rows sit in tensors of their own on its device
(``ShardedRows``), and a process holds its own shards' and no others.
Centroids, probe selection, k-means and the pending tail are replicated on
the first local device. Each query probes ``nprobe`` clusters; every shard
scans the probed clusters it owns and contributes a local top-k, and the
``(Q, k)`` candidate sets merge innermost axis first
(``hierarchical_topk_merge``).

- **Device-authoritative storage**: the row-major flat mirror on the device
  (storage-dtype vectors + scales + norms + optional f32 or two-level int8
  rescore mirror + tags) IS the corpus. The host keeps only O(N) metadata
  (liveness, cluster assignment, slot map, tags), whole in every process.
  Ingest uploads f32 rows and quantizes/normalizes on the device; builds,
  re-packs and compactions gather from the mirror on the device
  (``ShardedRows.take``: a row's mirror position and its cluster usually
  sit on different shards, and in a multi-process run in different
  processes, which then make every such call in the same order).
- **Build**: k-means coarse quantizer trained on the device
  (``ops/kmeans.py``), capacity-balanced assignment, then the vectors are
  laid out in capacity-padded cluster blocks ``data[nlist, cmax, dim]``.
- **Scan**: centroid scores pick ``nprobe`` clusters per query; per shard,
  the probing kernel (``ops/ivf_scan.py``, the Hopper counterpart of the
  Pallas ``ivf_scan_shard``, launched once per shard with the probes that
  shard does not own out of range) or the reference's gather-scan route
  scores the shard's probed rows; after the merge an exact f32 rescore
  (each shard gathering the candidates its mirror range holds) re-orders
  the merged candidates.
- **Exact mode** scans the flat mirror through the exact route the flat
  index takes (``scan.ExactRoute``, over the sharded ``scan.exact_scan``).
- **Streaming inserts**: nearest cluster with a free slot; layout rebuilds
  (cluster overflow / retrain) are amortized; past a device-memory
  threshold inserts land in a small exact-scanned pending tail.

Device state is swapped as whole tuples and readers' tensors are never
edited in place (out-of-place scatters), so a search racing a writer sees
a consistent old or new snapshot. Only tensors no reader has seen yet (a
fresh layout, the mirror inside ``bulk()`` before any snapshot exists) are
written in place. Tombstones (``ids == -1``) support upsert-by-id from the
store layer.
"""

from __future__ import annotations

import collections
import math
from contextlib import contextmanager
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, f32_matmul, round_up, storage_dtype, storage_name
from ..logger import get_logger
from ..ops import ivf_scan as ivf_ops
from ..ops.kmeans import TRAIN_POINTS_PER_CENTROID, balanced_assign, kmeans_fit_dev, topm_step
from ..parallel.mesh import (
    Mesh,
    ShardedRows,
    hierarchical_topk_merge,
    local_shards,
    n_shards as mesh_shards,
    pad_bucket,
    resolve_mesh,
)
from ..utils import tracing
from .flat import quantize_residual_device, quantize_rows_device
from .scan import (
    ExactRoute,
    ExactRows,
    allow_device,
    quantize_queries_device,
    rescore_global,
    rescore_global_residual,
    route_option,
    stable_topk,
)

log = get_logger("index.ivf")

# One atomically-swapped device snapshot (lock-free readers). The padded
# cluster layout (data/ids/sqnorms/scales/centroids) serves the probing path;
# the flat row-major mirror (the ``ExactRows`` fields, position == global row
# id) serves the exact path and is the authoritative storage. Every field
# but the replicated centroids is ShardedRows, split by cluster (layout) or
# by row (mirror):
#   data       (nlist, cmax, d) storage dtype
#   ids        (nlist, cmax) int32 row ids, -1 = empty/tombstone
#   sqnorms    (nlist, cmax) f32
#   scales     (nlist, cmax) f32 or None (int8 only)
#   centroids  (nlist, d) f32
#   f*         the mirror (see ``scan.ExactRows``)
_Dev = collections.namedtuple(
    "_Dev",
    [
        "data", "ids", "sqnorms", "scales", "centroids",
        "fvecs", "fvalid", "fnorms", "fscales", "frescore", "ftags",
    ],
)

_NEG_INF = np.float32(-3.0e38)
_NEG = -3.0e38

# rows per device chunk for ingest / pack / gather steps: bounds transient
# device memory (chunk * dim * 4 B)
_CHUNK_ROWS = 131072


def _set(arr: torch.Tensor, idx, vals: torch.Tensor) -> torch.Tensor:
    """Out-of-place row scatter ``arr[idx] = vals`` into the pending tail
    (readers keep the previous tensor)."""
    return arr.index_copy(0, idx, vals.to(arr.dtype))


def _normalize_rows(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    n = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x / torch.clamp(n, min=1e-12)


def _row_norms(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    return torch.sum(x * x, dim=1)


class IVFIndex:
    """Inverted-file index with capacity-padded cluster blocks, sharded by
    cluster over ``mesh`` (default: ``get_mesh`` over ``device``).

    The reference's approximate full-scan selection (``approx_topk``,
    ``approx_recall_target``) exists only on a TPU, so those options have no
    counterpart here: every selection is exact."""

    kind = "ivf"
    # the exact route's options, held on ``_route``
    fetch_width = route_option("fetch_width")
    rescore_width = route_option("rescore_width")
    score_dtype = route_option("score_dtype")
    scan_impl = route_option("scan_impl")
    rescore_mode = route_option("rescore_mode")
    device_rescore = route_option("device_rescore")

    def __init__(
        self,
        dim: int,
        *,
        nlist: int = 128,
        nprobe: int = 16,
        metric: str = "ip",
        dtype: str = "bfloat16",
        kmeans_iters: int = 12,
        seed: int = 0,
        use_pallas: str = "auto",  # auto | always | never (probing kernel)
        balance_cap: float = 2.0,  # cluster capacity cap, x mean occupancy
        device_rescore: Optional[bool] = None,  # None = auto by memory budget
        score_dtype: str = "auto",  # auto | float32 | float16 (exact path)
        fetch_width: int = 0,  # 0 = auto (max(4k, 128)); rescore candidate pool
        rescore_width: int = 0,  # top-W gather slice; 0 = auto, -1 = full fetch
        scan_impl: str = "auto",  # auto | xla | pallas (exact-scan kernel)
        rescore_mode: str = "auto",  # auto | f32 | residual | off
        mesh: Optional[Mesh] = None,
        device: DeviceLike = None,
    ):
        self._dtype = storage_dtype(dtype)
        self._route = ExactRoute(
            metric, storage_name(self._dtype), int(dim),
            fetch_width=fetch_width, rescore_width=rescore_width,
            score_dtype=score_dtype, scan_impl=scan_impl,
            rescore_mode=rescore_mode, device_rescore=device_rescore,
        )
        if use_pallas not in ("auto", "always", "never"):
            raise ValueError(f"unknown use_pallas: {use_pallas}")
        self.dim = int(dim)
        self.metric = metric
        self.mesh = resolve_mesh(mesh, device)
        self.device = self.mesh.home
        self.n_shards = mesh_shards(self.mesh)
        # every shard owns the same number of clusters
        self.nlist = round_up(int(nlist), self.n_shards)
        self.nprobe = min(int(nprobe), self.nlist)
        self.kmeans_iters = kmeans_iters
        self.seed = seed
        self.use_pallas = use_pallas
        self.balance_cap = float(balance_cap)
        # mirror rows split evenly across shards and stay 128-aligned
        self._row_multiple = math.lcm(self.n_shards * 8, 128)
        self._mirror_cap = 0  # flat-mirror rows currently materialized

        # host metadata (O(N), amortized-growth buffers; NO vector payloads)
        self.size = 0  # live rows (excluding tombstones)
        self._n_rows = 0  # total rows ever added
        self._meta_cap = 0
        self._assign = np.zeros((0,), dtype=np.int32)
        self._loc = np.zeros((0, 2), dtype=np.int32)  # row -> (cluster, slot)
        self._alive = np.zeros((0,), dtype=bool)
        # int32 row tags for device-side filtered search (0 = untagged)
        self._tags = np.zeros((0,), dtype=np.int32)
        self.centroids: Optional[np.ndarray] = None  # (nlist, dim) f32
        self._counts = np.zeros((self.nlist,), dtype=np.int32)  # slots used
        self.cmax = 0

        # device state: the authoritative mirror + one atomically-swapped
        # _Dev snapshot so lock-free readers always see consistent tensors
        self._mir: Optional[ExactRows] = None
        self._dev: Optional[_Dev] = None
        self._dirty = True
        # host f32 copy, maintained incrementally ONLY when no device rescore
        # mirror exists (the store's host rescore then needs it); otherwise
        # hydrated on demand for persistence
        self._host_cache: Optional[np.ndarray] = None
        self._host_ingest_only = True  # False once a device tensor is added
        self._bulk = False  # inside a bulk() block: defer layout/materialize
        # pending tail: streaming inserts past a device-memory threshold land
        # in a small exact-scanned side buffer (see _use_pending)
        self._pend: Optional[tuple] = None  # (vecs, ids, tags, n_used)

    # -- helpers ---------------------------------------------------------------

    @property
    def is_trained(self) -> bool:
        return self.centroids is not None

    @property
    def _host(self) -> np.ndarray:
        """Full-precision host copy of rows 0..n_rows (hydrated from the
        device when not incrementally maintained; persistence only)."""
        if self._host_cache is not None:
            return self._host_cache[: self._n_rows]
        return self.hydrate_host()

    def hydrate_host(self) -> np.ndarray:
        """Fetch the f32 corpus (n_rows, dim) from the device mirror."""
        self._fold_pending()  # pending rows live only in the side buffer
        n = self._n_rows
        if n == 0 or self._mir is None:
            return np.zeros((0, self.dim), dtype=np.float32)
        if n * self.dim * 4 > 1 << 30:
            log.warning("hydrate_host_large", rows=n, dim=self.dim)
        out = np.empty((n, self.dim), dtype=np.float32)
        for lo in range(0, n, _CHUNK_ROWS):
            hi = min(lo + _CHUNK_ROWS, n)
            out[lo:hi] = self._f32_chunk(np.arange(lo, hi)).cpu().numpy()
        return out

    def _check_vectors(self, x, *, device_ok: bool = True):
        if isinstance(x, torch.Tensor):
            if not device_ok:
                x = x.detach().cpu().numpy()
            elif x.dim() != 2 or x.shape[1] != self.dim:
                raise ValueError(
                    f"expected (n, {self.dim}) vectors, got {tuple(x.shape)}"
                )
            else:
                return x.to(self.device, torch.float32)
        x = np.ascontiguousarray(x, dtype=np.float32)
        if x.ndim != 2 or x.shape[1] != self.dim:
            raise ValueError(f"expected (n, {self.dim}) vectors, got {x.shape}")
        return x

    def _extend_meta_capacity(self, need: int) -> None:
        """Pre-size the host metadata buffers (no rows appended)."""
        if need > self._meta_cap:
            self._extend_meta_grow(max(need, max(1024, self._meta_cap * 2)))

    def _extend_meta_grow(self, new_cap: int) -> None:
        for name, fill in (("_assign", -1), ("_alive", False), ("_tags", 0)):
            old = getattr(self, name)
            buf = np.full((new_cap,), fill, dtype=old.dtype)
            buf[: self._n_rows] = old[: self._n_rows]
            setattr(self, name, buf)
        loc = np.full((new_cap, 2), -1, dtype=np.int32)
        loc[: self._n_rows] = self._loc[: self._n_rows]
        self._loc = loc
        if self._host_cache is not None:
            host = np.zeros((new_cap, self.dim), dtype=np.float32)
            host[: self._n_rows] = self._host_cache[: self._n_rows]
            self._host_cache = host
        self._meta_cap = new_cap

    def _extend_meta(self, n: int, tags: np.ndarray) -> np.ndarray:
        """Append n rows to the host metadata buffers; returns new row ids."""
        need = self._n_rows + n
        if need > self._meta_cap:
            self._extend_meta_grow(max(need, max(1024, self._meta_cap * 2)))
        rows = np.arange(self._n_rows, need, dtype=np.int64)
        self._alive[rows] = True
        self._tags[rows] = tags
        self._n_rows = need
        self.size += n
        return rows

    def _to_dev(self, arr: np.ndarray) -> torch.Tensor:
        arr = np.ascontiguousarray(arr)
        if not arr.flags.writeable:  # torch wants a writable buffer
            arr = arr.copy()
        return torch.from_numpy(arr).to(self.device)

    # -- device mirror (authoritative storage) ---------------------------------

    def _mirror_target_cap(self, n_rows: int) -> int:
        return round_up(n_rows + max(1024, n_rows // 8), self._row_multiple)

    def _zeros(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _sharded(self, rows: int, tail, dtype, fill=0) -> ShardedRows:
        return ShardedRows.full(self.mesh, rows, tail, dtype, fill)

    def _ensure_mirror(self, need_rows: int, *, exact: bool = False) -> None:
        """Create or grow the device mirror to hold ``need_rows`` rows.

        ``exact`` allocates exactly ``need_rows`` (lane-rounded) with no
        growth headroom: the exact scan's cost is linear in ALLOCATED mirror
        rows, so a bulk build with a declared row count must not carry the
        +12.5% amortization pad."""
        if self._mir is not None and need_rows <= self._mirror_cap:
            return
        mcap = (round_up(max(need_rows, 1), self._row_multiple)
                if exact else self._mirror_target_cap(need_rows))

        def _fresh_rescore(kind):
            if kind == "f32":
                return self._sharded(mcap, (self.dim,), torch.float32)
            if kind == "residual":
                return (
                    self._sharded(mcap, (self.dim,), torch.int8),
                    self._sharded(mcap, (), torch.float32),
                )
            return None

        if self._mir is None:
            kind = self._route.rescore_kind(mcap)
            self._mir = ExactRows(
                fvecs=self._sharded(mcap, (self.dim,), self._dtype),
                fvalid=self._sharded(mcap, (), torch.bool),
                fnorms=self._sharded(mcap, (), torch.float32),
                fscales=self._sharded(mcap, (), torch.float32),
                frescore=_fresh_rescore(kind),
                ftags=self._sharded(mcap, (), torch.int32),
            )
            if kind == "none" and self._dtype != torch.float32:
                # the store's host rescore needs f32 somewhere: keep it on host
                self._host_cache = np.zeros(
                    (max(self._meta_cap, 1024), self.dim), dtype=np.float32
                )
            self._mirror_cap = mcap
            return
        mir = self._mir
        new_kind = self._route.rescore_kind(mcap) if mir.frescore is not None else "none"
        is_resid = isinstance(mir.frescore, tuple)
        old_kind = "none" if mir.frescore is None else (
            "residual" if is_resid else "f32"
        )
        if old_kind != "none" and new_kind == "none":
            log.warning("frescore_dropped_on_growth", rows=need_rows)
            if self._host_ingest_only:
                # host-fed store: back-fill the host cache before dropping
                # the f32 mirror so exactness survives the transition
                host = self.hydrate_host()
                cache = np.zeros((self._meta_cap, self.dim), dtype=np.float32)
                cache[: host.shape[0]] = host
                self._host_cache = cache
        # growth moves the shard boundaries: ``grow`` passes rows between
        # shards
        if old_kind == "f32" and new_kind == "f32":
            frescore = mir.frescore.grow(mcap)
        elif old_kind == "residual" and new_kind in ("residual", "f32"):
            # an existing residual never upgrades to f32 on growth (the
            # dropped bits are gone); pad it
            frescore = (mir.frescore[0].grow(mcap), mir.frescore[1].grow(mcap))
        elif old_kind == "f32" and new_kind == "residual":
            # downgrade across the memory budget: requantize the residual
            # FROM the f32 mirror on the device, then free the mirror
            log.info("frescore_downgraded_to_residual", rows=need_rows)
            rq, rs = mir.frescore.map(
                lambda f, v, s: quantize_residual_device(f, v.to(torch.float32), s),
                mir.fvecs, mir.fscales,
            )
            frescore = (rq.grow(mcap), rs.grow(mcap))
        else:
            frescore = None
        grown = ExactRows(
            fvecs=mir.fvecs.grow(mcap),
            fvalid=mir.fvalid.grow(mcap),
            fnorms=mir.fnorms.grow(mcap),
            fscales=mir.fscales.grow(mcap),
            frescore=frescore,
            ftags=mir.ftags.grow(mcap),
        )
        self._mir = grown
        self._mirror_cap = mcap
        # the padded cluster layout is untouched by mirror growth; refresh
        # the reader snapshot so searches see the grown mirror
        if self._dev is not None and not self._dirty:
            self._dev = self._dev._replace(**grown._asdict())

    def _ingest_rows(self, x, rows: np.ndarray, tags: np.ndarray) -> None:
        """Scatter new/updated rows into the device mirror (chunked).

        ``x``: (n, dim) f32 numpy array or device tensor, NOT yet
        metric-normalized. Quantization/normalization run on the device,
        for the rows this process's shards own."""
        mir = self._mir
        n = rows.shape[0]
        cache = self._host_cache
        if isinstance(x, torch.Tensor):
            self._host_ingest_only = False
        # exclusive bulk build with no reader snapshot: scatter in place
        # instead of copying the whole mirror per chunk
        inplace = self._bulk and self._dev is None
        for lo in range(0, n, _CHUNK_ROWS):
            hi = min(lo + _CHUNK_ROWS, n)
            xc = x[lo:hi]
            rc = rows[lo:hi].astype(np.int64)
            tc = np.asarray(tags[lo:hi], dtype=np.int32)
            mine = mir.fvecs.mine(rc)
            if mine.any():
                xd = xc
                if not mine.all():  # rows another process owns are its own
                    sel = np.flatnonzero(mine)
                    xd = (xd[torch.from_numpy(sel).to(xd.device)]
                          if isinstance(xd, torch.Tensor) else xd[sel])
                    rc, tc = rc[sel], tc[sel]
                xd = xd if isinstance(xd, torch.Tensor) else self._to_dev(xd)
                mir = self._write_mirror(mir, xd, rc, tc, inplace)
                self._mir = mir
            if cache is not None:
                if isinstance(xc, torch.Tensor):
                    # fetching every device chunk back to the host would undo
                    # the device-authoritative build; drop the cache and
                    # hydrate on demand if persistence needs it
                    log.warning("host_cache_dropped_for_device_ingest")
                    self._host_cache = cache = None
                elif self.metric == "cosine":
                    # normalize on host rather than fetching the device copy
                    cache[rows[lo:hi]] = xc / np.maximum(
                        np.linalg.norm(xc, axis=1, keepdims=True), 1e-12
                    )
                else:
                    cache[rows[lo:hi]] = xc

    def _write_mirror(self, mir: ExactRows, xd: torch.Tensor, rows: np.ndarray,
                      tags: np.ndarray, inplace: bool) -> ExactRows:
        """Quantize rows ``xd`` (f32, not yet metric-normalized) and write
        them to mirror rows ``rows`` of their owner shards."""
        at = mir.fvecs.route(rows)  # one upload of the indices for all fields
        tags_d = self._to_dev(tags)
        xd = xd.to(torch.float32)
        if self.metric == "cosine":
            xd = _normalize_rows(xd)
        nrm = _row_norms(xd)
        fscales = mir.fscales
        if self._dtype == torch.int8:
            qx, scl = quantize_rows_device(xd)
            fvecs = mir.fvecs.set_rows(at, qx, inplace=inplace)
            fscales = mir.fscales.set_rows(at, scl, inplace=inplace)
        else:
            fvecs = mir.fvecs.set_rows(at, xd, inplace=inplace)
        fvalid = mir.fvalid.fill_rows(at, True, inplace=inplace)
        fnorms = mir.fnorms.set_rows(at, nrm, inplace=inplace)
        frescore = mir.frescore
        if isinstance(frescore, tuple):
            rq, rs = quantize_residual_device(xd, qx, scl)
            frescore = (frescore[0].set_rows(at, rq, inplace=inplace),
                        frescore[1].set_rows(at, rs, inplace=inplace))
        elif frescore is not None:
            frescore = frescore.set_rows(at, xd, inplace=inplace)
        ftags = mir.ftags.set_rows(at, tags_d, inplace=inplace)
        return ExactRows(fvecs, fnorms, fvalid, fscales, frescore, ftags)

    def _f32_chunk(self, rows: np.ndarray) -> torch.Tensor:
        """Gather f32(-grade) rows from the mirror by row id (int numpy) onto
        the home device, from whichever shards hold them (in a
        multi-process run every process calls it with the same rows). With
        the residual mirror the reconstruction carries ~16 bits of
        mantissa — exact enough for k-means samples, host rescores and
        persistence round trips."""
        mir = self._mir
        rows = mir.fvecs._route(rows)  # every mirror field has its row count
        if isinstance(mir.frescore, tuple):
            return (
                mir.fvecs.take(rows).to(torch.float32)
                * mir.fscales.take(rows)[:, None]
                + mir.frescore[0].take(rows).to(torch.float32)
                * mir.frescore[1].take(rows)[:, None]
            )
        if mir.frescore is not None:
            return mir.frescore.take(rows)
        if self._dtype == torch.int8:
            return (mir.fvecs.take(rows).to(torch.float32)
                    * mir.fscales.take(rows)[:, None])
        return mir.fvecs.take(rows).to(torch.float32)

    def gather_f32(self, rows: np.ndarray):
        """Exact f32 values for the given row ids, host-side, gathering ONLY
        those rows. Returns ``(vals, ok)`` where ``ok`` marks in-bounds ids
        (stale ids racing a compaction are masked, not dereferenced)."""
        rows = np.asarray(rows, dtype=np.int64)
        ok = (rows >= 0) & (rows < self._n_rows)
        safe = np.where(ok, rows, 0)
        if self._host_cache is not None:
            return self._host_cache[safe], ok
        if self._mir is None or self._n_rows == 0:
            return np.zeros((rows.shape[0], self.dim), dtype=np.float32), ok
        out = np.empty((rows.shape[0], self.dim), dtype=np.float32)
        for lo in range(0, rows.shape[0], _CHUNK_ROWS):
            hi = min(lo + _CHUNK_ROWS, rows.shape[0])
            out[lo:hi] = self._f32_chunk(safe[lo:hi]).cpu().numpy()
        return out, ok

    def _topm_rows(self, rows: np.ndarray, m: int) -> np.ndarray:
        """Per-row m nearest clusters, computed on the device from the mirror."""
        cent = self._to_dev(np.asarray(self.centroids, dtype=np.float32))
        out = np.empty((rows.shape[0], m), dtype=np.int32)
        for lo in range(0, rows.shape[0], _CHUNK_ROWS):
            hi = min(lo + _CHUNK_ROWS, rows.shape[0])
            xd = self._f32_chunk(rows[lo:hi])
            out[lo:hi] = topm_step(xd, cent, m).cpu().numpy()
        return out

    # -- build -------------------------------------------------------------------

    def train(self, x: Optional[np.ndarray] = None) -> None:
        """Train the coarse quantizer (on provided sample or current rows)."""
        with tracing.phase("ivf.build.kmeans"):
            if x is not None:
                x = self._check_vectors(x, device_ok=False)
                if self.metric == "cosine":
                    x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
                sample_dev = self._to_dev(x)
            else:
                live = np.flatnonzero(self._alive[: self._n_rows])
                if live.size == 0:
                    raise ValueError("cannot train IVF on an empty corpus")
                max_train = self.nlist * TRAIN_POINTS_PER_CENTROID
                if live.size > max_train:
                    rng = np.random.default_rng(self.seed)
                    live = rng.choice(live, size=max_train, replace=False)
                sample_dev = self._f32_chunk(live)
            if sample_dev.shape[0] == 0:
                raise ValueError("cannot train IVF on an empty corpus")
            self.centroids = kmeans_fit_dev(
                sample_dev, self.nlist, iters=self.kmeans_iters, seed=self.seed
            )

    @contextmanager
    def bulk(self, expected_rows: Optional[int] = None):
        """Deferred-materialization ingest for large streamed builds.

        Inside the block, ``add()`` only uploads rows into the device mirror;
        training, cluster placement and the padded-layout materialization all
        happen ONCE when the block exits. ``expected_rows`` pre-sizes the
        mirror exactly so chunked adds never trigger a grow-copy.

        Searching inside the block serves the pre-bulk snapshot if one
        exists; on a fresh index it raises. Not for concurrent use: callers
        hold the store write lock or own the index outright."""
        if self._bulk:
            raise RuntimeError("bulk() blocks do not nest")
        if expected_rows is not None and expected_rows > 0:
            self._extend_meta_capacity(expected_rows)
            self._ensure_mirror(max(expected_rows, 1), exact=True)
        self._bulk = True
        try:
            yield self
        finally:
            self._bulk = False
            if self._n_rows > 0:
                if not self.is_trained:
                    self.train()
                self._rebuild_layout()
                self._materialize()

    def add(self, x, tags=None) -> np.ndarray:
        """Append rows; trains the quantizer on first call. Returns row ids.

        ``x`` may be a numpy array or a torch tensor (a corpus generated on
        the device needs no host round trip). ``tags`` (optional int32 per
        row, >= 0) enable device-side filtered search on the exact path;
        None = tag 0."""
        with tracing.phase("ivf.add"):
            x = self._check_vectors(x)
            if x.shape[0] == 0:
                return np.zeros((0,), dtype=np.int64)
            n = x.shape[0]
            if tags is None:
                tags = np.zeros((n,), dtype=np.int32)
            else:
                tags = np.asarray(tags, dtype=np.int32).ravel()
                if tags.shape[0] != n:
                    raise ValueError(f"expected {n} tags, got {tags.shape[0]}")
            if self._use_pending(n):
                return self._add_pending(x, tags)
            rows = self._extend_meta(n, tags)
            self._ensure_mirror(self._n_rows)
            self._ingest_rows(x, rows, tags)
            if self._bulk:
                # layout/materialization deferred to bulk() exit; the mirror is
                # authoritative so nothing is lost if the block exits early
                self._dirty = True
                return rows
            if not self.is_trained:
                self.train()
                self._rebuild_layout()
                self._materialize()
                return rows
            if self.cmax == 0:
                self._rebuild_layout()
                self._materialize()
                return rows
            self._stream_place(rows)
            return rows

    def _stream_place(self, rows: np.ndarray) -> None:
        """Streaming placement: nearest candidate cluster with a free slot;
        a full layout rebuild when every candidate cluster is full."""
        cands = self._topm_rows(rows, m=min(4, self.nlist))
        assign = np.empty(len(rows), dtype=np.int32)
        counts = self._counts.copy()
        overflow = False
        for i, row_cands in enumerate(cands):
            for c in row_cands:
                if counts[c] < self.cmax:
                    assign[i] = c
                    counts[c] += 1
                    break
            else:
                overflow = True
                break
        if overflow:
            self._rebuild_layout()
        else:
            self._place_rows(rows, assign)
        if self._dirty:
            self._materialize()  # eager: readers never materialize dirty state

    # -- pending tail (streaming inserts past the memory threshold) --------------

    # streaming adds scatter copy-on-write into the authoritative mirror; past
    # this footprint inserts land in a small exact-scanned side buffer merged
    # into every search instead (the reference's constants, kept as they are)
    PENDING_THRESHOLD_BYTES = 2 << 30
    PENDING_CAP = 8192

    def _scatter_copy_bytes(self) -> int:
        """Transient bytes a copy-on-write mirror scatter materializes, over
        all shards (every process decides alike)."""
        mir = self._mir
        if mir is None:
            return 0
        resc = mir.frescore[0] if isinstance(mir.frescore, tuple) else mir.frescore
        return sum(math.prod(t.shape) * t.dtype.itemsize
                   for t in (mir.fvecs, resc) if t is not None)

    def _use_pending(self, n: int) -> bool:
        return (
            not self._bulk
            and self.is_trained
            and self.cmax > 0
            and n <= self.PENDING_CAP
            and self._scatter_copy_bytes() > self.PENDING_THRESHOLD_BYTES
        )

    def _add_pending(self, x, tags: np.ndarray) -> np.ndarray:
        n = x.shape[0]
        pend = self._pend
        used = 0 if pend is None else pend[3]
        if used + n > self.PENDING_CAP:
            # fold the tail into the main layout (one big scatter, the cost
            # this path amortizes PENDING_CAP rows deep)
            self._fold_pending()
            used = 0
        rows = self._extend_meta(n, tags)
        xd = (x if isinstance(x, torch.Tensor) else self._to_dev(x)).to(torch.float32)
        if self._pend is None:
            cap, d = self.PENDING_CAP, self.dim
            self._pend = (
                self._zeros((cap, d), torch.float32),
                torch.full((cap,), -1, dtype=torch.int32, device=self.device),
                self._zeros((cap,), torch.int32),
                0,
            )
            used = 0
        vecs, pids, ptags, _ = self._pend
        idx = torch.arange(used, used + n, device=self.device)
        self._pend = (
            _set(vecs, idx, xd),
            _set(pids, idx, self._to_dev(rows.astype(np.int32))),
            _set(ptags, idx, self._to_dev(tags)),
            used + n,
        )
        self._host_ingest_only = self._host_ingest_only and not isinstance(
            x, torch.Tensor
        )
        return rows

    def _fold_pending(self, place: bool = True) -> None:
        """Scatter the pending tail into the authoritative mirror (+ layout
        placement unless the caller is about to rebuild the layout anyway)."""
        pend = self._pend
        self._pend = None
        if pend is None or pend[3] == 0:
            return
        vecs, pids, ptags, n = pend
        pid_np = pids[:n].cpu().numpy()
        mask = pid_np >= 0  # tombstoned-in-pending rows drop here
        if not mask.any():
            return
        rows = pid_np[mask].astype(np.int64)
        keep = self._to_dev(np.flatnonzero(mask).astype(np.int64))
        self._ensure_mirror(self._n_rows)
        self._ingest_rows(vecs[keep], rows, ptags[:n].cpu().numpy()[mask])
        if place:
            self._stream_place(rows)

    def _merge_pending_into(self, scores, ids, q_dev, allow_tags=None):
        """Chain the pending-tail exact scan onto in-flight (scores, ids);
        with a leading batch dimension (``q_dev`` (B, Q, dim)) batch by
        batch."""
        pend = self._pend
        if pend is None or pend[3] == 0:
            return scores, ids
        vecs, pids, ptags, _ = pend
        with tracing.span("ivf.pending"):
            allow = allow_device(allow_tags, self.device)

            def merge(s, i, q):
                return _pending_merge(s, i, q, vecs, pids, ptags, self.metric,
                                      allow)

            if q_dev.dim() == 3:
                return _stacked(merge(*b) for b in zip(scores, ids, q_dev))
            return merge(scores, ids, q_dev)

    def remove(self, rows: np.ndarray) -> None:
        """Tombstone rows (device slots masked via ids == -1)."""
        rows = np.asarray(rows, dtype=np.int64)
        rows = rows[self._alive[rows]]
        if rows.size == 0:
            return
        self._alive[rows] = False
        self.size -= int(rows.size)
        locs = self._loc[rows]
        placed = locs[:, 0] >= 0
        rows_d = self._to_dev(rows)
        pend = self._pend
        if pend is not None and pend[3] > 0:
            vecs, pids, ptags, n_used = pend
            hit = torch.isin(pids, rows_d.to(torch.int32))
            self._pend = (vecs, torch.where(hit, -1, pids), ptags, n_used)
        if self._mir is not None:
            self._mir = self._mir._replace(
                fvalid=self._mir.fvalid.fill_rows(rows, False))
        dev = self._dev
        if not self._dirty and dev is not None:
            new = dev._replace(fvalid=self._mir.fvalid)
            if placed.any():
                new = new._replace(ids=new.ids.fill_rows(
                    locs[placed, 0], -1, cols=locs[placed, 1]))
            self._dev = new

    def _pack(self, data, ids, sqnorms, scales, mir, rows, c, s,
              inplace: bool):
        """Scatter mirror rows ``rows`` into slots ``(c, s)`` of the padded
        cluster layout (int numpy): the rows come from whichever shards
        hold them (``take``) and go to the shards that own their
        clusters."""
        src = mir.fvecs.route(rows)  # each side's indices uploaded once
        dst = data.route(c, s)
        row_ids = self._to_dev(rows.astype(np.int32))
        data = data.set_rows(dst, mir.fvecs.take(src), inplace=inplace)
        ids = ids.set_rows(dst, row_ids, inplace=inplace)
        sqnorms = sqnorms.set_rows(dst, mir.fnorms.take(src), inplace=inplace)
        if scales is not None:
            scales = scales.set_rows(dst, mir.fscales.take(src), inplace=inplace)
        return data, ids, sqnorms, scales

    def _place_rows(self, rows: np.ndarray, assign: np.ndarray) -> None:
        """Assign slots for new rows and scatter them into the device layout."""
        # vectorized slot assignment: rows headed to the same cluster take
        # consecutive slots starting at the cluster's current count
        order = np.argsort(assign, kind="stable")
        sorted_assign = assign[order]
        group_start = np.zeros(len(order), dtype=np.int64)
        new_group = np.flatnonzero(np.diff(sorted_assign)) + 1
        group_start[new_group] = new_group
        np.maximum.accumulate(group_start, out=group_start)
        rank_in_group = np.arange(len(order), dtype=np.int64) - group_start
        slots = np.empty(len(assign), dtype=self._counts.dtype)
        slots[order] = self._counts[sorted_assign] + rank_in_group
        np.add.at(self._counts, assign, 1)
        self._assign[rows] = assign
        self._loc[rows, 0] = assign
        self._loc[rows, 1] = slots
        dev = self._dev
        if self._dirty or dev is None:
            return
        mir = self._mir
        data, ids, sqnorms, scales = self._pack(
            dev.data, dev.ids, dev.sqnorms, dev.scales, mir,
            rows.astype(np.int64), assign.astype(np.int64),
            slots.astype(np.int64), inplace=False,
        )
        self._dev = dev._replace(data=data, ids=ids, sqnorms=sqnorms,
                                 scales=scales, **mir._asdict())

    def _rebuild_layout(self) -> None:
        """Re-pack live rows into capacity-padded cluster blocks.

        Assignment is capacity-balanced: clusters are capped near the mean
        occupancy and excess points spill to their next-nearest cluster, so
        the padded layout stays dense (bounded cmax = bounded scan traffic)
        even on skewed corpora. Candidate clusters are scored on the device;
        only the (N, m) int32 candidate table and the O(N) greedy assignment
        run on the host."""
        tracing.count("ivf.layout_rebuild")
        with tracing.phase("ivf.build.layout"):
            # pending rows live only in the side buffer; the re-pack below reads
            # every live row from the mirror, so fold first (no placement)
            self._fold_pending(place=False)
            live = np.flatnonzero(self._alive[: self._n_rows])
            mean = max(1.0, live.size / self.nlist)
            cap = max(8, int(np.ceil(mean * self.balance_cap)))
            # m=8 spill candidates: enough fallthrough that the cap holds
            with tracing.phase("ivf.build.layout.candidates"):
                cands = self._topm_rows(live, m=min(8, self.nlist))
            with tracing.phase("ivf.build.layout.assign"):
                assign = balanced_assign(cands, self.nlist, cap)
            self._assign[live] = assign
            counts = np.bincount(assign, minlength=self.nlist).astype(np.int32)
            # headroom so streaming inserts don't immediately re-trigger a
            # rebuild; the probing kernel needs 128-aligned cluster blocks
            slot_align = 128 if self._pallas_eligible() else 8
            self.cmax = max(
                slot_align, round_up(int(counts.max() * 1.1) + 8, slot_align)
            )
            order = np.argsort(assign, kind="stable")
            sorted_rows = live[order]
            sorted_assign = assign[order]
            starts = np.zeros(self.nlist + 1, dtype=np.int64)
            np.cumsum(counts, out=starts[1:])
            slots = np.arange(len(order), dtype=np.int64) - starts[sorted_assign]
            self._loc[sorted_rows, 0] = sorted_assign
            self._loc[sorted_rows, 1] = slots.astype(np.int32)
            self._counts = counts
            self._dirty = True
            log.info(
                "ivf_layout_rebuilt",
                nlist=self.nlist,
                cmax=self.cmax,
                rows=int(live.size),
                fill=float(live.size / max(self.nlist * self.cmax, 1)),
            )

    def _materialize(self) -> tuple:
        """(Re)build the padded cluster layout from the device mirror. All
        vector bytes move device to device; the host contributes only the
        int32 location table and the liveness/tag refresh."""
        with tracing.phase("ivf.build.pack"):
            self._ensure_mirror(max(self._n_rows, 1))
            mir = self._mir
            # refresh liveness/tags from the host authority (covers external
            # _tags writes, e.g. store.load re-deriving tags)
            mcap = self._mirror_cap
            fvalid_h = np.zeros((mcap,), dtype=bool)
            fvalid_h[: self._n_rows] = self._alive[: self._n_rows]
            ftags_h = np.zeros((mcap,), dtype=np.int32)
            ftags_h[: self._n_rows] = self._tags[: self._n_rows]
            mir = mir._replace(fvalid=ShardedRows.from_host(self.mesh, fvalid_h),
                               ftags=ShardedRows.from_host(self.mesh, ftags_h))
            self._mir = mir

            live = np.flatnonzero(self._alive[: self._n_rows])
            c_all = self._loc[live, 0].astype(np.int64)
            s_all = self._loc[live, 1].astype(np.int64)
            # the layout splits by cluster: nlist_s clusters a shard
            data = self._sharded(self.nlist, (self.cmax, self.dim), self._dtype)
            ids = self._sharded(self.nlist, (self.cmax,), torch.int32, -1)
            sqnorms = self._sharded(self.nlist, (self.cmax,), torch.float32)
            scales = (self._sharded(self.nlist, (self.cmax,), torch.float32)
                      if self._dtype == torch.int8 else None)
            # chunk so the transient (chunk, dim) gather stays bounded at high dim
            chunk = max(8192, min(_CHUNK_ROWS, (256 << 20) // max(self.dim * 4, 1)))
            for lo in range(0, live.size, chunk):
                hi = min(lo + chunk, live.size)
                # fresh tensors no reader has seen: pack in place
                data, ids, sqnorms, scales = self._pack(
                    data, ids, sqnorms, scales, mir, live[lo:hi].astype(np.int64),
                    c_all[lo:hi], s_all[lo:hi], inplace=True,
                )
            dev = _Dev(
                data=data,
                ids=ids,
                sqnorms=sqnorms,
                scales=scales,
                centroids=self._to_dev(np.asarray(self.centroids, dtype=np.float32)),
                **mir._asdict(),
            )
            self._dev = dev  # single atomic swap
            self._dirty = False
            return dev

    @property
    def device_rescore_active(self) -> bool:
        """True when exact-path searches already return exact-grade rescored
        results (f32 mirror or two-level int8 residual), so the store skips
        its host-side rescore."""
        mir = self._mir
        if mir is not None:
            return mir.frescore is not None
        return self._route.rescore_kind(max(self._n_rows, 1)) != "none"

    def _ensure_device(self) -> tuple:
        """Reader-side snapshot. Materialization is a writer responsibility
        (writers call it eagerly after layout rebuilds); a stale-but-
        consistent snapshot is always safe to search."""
        dev = self._dev
        if dev is None:
            if self._bulk:
                raise RuntimeError(
                    "index is inside a bulk() ingest and has no materialized "
                    "snapshot yet; finish the bulk block before searching"
                )
            dev = self._materialize()
        return dev

    # -- search ------------------------------------------------------------------

    def _pallas_eligible(self) -> bool:
        if self.use_pallas == "never":
            return False
        return self.metric in ("ip", "cosine") and self.dim % 128 == 0

    def _storage_name(self) -> str:
        return storage_name(self._dtype)

    @property
    def rows_allocated(self) -> int:
        """Upper bound (exclusive) of valid row ids, tombstoned rows
        included (``size`` counts live rows only)."""
        return self._n_rows

    def _pallas_mode(self) -> str:
        """'off' | 'compiled' | 'plain': the probing kernel on a CUDA device,
        its plain version on the CPU when asked for (``use_pallas="always"``,
        as the reference's Pallas interpret mode), or the gather-scan route."""
        if not self._pallas_eligible() or self.cmax % 128 != 0:
            return "off"
        if self.device.type == "cuda":
            return "compiled"
        return "plain" if self.use_pallas == "always" else "off"

    # Per-row fixed overhead of the probing path in dim-equivalent bytes, as
    # the reference calibrated it on its own hardware (ivf.py:1088-1097).
    # Kept unchanged so _pick_mode makes the reference's decision for the
    # same layout; recalibrating it for this card is separate work.
    _PROBE_ROW_OVERHEAD = 1536.0

    def _pick_mode(self, n_q_padded: int, nprobe: int, k: int) -> str:
        """Cost-based scan selection: probing reads each probed cluster once
        per batch, U * cmax * (dim + overhead) bytes with U the expected
        number of distinct probed clusters; the exact path reads the flat
        mirror once, N * dim bytes. Probing wins on wide rows at small batch
        and loses at large batch (the union saturates toward nlist)."""
        if nprobe >= self.nlist:
            return "exact"
        draws = n_q_padded * nprobe
        u_expect = self.nlist * (1.0 - (1.0 - 1.0 / self.nlist) ** draws)
        ivf_bytes = u_expect * self.cmax * (self.dim + self._PROBE_ROW_OVERHEAD)
        scan_rows = self._mirror_cap or (self.nlist * self.cmax)
        if scan_rows * self.dim <= ivf_bytes:
            return "exact"
        return "ivf"

    def _probe(self, dev, q_dev, k, np_probe):
        """Probing path + merged exact rescore; returns (scores, ids) with
        ``k_eff`` columns."""
        rows_total = dev.data.shape[0] * dev.data.shape[1]
        # with a rescore mirror, over-fetch candidates so the exact rescore
        # can recover int8-ranking misses (64 keeps the kernel eligible)
        fetch = max(4 * k, 64) if dev.frescore is not None else k
        # the per-shard width is capped by a shard's rows; the merged pool
        # holds n_shards * k_shard candidates
        k_shard = min(fetch, dev.data.shape[1] * np_probe,
                      rows_total // self.n_shards)
        k_eff = min(k, k_shard * self.n_shards)
        scores, ids = _ivf_search(
            self.mesh, dev.data, dev.ids, dev.sqnorms,
            dev.scales if dev.scales is not None else dev.sqnorms,
            dev.centroids, q_dev, k_shard, np_probe, self.metric,
            self._pallas_mode(), self._dtype == torch.int8,
            min(fetch, k_shard * self.n_shards),
        )
        scores, ids = self._rescore_merged(dev, q_dev, scores, ids)
        return scores[:, :k_eff], ids[:, :k_eff]

    def _search(self, q_dev, k: int, nprobe: Optional[int], mode: str,
                allow_tags, *, merged: bool = False, batched: bool = False):
        """The routed search under all three entries: the snapshot, the route
        (tags force the exact one; auto asks ``_pick_mode``), its counter and
        span, the scan, then the pending tail. ``q_dev``: (Q, dim), or (B, Q,
        dim) when ``batched``, metric-normalized on this index's device;
        ``merged`` as ``ExactRoute.scan``. Returns device (scores, ids)."""
        dev = self._ensure_device()
        np_probe = min(nprobe or self.nprobe, dev.data.shape[0])
        if allow_tags is not None:
            # tag masking lives on the flat mirror; the probing layout is
            # cluster-addressed and unfiltered, so filtered searches take
            # the exact path
            mode = "exact"
        if mode == "auto":
            mode = self._pick_mode(pad_bucket(q_dev.shape[-2]), np_probe, k)
        if mode == "exact":
            tracing.count("ivf.route.exact")
            with tracing.span("ivf.exact"):
                scores, ids = self._route.scan(self.mesh, dev, q_dev, k, allow_tags,
                                               merged=merged, batched=batched)
        else:
            tracing.count("ivf.route.probe")
            with tracing.span("ivf.probe"):
                if batched:
                    scores, ids = _stacked(self._probe(dev, q, k, np_probe)
                                           for q in q_dev)
                else:
                    scores, ids = self._probe(dev, q_dev, k, np_probe)
        return self._merge_pending_into(scores, ids, q_dev, allow_tags)

    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        nprobe: Optional[int] = None,
        mode: str = "auto",  # auto | ivf | exact
        allow_tags=None,  # device-side filter: forces the exact path
    ) -> Tuple[np.ndarray, np.ndarray]:
        q = np.ascontiguousarray(np.atleast_2d(queries), dtype=np.float32)
        if q.shape[1] != self.dim:
            raise ValueError(f"expected queries of dim {self.dim}, got {q.shape}")
        n_q = q.shape[0]
        if self.size == 0 or not self.is_trained:
            if self._bulk and self.size > 0:
                raise RuntimeError(
                    "index is inside a bulk() ingest with no materialized "
                    "snapshot; finish the bulk block before searching"
                )
            return (
                np.full((n_q, k), _NEG_INF, dtype=np.float32),
                np.full((n_q, k), -1, dtype=np.int64),
            )
        if self.metric == "cosine":
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        with tracing.span("ivf.search"):
            scores, ids = self._search(self._to_dev(q), k, nprobe, mode,
                                       allow_tags, merged=True)
            scores = scores.cpu().numpy().astype(np.float32)
            ids = ids.cpu().numpy().astype(np.int64)
        k_eff = scores.shape[1]
        bad = (ids < 0) | (scores <= _NEG_INF / 2)
        scores = np.where(bad, _NEG_INF, scores)
        ids = np.where(bad, -1, ids)
        if k_eff < k:
            scores = np.pad(scores, ((0, 0), (0, k - k_eff)), constant_values=_NEG_INF)
            ids = np.pad(ids, ((0, 0), (0, k - k_eff)), constant_values=-1)
        return scores, ids

    def _rescore_merged(self, dev, q_dev, scores, ids):
        """Post-merge exact re-ranking of probing-path candidates via the
        f32 mirror or the two-level int8 residual; no-op without a device
        rescore tier."""
        if dev.frescore is None:
            return scores, ids
        with tracing.span("ivf.rescore"):
            if isinstance(dev.frescore, tuple):
                exact = rescore_global_residual(
                    self.mesh, dev.fvecs, dev.fscales, dev.frescore[0],
                    dev.frescore[1], dev.fnorms, q_dev, ids, self.metric,
                )
            else:
                exact = rescore_global(self.mesh, dev.frescore, dev.fnorms,
                                       q_dev, ids, self.metric)
            return _resort(exact, ids)

    def search_device(
        self, q_dev, k: int, nprobe: Optional[int] = None, mode: str = "auto",
        allow_tags=None,
    ):
        """Device-to-device IVF search (see FlatIndex.search_device):
        ``q_dev`` (Q, dim) metric-normalized on this index's device; returns
        device tensors (scores, ids)."""
        with tracing.span("ivf.search"):
            return self._search(q_dev, k, nprobe, mode, allow_tags)

    def search_device_batched(
        self, qs_dev, k: int, allow_tags=None, mode: str = "exact",
        nprobe: Optional[int] = None,
    ):
        """Search over B query batches: ``qs_dev`` (B, Q, dim) metric-
        normalized. ``mode``: "exact" scans the flat mirror; "probe" runs the
        nprobe cluster-scan path (the reference chains B batches into one
        dispatch; here it is a loop). Returns (scores (B, Q, k), ids)."""
        if mode not in ("exact", "probe"):
            raise ValueError(
                f"search_device_batched mode must be 'exact' or 'probe', "
                f"got {mode!r} (no 'auto' here: the chained launch commits "
                f"all B batches to one path)"
            )
        with tracing.span("ivf.search"):
            return self._search(qs_dev, k, nprobe, mode, allow_tags,
                                batched=True)

    # -- maintenance / persistence -------------------------------------------------

    def retrain(self) -> None:
        """Re-train the quantizer on the live corpus and re-pack the layout."""
        self.train()
        self._rebuild_layout()
        self._materialize()

    def _like(self) -> "IVFIndex":
        return IVFIndex(
            self.dim,
            nlist=self.nlist,
            nprobe=self.nprobe,
            metric=self.metric,
            dtype=self._storage_name(),
            kmeans_iters=self.kmeans_iters,
            seed=self.seed,
            use_pallas=self.use_pallas,
            balance_cap=self.balance_cap,
            device_rescore=self.device_rescore,
            score_dtype=self.score_dtype,
            fetch_width=self.fetch_width,
            scan_impl=self.scan_impl,
            rescore_mode=self.rescore_mode,
            rescore_width=self.rescore_width,
            mesh=self.mesh,
        )

    def compacted(self) -> Tuple["IVFIndex", np.ndarray]:
        """Build a NEW index holding only the live rows, renumbered densely.

        Returns (new_index, remap) where remap maps old row -> new row (-1
        for dropped rows). The caller (store.compact) installs the new index
        and freshly-built row maps in ONE view swap."""
        # the gather below reads every live row from the mirror; fold the
        # pending tail in first (writer-side mutation, same lock)
        self._fold_pending()
        live = np.flatnonzero(self._alive[: self._n_rows])
        remap = np.full(self._n_rows, -1, dtype=np.int64)
        remap[live] = np.arange(live.size)
        new = self._like()
        new.centroids = None if self.centroids is None else self.centroids.copy()
        n = int(live.size)
        if n == 0:
            return new, remap
        new_rows = new._extend_meta(n, self._tags[live])
        new._ensure_mirror(n)
        # device-to-device renumbering gather into the new (unread) mirror:
        # a row's old and new positions may sit on different shards
        mir, nm = self._mir, new._mir
        cache = new._host_cache
        for lo in range(0, n, _CHUNK_ROWS):
            hi = min(lo + _CHUNK_ROWS, n)
            src_ids = live[lo:hi].astype(np.int64)
            src, dst = mir.fvecs.route(src_ids), nm.fvecs.route(new_rows[lo:hi])
            fvecs = nm.fvecs.set_rows(dst, mir.fvecs.take(src), inplace=True)
            fvalid = nm.fvalid.fill_rows(dst, True, inplace=True)
            fnorms = nm.fnorms.set_rows(dst, mir.fnorms.take(src), inplace=True)
            fscales = nm.fscales.set_rows(dst, mir.fscales.take(src), inplace=True)
            frescore = nm.frescore
            if frescore is not None and mir.frescore is not None:
                old_resid = isinstance(mir.frescore, tuple)
                if isinstance(frescore, tuple):
                    if old_resid:
                        rq, rs = (mir.frescore[0].take(src),
                                  mir.frescore[1].take(src))
                    else:  # auto-kind flip across the rebuild: re-derive
                        rq, rs = quantize_residual_device(
                            mir.frescore.take(src),
                            mir.fvecs.take(src).to(torch.float32),
                            mir.fscales.take(src),
                        )
                    frescore = (frescore[0].set_rows(dst, rq, inplace=True),
                                frescore[1].set_rows(dst, rs, inplace=True))
                else:
                    frescore = frescore.set_rows(dst, self._f32_chunk(src),
                                                 inplace=True)
            ftags = nm.ftags.set_rows(dst, self._to_dev(self._tags[src_ids]),
                                      inplace=True)
            nm = ExactRows(fvecs, fnorms, fvalid, fscales, frescore, ftags)
            if cache is not None:
                if self._host_cache is not None:
                    cache[lo:hi] = self._host_cache[live[lo:hi]]
                else:
                    cache[lo:hi] = self._f32_chunk(src).cpu().numpy()
        new._mir = nm
        if not new.is_trained:
            new.train()
        new._rebuild_layout()
        new._materialize()
        return new, remap

    def compact(self) -> np.ndarray:
        """Drop tombstoned rows and re-pack IN PLACE (legacy surface).

        Builds the compacted index as a new object and adopts its state, so
        readers holding the previous snapshot keep a consistent corpus.
        Returns the remap array (old row -> new row, -1 for dropped rows)."""
        new, remap = self.compacted()
        for name in (
            "size", "_n_rows", "_meta_cap", "_assign", "_loc", "_alive",
            "_tags", "centroids", "_counts", "cmax", "_mir", "_dirty",
            "_host_cache", "_mirror_cap", "_pend",
        ):
            setattr(self, name, getattr(new, name))
        self._dev = new._dev  # last: readers swap to the new snapshot whole
        return remap

    def state_dict(self) -> dict:
        """Same keys and dtypes as the reference's ``IVFIndex.state_dict``."""
        # the host hydration below reads the mirror; pending-tail rows live
        # only in the side buffer until folded
        self._fold_pending()
        live = np.flatnonzero(self._alive[: self._n_rows])
        host = self._host
        return {
            "kind": self.kind,
            "dim": self.dim,
            "metric": self.metric,
            "nlist": self.nlist,
            "nprobe": self.nprobe,
            "centroids": None if self.centroids is None else self.centroids.copy(),
            "vectors": host[live].copy(),
            "assignments": self._assign[live].copy(),
            "rows": live.copy(),
            "tags": self._tags[live].copy(),
        }

    @classmethod
    def from_state(cls, state: dict, **kwargs) -> "IVFIndex":
        """Rebuild from a state dict: the saved vectors are re-added under
        the saved centroids (rows renumber densely in saved order)."""
        idx = cls(
            int(state["dim"]),
            nlist=int(state["nlist"]),
            nprobe=int(state["nprobe"]),
            metric=str(state["metric"]),
            **kwargs,
        )
        vecs = np.asarray(state["vectors"], dtype=np.float32)
        if state.get("centroids") is not None:
            idx.centroids = np.asarray(state["centroids"], dtype=np.float32)
        if vecs.size:
            tags = state.get("tags")
            tags = (
                np.asarray(tags, dtype=np.int32)
                if tags is not None
                else np.zeros((vecs.shape[0],), dtype=np.int32)
            )
            # saved vectors are already metric-normalized; add() would
            # re-normalize (a no-op for unit rows) on the device
            idx.add(vecs, tags=tags)
        return idx


def _stacked(pairs):
    """Per-batch (scores, ids) pairs stacked into (B, Q, k) tensors."""
    pairs = list(pairs)
    return (torch.stack([p[0] for p in pairs]),
            torch.stack([p[1] for p in pairs]))


def _resort(scores, ids):
    """Order (scores, ids) by descending score, ties to the lower position."""
    s, pos = stable_topk(scores, scores.shape[1])
    return s, torch.gather(ids, 1, pos)


def _pending_merge(scores, ids, q, pvecs, pids, ptags, metric, allow):
    """Exact-scan the pending tail and fold it into (scores, ids).

    Score conventions match the main paths: ip = dot on the raw stored
    vectors, cosine = dot on unit rows (queries arrive normalized), l2 =
    -||q - x||^2."""
    k = scores.shape[1]
    qf = q.to(torch.float32)
    pv = pvecs
    if metric == "cosine":
        pv = pv / torch.clamp(torch.linalg.vector_norm(pv, dim=1, keepdim=True),
                              min=1e-9)
    ps = f32_matmul(qf, pv.T)
    if metric == "l2":
        pn = torch.sum(pv * pv, dim=1)
        qn = torch.sum(qf * qf, dim=1, keepdim=True)
        ps = 2.0 * ps - pn[None, :] - qn
    valid = pids >= 0
    if allow is not None:
        valid = valid & (ptags[:, None] == allow[None, :]).any(dim=1)
    ps = torch.where(valid[None, :], ps, _NEG)
    all_s = torch.cat([scores.to(torch.float32), ps], dim=1)
    all_i = torch.cat(
        [ids.to(torch.int64),
         pids.to(torch.int64)[None, :].expand(ps.shape[0], -1)], dim=1
    )
    s, pos = stable_topk(all_s, k)
    return s, torch.gather(all_i, 1, pos)


def _ivf_search(mesh, data, ids, sqnorms, scales, centroids, q, k, nprobe,
                metric, pallas_mode="off", quantized=False, k_out=None):
    """Sharded IVF query step (ivf.py:1849-2009): probe selection
    (replicated), each shard's scan of the probed clusters it owns, and the
    merge. ``k`` is the per-shard top-k width; the merge over the
    n_shards * k candidate pool returns ``k_out`` (default k) columns, ids
    int64. For l2, scores are -||q - x||^2."""
    n_shards = mesh_shards(mesh)
    k_out = k if k_out is None else k_out
    k_out = min(k_out, k * n_shards)
    nlist_s = data.shard_rows
    q = q.to(torch.float32)
    with tracing.span("ivf.probe.select"):
        qc = f32_matmul(q, centroids.T)  # (Q, nlist)
        if metric == "l2":
            probe_scores = 2.0 * qc - torch.sum(centroids * centroids, dim=1)[None, :]
        else:
            probe_scores = qc
        _, probes = stable_topk(probe_scores, nprobe)
    kernel = (pallas_mode != "off" and k <= ivf_ops.MAX_K
              and nprobe <= ivf_ops.MAX_PROBE)
    parts = []
    for rank, dev in local_shards(mesh):
        base = rank * nlist_s

        def clusters(t):
            return t.shard(rank)

        with tracing.span("ivf.probe.scan", rank):
            pr = probes.to(dev)
            q_s = q.to(dev)
            # one shard owns every probe: no mask
            owned = (pr // nlist_s) == rank if n_shards > 1 else None
            if kernel:
                # probes another shard owns go in out of range: the kernel's
                # probe table skips them, so they add nothing, ties included
                local = pr if owned is None else torch.where(owned, pr - base, -1)
                s_loc, i_loc = ivf_ops.ivf_scan(
                    clusters(data), clusters(ids), q_s, local, k,
                    clusters(scales) if quantized else None,
                )
            else:
                local = pr if owned is None else torch.clamp(pr - base, 0, nlist_s - 1)
                s_loc, i_loc = _gather_scan(
                    clusters(data), clusters(ids), clusters(sqnorms),
                    clusters(scales), q_s, local, owned, k, metric, quantized,
                )
        parts.append((s_loc, i_loc.to(torch.int64)))
    # local shards first, then across processes
    with tracing.span("ivf.probe.merge"):
        top_s, top_i = hierarchical_topk_merge(parts, k_out, mesh)
    if metric == "l2":
        top_s = top_s - torch.sum(q * q, dim=1, keepdim=True)
    return top_s, top_i


def _gather_scan(data, ids, sqnorms, scales, q, probes, owned, k, metric,
                 quantized):
    """The reference's gather-scan route over one shard's clusters
    (ivf.py:1932-1987): for each probe rank, gather every query's cluster
    block (``probes`` shard-local, clipped), score it and merge it into a
    running top-k (ties to the earlier probe rank, then the lower slot);
    probes the shard does not own (``owned`` False; None: it owns them
    all) score nothing. int8 rows score with exact integer products, as
    the kernel does."""
    n_q = q.shape[0]
    if quantized:
        q_int, q_scl = quantize_queries_device(q)
        qv = q_int.to(torch.float32)
    else:
        qv, q_scl = q, None
    best_s = torch.full((n_q, k), _NEG, dtype=torch.float32, device=q.device)
    best_i = torch.full((n_q, k), -1, dtype=torch.int32, device=q.device)
    for j in range(probes.shape[1]):
        pl = probes[:, j]
        blocks = data[pl].to(torch.float32)  # (Q, cmax, d)
        scores = f32_matmul(blocks, qv[:, :, None])[:, :, 0]
        if quantized:
            scores = scores * q_scl[:, None]
            scores = scores * scales[pl]
        ids_blk = ids[pl]
        if metric == "l2":
            scores = 2.0 * scores - sqnorms[pl]
        keep = ids_blk >= 0
        if owned is not None:
            keep = keep & owned[:, j:j + 1]
        scores = torch.where(keep, scores, _NEG)
        merged_s = torch.cat([best_s, scores], dim=1)
        merged_i = torch.cat([best_i, ids_blk], dim=1)
        best_s, pos = stable_topk(merged_s, k)
        best_i = torch.gather(merged_i, 1, pos)
    return best_s, best_i
