"""Host-side vector store facade over the device index.

Counterpart of ``semcode_tpu/index/store.py``: ``connect`` /
``upsert_embeddings`` / ``search`` with an in-process engine — upserts
scatter into device-resident tensors and a search is one exact scan plus
the device BM25 rerank — and snapshot persistence (save/load), deletes and
compaction. The snapshot format is the reference's (index.npz +
rows.msgpack + store.json), so a store saved by either package loads in
the other.

``index_kind``: ``flat`` (exact scan), ``ivf`` (k-means cluster layout,
probed), or ``auto``: flat until the corpus reaches ``index_ivf_min_size``
live rows, then promoted to IVF in one view swap.
"""

from __future__ import annotations

import json
import math
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import (
    Any,
    Callable,
    Dict,
    List,
    Optional,
    Protocol,
    Sequence,
    Union,
    runtime_checkable,
)

import numpy as np

import torch

from ..device import DeviceLike, resolve_device
from ..parallel.mesh import Mesh, get_mesh, local_devices, make_mesh, n_shards
from ..logger import get_logger
from ..settings import AppSettings, settings as default_settings
from ..utils.tracing import StageTimer
from .flat import FlatIndex, _NEG_INF as _SCORE_SENTINEL
from .ivf import IVFIndex
from .lexical import (
    LexicalFingerprints,
    featurize_queries,
    featurize_query_symbols,
    rerank_device,
)
from .rerank import rerank_hits

log = get_logger("index.store")

_UNSET = object()  # lazy-slot sentinel (None is a valid loaded value)

ProgressCallback = Callable[[int, int], None]
# queries arrive as python lists from the API and as ndarrays internally
VectorLike = Union[Sequence[float], np.ndarray]


def validate_top_k(top_k, max_k: int) -> int:
    """Coerce/validate a caller-supplied top_k (API bodies pass it raw)."""
    try:
        k = int(top_k)
    except (TypeError, ValueError):
        raise ValueError(f"top_k must be an integer, got {top_k!r}") from None
    if isinstance(top_k, float) and top_k != k:
        raise ValueError(f"top_k must be an integer, got {top_k!r}")
    if k <= 0:
        raise ValueError(f"top_k must be positive, got {k}")
    return min(k, max_k)


@dataclass
class SearchHit:
    """One retrieval result (the reference returns Milvus hit entities with
    repo/path/language/text/metadata fields — milvus_store.py:135-148)."""

    id: str
    score: float
    repo: Optional[str] = None
    path: Optional[str] = None
    language: Optional[str] = None
    text: Optional[str] = None
    metadata: Dict[str, Any] = field(default_factory=dict)


class VectorStore:
    """In-process device vector store with upsert/search/delete + snapshots.

    ``mesh`` shards the index (``parallel/mesh.py``); without one the store
    builds it from the settings on first use (``_ensure_mesh``): the
    process group when ``[mesh] num_processes > 1``, then the ``("dcn",
    "data")`` mesh over the processes, or ``get_mesh(mesh_shape)`` over
    ``device``'s local devices."""

    def __init__(
        self,
        config: Optional[AppSettings] = None,
        *,
        dim: Optional[int] = None,
        mesh: Optional[Mesh] = None,
        device: DeviceLike = None,
    ):
        self.config = config or default_settings
        self.dim = int(dim or self.config.embedding_dimension)
        self.metric = self.config.index_metric
        self._mesh = mesh
        self._device_arg = device
        self.device = mesh.home if mesh is not None else resolve_device(device)
        # Reader-visible state is ONE atomically-swapped tuple
        # (index, row_to_id, row_meta, id_to_row) — mirroring the device-tuple
        # pattern inside the indexes. Row-stable mutations (appends, metadata
        # updates) mutate the dicts in place; row-RENUMBERING mutations
        # (flat->IVF promotion, compaction, load) build a fresh index object
        # AND fresh dicts and swap the whole tuple, so a lock-free reader can
        # never map old row numbers through new maps (or vice versa).
        self._view: tuple = (None, {}, {}, {})
        # Host-side WRITE lock. Scatter updates do not donate their buffers,
        # so an in-flight search keeps consuming the previous (immutable)
        # device arrays while a writer installs new ones — reads are lock-free
        # with bounded staleness: a query racing an upsert may see the
        # pre-update corpus or skip rows whose metadata is mid-swap, but
        # never crashes or returns torn data.
        self._lock = threading.RLock()
        self._connected = False
        self.version = 0  # bumped on every mutation (cache invalidation)
        # (repo, language) -> tag id for device-side filtered search.
        # Ids start at 1 (0 = untagged) and are append-only, so a lock-free
        # reader iterating a copy sees a consistent (possibly slightly stale)
        # table; rows tagged under a brand-new pair become filterable as soon
        # as the reader re-snapshots.
        self._pair_ids: Dict[tuple, int] = {}
        # per-row lexical fingerprints for the ON-DEVICE second-stage rerank
        # (index/lexical.py). Maintained by writers in lockstep with
        # row_meta; None until the first post-construction mutation (loads
        # leave it None — it rebuilds from row_meta on the next upsert, and
        # searches fall back to the host scorer meanwhile). Readers only
        # snapshot its immutable device tuple: bounded staleness, same
        # contract as the index's own device state.
        self._lex: Optional[LexicalFingerprints] = None
        self._learned_dev: Any = _UNSET  # learned rerank table (lazy)

    # Convenience accessors into the current view (writers hold the lock, so
    # in-place dict mutation through these is safe; readers must instead
    # snapshot self._view ONCE and destructure it).
    @property
    def _index(self):
        return self._view[0]

    # deliberately bare `dict` annotations: these return the LIVE shared
    # maps (readers do GIL-atomic point lookups; compaction swaps whole
    # views). A parameterized Dict[...] annotation makes the typeguard
    # harness ITERATE the returned dict to check element types — racing
    # concurrent in-place upserts with "dictionary changed size during
    # iteration", a harness artifact production lookups can never hit.
    @property
    def _row_to_id(self) -> dict:
        return self._view[1]

    @property
    def _row_meta(self) -> dict:
        return self._view[2]

    @property
    def _id_to_row(self) -> dict:
        return self._view[3]

    # -- lifecycle -----------------------------------------------------------

    def connect(self) -> None:
        """Initialize the engine; loads a snapshot if one exists."""
        if self._connected:
            return
        mesh = self._ensure_mesh()
        snap = self.snapshot_dir()
        if snap is not None and (snap / "store.json").exists():
            self.load(snap)
        self._connected = True
        log.info(
            "vector_store_connected",
            dim=self.dim,
            metric=self.metric,
            device=str(self.device),
            shards=n_shards(mesh),
            rows=self.count(),
        )

    def _ensure_mesh(self) -> Mesh:
        """The store's mesh, built once from the settings (store.py:160-176):
        the process group first, then the ``("dcn", "data")`` mesh of a
        multi-process run unless ``mesh_shape`` names one, else
        ``get_mesh(mesh_shape, mesh_axis_names)``."""
        if self._mesh is None:
            from ..parallel.distributed import (
                maybe_init_distributed,
                multihost_mesh_shape,
            )

            cfg = self.config
            maybe_init_distributed(cfg, device=self._device_arg)
            multi = multihost_mesh_shape(cfg, device=self._device_arg)
            if multi is not None and not cfg.mesh_shape:
                mesh = make_mesh(*multi,
                                 devices=local_devices(self._device_arg))
            else:
                mesh = get_mesh(cfg.mesh_shape,
                                tuple(cfg.mesh_axis_names.split(",")),
                                device=self._device_arg)
            self._mesh = mesh
            self.device = mesh.home
        return self._mesh

    def snapshot_dir(self) -> Optional[Path]:
        if self.config.index_snapshot_dir is not None:
            return Path(self.config.index_snapshot_dir)
        if self.config.workspace_root:
            return Path(self.config.workspace_root) / "index"
        return None

    def _ensure_index(self):
        index, row_to_id, row_meta, id_to_row = self._view
        if index is None:
            if self.config.index_kind == "ivf":
                index = self._new_ivf()
            else:  # flat | auto start flat; auto promotes later
                index = FlatIndex(
                    self.dim,
                    metric=self.metric,
                    capacity=self.config.index_capacity,
                    **self._index_options(),
                )
            self._view = (index, row_to_id, row_meta, id_to_row)
        return index

    def _index_options(self) -> Dict[str, Any]:
        """Index options from the settings (FlatIndex's; IVFIndex adds its
        own). Used for new indexes AND snapshot loads: the reference's load
        passes only the dtype, so a
        reloaded store silently reverts scan_impl, the rescore tier and the
        fetch widths to their defaults (a store configured for the kernel
        route serves the full-matrix route after a restart)."""
        cfg = self.config
        return dict(
            dtype=cfg.index_dtype,
            device_rescore=cfg.index_device_rescore,
            rescore_mode=cfg.index_rescore_mode,
            score_dtype=cfg.index_score_dtype,
            fetch_width=cfg.index_fetch_width,
            scan_impl=cfg.index_scan_impl,
            rescore_width=cfg.index_rescore_width,
            mesh=self._ensure_mesh(),
        )

    def _ivf_options(self) -> Dict[str, Any]:
        """IVFIndex options from the settings (new indexes and loads; the
        nlist/nprobe/metric of a load come from the snapshot)."""
        return dict(kmeans_iters=self.config.index_kmeans_iters,
                    **self._index_options())

    def _new_ivf(self) -> IVFIndex:
        return IVFIndex(
            self.dim,
            nlist=self.config.index_nlist,
            nprobe=self.config.index_nprobe,
            metric=self.metric,
            **self._ivf_options(),
        )

    def _maybe_promote(self) -> None:
        """auto mode: switch flat -> IVF once the corpus justifies ANN."""
        if self.config.index_kind != "auto":
            return
        idx = self._index
        if not isinstance(idx, FlatIndex):
            return
        if idx.n_live < self.config.index_ivf_min_size:
            return
        log.info("index_promotion_started", rows=idx.n_live)
        live = np.flatnonzero(idx._alive[: idx.size])
        ivf = self._new_ivf()
        new_rows = ivf.add(idx._host[live], idx._tags[live])
        remap = dict(zip(live.tolist(), new_rows.tolist()))
        # Promotion renumbers rows: build FRESH maps and install them together
        # with the new index in one view swap, so a concurrent lock-free
        # search never maps flat row numbers through IVF-numbered dicts.
        old_meta = self._row_meta
        id_to_row = {k: remap[v] for k, v in self._id_to_row.items()}
        if self._lex is not None:
            remap_arr = np.full(max(idx.size, 1), -1, dtype=np.int64)
            remap_arr[live] = new_rows
            self._lex.remap(remap_arr)
        self._view = (
            ivf,
            {r: i for i, r in id_to_row.items()},
            {remap[r]: m for r, m in old_meta.items()},
            id_to_row,
        )
        log.info("index_promotion_done", rows=int(ivf.size))

    # -- mutation ----------------------------------------------------------------

    def upsert_embeddings(
        self,
        payloads: Sequence["EmbeddingPayloadLike"],
        *,
        batch_size: Optional[int] = None,
        progress: Optional[ProgressCallback] = None,
    ) -> int:
        """Idempotent upsert by payload id (reference milvus_store.py:87-133)."""
        self.connect()
        batch = batch_size or self.config.upsert_batch_size
        total = len(payloads)
        done = 0
        with self._lock:
            if total:
                in_dim = len(payloads[0].vector)
                if in_dim != self.dim:
                    if self.count() == 0:
                        # providers can emit a different width than the
                        # configured hash dimension (tpu-hybrid concatenates
                        # hash + encoder vectors; encoder checkpoints carry
                        # their own output dim) — an EMPTY store adopts the
                        # provider's width on first write instead of failing
                        log.info(
                            "store_dim_adopted",
                            configured=self.dim,
                            provider=in_dim,
                        )
                        self.dim = int(in_dim)
                        self._view = (None, {}, {}, {})
                    else:
                        raise ValueError(
                            f"embedding dim mismatch: provider emits {in_dim}-d "
                            f"vectors but the index holds {self.dim}-d rows — "
                            "the embedding configuration changed after data "
                            "was indexed; re-ingest with --force (or restore "
                            "the original [embeddings] settings)"
                        )
            index = self._ensure_index()
            for start in range(0, total, batch):
                chunk = payloads[start : start + batch]
                vecs = np.asarray([p.vector for p in chunk], dtype=np.float32)
                new_mask = [p.id not in self._id_to_row for p in chunk]
                new_items = [p for p, m in zip(chunk, new_mask) if m]
                old_items = [p for p, m in zip(chunk, new_mask) if not m]
                lex = self._ensure_lex()
                if new_items:
                    new_vecs = vecs[np.asarray(new_mask)]
                    new_metas = [self._payload_meta(p) for p in new_items]
                    new_tags = np.asarray(
                        [self._tag_for(m) for m in new_metas],
                        dtype=np.int32,
                    )
                    rows = index.add(new_vecs, new_tags)
                    for p, r, m in zip(new_items, rows, new_metas):
                        self._id_to_row[p.id] = int(r)
                        self._row_to_id[int(r)] = p.id
                        self._row_meta[int(r)] = m
                    if lex is not None:
                        lex.set_rows(rows, new_metas)
                if old_items:
                    old_vecs = vecs[~np.asarray(new_mask)]
                    old_metas = [self._payload_meta(p) for p in old_items]
                    old_tags = np.asarray(
                        [self._tag_for(m) for m in old_metas],
                        dtype=np.int32,
                    )
                    rows = np.asarray(
                        [self._id_to_row[p.id] for p in old_items], dtype=np.int64
                    )
                    if isinstance(index, IVFIndex):
                        # IVF slots are cluster-addressed: tombstone + re-add
                        index.remove(rows)
                        new_rows = index.add(old_vecs, old_tags)
                        for p, r, m in zip(old_items, new_rows, old_metas):
                            old_row = self._id_to_row[p.id]
                            self._row_meta.pop(old_row, None)
                            self._row_to_id.pop(old_row, None)
                            self._id_to_row[p.id] = int(r)
                            self._row_to_id[int(r)] = p.id
                            self._row_meta[int(r)] = m
                        if lex is not None:
                            lex.set_rows(new_rows, old_metas)
                    else:
                        index.update_rows(rows, old_vecs, old_tags)
                        for p, m in zip(old_items, old_metas):
                            self._row_meta[self._id_to_row[p.id]] = m
                        if lex is not None:
                            lex.set_rows(rows, old_metas)
                done += len(chunk)
                if progress is not None:
                    progress(done, total)
            self._maybe_promote()
            self.version += 1
            self._maybe_compact()  # IVF upserts tombstone + re-add
        return done

    @staticmethod
    def _payload_meta(p: "EmbeddingPayloadLike") -> Dict[str, Any]:
        meta = dict(p.metadata or {})
        meta.setdefault("text", p.text)
        return meta

    # -- lexical fingerprints (device rerank) --------------------------------

    def _lex_enabled(self) -> bool:
        return (
            self.config.search_rerank_weight > 0.0
            and self.config.search_rerank_impl in ("auto", "device")
        )

    def _ensure_lex(self) -> Optional[LexicalFingerprints]:
        """Writer-side: the fingerprint table, created (and back-filled from
        row_meta, e.g. after a snapshot load) on first use."""
        if not self._lex_enabled():
            return None
        if self._lex is None:
            from .lexical import DEFAULT_KTERMS

            mesh = self._ensure_mesh()
            lex = LexicalFingerprints(
                # the index's row multiple: shards stay equal and aligned
                math.lcm(n_shards(mesh) * 8, 128),
                kterms=self.config.search_rerank_terms or DEFAULT_KTERMS,
                mesh=mesh,
            )
            if self._row_meta:
                lex.rebuild(self._row_meta)
            self._lex = lex
        return self._lex

    def _learned_table(self):
        """Device copy of the learned term-embedding table for the rerank's
        MaxSim channel (models/term_reranker.py), or None when disabled /
        absent. Loaded lazily once; replicated (it is an 8-16 MB constant,
        not row data)."""
        if self._learned_dev is not _UNSET:
            return self._learned_dev
        mode = str(self.config.search_rerank_learned or "off")
        table = None
        if mode != "off":
            from ..models.term_reranker import default_asset_path, load_table

            path = default_asset_path() if mode == "auto" else mode
            try:
                table = load_table(path)
            except Exception as exc:  # noqa: BLE001 — degrade to BM25-only
                log.warning("learned_rerank_load_failed", error=str(exc))
            if table is not None:
                table = torch.from_numpy(table).to(self.device)
                log.info(
                    "learned_rerank_loaded", path=str(path),
                    buckets=int(table.shape[0]), dim=int(table.shape[1]),
                )
        self._learned_dev = table
        return table

    def _tag_for(self, meta: Dict[str, Any]) -> int:
        """Assign/look up the (repo, language) tag id for a row (writer-side,
        under the store lock)."""
        pair = (str(meta.get("repo") or ""), str(meta.get("language") or ""))
        tag = self._pair_ids.get(pair)
        if tag is None:
            tag = len(self._pair_ids) + 1  # 0 = untagged
            self._pair_ids[pair] = tag
        return tag

    # device-filterable keys: equality on repo/language rides the row tags
    _DEVICE_FILTER_KEYS = ("repo", "language")

    def _split_filters(self, filters):
        """Split filters into (allow_tags, residual_filters, definitely_empty).

        repo/language equality filters compile to an allowed-tag list that
        the indexes mask ON DEVICE before top-k selection — a selective
        filter still yields top_k true matches, where host post-filtering
        could exhaust its over-fetched candidates. Other keys (and oversized
        allow lists) stay host-side via the residual filters."""
        if not filters:
            return None, filters, False
        dev = {}
        for k in self._DEVICE_FILTER_KEYS:
            v = filters.get(k)
            if isinstance(v, str):
                dev[k] = (v,)
            elif (
                isinstance(v, (list, tuple))
                and v
                and all(isinstance(i, str) for i in v)
            ):
                dev[k] = tuple(v)
        if not dev:
            return None, filters, False
        allowed = [
            tag
            for (repo, lang), tag in list(self._pair_ids.items())
            if repo in dev.get("repo", (repo,))
            and lang in dev.get("language", (lang,))
        ]
        if not allowed:
            return None, filters, True  # no stored row can ever match
        if len(allowed) > 64:
            return None, filters, False  # host fallback for huge allow lists
        residual = {k: v for k, v in filters.items() if k not in dev}
        return np.asarray(sorted(allowed), dtype=np.int32), residual or None, False

    def delete(self, ids: Sequence[str]) -> int:
        """Delete payloads by id (capability Milvus had server-side)."""
        self.connect()
        with self._lock:
            rows = [self._id_to_row[i] for i in ids if i in self._id_to_row]
            if not rows:
                return 0
            self._index.remove(np.asarray(rows, dtype=np.int64))
            for i in ids:
                row = self._id_to_row.pop(i, None)
                if row is not None:
                    self._row_meta.pop(row, None)
                    self._row_to_id.pop(row, None)
            self.version += 1
            self._maybe_compact()
            return len(rows)

    def delete_repo(self, repo: str) -> int:
        return self.delete_where({"repo": repo})

    @staticmethod
    def _meta_matches(meta: Dict[str, Any], filters: Dict[str, Any]) -> bool:
        """Equality/membership filter semantics shared by search results,
        listing, and delete-by-filter (value may be a scalar or a list)."""
        for k, v in filters.items():
            if isinstance(v, (list, tuple)):
                if meta.get(k) not in v:
                    return False
            elif meta.get(k) != v:
                return False
        return True

    def delete_where(self, filters: Dict[str, Any]) -> int:
        """Delete every chunk whose metadata matches the filters (the
        delete-by-expression capability Milvus exposes; the reference's
        client had no delete at all)."""
        if not filters:
            raise ValueError("delete_where requires at least one filter")
        ids = [
            pid
            for pid, r in list(self._id_to_row.items())
            if self._meta_matches(self._row_meta.get(r, {}), filters)
        ]
        return self.delete(ids)

    def list_chunks(
        self,
        filters: Optional[Dict[str, Any]] = None,
        *,
        offset: int = 0,
        limit: int = 100,
        include_text: bool = False,
    ) -> List[Dict[str, Any]]:
        """Snapshot-consistent listing of stored chunks (Milvus query()
        equivalent): deterministic order, offset/limit pagination."""
        _, row_to_id, row_meta, _ = self._view
        rows = []
        for row, pid in row_to_id.items():
            meta = row_meta.get(row, {})
            if filters and not self._meta_matches(meta, filters):
                continue
            rows.append((pid, meta))
        rows.sort(key=lambda it: (
            str(it[1].get("repo") or ""),
            str(it[1].get("path") or ""),
            int(it[1].get("start_line") or 0),
            it[0],
        ))
        out = []
        for pid, meta in rows[offset : offset + max(0, int(limit))]:
            entry = {
                "id": pid,
                "repo": meta.get("repo"),
                "path": meta.get("path"),
                "language": meta.get("language"),
                "start_line": meta.get("start_line"),
                "end_line": meta.get("end_line"),
                "symbol": meta.get("symbol"),
            }
            if include_text:
                entry["text"] = meta.get("text")
            out.append(entry)
        return out

    def _maybe_compact(self) -> None:
        """Auto-compaction policy (caller holds the write lock): re-pack
        once tombstones exceed the configured fraction of live rows and the
        absolute floor. Readers are lock-free and keep serving the previous
        device snapshot while the re-pack runs."""
        ratio = self.config.index_auto_compact_ratio
        if ratio <= 0:
            return
        idx = self._index
        if idx is None:
            return
        allocated = _allocated(idx)
        live = self.count()
        dead = allocated - live
        if dead >= max(self.config.index_auto_compact_min, ratio * max(live, 1)):
            self.compact()

    def compact(self) -> int:
        """Reclaim tombstoned rows (the maintenance Milvus ran server-side).

        Builds the compacted index as a NEW object (``Index.compacted()``)
        while readers keep serving the old one, then installs the new index
        together with freshly-remapped id/meta maps in ONE atomic view swap.
        A lock-free reader therefore either sees the complete pre-compaction
        state (old index + old maps) or the complete post-compaction state —
        never compacted row ids mapped through stale dicts (the round-2
        in-place compact had exactly that race: auto-compaction inline on
        upsert/delete re-materialized the SAME index object a concurrent
        reader's snapshot pointed into). Returns tombstones reclaimed."""
        self.connect()
        with self._lock:
            idx = self._index
            if idx is None:
                return 0

            before = _allocated(idx)
            if before - self.count() == 0:
                # nothing tombstoned: skip the device re-pack entirely
                # (compacted() would otherwise build a full new layout —
                # minutes at 1M x 3072 — only to be discarded below)
                return 0
            new_idx, remap = idx.compacted()
            reclaimed = before - _allocated(new_idx)
            if reclaimed == 0:
                return 0
            old_meta = self._row_meta
            id_to_row = {
                pid: int(remap[r])
                for pid, r in self._id_to_row.items()
                if r < len(remap) and remap[r] >= 0
            }
            if self._lex is not None:
                self._lex.remap(remap)
            self._view = (
                new_idx,
                {r: p for p, r in id_to_row.items()},
                {
                    int(remap[r]): m
                    for r, m in old_meta.items()
                    if r < len(remap) and remap[r] >= 0
                },
                id_to_row,
            )
            self.version += 1
            log.info("store_compacted", reclaimed=reclaimed, rows=self.count())
            return reclaimed

    # -- query ---------------------------------------------------------------------

    def search(
        self,
        vector: VectorLike,
        *,
        top_k: Any = 10,  # validated/coerced via validate_top_k (API passes raw JSON)
        nprobe: Optional[int] = None,
        filters: Optional[Dict[str, Any]] = None,
        query_text: Optional[str] = None,
    ) -> List[SearchHit]:
        """Single-vector ANN search returning enriched hits."""
        self.connect()
        if self._index is None or self.count() == 0:
            return []
        hits_batch = self.search_batch(
            np.asarray(vector, dtype=np.float32)[None, :],
            top_k=top_k,
            nprobe=nprobe,
            filters=filters,
            query_texts=[query_text] if query_text is not None else None,
        )
        return hits_batch[0]

    def search_batch(
        self,
        vectors: np.ndarray,
        *,
        top_k: Any = 10,  # validated/coerced via validate_top_k (API passes raw JSON)
        nprobe: Optional[int] = None,
        filters: Optional[Dict[str, Any]] = None,
        query_texts: Optional[Sequence[Optional[str]]] = None,
        timer=None,  # optional StageTimer: per-stage serving attribution
    ) -> List[List[SearchHit]]:
        self.connect()
        timer = timer or StageTimer()
        top_k = validate_top_k(top_k, self.config.search_top_k_max)
        q = np.ascontiguousarray(np.atleast_2d(vectors), dtype=np.float32)
        view = self._view  # lock-free read: snapshot the view tuple once
        index = view[0]
        if index is None or self.count() == 0:
            return [[] for _ in range(q.shape[0])]
        if q.shape[1] != index.dim:
            raise ValueError(
                f"embedding dim mismatch: query vectors are {q.shape[1]}-d "
                f"but the index holds {index.dim}-d rows — the embedding "
                "configuration changed after data was indexed; re-ingest "
                "with --force (or restore the original [embeddings] settings)"
            )
        allow, residual, empty = self._split_filters(filters)
        if empty:
            return [[] for _ in range(q.shape[0])]
        window = self._rerank_window(top_k, query_texts)
        fetch_k = self._fetch_k(index, window, residual)
        use_dev = self._use_device_rerank(index, query_texts, residual)
        with timer.stage("search_device"):
            if isinstance(index, IVFIndex):
                scores, ids = index.search(
                    q, k=fetch_k, nprobe=nprobe, allow_tags=allow
                )
            else:
                scores, ids = index.search(q, k=fetch_k, allow_tags=allow)
            if use_dev:
                scores, ids = self._device_rerank_np(
                    scores, ids, query_texts
                )
            scores, ids = self._rescore_host(index, q, scores, ids)
        with timer.stage("assemble"):
            hits = self._hits_from(
                view, scores, ids,
                [top_k] * q.shape[0] if use_dev
                else self._limits(q.shape[0], top_k, window, query_texts),
                residual,
            )
        with timer.stage("rerank"):
            if use_dev:
                return hits  # blended on device inside the search stage
            return self._apply_rerank(hits, query_texts, top_k)

    def search_batch_device(
        self,
        q_dev,
        *,
        top_k: Any = 10,  # validated/coerced via validate_top_k (API passes raw JSON)
        nprobe: Optional[int] = None,
        filters: Optional[Dict[str, Any]] = None,
        query_texts: Optional[Sequence[Optional[str]]] = None,
        timer=None,  # optional StageTimer: per-stage serving attribution
    ) -> List[List[SearchHit]]:
        """Search with an already-on-device, already-normalized query batch
        (a tensor on the store's device). Saves a host->device round trip on
        the serving path; the single host sync happens when results
        transfer back."""
        self.connect()
        timer = timer or StageTimer()
        top_k = validate_top_k(top_k, self.config.search_top_k_max)
        n_q = q_dev.shape[0]
        view = self._view  # lock-free read: snapshot the view tuple once
        index = view[0]
        if index is None or self.count() == 0:
            return [[] for _ in range(n_q)]
        if q_dev.shape[1] != index.dim:
            raise ValueError(
                f"embedding dim mismatch: query vectors are {q_dev.shape[1]}-d "
                f"but the index holds {index.dim}-d rows — the embedding "
                "configuration changed after data was indexed; re-ingest "
                "with --force (or restore the original [embeddings] settings)"
            )
        allow, residual, empty = self._split_filters(filters)
        if empty:
            return [[] for _ in range(n_q)]
        window = self._rerank_window(top_k, query_texts)
        fetch_k = self._fetch_k(index, window, residual)
        use_dev = self._use_device_rerank(index, query_texts, residual)
        with timer.stage("search_device"):
            if isinstance(index, IVFIndex):
                scores, ids = index.search_device(
                    q_dev, fetch_k, nprobe=nprobe, allow_tags=allow
                )
            else:
                scores, ids = index.search_device(
                    q_dev, fetch_k, allow_tags=allow
                )
            if use_dev:
                # second-stage blend chained on device: no host round trip
                # between the scan and the rerank
                scores, ids = self._device_rerank_dispatch(
                    scores, ids, query_texts, n_q
                )
            # the host fetch below is the device sync point: its wall time
            # includes the scan itself, so "search_device" is the honest
            # engine stage
            scores = scores.cpu().numpy().astype(np.float32, copy=False)
            ids = ids.cpu().numpy().astype(np.int64, copy=False)
        # scrub sentinel-scored slots (tag-masked or padded rows) exactly
        # like the index host paths do: without this, _rescore_host would
        # overwrite the -3e38 filter sentinel with the row's TRUE score and
        # resurrect filtered-out rows into the results
        bad = (
            (ids < 0)
            | (ids >= max(index.rows_allocated, 1))
            | ~np.isfinite(scores)
            | (scores <= _SCORE_SENTINEL / 2)
        )
        scores = np.where(bad, _SCORE_SENTINEL, scores)
        ids = np.where(bad, -1, ids)
        scores, ids = self._rescore_host(
            index, q_dev.cpu().numpy().astype(np.float32, copy=False),
            scores, ids,
        )
        with timer.stage("assemble"):
            hits = self._hits_from(
                view, scores, ids,
                [top_k] * n_q if use_dev
                else self._limits(n_q, top_k, window, query_texts),
                residual,
            )
        with timer.stage("rerank"):
            if use_dev:
                return hits  # blended on device inside the search stage
            return self._apply_rerank(hits, query_texts, top_k)

    def search_bulk(
        self,
        vectors: np.ndarray,
        *,
        top_k: Any = 10,
        filters: Optional[Dict[str, Any]] = None,
        batch_q: int = 256,
        chunk_batches: int = 16,
    ) -> List[List[SearchHit]]:
        """High-throughput bulk search: M query vectors through chunked
        device dispatch (``search_device_batched``: ``chunk_batches``
        batches of ``batch_q`` queries per call). For offline jobs (dedup
        sweeps, corpus-vs-corpus nearest neighbours, eval), not the
        interactive path: no rerank stage, which needs query text. Returns
        one hit list per query, the same shape as ``search_batch``."""
        self.connect()
        top_k = validate_top_k(top_k, self.config.search_top_k_max)
        q = np.ascontiguousarray(np.atleast_2d(vectors), dtype=np.float32)
        m = q.shape[0]
        view = self._view  # lock-free snapshot
        index = view[0]
        if index is None or self.count() == 0:
            return [[] for _ in range(m)]
        if q.shape[1] != index.dim:
            raise ValueError(
                f"embedding dim mismatch: query vectors are {q.shape[1]}-d "
                f"but the index holds {index.dim}-d rows — the embedding "
                "configuration changed after data was indexed; re-ingest "
                "with --force (or restore the original [embeddings] settings)"
            )
        allow, residual, empty = self._split_filters(filters)
        if empty:
            return [[] for _ in range(m)]
        if self.metric == "cosine":
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        fetch_k = self._fetch_k(index, top_k, residual)  # x4 applied inside
        # 8-aligned batches and one batch count per call (the tail padded
        # with zero batches), as the reference keeps one compiled shape
        bq = max(8, min(((batch_q + 7) // 8) * 8, ((m + 7) // 8) * 8))
        n_b = (m + bq - 1) // bq
        chunk_b = min(chunk_batches, n_b)
        pad = n_b * bq - m
        if pad:
            q = np.concatenate([q, np.zeros((pad, q.shape[1]), np.float32)])
        qs = torch.from_numpy(q.reshape(n_b, bq, -1))
        all_scores = np.full((n_b * bq, fetch_k), _SCORE_SENTINEL, np.float32)
        all_ids = np.full((n_b * bq, fetch_k), -1, np.int64)
        for start in range(0, n_b, chunk_b):
            stack = qs[start:start + chunk_b]
            n_real = stack.shape[0]
            if n_real < chunk_b:
                stack = torch.cat([stack, stack.new_zeros(
                    (chunk_b - n_real, bq, q.shape[1]))])
            s, i = index.search_device_batched(
                stack.to(self.device), fetch_k, allow_tags=allow
            )
            s = s[:n_real].reshape(-1, s.shape[-1]).cpu().numpy().astype(
                np.float32, copy=False)
            i = i[:n_real].reshape(-1, i.shape[-1]).cpu().numpy().astype(
                np.int64, copy=False)
            lo = start * bq
            all_scores[lo:lo + s.shape[0], :s.shape[1]] = s
            all_ids[lo:lo + i.shape[0], :i.shape[1]] = i
        scores, ids = all_scores[:m], all_ids[:m]
        # scrub sentinel-scored slots (tag-masked or padded) before the host
        # rescore, as search_batch_device does
        bad = (
            (ids < 0)
            | (ids >= max(index.rows_allocated, 1))
            | ~np.isfinite(scores)
            | (scores <= _SCORE_SENTINEL / 2)
        )
        scores = np.where(bad, _SCORE_SENTINEL, scores)
        ids = np.where(bad, -1, ids)
        scores, ids = self._rescore_host(index, q[:m], scores, ids)
        return self._hits_from(view, scores, ids, [top_k] * m, residual)

    def _rerank_window(
        self, top_k: int, query_texts: Optional[Sequence[Optional[str]]]
    ) -> int:
        """Candidate-window size for the second-stage lexical rerank
        (index/rerank.py). top_k when reranking is off (no query text or
        weight 0) — then the window IS the result."""
        if not query_texts or self.config.search_rerank_weight <= 0.0:
            return top_k
        return min(
            max(top_k * self.config.search_rerank_depth, top_k),
            self.config.search_top_k_max,
        )

    @staticmethod
    def _limits(
        n_q: int,
        top_k: int,
        window: int,
        query_texts: Optional[Sequence[Optional[str]]],
    ) -> List[int]:
        """Per-query hit-list depth: the rerank window only where a query
        TEXT exists (padding queries and text-less entries get plain top_k,
        skipping ~window-deep hit construction they would discard)."""
        return [
            window
            if (query_texts and i < len(query_texts) and query_texts[i])
            else top_k
            for i in range(n_q)
        ]

    def _apply_rerank(
        self,
        hits_batch: List[List[SearchHit]],
        query_texts: Optional[Sequence[Optional[str]]],
        top_k: int,
    ) -> List[List[SearchHit]]:
        # clamp: weight > 1 would flip the dense coefficient negative and
        # actively prefer the dense-worst candidate
        weight = min(max(self.config.search_rerank_weight, 0.0), 1.0)
        if not query_texts or weight <= 0.0:
            return hits_batch
        # preserve the one-list-per-query contract even when fewer texts
        # than queries were passed (e.g. a padded device batch)
        return [
            rerank_hits(
                (query_texts[i] if i < len(query_texts) else None) or "",
                hits,
                top_k,
                weight=weight,
                sym_bonus=max(self.config.search_rerank_sym_bonus, 0.0),
            )
            for i, hits in enumerate(hits_batch)
        ]

    def _use_device_rerank(self, index, query_texts, residual) -> bool:
        """Route the second-stage blend on device (index/lexical.py)?

        Requires: fingerprints exist (writer-maintained), at least one query
        carries text, lexical weight > 0, impl not forced to host, no
        residual host-side filters (those drop hits AFTER assembly, which
        would starve a pre-assembled blended top_k), and dense scores that
        are already FINAL on device (fused rescore active, or no rescore
        configured) — the blend must never be re-sorted afterwards."""
        if residual:
            return False
        if self.config.search_rerank_impl == "host":
            return False
        if not query_texts or not any(query_texts):
            return False
        if self.config.search_rerank_weight <= 0.0:
            return False
        if self._lex is None:
            return False
        if self.config.index_rescore > 0 and not getattr(
            index, "device_rescore_active", False
        ):
            return False
        return True

    def _device_rerank_dispatch(self, scores, ids, query_texts, n_q: int):
        """Chain the device blend onto in-flight (scores, ids) device
        arrays; returns device arrays (no sync)."""
        texts = [
            (query_texts[i] if query_texts and i < len(query_texts) else None)
            for i in range(n_q)
        ]
        q_ids = featurize_queries(texts)
        q_sym = featurize_query_symbols(texts)
        weight = min(max(self.config.search_rerank_weight, 0.0), 1.0)
        table = self._learned_table()
        return rerank_device(
            self._lex.device_arrays(0),
            scores,
            ids,
            q_ids,
            q_sym=q_sym,
            weight=weight,
            sym_bonus=max(self.config.search_rerank_sym_bonus, 0.0),
            table=table,
            learned_weight=max(
                getattr(self.config, "search_rerank_learned_weight", 0.0), 0.0
            ),
            mesh=self._lex.mesh,
        )

    def _device_rerank_np(self, scores, ids, query_texts):
        """Host-array variant (search_batch): round-trips through the
        device blend and returns numpy arrays."""
        s, i = self._device_rerank_dispatch(
            scores, ids, query_texts, scores.shape[0]
        )
        return (
            s.cpu().numpy().astype(np.float32, copy=False),
            i.cpu().numpy().astype(np.int64, copy=False),
        )

    def _fetch_k(self, index, top_k: int, filters) -> int:
        """Candidate fetch depth: headroom for post-filtering, plus — only
        when the index does NOT rescore on device — headroom for the host
        f32 rescore to recover approx-topk/low-precision-scoring misses."""
        fetch_k = top_k * 4 if filters else top_k
        if not getattr(index, "device_rescore_active", False):
            fetch_k = max(
                fetch_k,
                top_k * self.config.index_rescore,
                self.config.index_rescore_min if self.config.index_rescore else 0,
            )
        return min(fetch_k, max(index.size, 1))

    def _rescore_host(self, index, q: np.ndarray, scores, ids):
        """Re-rank the device candidates with exact f32 scores from the host
        mirror — recovers bf16/int8 scoring-precision losses at negligible
        cost (hundreds of candidate rows per query). Fully vectorized: one
        gather + one batched matmul per query chunk, so rescore cost stays
        flat as the batch grows."""
        if self.config.index_rescore <= 0:
            return scores, ids
        if getattr(index, "device_rescore_active", False):
            return scores, ids  # already exactly rescored in the scan step
        gather = getattr(index, "gather_f32", None)
        if gather is None:
            return scores, ids
        scores = np.asarray(scores, dtype=np.float32).copy()
        ids = np.asarray(ids)
        if self.metric == "cosine":
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        # fetch ONLY the unique candidate rows (Q*K of them) — never a whole
        # corpus mirror: gather_f32 reads the flat host buffer for FlatIndex
        # and a chunked device-mirror gather for IVF (round-2's `_host`
        # attribute became an O(N*dim) hydration property in round 3, which
        # would have made every f32-IVF search fetch the full corpus)
        uniq, inv = np.unique(np.maximum(ids, 0), return_inverse=True)
        vals, ok = gather(uniq)  # (U, d) f32, (U,) in-bounds mask
        mask = (ids >= 0) & ok[inv].reshape(ids.shape)  # (Q, K)
        # chunk queries to bound the (q, K, d) einsum footprint at high dim
        chunk = max(1, int(8e6 // max(ids.shape[1] * vals.shape[1], 1)))
        inv = inv.reshape(ids.shape)
        for lo in range(0, ids.shape[0], chunk):
            hi = lo + chunk
            x = vals[inv[lo:hi]]  # (q, K, d)
            if self.metric == "l2":
                s = -np.sum(
                    (x - q[lo:hi, None, :]) ** 2, axis=2, dtype=np.float32
                )
            else:
                s = np.einsum(
                    "qkd,qd->qk", x, q[lo:hi], dtype=np.float32
                )
            scores[lo:hi] = np.where(mask[lo:hi], s, scores[lo:hi])
        order = np.argsort(-scores, axis=1, kind="stable")
        return (
            np.take_along_axis(scores, order, axis=1),
            np.take_along_axis(ids, order, axis=1),
        )

    def _hits_from(self, view, scores, ids, top_k, filters) -> List[List[SearchHit]]:
        # row maps come from the caller's view snapshot — consistent with the
        # index the ids came from even across a concurrent promotion/load.
        # Incremental reverse map: point lookups only (building this per
        # search would be O(corpus) host work on every query).
        # top_k: one int for every query, or a per-query limit list (the
        # rerank window applies only to queries that carry text).
        _, row_to_id, row_meta, _ = view
        limits = (
            top_k if isinstance(top_k, (list, tuple))
            else [top_k] * len(scores)
        )
        out: List[List[SearchHit]] = []
        for q_scores, q_ids, lim in zip(scores, ids, limits):
            hits: List[SearchHit] = []
            for s, r in zip(q_scores.tolist(), q_ids.tolist()):
                if r < 0 or len(hits) >= lim:
                    continue
                pid = row_to_id.get(int(r))
                if pid is None:
                    continue
                meta = row_meta.get(int(r), {})
                if filters and not self._meta_matches(meta, filters):
                    continue
                hits.append(
                    SearchHit(
                        id=pid,
                        score=float(s),
                        repo=meta.get("repo"),
                        path=meta.get("path"),
                        language=meta.get("language"),
                        text=meta.get("text"),
                        metadata={
                            k: v for k, v in meta.items() if k != "text"
                        },
                    )
                )
            out.append(hits)
        return out

    def count(self) -> int:
        return len(self._id_to_row)

    def get_metadata(self, payload_id: str) -> Optional[Dict[str, Any]]:
        """Metadata for one stored chunk id (None if absent). Lock-free:
        row lookup and metadata come from ONE view snapshot, so a concurrent
        compaction/promotion can't mix old row numbers with new maps."""
        view = self._view
        row = view[3].get(payload_id)
        if row is None:
            return None
        return view[2].get(row)

    def ids_for_repo(self, repo: str) -> List[str]:
        """All stored payload ids belonging to a repo (snapshot-consistent)."""
        _, row_to_id, row_meta, _ = self._view
        return [
            pid
            for row, pid in list(row_to_id.items())
            if row_meta.get(row, {}).get("repo") == repo
        ]

    def iter_payload_meta(self):
        """Yield (payload id, metadata dict) for every stored chunk.

        Snapshot-consistent: iterates one view, so concurrent mutation can't
        produce a mixed-generation listing (used by the quality harness)."""
        _, row_to_id, row_meta, _ = self._view
        for row, pid in list(row_to_id.items()):
            yield pid, row_meta.get(row, {})

    # -- persistence ------------------------------------------------------------------

    def save(self, directory: Optional[Path] = None) -> Path:
        """Serialize the index + metadata (centroids, vectors, id map)."""
        directory = Path(directory or self.snapshot_dir())
        directory.mkdir(parents=True, exist_ok=True)
        with self._lock:
            state = self._index.state_dict() if self._index else None
            arrays = {}
            meta: Dict[str, Any] = {
                "dim": self.dim,
                "metric": self.metric,
                "kind": state["kind"] if state else None,
                "pair_ids": [
                    [repo, lang, tag]
                    for (repo, lang), tag in self._pair_ids.items()
                ],
            }
            if state:
                for key, val in state.items():
                    if isinstance(val, np.ndarray):
                        arrays[key] = val
                    else:
                        meta[f"state_{key}"] = val
            np.savez_compressed(directory / "index.npz", **arrays)
            # chunk texts/metadata are bulky at corpus scale: msgpack, not JSON
            import msgpack

            payload = msgpack.packb(
                {
                    "id_to_row": self._id_to_row,
                    "row_meta": {str(k): v for k, v in self._row_meta.items()},
                },
                use_bin_type=True,
            )
            tmp_meta = directory / "rows.msgpack.tmp"
            tmp_meta.write_bytes(payload)
            tmp_meta.replace(directory / "rows.msgpack")
            tmp = directory / "store.json.tmp"
            tmp.write_text(json.dumps(meta), encoding="utf-8")
            tmp.replace(directory / "store.json")
        log.info("store_saved", path=str(directory), rows=self.count())
        return directory

    def load(self, directory: Path) -> None:
        directory = Path(directory)
        meta = json.loads((directory / "store.json").read_text(encoding="utf-8"))
        arrays = dict(np.load(directory / "index.npz", allow_pickle=False))
        state = {k[6:]: v for k, v in meta.items() if k.startswith("state_")}
        state.update(arrays)
        self.dim = int(meta["dim"])
        self.metric = str(meta["metric"])
        kind = meta.get("kind")
        if kind == "ivf":
            index = IVFIndex.from_state(state, **self._ivf_options())
        elif kind == "flat":
            index = FlatIndex.from_state(state, **self._index_options())
        else:
            index = None
        rows_file = directory / "rows.msgpack"
        if rows_file.exists():
            import msgpack

            rows = msgpack.unpackb(rows_file.read_bytes(), raw=False)
            id_to_row = {k: int(v) for k, v in rows["id_to_row"].items()}
            row_meta = {int(k): v for k, v in rows["row_meta"].items()}
        else:  # snapshots from before the msgpack split
            id_to_row = {k: int(v) for k, v in meta["id_to_row"].items()}
            row_meta = {int(k): v for k, v in meta["row_meta"].items()}
        if kind == "ivf" and "rows" in state:
            # IVFIndex.from_state renumbers the saved LIVE rows densely
            # (0..n-1 in saved order); remap the id/meta maps to match, else a
            # snapshot taken after any delete dereferences the wrong vectors
            remap = {
                int(old): new
                for new, old in enumerate(np.asarray(state["rows"]).tolist())
            }
            id_to_row = {
                pid: remap[r] for pid, r in id_to_row.items() if r in remap
            }
            row_meta = {
                remap[r]: m for r, m in row_meta.items() if r in remap
            }
        self._pair_ids = {
            (str(repo), str(lang)): int(tag)
            for repo, lang, tag in meta.get("pair_ids", [])
        }
        # Re-derive row tags from the (authoritative) row metadata. Snapshots
        # written before the filtered-search feature carry no pair table and
        # tag-0 rows; without this, device filters would silently exclude
        # every legacy row forever (and new upserts would assign conflicting
        # tag ids).
        if index is not None and row_meta:
            for row, m in row_meta.items():
                tag = self._tag_for(m)
                if 0 <= row < index._tags.shape[0]:
                    index._tags[row] = tag
            index._dirty = True  # device tags refresh on next materialize
        # single atomic view swap: loading renumbers rows wholesale
        self._view = (
            index, {r: i for i, r in id_to_row.items()}, row_meta, id_to_row
        )
        # fingerprint rows are snapshot-derived: drop them; the table
        # rebuilds from row_meta on the next mutation (searches use the
        # host scorer until then — same blend, host-side)
        self._lex = None
        self.version += 1
        log.info("store_loaded", path=str(directory), rows=self.count())

    # -- introspection ---------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        idx = self._index
        info: Dict[str, Any] = {
            "rows": self.count(),
            "dim": self.dim,
            "metric": self.metric,
            "kind": idx.kind if idx else None,
            # mutation generation (cache invalidation) and the number of
            # (repo, language) pairs filterable on device
            "version": self.version,
            "filter_pairs": len(self._pair_ids),
            # allocated minus live = reclaimable via compact(). FlatIndex
            # counts allocation in .size/.n_live; IVFIndex in ._n_rows/.size
            "tombstones": (
                int(idx._n_rows) - int(idx.size)
                if isinstance(idx, IVFIndex)
                else int(idx.size) - int(idx.n_live)
            )
            if idx
            else 0,
        }
        if isinstance(idx, IVFIndex):
            info.update(
                nlist=idx.nlist,
                nprobe=idx.nprobe,
                cmax=idx.cmax,
                trained=idx.is_trained,
            )
        return info


def _allocated(index) -> int:
    """Rows allocated, tombstones included: FlatIndex counts them in
    ``size``, IVFIndex in ``_n_rows`` (its ``size`` counts live rows)."""
    return int(index._n_rows) if isinstance(index, IVFIndex) else int(index.size)


@runtime_checkable
class EmbeddingPayloadLike(Protocol):
    """Structural type for upsert payloads: id, text, vector, metadata."""

    id: str
    text: str
    vector: VectorLike
    metadata: Optional[Dict[str, Any]]
