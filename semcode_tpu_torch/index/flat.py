"""Flat (exact) vector index on one device.

Counterpart of ``semcode_tpu/index/flat.py``: the corpus lives in device
memory as a ``(capacity, dim)`` matrix in the storage dtype; a query batch
is one exact scan (``scan.exact_scan``) with a fused f32 rescore. The host
keeps the authoritative f32 buffer, so snapshots and growth never read back
from the device.

Device state is one tuple of tensors swapped as a whole, and writers build
new tensors (out-of-place scatters) rather than editing the ones a reader
may hold: a search racing an upsert sees the old or the new corpus, never a
torn one — the reference's immutable-array contract, at the cost of one
device copy of the touched arrays per write batch.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, round_up, storage_dtype, storage_name
from .scan import exact_scan, exact_scan_batched, resolve_rescore_width

_NEG_INF = np.float32(-3.0e38)

# above this f32-mirror footprint the fused device rescore falls back to the
# two-level int8 residual mirror (auto mode), and above the residual budget
# to host rescoring (device-memory budget guards, as the reference)
DEVICE_RESCORE_MAX_BYTES = 4 << 30
RESIDUAL_RESCORE_MAX_BYTES = 6 << 30


def quantize_rows(x: np.ndarray):
    """Symmetric per-row int8 quantization: returns (int8 values, f32 scales)."""
    scale = np.maximum(np.abs(x).max(axis=-1), 1e-12) / 127.0
    q = np.clip(np.rint(x / scale[..., None]), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def quantize_rows_device(x: torch.Tensor):
    """``quantize_rows`` on device tensors: the same f32 operations, so the
    same bits (division and round-half-even are exact IEEE operations)."""
    scale = torch.clamp(x.abs().amax(dim=-1), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float32)


def quantize_residual_device(x: torch.Tensor, qx: torch.Tensor,
                             scales: torch.Tensor):
    """Second-level int8 quantization of the reconstruction residual
    ``r = x - qx * scale`` (|r| <= scale/2, so its own scale is ~1/254 of
    the first level), as the reference's host ``quantize_residual``.
    Returns (int8 residual, f32 residual scales)."""
    r = x - qx.to(torch.float32) * scales[..., None]
    rs = torch.clamp(r.abs().amax(dim=-1), min=1e-20) / 127.0
    rq = torch.clamp(torch.round(r / rs[..., None]), -127, 127)
    return rq.to(torch.int8), rs.to(torch.float32)


def split_rescore(payload):
    """Normalize a rescore payload (None | f32 mirror | (resid, rscales))
    into the (rescore, resid, rscales) operand triple exact_scan takes."""
    if payload is None:
        return None, None, None
    if isinstance(payload, tuple):
        return None, payload[0], payload[1]
    return payload, None, None


def pad_allow(allow) -> np.ndarray:
    """Pad an allowed-tag list to a power-of-two bucket with -1 sentinels
    (tags are >= 0, so -1 never matches)."""
    a = np.asarray(allow, dtype=np.int32).ravel()
    if a.size == 0:
        raise ValueError("allow_tags must be non-empty (empty = no results)")
    n = 8
    while n < a.size:
        n *= 2
    out = np.full((n,), -1, dtype=np.int32)
    out[: a.size] = a
    return out


def _sqnorms(x: np.ndarray) -> np.ndarray:
    return np.sum(x.astype(np.float32) ** 2, axis=1)


def _set_rows(arr: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor):
    """Out-of-place row scatter (readers keep the previous tensor)."""
    return arr.index_copy(0, rows, vals.to(arr.dtype))


class FlatIndex:
    """Exact-scan index over a device-resident matrix.

    Host-authoritative storage: a float32 numpy buffer (amortized growth)
    mirrors the device tensors. Selection is always exact: the reference's
    approximate selection (``approx_topk``, ``approx_recall_target``)
    exists only on a TPU, so those options have no counterpart here."""

    kind = "flat"

    def __init__(
        self,
        dim: int,
        *,
        metric: str = "ip",
        dtype: str = "bfloat16",
        capacity: int = 0,
        device_rescore: Optional[bool] = None,  # None = auto by memory budget
        score_dtype: str = "auto",  # auto | float32 | float16
        fetch_width: int = 0,  # 0 = auto (max(4k, 128)); rescore candidate pool
        scan_impl: str = "auto",  # auto | xla | pallas (exact-scan kernel)
        rescore_mode: str = "auto",  # auto | f32 | residual | off
        rescore_width: int = 0,  # top-W gather slice; 0 = auto, -1 = full fetch
        device: DeviceLike = None,
    ):
        if metric not in ("ip", "cosine", "l2"):
            raise ValueError(f"unknown metric: {metric}")
        if score_dtype not in ("auto", "float32", "float16"):
            raise ValueError(f"unknown score_dtype: {score_dtype}")
        if scan_impl not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown scan_impl: {scan_impl}")
        if rescore_mode not in ("auto", "f32", "residual", "off"):
            raise ValueError(f"unknown rescore_mode: {rescore_mode}")
        self.dim = int(dim)
        self.metric = metric
        self.device = resolve_device(device)
        self._dtype = storage_dtype(dtype)
        self._device_rescore = device_rescore
        self.rescore_mode = rescore_mode
        self.score_dtype = score_dtype
        self.fetch_width = int(fetch_width)
        self.rescore_width = int(rescore_width)
        self.scan_impl = scan_impl
        # the reference's lcm(n_shards * 8, 128) with one shard: rows stay
        # 128-aligned, so the kernel's block layout matches its tiling
        self._row_multiple = math.lcm(8, 128)
        self.capacity = round_up(max(capacity, self._row_multiple), self._row_multiple)
        self.size = 0  # rows allocated (including tombstones)
        self.n_live = 0  # rows alive
        self._host = np.zeros((self.capacity, self.dim), dtype=np.float32)
        self._alive = np.zeros((self.capacity,), dtype=bool)
        # int32 row tags for device-side filtered search (0 = untagged)
        self._tags = np.zeros((self.capacity,), dtype=np.int32)
        # device state: one atomically-swapped tuple
        # (vecs, norms, valid, scales-or-None, rescore-or-None, tags)
        self._dev: Optional[tuple] = None
        self._dirty = True  # device tensors need (re)materialization

    # -- host <-> device ------------------------------------------------------

    def _score_dtype(self, rescore) -> str:
        """fp16 score matrix only where the fused f32 rescore re-orders the
        fetched candidates; auto is float32 (as the reference)."""
        if self.score_dtype == "float16" and rescore is None:
            return "float32"
        if self.score_dtype != "auto":
            return self.score_dtype
        return "float32"

    def _rescore_kind(self) -> str:
        """Fused device-rescore policy: 'f32' (exact mirror), 'residual'
        (two-level int8, int8 storage only), or 'none' (flat.py:178-207)."""
        if self._dtype == torch.float32:
            return "none"  # storage is already exact
        if self.rescore_mode == "off":
            return "none"
        if self.rescore_mode == "f32":
            return "f32"
        if self.rescore_mode == "residual":
            return "residual" if self._dtype == torch.int8 else "f32"
        if self._device_rescore is False:
            return "none"
        if self._device_rescore is True:
            return "f32"
        if self.capacity * self.dim * 4 <= DEVICE_RESCORE_MAX_BYTES:
            return "f32"
        if (
            self._dtype == torch.int8
            and self.capacity * (self.dim + 4) <= RESIDUAL_RESCORE_MAX_BYTES
        ):
            return "residual"
        return "none"

    def _materialize(self) -> tuple:
        """Push the host buffer to device tensors (quantized on device)."""
        x = torch.from_numpy(self._host).to(self.device)
        scales = None
        if self._dtype == torch.int8:
            vecs, scales = quantize_rows_device(x)
        else:
            vecs = x.to(self._dtype)
        # squared norms summed on the host, in the reference's (numpy) order
        norms = torch.from_numpy(_sqnorms(self._host)).to(self.device)
        valid = torch.from_numpy(self._alive).to(self.device)
        kind = self._rescore_kind()
        if kind == "f32":
            rescore = x
        elif kind == "residual":
            rescore = quantize_residual_device(x, vecs, scales)
        else:
            rescore = None
        tags = torch.from_numpy(self._tags).to(self.device)
        dev = (vecs, norms, valid, scales, rescore, tags)
        self._dev = dev  # single atomic swap
        self._dirty = False
        return dev

    @property
    def device_rescore_active(self) -> bool:
        """True when searches already return exact-grade rescored results,
        so the store skips its host-side rescore."""
        dev = self._dev
        if dev is not None:
            return dev[4] is not None
        return self._rescore_kind() != "none"

    def _ensure_device(self) -> tuple:
        dev = self._dev
        if dev is None:
            dev = self._materialize()
        return dev

    # -- mutation ---------------------------------------------------------------

    def _grow(self, min_capacity: int) -> None:
        new_cap = round_up(max(min_capacity, self.capacity * 2), self._row_multiple)
        host = np.zeros((new_cap, self.dim), dtype=np.float32)
        host[: self.size] = self._host[: self.size]
        alive = np.zeros((new_cap,), dtype=bool)
        alive[: self.size] = self._alive[: self.size]
        tags = np.zeros((new_cap,), dtype=np.int32)
        tags[: self.size] = self._tags[: self.size]
        self._host = host
        self._alive = alive
        self._tags = tags
        self.capacity = new_cap
        self._dirty = True

    def _prepare(self, x: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(x, dtype=np.float32)
        if x.ndim != 2 or x.shape[1] != self.dim:
            raise ValueError(f"expected (n, {self.dim}) vectors, got {x.shape}")
        if self.metric == "cosine":
            norms = np.linalg.norm(x, axis=1, keepdims=True)
            x = x / np.maximum(norms, 1e-12)
        return x

    def _coerce_tags(self, tags, n: int) -> np.ndarray:
        if tags is None:
            return np.zeros((n,), dtype=np.int32)
        tags = np.asarray(tags, dtype=np.int32).ravel()
        if tags.shape[0] != n:
            raise ValueError(f"expected {n} tags, got {tags.shape[0]}")
        return tags

    def add(self, x: np.ndarray, tags=None) -> np.ndarray:
        """Append rows; returns assigned row ids. ``tags`` (optional int32
        per row, >= 0) enable device-side filtered search; None = tag 0."""
        x = self._prepare(x)
        n = x.shape[0]
        if n == 0:
            return np.zeros((0,), dtype=np.int64)
        tags = self._coerce_tags(tags, n)
        if self.size + n > self.capacity:
            self._grow(self.size + n)
        rows = np.arange(self.size, self.size + n, dtype=np.int64)
        self._host[rows] = x
        self._alive[rows] = True
        self._tags[rows] = tags
        self.size += n
        self.n_live += n
        self._write_device(rows, x, tags)
        if self._dirty:
            self._materialize()  # eager: readers never materialize dirty state
        return rows

    def gather_f32(self, rows: np.ndarray):
        """Exact f32 values for the given row ids from the host buffer.
        Returns ``(vals, ok)``; ``ok`` masks out-of-bounds ids."""
        rows = np.asarray(rows, dtype=np.int64)
        ok = (rows >= 0) & (rows < self._host.shape[0])
        return self._host[np.where(ok, rows, 0)], ok

    def update_rows(self, rows: np.ndarray, x: np.ndarray, tags=None) -> None:
        """Overwrite existing rows in place (upsert path)."""
        x = self._prepare(x)
        rows = np.asarray(rows, dtype=np.int64)
        tags = self._coerce_tags(tags, x.shape[0])
        self.n_live += int(np.sum(~self._alive[rows]))
        self._host[rows] = x
        self._alive[rows] = True
        self._tags[rows] = tags
        self._write_device(rows, x, tags)

    def remove(self, rows: np.ndarray) -> None:
        """Tombstone rows; they stop appearing in search results."""
        rows = np.asarray(rows, dtype=np.int64)
        rows = rows[self._alive[rows]]
        if rows.size == 0:
            return
        self._alive[rows] = False
        self.n_live -= int(rows.size)
        dev = self._dev
        if not self._dirty and dev is not None:
            rows_d = torch.from_numpy(rows).to(self.device)
            valid = dev[2].index_fill(0, rows_d, False)
            self._dev = (dev[0], dev[1], valid, dev[3], dev[4], dev[5])

    def _write_device(self, rows: np.ndarray, x: np.ndarray, tags) -> None:
        """Incremental scatter into the device tensors."""
        dev = self._dev
        if self._dirty or dev is None:
            return  # will materialize before the next search
        rows_d = torch.from_numpy(rows).to(self.device)
        x_d = torch.from_numpy(x).to(self.device)
        vecs, norms, valid, scl, rescore, tags_dev = dev
        tags_dev = _set_rows(tags_dev, rows_d, torch.from_numpy(tags).to(self.device))
        norms = _set_rows(norms, rows_d, torch.from_numpy(_sqnorms(x)).to(self.device))
        valid = _set_rows(valid, rows_d, torch.ones_like(rows_d, dtype=torch.bool))
        if self._dtype == torch.int8:
            qx, sx = quantize_rows_device(x_d)
            vecs = _set_rows(vecs, rows_d, qx)
            scl = _set_rows(scl, rows_d, sx)
            if isinstance(rescore, tuple):  # residual mirror in lockstep
                rq, rs = quantize_residual_device(x_d, qx, sx)
                rescore = (_set_rows(rescore[0], rows_d, rq),
                           _set_rows(rescore[1], rows_d, rs))
        else:
            vecs = _set_rows(vecs, rows_d, x_d)
        if rescore is not None and not isinstance(rescore, tuple):
            rescore = _set_rows(rescore, rows_d, x_d)  # f32 mirror in lockstep
        self._dev = (vecs, norms, valid, scl, rescore, tags_dev)

    # -- search -----------------------------------------------------------------

    def _storage_name(self) -> str:
        return storage_name(self._dtype)

    @property
    def rows_allocated(self) -> int:
        """Upper bound (exclusive) of valid row ids, tombstones included."""
        return self.size

    def _scan_impl(self) -> str:
        """Exact-scan routing (flat.py:405-417): 'pallas' runs the fused
        top-2 kernel (its plain version on a CPU device) when dim % 128 ==
        0; everything else, 'auto' included, runs the full-matrix route."""
        if self.scan_impl != "pallas" or self.dim % 128 != 0:
            return "xla"
        return "pallas"

    def _fetch_width(self, k: int, n_rows: int, rescore) -> int:
        """Candidate width: over-fetch when the fused rescore re-ranks."""
        if rescore is None:
            return min(k, n_rows)
        if self.fetch_width > 0:
            return min(max(self.fetch_width, k), n_rows)
        if isinstance(rescore, tuple):
            return min(max(4 * k, 96), n_rows)
        return min(max(4 * k, 128), n_rows)

    def _rescore_width(self, k: int, rescore) -> int:
        return resolve_rescore_width(
            self.rescore_width, self.fetch_width, k, rescore
        )

    def _allow_dev(self, allow_tags):
        if allow_tags is None:
            return None
        return torch.from_numpy(pad_allow(allow_tags)).to(self.device)

    def _scan(self, dev, q_dev, k, k_out, allow_tags, batched=False):
        vecs, norms, valid, scales, rescore, tags = dev
        resc_f32, resid, rscl = split_rescore(rescore)
        fn = exact_scan_batched if batched else exact_scan
        return fn(
            vecs,
            norms,
            valid,
            scales if scales is not None else norms,
            resc_f32,
            q_dev,
            k,
            self._fetch_width(k, vecs.shape[0], rescore),
            self.metric,
            self._storage_name(),
            k_out=k_out,
            score_dtype=self._score_dtype(rescore),
            tags=tags if allow_tags is not None else None,
            allow=self._allow_dev(allow_tags),
            scan_impl=self._scan_impl(),
            resid=resid,
            rscales=rscl,
            rescore_width=self._rescore_width(k, rescore),
        )

    def search(
        self, queries: np.ndarray, k: int = 10, allow_tags=None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k search; returns (scores f32 (Q,k), ids int64 (Q,k), -1 = empty).

        ``allow_tags``: optional sequence of allowed row tags — rows tagged
        otherwise are masked on device before selection (filtered search)."""
        q = np.ascontiguousarray(np.atleast_2d(queries), dtype=np.float32)
        if q.shape[1] != self.dim:
            raise ValueError(f"expected queries of dim {self.dim}, got {q.shape}")
        n_q = q.shape[0]
        if self.n_live == 0:
            return (
                np.full((n_q, k), _NEG_INF, dtype=np.float32),
                np.full((n_q, k), -1, dtype=np.int64),
            )
        if self.metric == "cosine":
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        dev = self._ensure_device()
        n_rows = dev[0].shape[0]
        k_eff = min(k, n_rows)
        scores, ids = self._scan(
            dev, torch.from_numpy(q).to(self.device), k_eff, k_eff, allow_tags
        )
        scores = scores.cpu().numpy().astype(np.float32)
        ids = ids.cpu().numpy().astype(np.int64)
        invalid = ids >= self.size
        scores = np.where(invalid | (scores <= _NEG_INF / 2), _NEG_INF, scores)
        ids = np.where(invalid | (scores <= _NEG_INF / 2), -1, ids)
        if k_eff < k:
            scores = np.pad(scores, ((0, 0), (0, k - k_eff)), constant_values=_NEG_INF)
            ids = np.pad(ids, ((0, 0), (0, k - k_eff)), constant_values=-1)
        return scores, ids

    def search_device(self, q_dev: torch.Tensor, k: int, allow_tags=None):
        """Device-to-device search: no host transfers or syncs.

        ``q_dev``: (Q, dim) tensor on this index's device, already
        metric-normalized. Returns device tensors (scores, ids)."""
        dev = self._ensure_device()
        k = min(k, dev[0].shape[0])
        return self._scan(dev, q_dev, k, None, allow_tags)

    def search_device_batched(self, qs_dev: torch.Tensor, k: int, allow_tags=None):
        """``search_device`` over B batches: qs_dev (B, Q, dim); returns
        (scores (B, Q, k), ids (B, Q, k)) device tensors."""
        dev = self._ensure_device()
        k = min(k, dev[0].shape[0])
        return self._scan(dev, qs_dev, k, None, allow_tags, batched=True)

    # -- maintenance ---------------------------------------------------------------

    def _like(self, capacity: int) -> "FlatIndex":
        return FlatIndex(
            self.dim,
            metric=self.metric,
            dtype=self._storage_name(),
            capacity=capacity,
            device_rescore=self._device_rescore,
            score_dtype=self.score_dtype,
            fetch_width=self.fetch_width,
            scan_impl=self.scan_impl,
            rescore_mode=self.rescore_mode,
            rescore_width=self.rescore_width,
            device=self.device,
        )

    def compacted(self) -> Tuple["FlatIndex", np.ndarray]:
        """Build a NEW index holding only the live rows, renumbered densely.
        Returns (new_index, remap) for the store's one-swap install."""
        live = np.flatnonzero(self._alive[: self.size])
        remap = np.full(self.size, -1, dtype=np.int64)
        remap[live] = np.arange(live.size)
        new = self._like(int(live.size))
        if live.size:
            # rows are already metric-normalized; add()'s re-normalization is
            # a no-op for unit rows
            new.add(self._host[live], tags=self._tags[live])
        return new, remap

    def compact(self) -> np.ndarray:
        """Drop tombstoned rows and renumber densely; returns the remap
        array (old row -> new row, -1 for dropped rows)."""
        live = np.flatnonzero(self._alive[: self.size])
        remap = np.full(self.size, -1, dtype=np.int64)
        remap[live] = np.arange(live.size)
        n = int(live.size)
        self._host[:n] = self._host[live]
        self._tags[:n] = self._tags[live]
        self._host[n : self.size] = 0.0
        self._tags[n : self.size] = 0
        self._alive[: self.size] = False
        self._alive[:n] = True
        self.size = n
        self.n_live = n
        self._dirty = True
        self._materialize()
        return remap

    # -- persistence ---------------------------------------------------------------

    def state_dict(self) -> dict:
        """Same keys and dtypes as the reference's ``FlatIndex.state_dict``."""
        return {
            "kind": self.kind,
            "dim": self.dim,
            "metric": self.metric,
            "size": self.size,
            "vectors": self._host[: self.size].copy(),
            "alive": self._alive[: self.size].copy(),
            "tags": self._tags[: self.size].copy(),
        }

    @classmethod
    def from_state(cls, state: dict, **kwargs) -> "FlatIndex":
        idx = cls(int(state["dim"]), metric=str(state["metric"]), **kwargs)
        vecs = np.asarray(state["vectors"], dtype=np.float32)
        if vecs.size:
            # rows were normalized already if cosine; bypass _prepare's re-norm
            n = vecs.shape[0]
            if idx.size + n > idx.capacity:
                idx._grow(idx.size + n)
            idx._host[:n] = vecs
            alive = state.get("alive")
            alive = (
                np.asarray(alive, dtype=bool)
                if alive is not None
                else np.ones(n, dtype=bool)
            )
            idx._alive[:n] = alive
            tags = state.get("tags")
            if tags is not None:
                idx._tags[:n] = np.asarray(tags, dtype=np.int32)
            idx.size = n
            idx.n_live = int(alive.sum())
            idx._dirty = True
        return idx
