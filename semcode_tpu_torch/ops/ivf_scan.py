"""IVF probing kernel: masked top-k of each query over its probed clusters.

Replaces ``semcode_tpu/ops/kernels.py::ivf_scan_shard`` (the Pallas TPU
kernel, ``pallas_call`` at line 374). A sharded index calls it once per
shard on that shard's clusters, with the probes it does not own out of
range (the probe table skips them). The function:

    for query q and every slot s of every cluster c it probes:
        int8:       score = (float(raw) * q_scale[q]) * scales[c, s]
                    raw = quantized q . data[c, s]   (exact integer dot)
        bf16 / f32: score = q . data[c, s]           (f32 query, f32 sum)
        slots with ids[c, s] < 0 score -3e38 (empty or tombstoned)
    -> (scores (Q, k) descending, ids (Q, k) int32); a query with fewer
       than k valid candidates gets -3e38 / -1 in its tail.

Ties break by (cluster id, slot), lowest first: the TPU kernel's order for
any query whose probed clusters hold at most 128 candidates that reach its
running top-k; beyond that the TPU kernel's slot reuse leaves its tie order
unspecified, and only tied scores can differ.

What bounds it on an H100 at the main path's shape (1M x 384 int8, nlist
1024, cmax 2176, Q=512, nprobe 32, clusters ~45% full): reading the ids of
every slot of the probed clusters and the row and scale of every valid
one, ~0.40 GB (0.12 ms at 3.35 TB/s), against 2.7e10 int8 ops (0.014 ms);
bf16 rows are ~0.78 GB (0.23 ms) and f32 rows ~1.54 GB (0.46 ms), against
1.2e10 useful f32 operations (0.18 ms on the CUDA cores).
The CUDA source (``csrc/ivf_scan.cu``) streams each probed cluster up to
its last valid 128-slot chunk (a layout packs a cluster's rows at the
front of its block) and hides the selection under the stream, in four
launches and no host sync:

- ``prep`` (one block) builds the probe table (repeats and out-of-range
  probes skipped), ranks the (query, probe) pairs in per-cluster buckets
  and writes the tile list; ``scatter`` puts each pair in its bucket, finds
  each probed cluster's last chunk holding a valid id and copies the pair's
  query row into pair order (int8: the quantized row; bf16: the f32 row's
  three bf16 parts, ``split_bf16x3``; f32: the row), so that a tile's
  queries are contiguous rows for TMA;
- the scan, one kernel body for every storage: persistent warp-specialised
  CTAs stream each tile's cluster and query rows by TMA into an mbarrier
  ring. int8: two consumer warpgroups run ``wgmma`` s8 m64n64k32 on half a
  128-row chunk each (queries as M, rows as N). bf16 (tiles of 20 queries):
  the same with one ``wgmma`` bf16 m64n64k16 a 16 of depth on the rows as
  stored, each query's three parts as three M rows, so each score sums the
  exact f32 products; f32 (tiles of 32): the consumers' eight warps run
  exact f32 FMAs from the same stages on the CUDA cores. Each
  query keeps its k-th score as a threshold and appends the scores that
  beat it to a candidate buffer in shared memory; before a chunk could
  overflow a buffer, and at the cluster's end, a warp selects the buffer's
  k best (an exact histogram select), raises the threshold and publishes
  the k-th score as a bound on the query's final k-th, against which its
  later pairs filter too (ties pass, so the result stays exact);
- ``merge`` (a warp per query) merges the query's sorted per-pair lists by
  (score desc, cluster asc, list position asc), which is the order a stable
  top-k over the probe-sorted partials gives.

``ivf_geometry`` computes every launch's geometry; the C entry points check
it again. On a CPU tensor the wrapper runs ``ivf_scan_reference``, the
plain torch version; on a CUDA tensor it launches the kernels or raises.
``prep_reference`` and ``merge_reference`` are the plain versions of the
bookkeeping kernels.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..device import sm_count
from ..index.scan import quantize_queries_device, stable_topk
from .build import KernelError, KernelLibrary

NEG = -3.0e38  # masked-slot / empty-result sentinel (f32)
MAX_K = 64
MAX_PROBE = 128

_STORAGE_CODES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
# bytes of the (Q, nprobe, cmax, d) f64 gather the plain version holds at once
_PLAIN_CHUNK_BYTES = 1 << 30

# launch geometry; csrc/ivf_scan.cu holds the same constants
QUERY_TILE = 64  # int8 tile queries (wgmma M)
BF16_QUERY_TILE = 20  # bf16 tile queries: three parts of 5 a warp fill 15 of its 16 M rows
FLOAT_QUERY_TILE = 32  # f32 tile queries
ROW_CHUNK = 128  # cluster rows per streamed chunk (wgmma N)
DEPTH_CHUNK = 128  # bytes of depth per ring stage
QUERY_PARTS = 3  # bf16 storage: the f32 query's bf16 parts hi, mid, lo
QUERY_BOX = 16  # int8/bf16 query rows per TMA box: one consumer warp's rows of M
FLOAT_QUERY_BOX = 8  # f32 query rows per TMA box
# a ring stage: the row chunk, then the queries: int8 and bf16 one 64-row M
# operand (bf16: a query's three parts are three of its rows), f32 the
# tile's 32 rows
STAGE_BYTES = ROW_CHUNK * DEPTH_CHUNK + QUERY_TILE * DEPTH_CHUNK
BF16_STAGE_BYTES = STAGE_BYTES
F32_STAGE_BYTES = ROW_CHUNK * DEPTH_CHUNK + FLOAT_QUERY_TILE * DEPTH_CHUNK
# candidate (score, slot) entries of a tile's queries, shared out per tile:
# min(CANDIDATES_MAX, pool / nq) each, never less than MAX_K + ROW_CHUNK
CANDIDATE_POOL = QUERY_TILE * 192
BF16_CANDIDATE_POOL = BF16_QUERY_TILE * 192
FLOAT_CANDIDATE_POOL = FLOAT_QUERY_TILE * 192
CANDIDATES_MAX = 384
BUFFER_BYTES = CANDIDATE_POOL * 8
BF16_BUFFER_BYTES = BF16_CANDIDATE_POOL * 8
FLOAT_BUFFER_BYTES = FLOAT_CANDIDATE_POOL * 8
EPILOGUE_BYTES = 4 * ROW_CHUNK * 8  # ids and scales of four row chunks
MISC_BYTES = 6144  # per-query state, the select histograms, the barriers
SMEM_ALIGN = 1024  # slack to align the ring to the 128-byte swizzle atom
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on Hopper
GATHER_ROWS = 8  # pairs per scatter block (a warp each)
MERGE_SMEM_MAX = 49_152
MAX_MERGE_WARPS = 4


@dataclass(frozen=True)
class IvfGeometry:
    """Launch geometry of one ``ivf_scan`` call's scan.

    ``tile_bound`` bounds the tiles without reading the bucket sizes back;
    the scan runs ``grid`` persistent CTAs with ``stages`` ring stages."""

    query_tile: int
    n_pairs: int
    tile_bound: int
    grid: int
    stages: int
    smem_bytes: int


def tile_bound(n_pairs: int, nlist: int, query_tile: int) -> int:
    """Each cluster's ``n`` pairs make ``ceil(n / query_tile)`` tiles: at
    most ``n / query_tile`` plus one for every non-empty cluster."""
    return -(-n_pairs // query_tile) + min(nlist, n_pairs)


def merge_geometry(nprobe: int, k: int) -> Tuple[int, int]:
    """(queries per merge block, its shared-memory bytes): a warp a query,
    each with its ``nprobe * k`` list scores staged."""
    per_query = nprobe * k * 4
    warps = max(1, min(MAX_MERGE_WARPS, MERGE_SMEM_MAX // per_query))
    return warps, warps * per_query


def stage_bytes(storage: torch.dtype) -> int:
    """Bytes of one ring stage of the scan over ``storage`` rows."""
    return {torch.int8: STAGE_BYTES, torch.bfloat16: BF16_STAGE_BYTES,
            torch.float32: F32_STAGE_BYTES}[storage]


def query_tile(storage: torch.dtype) -> int:
    """Queries of one tile of the scan over ``storage`` rows."""
    return {torch.int8: QUERY_TILE, torch.bfloat16: BF16_QUERY_TILE,
            torch.float32: FLOAT_QUERY_TILE}[storage]


def buffer_bytes(storage: torch.dtype) -> int:
    """Bytes of the candidate pool of one tile's queries."""
    return {torch.int8: BUFFER_BYTES, torch.bfloat16: BF16_BUFFER_BYTES,
            torch.float32: FLOAT_BUFFER_BYTES}[storage]


def ivf_geometry(storage: torch.dtype, nlist: int, cmax: int, d: int, nq: int,
                 nprobe: int, k: int, sms: int) -> IvfGeometry:
    """Tiles, ring stages, shared memory and grid of the scan over
    ``storage`` rows (int8, bf16 or f32) on ``sms`` multiprocessors."""
    if (storage not in _STORAGE_CODES or nlist <= 0 or cmax <= 0 or cmax % ROW_CHUNK
            or d <= 0 or d % DEPTH_CHUNK or nq <= 0 or not 0 < nprobe <= MAX_PROBE
            or not 0 < k <= MAX_K or sms <= 0):
        raise ValueError(f"no ivf_scan geometry for {storage} nlist={nlist} "
                         f"cmax={cmax} d={d} Q={nq} nprobe={nprobe} k={k}")
    tile = query_tile(storage)
    n_pairs = nq * nprobe
    bound = tile_bound(n_pairs, nlist, tile)
    fixed = SMEM_ALIGN + buffer_bytes(storage) + EPILOGUE_BYTES + MISC_BYTES
    stages = (SMEM_LIMIT - fixed) // stage_bytes(storage)
    return IvfGeometry(query_tile=tile, n_pairs=n_pairs, tile_bound=bound,
                       grid=min(sms, bound), stages=stages,
                       smem_bytes=fixed + stages * stage_bytes(storage))


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    # probes, int64?, Q, nprobe, nlist, tile; seven buffers; query form,
    # query rows, d, qbuf; ids, cmax, nchunk; gather blocks, stream
    lib.semcode_ivf_prep.argtypes = (
        [p, i, i, i, i, i] + [p] * 7 + [i, p, i, p] + [p, i, p] + [i, p]
    )
    lib.semcode_ivf_prep.restype = i
    # twelve pointers; nlist, cmax, d, n_pairs, nprobe, k, storage, grid,
    # stages, smem bytes; stream
    lib.semcode_ivf_scan.argtypes = [p] * 12 + [i] * 10 + [p]
    lib.semcode_ivf_scan.restype = i
    lib.semcode_ivf_merge.argtypes = [p] * 5 + [i] * 5 + [p]
    lib.semcode_ivf_merge.restype = i
    lib.semcode_ivf_scan_attributes.argtypes = [i, p]
    lib.semcode_ivf_scan_attributes.restype = i
    lib.semcode_ivf_phases.argtypes = [i, p]
    lib.semcode_ivf_phases.restype = i


_library = KernelLibrary("ivf_scan", _bind)
PROBE_LIBRARIES = {
    "products": KernelLibrary("ivf_scan", _bind, ("-DIVF_PROBE=1",), "products"),
    "selection": KernelLibrary("ivf_scan", _bind, ("-DIVF_PROBE=2",), "selection"),
    "phases": KernelLibrary("ivf_scan", _bind, ("-DIVF_PROBE=3",), "phases"),
}
# the phase build's counters (csrc/ivf_scan.cu, PHASE): consumer warps'
# cycles by phase, their total, and the TMA producer's wait for free stages
# and total
PHASE_NAMES = ("products", "merges", "ids wait", "offer", "offer barrier",
               "tile start and end", "consumer total", "producer waiting",
               "producer total")


def build_library(verbose: bool = False):
    """Compile ``csrc/ivf_scan.cu`` into ``build/kernels`` (git-ignored)."""
    return _library.build(verbose=verbose)


def load_library():
    """The loaded kernel library, built at the first call of the process."""
    return _library.get()


def split_bf16x3(q: torch.Tensor) -> torch.Tensor:
    """The f32 query's three bf16 parts, (3, *q.shape): hi = bf16(q), mid =
    bf16(q - hi), lo = bf16(q - hi - mid), as ``scatter`` writes them for
    bf16 storage. Each residual is exact in f32 and the last part holds the
    last 8 bits, so hi + mid + lo == q for every normal f32 value: three
    bf16 x bf16 products, each exact in f32, make q . row exactly."""
    q = q.to(torch.float32)
    hi = q.to(torch.bfloat16)
    r = q - hi.to(torch.float32)
    mid = r.to(torch.bfloat16)
    lo = (r - mid.to(torch.float32)).to(torch.bfloat16)
    return torch.stack([hi, mid, lo])


def probe_table(probes: torch.Tensor, nlist: int) -> torch.Tensor:
    """Each query's probes in ascending cluster order, with repeats and
    out-of-range entries set to -1 (skipped): the order that makes a stable
    top-k break ties by (cluster, slot)."""
    p = torch.sort(probes.to(torch.int64), dim=1).values
    bad = (p < 0) | (p >= nlist)
    bad[:, 1:] |= p[:, 1:] == p[:, :-1]
    return torch.where(bad, -1, p)


def _prepare(data, q, scales):
    """(query operand, per-query scales): int8 storage quantizes the queries
    as the reference's kernel call does; float storage keeps them f32."""
    q = q.to(torch.float32)
    if data.dtype == torch.int8:
        return quantize_queries_device(q)
    return q, torch.ones((q.shape[0],), dtype=torch.float32, device=q.device)


def ivf_scan_reference(
    data: torch.Tensor,
    ids: torch.Tensor,
    q: torch.Tensor,
    probes: torch.Tensor,
    k: int,
    scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the kernel (same arguments as ``ivf_scan``).

    raw is computed in float64: exact for int8 at any real dim and for
    bf16/f32 rows against the f32 query (exact products), then rounded to f32
    as the kernel's accumulator is read; the int8 epilogue is the kernel's f32
    arithmetic, operation by operation."""
    _check_args(data, ids, q, probes, k, scales)
    nlist, cmax, d = data.shape
    qv, qsc = _prepare(data, q, scales)
    table = probe_table(probes, nlist)
    n_q, n_probe = table.shape
    per_query = max(n_probe * cmax * d * 8, 1)
    step = max(1, _PLAIN_CHUNK_BYTES // per_query)
    out_s, out_i = [], []
    for lo in range(0, n_q, step):
        hi = min(lo + step, n_q)
        tab = table[lo:hi]
        cl = tab.clamp(min=0)
        blocks = data[cl].to(torch.float64)  # (q, P, cmax, d)
        raw = torch.einsum("qd,qpcd->qpc", qv[lo:hi].to(torch.float64), blocks)
        s = raw.to(torch.float32)
        if data.dtype == torch.int8:
            s = s * qsc[lo:hi, None, None]
            s = s * scales[cl]
        slot_ids = ids[cl]
        valid = (slot_ids >= 0) & (tab >= 0)[:, :, None]
        s = torch.where(valid, s, NEG)
        top, pos = stable_topk(s.reshape(hi - lo, -1), k)
        got = torch.gather(slot_ids.reshape(hi - lo, -1), 1, pos)
        out_s.append(top)
        out_i.append(torch.where(top > NEG, got, -1).to(torch.int32))
    # every query has >= cmax >= 128 > k slot columns, so k always fit
    return torch.cat(out_s), torch.cat(out_i)


def prep_reference(probes: torch.Tensor, nlist: int, query_tile: int,
                   ids: Optional[torch.Tensor] = None):
    """Plain version of the ``prep`` and ``scatter`` kernels, on the host.

    -> (table (Q, nprobe) int32: each probe, or -1 where it is out of range
    or repeats an earlier probe of its query; pair_at (valid pairs,) int32:
    the pairs ``q * nprobe + j``, bucketed by cluster in ascending order,
    ascending inside a bucket; tiles (n, 3) int32: (cluster, first bucket
    position, pair count), each bucket cut into tiles of ``query_tile``),
    and with ``ids`` (nlist, cmax) a fourth, nchunk (nlist,) int32: each
    probed cluster's 128-slot chunks up to its last valid slot, 0 for the
    others. The kernel fills a bucket in no fixed order; everything else is
    equal."""
    rows = probes.tolist()
    n_probe = probes.shape[1]
    buckets = [[] for _ in range(nlist)]
    table = []
    for qi, row in enumerate(rows):
        seen = set()
        out = []
        for j, c in enumerate(row):
            if 0 <= c < nlist and c not in seen:
                seen.add(c)
                buckets[c].append(qi * n_probe + j)
                out.append(c)
            else:
                out.append(-1)
        table.append(out)
    tiles = []
    pos = 0
    for c, bucket in enumerate(buckets):
        for t0 in range(0, len(bucket), query_tile):
            tiles.append((c, pos + t0, min(query_tile, len(bucket) - t0)))
        pos += len(bucket)
    pair_at = [f for bucket in buckets for f in bucket]
    out = (torch.tensor(table, dtype=torch.int32).reshape(len(rows), n_probe),
           torch.tensor(pair_at, dtype=torch.int32),
           torch.tensor(tiles, dtype=torch.int32).reshape(-1, 3))
    if ids is None:
        return out
    valid = (ids.cpu() >= 0).reshape(nlist, -1, ROW_CHUNK).any(dim=2)
    last = (valid * torch.arange(1, valid.shape[1] + 1)).amax(dim=1)
    probed = torch.tensor([len(b) > 0 for b in buckets])
    return out + (torch.where(probed, last, 0).to(torch.int32),)


def merge_reference(part_s: torch.Tensor, part_i: torch.Tensor,
                    table: torch.Tensor, k: int):
    """Plain version of the ``merge`` kernel.

    ``part_s``/``part_i`` (Q * nprobe, k): each (query, probe) pair's list,
    sorted; ``table`` (Q, nprobe): each pair's cluster, -1 for a skipped
    probe (its list is not read). -> each query's top k over its lists by
    (score desc, cluster asc, list position asc), ids -1 where the score is
    not above -3e38."""
    n_q, n_probe = table.shape
    valid = (table >= 0)[:, :, None]
    s = part_s.reshape(n_q, n_probe, k).to(torch.float32)
    s = torch.where(valid, s, float("-inf")).reshape(n_q, -1)
    ids = part_i.reshape(n_q, n_probe * k)
    # secondary key (cluster, position), then a stable sort by score
    pos = torch.arange(k, device=table.device, dtype=torch.int64)
    second = (table.to(torch.int64).clamp(min=0)[:, :, None] * k + pos).reshape(n_q, -1)
    by_second = torch.argsort(second, dim=1, stable=True)
    ranked = torch.sort(torch.gather(s, 1, by_second), dim=1, descending=True,
                        stable=True).indices[:, :k]
    col = torch.gather(by_second, 1, ranked)
    top = torch.gather(s, 1, col)
    ok = top > NEG
    return (torch.where(ok, top, NEG),
            torch.where(ok, torch.gather(ids, 1, col), -1).to(torch.int32))


def _check_args(data, ids, q, probes, k, scales) -> None:
    if data.dim() != 3 or ids.dim() != 2 or q.dim() != 2 or probes.dim() != 2:
        raise ValueError("ivf_scan needs data (nlist, cmax, d), ids (nlist, "
                         "cmax), q (Q, d) and probes (Q, nprobe)")
    nlist, cmax, d = data.shape
    if cmax % 128 or d % 128:
        raise ValueError(f"ivf_scan needs cmax and dim multiples of 128, got "
                         f"cmax={cmax} d={d}")
    if data.dtype not in _STORAGE_CODES:
        raise TypeError(f"unsupported storage dtype {data.dtype}")
    if tuple(ids.shape) != (nlist, cmax) or ids.dtype != torch.int32:
        raise TypeError(f"ids must be ({nlist}, {cmax}) int32")
    if q.shape[1] != d or q.dtype != torch.float32:
        raise TypeError(f"q must be (Q, {d}) float32")
    if probes.shape[0] != q.shape[0] or not 0 < probes.shape[1] <= MAX_PROBE:
        raise ValueError(f"probes must be (Q, 1..{MAX_PROBE})")
    if not 0 < k <= MAX_K:
        raise ValueError(f"ivf_scan supports 1 <= k <= {MAX_K}, got {k}")
    if data.dtype == torch.int8:
        if scales is None:
            # zero scales would score every row 0 and return arbitrary rows
            raise ValueError("int8 cluster data requires per-row scales")
        if tuple(scales.shape) != (nlist, cmax) or scales.dtype != torch.float32:
            raise TypeError(f"scales must be ({nlist}, {cmax}) float32")
    devs = {t.device for t in (data, ids, q, probes)}
    if scales is not None:
        devs.add(scales.device)
    if len(devs) != 1:
        raise ValueError(f"ivf_scan inputs span devices {devs}")
    if q.shape[0] == 0:
        raise ValueError("ivf_scan needs at least one query")


def ivf_scan(
    data: torch.Tensor,      # (nlist, cmax, d) int8 | bf16 | f32
    ids: torch.Tensor,       # (nlist, cmax) int32 row ids, -1 = empty
    q: torch.Tensor,         # (Q, d) f32, metric-normalized
    probes: torch.Tensor,    # (Q, nprobe) cluster ids
    k: int,
    scales: Optional[torch.Tensor] = None,  # (nlist, cmax) f32, int8 only
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (scores (Q, k) f32 descending, ids (Q, k) int32).

    CPU tensors run the plain version; CUDA tensors launch the kernels."""
    _check_args(data, ids, q, probes, k, scales)
    if data.device.type == "cpu":
        return ivf_scan_reference(data, ids, q, probes, k, scales)
    if data.device.type != "cuda":
        raise ValueError(f"ivf_scan: unsupported device {data.device}")
    out = _launch(_library.get(), data, ids, q, probes, k, scales)
    ivf_scan.launches += 1
    return out


ivf_scan.launches = 0  # scan-kernel launches (not plain-version calls)


def ivf_scan_probe(kind: str, data, ids, q, probes, k, scales):
    """The whole call with a measurement build of the scan on the card:
    "products" skips the selection, "selection" runs it on synthetic scores
    with no products, "phases" is the whole scan with phase timers
    (``IVF_PROBE`` in csrc/ivf_scan.cu; read them with ``scan_phases``).
    The outputs of the first two are meaningless, and no launch of
    ``ivf_scan`` is counted."""
    _check_args(data, ids, q, probes, k, scales)
    if data.device.type != "cuda":
        raise ValueError("ivf_scan_probe runs the kernel on a CUDA card")
    return _launch(PROBE_LIBRARIES[kind].get(), data, ids, q, probes, k, scales)


def scan_phases(storage: torch.dtype) -> dict:
    """Cycles by phase (``PHASE_NAMES``) summed over the phase build's scans
    of ``storage`` rows since the last read, which clears them."""
    out = (ctypes.c_ulonglong * len(PHASE_NAMES))()
    _check(PROBE_LIBRARIES["phases"].get().semcode_ivf_phases(
        _STORAGE_CODES[storage], ctypes.addressof(out)), "phases")
    return dict(zip(PHASE_NAMES, out))


def scan_attributes(storage: torch.dtype) -> Tuple[int, int]:
    """(registers a thread, local-memory bytes a thread: spills) of the scan
    kernel over ``storage`` rows, from the loaded library."""
    out = (ctypes.c_int * 2)()
    _check(_library.get().semcode_ivf_scan_attributes(
        _STORAGE_CODES[storage], ctypes.addressof(out)), "attributes")
    return out[0], out[1]


def _check(err: int, what: str) -> None:
    if err != 0:
        raise KernelError(f"ivf_scan {what} launch failed: CUDA error {err}")


def _probes_operand(probes: torch.Tensor) -> torch.Tensor:
    if probes.dtype not in (torch.int32, torch.int64):
        probes = probes.to(torch.int64)
    return probes.contiguous()


# how scatter writes a storage's query rows into pair order (csrc: qform)
_QUERY_FORMS = {torch.int8: 1, torch.bfloat16: 2, torch.float32: 3}


class _Plan:
    """The device buffers of one call: a single int32 scratch tensor cut
    into ptab, prank, pair_at, cluster counts, each probed cluster's chunk
    count (nchunk), tiles (tiles, 4), hdr (tiles, valid pairs), qthr (each
    query's bound) and the per-pair lists (scores and ids, n_pairs x k
    each), passed to the kernels as pointers; and qbuf, the query rows in
    pair order for ``storage`` rows (int8 (n_pairs, d); bf16 (n_pairs, 3,
    d), a pair's three parts; f32 (n_pairs, d)), or None."""

    def __init__(self, n_q, n_pairs, nlist, tiles, k, storage, d, device):
        n = n_pairs
        sizes = {"ptab": n, "prank": n, "pair_at": n, "count": nlist,
                 "nchunk": nlist, "tiles": 4 * tiles, "hdr": 2, "qthr": n_q,
                 "part_s": n * k, "part_i": n * k}
        self.scratch = torch.empty((sum(sizes.values()),), dtype=torch.int32,
                                   device=device)
        self.offsets = {}
        at = 0
        for name, size in sizes.items():
            self.offsets[name] = (at, size)
            at += size
        base = self.scratch.data_ptr()
        self.ptr = {name: base + 4 * lo for name, (lo, _) in self.offsets.items()}
        self.qbuf = None
        if storage == torch.bfloat16:
            self.qbuf = torch.empty((n, QUERY_PARTS, d), dtype=storage, device=device)
        elif storage is not None:
            self.qbuf = torch.empty((n, d), dtype=storage, device=device)

    def view(self, name):
        lo, size = self.offsets[name]
        return self.scratch[lo:lo + size]


def _run_prep(lib, probes, nlist, query_tile, plan: _Plan, qv, storage, ids,
              stream):
    """Launch ``prep`` and ``scatter`` into ``plan``'s buffers; ``scatter``
    also writes the query rows ``qv`` into ``plan.qbuf`` in pair order, in
    the form ``storage`` rows take, when ``qv`` is given, and counts each
    probed cluster's chunks when ``ids`` is."""
    n_q, n_probe = probes.shape
    p = plan.ptr
    _check(lib.semcode_ivf_prep(
        probes.data_ptr(), int(probes.dtype == torch.int64), n_q, n_probe,
        nlist, query_tile, p["ptab"], p["prank"], p["pair_at"], p["count"],
        p["tiles"], p["hdr"], p["qthr"],
        0 if qv is None else _QUERY_FORMS[storage],
        None if qv is None else qv.data_ptr(), 0 if qv is None else qv.shape[1],
        None if plan.qbuf is None else plan.qbuf.data_ptr(),
        None if ids is None else ids.data_ptr(), 0 if ids is None else ids.shape[1],
        p["nchunk"], -(-(n_q * n_probe) // GATHER_ROWS), stream), "prep")


def _run_merge(lib, part_s_ptr, part_i_ptr, ptab_ptr, n_q, n_probe, k,
               device, stream):
    out_s = torch.empty((n_q, k), dtype=torch.float32, device=device)
    out_i = torch.empty((n_q, k), dtype=torch.int32, device=device)
    warps, smem = merge_geometry(n_probe, k)
    _check(lib.semcode_ivf_merge(
        part_s_ptr, part_i_ptr, ptab_ptr, out_s.data_ptr(), out_i.data_ptr(),
        n_q, n_probe, k, warps, smem, stream), "merge")
    return out_s, out_i


def _launch(lib, data, ids, q, probes, k, scales):
    nlist, cmax, d = data.shape
    qv, qsc = _prepare(data, q, scales)
    qv = qv.contiguous()
    qsc = qsc.contiguous()
    data = data.contiguous()
    ids = ids.contiguous()
    if scales is not None:
        scales = scales.contiguous()
    for t in (data, qv):
        if t.data_ptr() % 16:
            raise ValueError("ivf_scan needs 16-byte aligned rows")
    probes = _probes_operand(probes)
    n_q, n_probe = probes.shape
    dev = data.device
    geom = ivf_geometry(data.dtype, nlist, cmax, d, n_q, n_probe, k,
                        sm_count(dev.index or 0))
    plan = _Plan(n_q, geom.n_pairs, nlist, geom.tile_bound, k, data.dtype, d, dev)
    p = plan.ptr
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _run_prep(lib, probes, nlist, geom.query_tile, plan, qv, data.dtype, ids,
                  stream)
        _check(lib.semcode_ivf_scan(
            data.data_ptr(), ids.data_ptr(),
            None if scales is None else scales.data_ptr(),
            plan.qbuf.data_ptr(), qsc.data_ptr(), p["pair_at"], p["tiles"],
            p["hdr"], p["nchunk"], p["part_s"], p["part_i"], p["qthr"],
            nlist, cmax, d, geom.n_pairs, n_probe, k,
            _STORAGE_CODES[data.dtype], geom.grid, geom.stages,
            geom.smem_bytes, stream), "scan")
        return _run_merge(lib, p["part_s"], p["part_i"], p["ptab"], n_q, n_probe,
                          k, dev, stream)


def ivf_prep(probes: torch.Tensor, nlist: int, query_tile: int = QUERY_TILE,
             ids: Optional[torch.Tensor] = None):
    """``prep_reference``'s outputs from the ``prep`` and ``scatter``
    kernels on a CUDA tensor (the plain version on a CPU tensor). Reads the
    tile and pair counts back to trim the buffers: a check, not the scan's
    path."""
    if probes.device.type == "cpu":
        return prep_reference(probes, nlist, query_tile, ids)
    if not 0 < query_tile <= QUERY_TILE:
        raise ValueError(f"query_tile must be 1..{QUERY_TILE}")
    probes = _probes_operand(probes)
    n_q, n_probe = probes.shape
    n_pairs = n_q * n_probe
    plan = _Plan(n_q, n_pairs, nlist, tile_bound(n_pairs, nlist, query_tile), 1,
                 None, 0, probes.device)
    if ids is not None:
        ids = ids.contiguous()
        plan.view("nchunk").zero_()  # scatter writes the probed clusters'
    with torch.cuda.device(probes.device):
        stream = torch.cuda.current_stream(probes.device).cuda_stream
        _run_prep(_library.get(), probes, nlist, query_tile, plan, None, None,
                  ids, stream)
    n_tiles, n_valid = plan.view("hdr").tolist()
    out = (plan.view("ptab").view(n_q, n_probe), plan.view("pair_at")[:n_valid],
           plan.view("tiles").view(-1, 4)[:n_tiles, :3].contiguous())
    return out if ids is None else out + (plan.view("nchunk"),)


def ivf_merge(part_s: torch.Tensor, part_i: torch.Tensor, table: torch.Tensor,
              k: int):
    """``merge_reference`` by the ``merge`` kernel on a CUDA tensor (the
    plain version on a CPU tensor); ``table`` int32 (Q, nprobe)."""
    if part_s.device.type == "cpu":
        return merge_reference(part_s, part_i, table, k)
    n_q, n_probe = table.shape
    part_s, part_i = part_s.contiguous(), part_i.contiguous()
    table = table.to(torch.int32).contiguous()
    with torch.cuda.device(part_s.device):
        stream = torch.cuda.current_stream(part_s.device).cuda_stream
        return _run_merge(_library.get(), part_s.data_ptr(), part_i.data_ptr(),
                          table.data_ptr(), n_q, n_probe, k, part_s.device,
                          stream)
