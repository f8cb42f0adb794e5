"""Fused exact-scan kernel: per-128-row-block top-2 of a scaled inner product.

Replaces ``semcode_tpu/ops/scan_kernel2.py::top2_scan_shard`` (the Pallas
TPU kernel, ``pallas_call`` at line 220). Same function, not the same tiling:

    score[q, r] = ((raw[q, r] * q_scales[q]) * mult[r]) + add[r]
    raw = qq[q] . vecs[r]     (int8 x int8 -> int32 exact; else bf16 x bf16
                               products summed in f32)
    rows r >= Rs score -3e38; each 128-row block emits its top-2
    (score, shard-local row), ties to the lowest row; output (Q, 2*nb) with
    nb = ceil(Rs/128): all block-firsts, then all runner-ups.

The CUDA kernel (``csrc/top2_scan.cu``) is one persistent warp-specialised
design for every storage: TMA streams 128-byte depth chunks of a 256-row
tile and two 64-query tiles into an mbarrier ring, two consumer warpgroups
run ``wgmma`` m64n256 (int8: k32 s8; bf16/f32: k16 bf16 with f32 sums) with
the queries as M and the rows as N, and each takes a block's top-2 from its
accumulator registers (an in-thread scan over 32 rows, then two shuffle
rounds) while the other's products run. f32 rows go by TMA as stored into a
raw ring and the producer's converter warps round them to bf16 (as the TPU
kernel casts them at scan_kernel2.py:130) into the operand stage; that
rounding bounds the f32 kernel, so there both consumers read each rounded
chunk together, without turns. The
epilogue is evaluated with unfused f32 multiplies and adds; the (Q, R)
score matrix never reaches device memory.

What bounds it on an H100: at the main path's shape (1M x 384 int8, Q=512)
the dot is 3.9e11 int8 ops (0.2 ms at the 1,979 TOP/s int8 peak) against
~0.46 GB of rows, row scalars and output (0.14 ms at 3.35 TB/s), so
operations bound it; bf16 rows take 0.4 ms at the bf16 rate, f32 rows
~0.48 ms by their 1.54 GB; at Q=8 the bytes bound every storage. The
launch geometry (tiles, work items, persistent grid, ring stages, shared
memory) is computed here by ``scan_geometry`` and checked again by the
kernel's entry point.

On a CPU tensor the wrapper runs ``top2_scan_reference``, the plain torch
version; on a CUDA tensor it launches the kernel or raises.

``scan_topk`` runs the same stream over int8 rows with an exact top-``w``
epilogue (``w`` <= 64): the best ``w`` rows of each query by

    score[q, r] = valid[r] ? s : -3e38,  s = (raw * q_scales[q]) * scales[r]
    (l2: 2 * s - norms[r]),

ordered by the score's IEEE total order descending (-0 below +0), ties to
the lowest row: what the exact route's full-matrix selection
(``index/scan._select_xla``) returns, bit for bit, without its (Q, Rs)
score matrix, int64 keys and radix top-k. It replaces no TPU kernel (the
JAX exact route leaves the product and ``top_k`` to XLA). Its CUDA form is
two launches, ``scan_topk_s8`` (each CTA keeps one query pair and writes
each query's best ``w`` of its rows as a sorted list) and
``scan_topk_merge`` (a warp a query merges the lists); bytes bound it at
d 3072 (3.07 GB of rows at 1M), the products and the per-score epilogue
and threshold test on the CUDA cores at d 384. ``scan_topk_reference`` is
its plain version; ``scan_topk_counts`` reads the last call's counters
(offer rounds that entered the append path, cuts).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from ..device import sm_count
from .build import KernelError, KernelLibrary

NEG = -3.0e38  # dead-row / masked-slot sentinel (f32)
BLOCK = 128  # rows per top-2 block

_STORAGE_CODES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
STORAGES = ("int8", "bfloat16", "float32")

# kernel geometry; csrc/top2_scan.cu holds the same constants
ROW_TILE = 256  # rows per work item (wgmma N): two top-2 blocks
QUERY_TILE = 64  # queries per consumer warpgroup (wgmma M)
DEPTH_CHUNK = 128  # bytes of operand depth per ring stage (int8 or bf16)
STAGE_BYTES = ROW_TILE * DEPTH_CHUNK + 2 * QUERY_TILE * DEPTH_CHUNK
RAW_STAGES = 2  # f32 rows: raw stages of 32 values a row before rounding
RAW_STAGE_BYTES = ROW_TILE * DEPTH_CHUNK
EPILOGUE_BYTES = 4 * ROW_TILE * 8  # mult/add of four row tiles in flight
BARRIER_BYTES = 256
SMEM_ALIGN = 1024  # slack to align the ring to the 128-byte swizzle atom
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on Hopper


@dataclass(frozen=True)
class ScanGeometry:
    """Launch geometry of the kernel for one (Rs, d, Q, storage).

    A work item is one row tile x one pair of query tiles (the two consumer
    warpgroups' shares); item ``u`` is row tile ``u // n_query_pairs``,
    pair ``u % n_query_pairs``, and CTA ``b`` of ``grid`` takes items
    ``b, b + grid, ...``. ``depth_chunks``: ring stages an item's depth
    takes (128 int8 or 64 bf16 values each; f32 rows are rounded to bf16
    on the way in, from ``raw_stages`` stages of their own). ``turns``: the
    consumers take turns at the tensor cores, one selecting while the other
    multiplies (int8, bf16); f32 rows, whose rounding bounds the kernel, are
    read by both consumers together. ``shared_rows``: one load of a row
    chunk serves both consumers; with turns that needs the item's whole
    depth in the ring, since the second consumer starts only once the first
    has read it all."""

    n_row_tiles: int
    n_query_tiles: int
    n_query_pairs: int
    work_items: int
    grid: int
    stages: int
    raw_stages: int
    depth_chunks: int
    smem_bytes: int
    turns: bool
    shared_rows: bool


def scan_geometry(rs: int, d: int, nq: int, sms: int,
                  storage: str = "int8") -> ScanGeometry:
    """The kernel's tiles, work items, persistent grid (one CTA per SM, at
    most one per item), ring stages and dynamic shared-memory bytes for
    ``storage`` rows (int8, bfloat16 or float32)."""
    if (rs <= 0 or nq <= 0 or d <= 0 or d % DEPTH_CHUNK or sms <= 0
            or storage not in STORAGES):
        raise ValueError(f"no top2_scan geometry for Rs={rs} d={d} Q={nq} "
                         f"{storage} on {sms} SMs")
    n_row_tiles = -(-rs // ROW_TILE)
    n_query_tiles = -(-nq // QUERY_TILE)
    n_query_pairs = -(-n_query_tiles // 2)
    work_items = n_row_tiles * n_query_pairs
    raw_stages = RAW_STAGES if storage == "float32" else 0
    fixed = SMEM_ALIGN + raw_stages * RAW_STAGE_BYTES + EPILOGUE_BYTES + BARRIER_BYTES
    stages = (SMEM_LIMIT - fixed) // STAGE_BYTES
    depth_chunks = d * (1 if storage == "int8" else 2) // DEPTH_CHUNK
    turns = storage != "float32"
    return ScanGeometry(
        n_row_tiles=n_row_tiles,
        n_query_tiles=n_query_tiles,
        n_query_pairs=n_query_pairs,
        work_items=work_items,
        grid=min(sms, work_items),
        stages=stages,
        raw_stages=raw_stages,
        depth_chunks=depth_chunks,
        smem_bytes=fixed + stages * STAGE_BYTES,
        turns=turns,
        shared_rows=not turns or depth_chunks <= stages,
    )


def cta_tiles(geom: ScanGeometry, cta: int) -> List[Tuple[int, int]]:
    """(row tile, query tile) pairs that CTA ``cta`` scores, in its order
    (query tiles past Q are skipped, as the kernel skips them)."""
    out = []
    for u in range(cta, geom.work_items, geom.grid):
        rt, pair = divmod(u, geom.n_query_pairs)
        out.extend((rt, qt) for qt in (2 * pair, 2 * pair + 1)
                   if qt < geom.n_query_tiles)
    return out


def _bind(lib: ctypes.CDLL) -> None:
    # seven pointers, Rs, d, Q, storage code, grid, stages, smem bytes, stream
    lib.semcode_top2_scan.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    )
    lib.semcode_top2_scan.restype = ctypes.c_int
    # eleven pointers; Rs, d, Q, w, l2, grid, stages, smem bytes, merge
    # warps, merge smem bytes; stream
    lib.semcode_scan_topk.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    )
    lib.semcode_scan_topk.restype = ctypes.c_int
    lib.semcode_scan_topk_attributes.argtypes = [ctypes.c_void_p]
    lib.semcode_scan_topk_attributes.restype = ctypes.c_int


_library = KernelLibrary("top2_scan", _bind)
PROBE_LIBRARIES = {
    "products": KernelLibrary("top2_scan", _bind, ("-DTOP2_PROBE=1",), "products"),
    "selection": KernelLibrary("top2_scan", _bind, ("-DTOP2_PROBE=2",), "selection"),
}


def build_library(verbose: bool = False):
    """Compile ``csrc/top2_scan.cu`` into ``build/kernels`` (git-ignored)."""
    return _library.build(verbose=verbose)


def load_library():
    """The loaded kernel library, built at the first call of the process."""
    return _library.get()


def _top2_lanes(scores: torch.Tensor, nb: int) -> Tuple[torch.Tensor, ...]:
    """(Q, nb*128) -> per-128-row-block top-2 (m1, o1, m2, o2), each (Q, nb),
    following ``scan_kernel2._top2_lanes`` step for step (including its
    dead-block case: an all-sentinel block emits lane 0 in both slots)."""
    n_q = scores.shape[0]
    s3 = scores.reshape(n_q, nb, BLOCK)
    lane = torch.arange(BLOCK, device=scores.device, dtype=torch.int32)
    big = torch.full(s3.shape, BLOCK, dtype=torch.int32, device=s3.device)
    m1k = s3.amax(dim=2, keepdim=True)
    o1 = torch.where(s3 == m1k, lane, big).amin(dim=2)
    s3b = torch.where(lane == o1[:, :, None], torch.full_like(s3, NEG), s3)
    m2k = s3b.amax(dim=2, keepdim=True)
    o2 = torch.where(s3b == m2k, lane, big).amin(dim=2)
    return (
        m1k[:, :, 0],
        torch.clamp(o1, max=BLOCK - 1),
        m2k[:, :, 0],
        torch.clamp(o2, max=BLOCK - 1),
    )


def top2_scan_reference(
    vecs: torch.Tensor,
    mult: torch.Tensor,
    add: torch.Tensor,
    qq: torch.Tensor,
    q_scales: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the kernel (same arguments as ``top2_scan``).

    raw is computed in float64: exact for int8 at any real dim (|raw| <=
    d*127^2) and for bf16 operands (exact 16-bit products), then rounded to
    f32 as the kernel's accumulator is read. The epilogue is the kernel's
    f32 arithmetic, operation by operation."""
    rs, d = vecs.shape
    n_q = qq.shape[0]
    nb = -(-rs // BLOCK)
    if vecs.dtype == torch.int8:
        v64 = vecs.to(torch.float64)
    else:
        v64 = vecs.to(torch.bfloat16).to(torch.float64)
    raw = (qq.to(torch.float64) @ v64.T).to(torch.float32)  # (Q, Rs)
    scores = raw * q_scales.reshape(n_q, 1).to(torch.float32)
    scores = scores * mult.reshape(1, rs).to(torch.float32)
    scores = scores + add.reshape(1, rs).to(torch.float32)
    padded = torch.full((n_q, nb * BLOCK), NEG, dtype=torch.float32,
                        device=vecs.device)
    padded[:, :rs] = scores
    m1, o1, m2, o2 = _top2_lanes(padded, nb)
    base = torch.arange(nb, device=vecs.device, dtype=torch.int32) * BLOCK
    return (
        torch.cat([m1, m2], dim=1),
        torch.cat([base + o1, base + o2], dim=1),
    )


def _check_args(vecs, mult, add, qq, q_scales) -> None:
    if vecs.dim() != 2 or qq.dim() != 2:
        raise ValueError("vecs and qq must be 2-D")
    rs, d = vecs.shape
    if d % 128 != 0:
        raise ValueError(f"top2_scan needs dim % 128 == 0, got {d}")
    if vecs.dtype not in _STORAGE_CODES:
        raise TypeError(f"unsupported storage dtype {vecs.dtype}")
    want_q = torch.int8 if vecs.dtype == torch.int8 else torch.bfloat16
    if qq.dtype != want_q or qq.shape[1] != d:
        raise TypeError(f"qq must be ({qq.shape[0]}, {d}) {want_q}")
    n_q = qq.shape[0]
    for name, t, n in (("mult", mult, rs), ("add", add, rs),
                       ("q_scales", q_scales, n_q)):
        if t.dtype != torch.float32 or t.numel() != n:
            raise TypeError(f"{name} must hold {n} float32 values")
    devs = {t.device for t in (vecs, mult, add, qq, q_scales)}
    if len(devs) != 1:
        raise ValueError(f"top2_scan inputs span devices {devs}")
    if rs == 0 or n_q == 0:
        raise ValueError("top2_scan needs at least one row and one query")


def top2_scan(
    vecs: torch.Tensor,      # (Rs, d) int8 | bf16 | f32
    mult: torch.Tensor,      # (Rs,) f32 per-row scale (incl. metric factor)
    add: torch.Tensor,       # (Rs,) f32 per-row additive (-3e38 = dead row)
    qq: torch.Tensor,        # (Q, d) int8 for int8 storage, else bf16
    q_scales: torch.Tensor,  # (Q,) f32 per-query scale
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (bmax (Q, 2*nb) f32, brow (Q, 2*nb) int32), nb = ceil(Rs/128).

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    _check_args(vecs, mult, add, qq, q_scales)
    if vecs.device.type == "cpu":
        return top2_scan_reference(vecs, mult, add, qq, q_scales)
    if vecs.device.type != "cuda":
        raise ValueError(f"top2_scan: unsupported device {vecs.device}")
    out = _launch(_library.get(), vecs, mult, add, qq, q_scales)
    top2_scan.launches += 1
    return out


top2_scan.launches = 0  # kernel launches (not plain-version calls)


def top2_scan_probe(kind: str, vecs, mult, add, qq, q_scales):
    """Launch a measurement build of the kernel on the card: "products"
    skips the selection, "selection" skips the products (``TOP2_PROBE`` in
    csrc/top2_scan.cu). The outputs are meaningless, and no launch of
    ``top2_scan`` is counted: the two times split the kernel's."""
    _check_args(vecs, mult, add, qq, q_scales)
    if vecs.device.type != "cuda":
        raise ValueError("top2_scan_probe runs the kernel on a CUDA card")
    return _launch(PROBE_LIBRARIES[kind].get(), vecs, mult, add, qq, q_scales)


def _launch(lib, vecs, mult, add, qq, q_scales):
    rs, d = vecs.shape
    n_q = qq.shape[0]
    nb = -(-rs // BLOCK)
    vecs = vecs.contiguous()
    qq = qq.contiguous()
    mult = mult.contiguous()
    add = add.contiguous()
    q_scales = q_scales.contiguous()
    for t in (vecs, qq):
        if t.data_ptr() % 16:
            raise ValueError("top2_scan needs 16-byte aligned rows")
    bmax = torch.empty((n_q, 2 * nb), dtype=torch.float32, device=vecs.device)
    brow = torch.empty((n_q, 2 * nb), dtype=torch.int32, device=vecs.device)
    storage = str(vecs.dtype).replace("torch.", "")
    with torch.cuda.device(vecs.device):
        geom = scan_geometry(rs, d, n_q, sm_count(torch.cuda.current_device()),
                             storage)
        stream = torch.cuda.current_stream(vecs.device).cuda_stream
        err = lib.semcode_top2_scan(
            vecs.data_ptr(), mult.data_ptr(), add.data_ptr(), qq.data_ptr(),
            q_scales.data_ptr(), bmax.data_ptr(), brow.data_ptr(),
            rs, d, n_q, _STORAGE_CODES[vecs.dtype], geom.grid, geom.stages,
            geom.smem_bytes, stream,
        )
    if err != 0:
        raise KernelError(f"top2_scan kernel launch failed: CUDA error {err}")
    return bmax, brow


# scan_topk's geometry; csrc/top2_scan.cu holds the same constants
MAX_WIDTH = 64  # widest selection the kernel takes
ROUND_ROWS = 32  # rows of one query an offer round appends at most
CTA_QUERIES = 2 * QUERY_TILE  # a CTA's query pair
MASK_BYTES = 4 * (ROW_TILE // 32) * 4  # validity words of four row tiles
HIST_BYTES = 8 * 128 * 4  # a 128-bin select histogram per consumer warp
TALLY_BYTES = 8 * 2 * 4 + 16  # append rounds and cuts of each consumer warp; a done count
STATE_BYTES = 2 * QUERY_TILE * 16  # each query's threshold (key, row), count, best key
MAX_LISTS = 256  # CTAs per query pair
MERGE_SMEM = 96 * 1024  # staged lists of one merge block at most
COUNTERS = 2  # ints after the queries' bounds: append rounds, cuts
SHALLOW_CHUNKS = 3  # item depths of at most 3 ring chunks (d <= 384) ...
SHALLOW_STAGES = 2  # ... at Q > 64 take a ring of 2 stages (topk_geometry)


def topk_capacity(width: int) -> int:
    """Candidate entries a query's buffer holds: ``width`` rounded up to 32
    and one offer round."""
    return -(-width // 32) * 32 + ROUND_ROWS


@dataclass(frozen=True)
class TopkGeometry:
    """Launch geometry of ``scan_topk`` for one (Rs, d, Q, w).

    Work items are ``scan_geometry``'s (a row tile x a query pair); the
    grid is ``lists`` CTAs for each query pair, so CTA ``b`` keeps pair ``b
    % n_query_pairs`` on every item and writes list ``b // n_query_pairs``
    of each of its queries. ``capacity``: a query's candidate buffer. The
    consumers read each row chunk together, without turns at the tensor
    cores. ``merge_warps`` queries share a merge block of
    ``merge_smem_bytes``."""

    n_row_tiles: int
    n_query_pairs: int
    lists: int
    grid: int
    stages: int
    capacity: int
    smem_bytes: int
    merge_warps: int
    merge_smem_bytes: int


@functools.lru_cache(maxsize=256)
def topk_geometry(rs: int, d: int, nq: int, sms: int, width: int) -> TopkGeometry:
    """``scan_topk``'s grid, ring stages, shared memory and merge blocks for
    ``nq`` queries at most ``sms * 128`` (more query pairs than SMs leave a
    pair no CTA). Ring stages: SHALLOW_STAGES while an item's depth takes at
    most SHALLOW_CHUNKS ring chunks and Q fills both tiles of a pair (the
    epilogue bounds those), else as many as fit (the rows' reads bound a
    deeper item, and Q <= 64, whose CTAs multiply one tile). Measured on one
    H100, ms per call: at d 384 and Q 512 two stages 1.225 against 1.316 for
    three; at Q 8 0.301 against 0.285 (and, for the epilogue before the
    pooled bounds, at d 3072 and Q 256 three stages 1.80 against 2.31)."""
    n_query_pairs = -(-nq // CTA_QUERIES)
    if (rs <= 0 or d <= 0 or d % DEPTH_CHUNK or sms <= 0 or nq <= 0
            or not 1 <= width <= min(MAX_WIDTH, rs) or n_query_pairs > sms):
        raise ValueError(f"no scan_topk geometry for Rs={rs} d={d} Q={nq} "
                         f"w={width} on {sms} SMs")
    n_row_tiles = -(-rs // ROW_TILE)
    lists = min(sms // n_query_pairs, n_row_tiles, MAX_LISTS)
    capacity = topk_capacity(width)
    fixed = (SMEM_ALIGN + EPILOGUE_BYTES + MASK_BYTES + HIST_BYTES + TALLY_BYTES
             + STATE_BYTES + CTA_QUERIES * capacity * 8 + BARRIER_BYTES)
    most = (SMEM_LIMIT - fixed) // STAGE_BYTES
    shallow = d // DEPTH_CHUNK <= SHALLOW_CHUNKS and nq > QUERY_TILE
    stages = SHALLOW_STAGES if shallow else most
    per_warp = lists * width * 8
    merge_warps = max(1, min(8, MERGE_SMEM // per_warp))
    return TopkGeometry(
        n_row_tiles=n_row_tiles,
        n_query_pairs=n_query_pairs,
        lists=lists,
        grid=lists * n_query_pairs,
        stages=stages,
        capacity=capacity,
        smem_bytes=fixed + stages * STAGE_BYTES,
        merge_warps=merge_warps,
        merge_smem_bytes=merge_warps * per_warp,
    )


def scan_topk_reference(
    vecs: torch.Tensor,
    scales: torch.Tensor,
    valid: torch.Tensor,
    norms: Optional[torch.Tensor],
    qq: torch.Tensor,
    q_scales: torch.Tensor,
    width: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of ``scan_topk`` (same arguments).

    raw in float64 (exact for int8 at any real dim), rounded to f32; the
    epilogue's f32 operations one by one, then a stable descending sort of
    the scores' total-order keys, so ties keep the lowest row."""
    raw = (qq.to(torch.float64) @ vecs.to(torch.float64).T).to(torch.float32)
    scores = raw * q_scales.reshape(-1, 1) * scales.reshape(1, -1)
    if norms is not None:
        scores = 2.0 * scores - norms.reshape(1, -1)
    scores = torch.where(valid.reshape(1, -1), scores,
                         torch.tensor(NEG, dtype=torch.float32, device=vecs.device))
    bits = scores.view(torch.int32)
    keys = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    rows = torch.sort(keys, dim=1, descending=True, stable=True).indices[:, :width]
    return torch.gather(scores, 1, rows), rows


def _check_topk_args(vecs, scales, valid, norms, qq, q_scales, width) -> None:
    if vecs.dim() != 2 or qq.dim() != 2:
        raise ValueError("vecs and qq must be 2-D")
    rs, d = vecs.shape
    if vecs.dtype != torch.int8 or qq.dtype != torch.int8 or qq.shape[1] != d:
        raise TypeError(f"scan_topk takes int8 rows and ({qq.shape[0]}, {d}) int8 queries")
    if d % DEPTH_CHUNK:
        raise ValueError(f"scan_topk needs dim % {DEPTH_CHUNK} == 0, got {d}")
    n_q = qq.shape[0]
    for name, t, n in (("scales", scales, rs), ("q_scales", q_scales, n_q)) + (
            (("norms", norms, rs),) if norms is not None else ()):
        if t.dtype != torch.float32 or t.numel() != n:
            raise TypeError(f"{name} must hold {n} float32 values")
    if valid.dtype != torch.bool or valid.numel() != rs:
        raise TypeError(f"valid must hold {rs} bools")
    if not 1 <= width <= min(MAX_WIDTH, rs) or n_q == 0:
        raise ValueError(f"scan_topk selects 1 to min({MAX_WIDTH}, Rs={rs}) rows "
                         f"for at least one query, not {width} for {n_q}")
    devs = {t.device for t in (vecs, scales, valid, qq, q_scales)
            + ((norms,) if norms is not None else ())}
    if len(devs) != 1:
        raise ValueError(f"scan_topk inputs span devices {devs}")


def scan_topk(
    vecs: torch.Tensor,              # (Rs, d) int8
    scales: torch.Tensor,            # (Rs,) f32 row scales
    valid: torch.Tensor,             # (Rs,) bool: live and allowed rows
    norms: Optional[torch.Tensor],   # (Rs,) f32 row sqnorms for l2, else None
    qq: torch.Tensor,                # (Q, d) int8 queries
    q_scales: torch.Tensor,          # (Q,) f32 query scales
    width: int,                      # rows to select, 1..min(64, Rs)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (scores (Q, width) f32, rows (Q, width) int64), best first.

    CPU tensors run the plain version; CUDA tensors launch the kernels (one
    pair of launches for every ``sms * 128`` queries)."""
    _check_topk_args(vecs, scales, valid, norms, qq, q_scales, width)
    if vecs.device.type == "cpu":
        return scan_topk_reference(vecs, scales, valid, norms, qq, q_scales, width)
    if vecs.device.type != "cuda":
        raise ValueError(f"scan_topk: unsupported device {vecs.device}")
    out, launches = _launch_topk(_library.get(), vecs, scales, valid, norms, qq,
                                 q_scales, width)
    scan_topk.launches += launches
    return out


scan_topk.launches = 0  # scan_topk_s8 launches (not plain-version calls)
_last_counts: List[Tuple[torch.Tensor, int]] = []  # the last call's (scratch, offset)s


def scan_topk_counts() -> Tuple[int, int]:
    """(offer rounds that entered the append path, cuts) of the last
    ``scan_topk`` call on the card, summed over its launches: an offer
    round here is one lane's 8 rows of one query (an item holds 32 lanes x
    2 queries x 8 rounds a warp), a cut one query's buffer cut to its ``w``
    best. Reading them waits for the call (a synchronising copy), so only
    tests and ``chip_smoke.py`` do."""
    counts = [t[at:at + COUNTERS].tolist() for t, at in _last_counts]
    return sum(c[0] for c in counts), sum(c[1] for c in counts)


def scan_topk_probe(kind: str, vecs, scales, valid, norms, qq, q_scales, width):
    """Launch a measurement build of ``scan_topk`` on the card (``TOP2_PROBE``;
    "products" skips the selection, so its outputs are meaningless). No
    launch of ``scan_topk`` is counted."""
    _check_topk_args(vecs, scales, valid, norms, qq, q_scales, width)
    if vecs.device.type != "cuda":
        raise ValueError("scan_topk_probe runs the kernel on a CUDA card")
    return _launch_topk(PROBE_LIBRARIES[kind].get(), vecs, scales, valid, norms, qq,
                        q_scales, width)[0]


def _launch_topk(lib, vecs, scales, valid, norms, qq, q_scales, width):
    """The kernels' launches, one pair for every ``sms * 128`` queries:
    ((scores, rows), launches)."""
    rs, d = vecs.shape
    n_q = qq.shape[0]
    vecs, qq, scales, valid, q_scales = (
        t.contiguous() for t in (vecs, qq, scales, valid, q_scales))
    norms = norms.contiguous() if norms is not None else None
    if vecs.data_ptr() % 16 or qq.data_ptr() % 16:
        raise ValueError("scan_topk needs 16-byte aligned rows")
    out_s = torch.empty((n_q, width), dtype=torch.float32, device=vecs.device)
    out_i = torch.empty((n_q, width), dtype=torch.int64, device=vecs.device)
    launches, counts = 0, []
    with torch.cuda.device(vecs.device):
        sms = sm_count(torch.cuda.current_device())
        stream = torch.cuda.current_stream(vecs.device).cuda_stream
        step = sms * CTA_QUERIES
        for lo in range(0, n_q, step):
            nq = min(step, n_q - lo)
            geom = topk_geometry(rs, d, nq, sms, width)
            # the CTAs' lists (keys, rows), the queries' bounds, the counters,
            # each CTA's best key of each query
            scratch = torch.empty(2 * nq * geom.lists * width + nq + COUNTERS
                                  + nq * geom.lists, dtype=torch.int32, device=vecs.device)
            part = scratch.data_ptr()
            n_part = nq * geom.lists * width
            err = lib.semcode_scan_topk(
                vecs.data_ptr(), scales.data_ptr(), valid.data_ptr(),
                norms.data_ptr() if norms is not None else None,
                qq.data_ptr() + lo * d, q_scales.data_ptr() + 4 * lo,
                part, part + 4 * n_part, part + 8 * n_part,
                out_s.data_ptr() + 4 * lo * width, out_i.data_ptr() + 8 * lo * width,
                rs, d, nq, width, int(norms is not None), geom.grid, geom.stages,
                geom.smem_bytes, geom.merge_warps, geom.merge_smem_bytes, stream,
            )
            if err != 0:
                raise KernelError(f"scan_topk kernel launch failed: CUDA error {err}")
            launches += 1
            counts.append((scratch, 2 * n_part + nq))
    _last_counts[:] = counts
    return (out_s, out_i), launches


def scan_topk_attributes() -> Tuple[int, int]:
    """(registers, local bytes) a thread of ``scan_topk_s8`` as built."""
    attrs = (ctypes.c_int * 2)()
    err = _library.get().semcode_scan_topk_attributes(ctypes.addressof(attrs))
    if err != 0:
        raise KernelError(f"scan_topk attributes: CUDA error {err}")
    return attrs[0], attrs[1]
