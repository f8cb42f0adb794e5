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
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Tuple

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
