"""IVF probing kernel: masked top-k of each query over its probed clusters.

Replaces ``semcode_tpu/ops/kernels.py::ivf_scan_shard`` (the Pallas TPU
kernel, ``pallas_call`` at line 374) on one device. The function:

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

The CUDA kernel (``csrc/ivf_scan.cu``) runs cluster-major: the probe table
is sorted by cluster on the device, one block scans one cluster for a tile
of up to 32 of its probing queries and writes each (query, probe) pair's
top-k; a stable top-k over a query's ``nprobe * k`` partials orders the
result. What bounds it on an H100 at the main path's shape (1M x 384 int8,
nlist 1024, Q=512, nprobe 32): reading each probed cluster once, ~0.87 GB
(0.26 ms at 3.35 TB/s), against 2.7e10 int8 ops (0.014 ms).

On a CPU tensor the wrapper runs ``ivf_scan_reference``, the plain torch
version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..index.scan import quantize_queries_device, stable_topk
from .build import KernelLibrary

NEG = -3.0e38  # masked-slot / empty-result sentinel (f32)
MAX_K = 64
MAX_PROBE = 128

_STORAGE_CODES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
# bytes of the (Q, nprobe, cmax, d) f64 gather the plain version holds at once
_PLAIN_CHUNK_BYTES = 1 << 30


def _bind(lib: ctypes.CDLL) -> None:
    # eight input pointers, two output pointers, n_blocks, nlist, cmax,
    # d, nprobe, k, storage code, stream
    lib.semcode_ivf_scan.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    )
    lib.semcode_ivf_scan.restype = ctypes.c_int
    lib.semcode_ivf_scan_tile_queries.argtypes = []
    lib.semcode_ivf_scan_tile_queries.restype = ctypes.c_int


_library = KernelLibrary("ivf_scan", _bind)


def build_library(verbose: bool = False):
    """Compile ``csrc/ivf_scan.cu`` into ``build/kernels`` (git-ignored)."""
    return _library.build(verbose=verbose)


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

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    _check_args(data, ids, q, probes, k, scales)
    if data.device.type == "cpu":
        return ivf_scan_reference(data, ids, q, probes, k, scales)
    if data.device.type != "cuda":
        raise ValueError(f"ivf_scan: unsupported device {data.device}")
    nlist, cmax, d = data.shape
    dev = data.device
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
    lib = _library.get()
    tile = lib.semcode_ivf_scan_tile_queries()
    table = probe_table(probes, nlist)
    n_q, n_probe = table.shape
    n_pairs = n_q * n_probe
    # (cluster, query, probe) pairs in cluster order; skipped probes sort
    # into an extra bin past the last cluster
    cl = torch.where(table < 0, nlist, table).reshape(-1)
    cl_sorted, order = torch.sort(cl, stable=True)
    counts = torch.bincount(cl_sorted, minlength=nlist + 1)[:nlist]
    zero = torch.zeros((1,), dtype=torch.int64, device=dev)
    pair_start = torch.cat([zero, torch.cumsum(counts, 0)]).to(torch.int32)
    tiles = (counts + tile - 1) // tile
    tile_start = torch.cat([zero, torch.cumsum(tiles, 0)]).to(torch.int32)
    pairs = order.to(torch.int32)
    # an upper bound on the tiles, known without reading counts back
    n_blocks = -(-n_pairs // tile) + min(nlist, n_pairs)
    part_s = torch.full((n_pairs, k), NEG, dtype=torch.float32, device=dev)
    part_i = torch.full((n_pairs, k), -1, dtype=torch.int32, device=dev)
    dummy = qsc  # placeholder pointer for float storage's unused scales
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.semcode_ivf_scan(
            data.data_ptr(), ids.data_ptr(),
            (scales if scales is not None else dummy).data_ptr(),
            qv.data_ptr(), qsc.data_ptr(), pairs.data_ptr(),
            pair_start.data_ptr(), tile_start.data_ptr(),
            part_s.data_ptr(), part_i.data_ptr(),
            n_blocks, nlist, cmax, d, n_probe, k,
            _STORAGE_CODES[data.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"ivf_scan kernel launch failed: CUDA error {err}")
    ivf_scan.launches += 1
    top, pos = stable_topk(part_s.view(n_q, n_probe * k), k)
    return top, torch.gather(part_i.view(n_q, n_probe * k), 1, pos)


ivf_scan.launches = 0  # kernel launches (not plain-version calls)
