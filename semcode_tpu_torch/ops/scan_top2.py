"""Fused exact-scan kernel: per-128-row-block top-2 of a scaled inner product.

Replaces ``semcode_tpu/ops/scan_kernel2.py::top2_scan_shard`` (the Pallas
TPU kernel, ``pallas_call`` at line 220). Same function, not the same tiling:

    score[q, r] = ((raw[q, r] * q_scales[q]) * mult[r]) + add[r]
    raw = qq[q] . vecs[r]     (int8 x int8 -> int32 exact; else bf16 x bf16
                               products summed in f32)
    rows r >= Rs score -3e38; each 128-row block emits its top-2
    (score, shard-local row), ties to the lowest row; output (Q, 2*nb) with
    nb = ceil(Rs/128): all block-firsts, then all runner-ups.

The CUDA kernel (``csrc/top2_scan.cu``) runs the dot on the tensor cores
(``mma.sync`` s8 m16n8k32 for int8 storage, bf16 m16n8k16 for bf16/f32
storage — f32 rows are rounded to bf16 on load, as the TPU kernel casts them
at scan_kernel2.py:130), evaluates the epilogue with unfused f32 multiplies
and adds, and reduces each block's 128 x 64 score tile to its top-2 in
shared memory. The (Q, R) score matrix never reaches device memory.

What bounds it on an H100: at the main path's shape (1M x 384 int8, Q=512)
the dot is 4e11 int8 ops (0.2 ms at the 1,979 TOP/s int8 peak) against
384 MB of rows (0.11 ms at 3.35 TB/s), so operations bound it. This first
version tiles 128 rows x 64 queries per block with synchronous shared-memory
staging and ``mma.sync``; wgmma, TMA and a pipelined selection are later
work (PERF.md holds its measured time beside the bound).

On a CPU tensor the wrapper runs ``top2_scan_reference``, the plain torch
version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .build import KernelLibrary

NEG = -3.0e38  # dead-row / masked-slot sentinel (f32)
BLOCK = 128  # rows per top-2 block

_STORAGE_CODES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


def _bind(lib: ctypes.CDLL) -> None:
    # seven pointers, Rs, d, Q, storage code, stream
    lib.semcode_top2_scan.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    lib.semcode_top2_scan.restype = ctypes.c_int


_library = KernelLibrary("top2_scan", _bind)


def build_library(verbose: bool = False):
    """Compile ``csrc/top2_scan.cu`` into ``build/kernels`` (git-ignored)."""
    return _library.build(verbose=verbose)


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
    lib = _library.get()
    with torch.cuda.device(vecs.device):
        stream = torch.cuda.current_stream(vecs.device).cuda_stream
        err = lib.semcode_top2_scan(
            vecs.data_ptr(), mult.data_ptr(), add.data_ptr(), qq.data_ptr(),
            q_scales.data_ptr(), bmax.data_ptr(), brow.data_ptr(),
            rs, d, n_q, _STORAGE_CODES[vecs.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"top2_scan kernel launch failed: CUDA error {err}")
    top2_scan.launches += 1
    return bmax, brow


top2_scan.launches = 0  # kernel launches (not plain-version calls)
