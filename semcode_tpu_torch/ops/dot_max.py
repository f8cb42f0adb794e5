"""Int8 dot-max kernel: each query's largest dot product over a corpus.

Replaces the Pallas kernel that ``tools/dot_pallas.py::make_kernel`` builds
(``pallas_call`` at line 89), the TPU's int8 GEMM rate probe. The function:

    out[i] = max_r  sum_k q[i, k] * rows[r, k]      (Q,) int32, exact

The TPU kernel writes each maximum broadcast over 128 lanes, a ``(Q, 128)``
array whose columns all hold the same value: an artifact of the TPU's output
layout, not reproduced here.

Modes:

- ``"s32"``: s8 x s8 -> s32 on the tensor cores (``wgmma`` k32).
- ``"bf16"``: the TPU tool's ``bf16cast`` form (dot_pallas.py:64-72): the
  int8 operands are widened to bf16, the products summed in an f32
  accumulator (``wgmma`` k16) and the sum converted to int32 before the
  maximum. That is exact only while every partial sum stays below 2^24,
  i.e. ``d * 127**2 < 2**24`` (``d <= 1040``) for values in [-127, 127], so
  the wrapper refuses a larger ``d`` in this mode (the TPU tool has the same
  limit, unstated); with ``d % 128 == 0`` the largest is 1024. A -128 in
  both operands lowers the limit to d = 1024.

The CUDA kernel (``csrc/dot_max.cu``) is ``top2_scan``'s pipeline with a
maximum for an epilogue: persistent warp-specialised CTAs, a TMA ring of
128-byte depth chunks (so ``d % 128 == 0`` is required) of ``rtile`` rows
(64, 128 or 256; the TPU tool's row-tile sweep, ``wgmma`` N) and two
64-query tiles (``wgmma`` M, one per consumer warpgroup). In bf16 mode the
wrapper widens the queries once (exact) and the row chunks land in a raw
ring, from which the consumer warpgroups widen the next stage into bf16
operands while their ``wgmma`` on the current one runs (``csrc/hopper.cuh``'s
``to_bf16``, shared with ``top2_scan``). Each consumer keeps its queries' running maxima in registers
across the items of one query pair and folds them into the output with
``atomicMax``; an integer maximum does not depend on the order, so the result
is deterministic. The launch geometry is computed here by ``dot_geometry``
and checked again by the kernel's entry point.

What bounds it on an H100 at 1M x 384 int8, Q=512: 3.9e11 int8 operations
(0.2 ms at the 1,979 TOP/s int8 peak; 0.4 ms at the bf16 rate in bf16 mode)
against 384 MB of rows (0.11 ms at 3.35 TB/s): operations bound it.

On a CPU tensor the wrapper runs ``dot_max_reference``, the plain torch
version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..device import sm_count
from .build import KernelLibrary

MODES = {"s32": 0, "bf16": 1}
RTILES = (64, 128, 256)
BF16_MAX_DIM = 1040  # d * 127**2 < 2**24: the f32 sums stay exact
INT32_MIN = -(2**31)
# elements of the (Q, rows) float64 product the plain version holds at once
_PLAIN_CHUNK_ELEMS = 1 << 27

# kernel geometry; csrc/dot_max.cu holds the same constants
QUERY_TILE = 64  # queries per consumer warpgroup (wgmma M)
DEPTH_CHUNK = 128  # bytes (int8 values) of depth per TMA stage
RAW_STAGES = 2  # bf16 mode: int8 row stages before widening
BARRIER_BYTES = 256
SMEM_ALIGN = 1024  # slack to align the ring to the 128-byte swizzle atom
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on Hopper


def stage_bytes(rtile: int) -> int:
    """One operand stage: ``rtile`` rows and two query tiles of 128 bytes."""
    return (rtile + 2 * QUERY_TILE) * DEPTH_CHUNK


@dataclass(frozen=True)
class DotGeometry:
    """Launch geometry of the kernel for one (N, d, Q, mode, rtile).

    A work item is one row tile x one pair of query tiles; item ``u`` is row
    tile ``u // n_query_pairs``, pair ``u % n_query_pairs``, and CTA ``b``
    of ``grid`` takes items ``b, b + grid, ...``. bf16 mode adds
    ``raw_stages`` int8 row stages (``rtile`` x 128 bytes), each widened
    into the rows of two operand stages, and needs three operand stages: a
    consumer widens stage q + 1 before it releases stage q - 1."""

    n_row_tiles: int
    n_query_tiles: int
    n_query_pairs: int
    work_items: int
    grid: int
    stages: int
    raw_stages: int
    smem_bytes: int


def dot_geometry(n: int, d: int, nq: int, sms: int, mode: str,
                 rtile: int) -> DotGeometry:
    """The kernel's work items, persistent grid (one CTA per SM, at most one
    per item), ring stages and dynamic shared-memory bytes."""
    if (n <= 0 or nq <= 0 or d <= 0 or d % DEPTH_CHUNK or sms <= 0
            or mode not in MODES or rtile not in RTILES):
        raise ValueError(f"no dot_max geometry for N={n} d={d} Q={nq} "
                         f"{mode} rtile={rtile} on {sms} SMs")
    n_row_tiles = -(-n // rtile)
    n_query_tiles = -(-nq // QUERY_TILE)
    n_query_pairs = -(-n_query_tiles // 2)
    work_items = n_row_tiles * n_query_pairs
    raw_stages = RAW_STAGES if mode == "bf16" else 0
    fixed = SMEM_ALIGN + raw_stages * rtile * DEPTH_CHUNK + BARRIER_BYTES
    stages = (SMEM_LIMIT - fixed) // stage_bytes(rtile)
    return DotGeometry(
        n_row_tiles=n_row_tiles,
        n_query_tiles=n_query_tiles,
        n_query_pairs=n_query_pairs,
        work_items=work_items,
        grid=min(sms, work_items),
        stages=stages,
        raw_stages=raw_stages,
        smem_bytes=fixed + stages * stage_bytes(rtile),
    )


def _bind(lib: ctypes.CDLL) -> None:
    # rows, q, out, n, d, nq, mode, rtile, grid, stages, raw stages, smem
    # bytes, stream
    lib.semcode_dot_max.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    )
    lib.semcode_dot_max.restype = ctypes.c_int


_library = KernelLibrary("dot_max", _bind)


def build_library(verbose: bool = False):
    """Compile ``csrc/dot_max.cu`` into ``build/kernels`` (git-ignored)."""
    return _library.build(verbose=verbose)


def dot_max_reference(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel: (Q,) int32 maxima.

    The products are summed in float64, which is exact here (every partial
    sum is an integer of magnitude at most d * 2**14, far below 2**53) and
    runs on the card, where PyTorch has no int64 matrix product. Both modes
    of the kernel give this value wherever the wrapper accepts them."""
    q64 = q.to(torch.float64)
    step = max(1, _PLAIN_CHUNK_ELEMS // max(q.shape[0], 1))
    best = None
    for lo in range(0, rows.shape[0], step):
        part = (q64 @ rows[lo:lo + step].to(torch.float64).T).amax(dim=1)
        best = part if best is None else torch.maximum(best, part)
    return best.to(torch.int32)


def _check_args(rows, q, mode, rtile) -> None:
    if mode not in MODES:
        raise ValueError(f"dot_max mode must be one of {sorted(MODES)}, got {mode!r}")
    if rtile not in RTILES:
        raise ValueError(f"dot_max rtile must be one of {RTILES}, got {rtile!r}")
    if rows.dim() != 2 or q.dim() != 2:
        raise ValueError("rows and q must be 2-D")
    if rows.dtype != torch.int8 or q.dtype != torch.int8:
        raise TypeError(f"dot_max takes int8 rows and queries, got {rows.dtype} "
                        f"and {q.dtype}")
    n, d = rows.shape
    if q.shape[1] != d:
        raise ValueError(f"q must be (Q, {d}), got {tuple(q.shape)}")
    if d == 0 or d % 128 != 0:
        raise ValueError(f"dot_max streams 128-byte depth chunks: needs d % 128 "
                         f"== 0, got {d}")
    if mode == "bf16" and d > BF16_MAX_DIM:
        raise ValueError(f"bf16 mode is exact only for d <= {BF16_MAX_DIM} "
                         f"(d * 127**2 < 2**24), got {d}")
    if n == 0 or q.shape[0] == 0:
        raise ValueError("dot_max needs at least one row and one query")
    if rows.device != q.device:
        raise ValueError(f"dot_max inputs span devices {rows.device} and {q.device}")


def dot_max(
    rows: torch.Tensor,  # (N, d) int8
    q: torch.Tensor,     # (Q, d) int8
    *,
    mode: str = "s32",
    rtile: int = 128,
) -> torch.Tensor:
    """-> (Q,) int32: ``max_r q[i] . rows[r]``, exact.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    _check_args(rows, q, mode, rtile)
    if rows.device.type == "cpu":
        return dot_max_reference(rows, q)
    if rows.device.type != "cuda":
        raise ValueError(f"dot_max: unsupported device {rows.device}")
    rows = rows.contiguous()
    # bf16 mode reads the queries widened (exact for int8): once here, not
    # once per row tile in the kernel
    q = (q if mode == "s32" else q.to(torch.bfloat16)).contiguous()
    for t in (rows, q):
        if t.data_ptr() % 16:
            raise ValueError("dot_max needs 16-byte aligned rows")
    n, d = rows.shape
    out = torch.full((q.shape[0],), INT32_MIN, dtype=torch.int32, device=rows.device)
    lib = _library.get()
    with torch.cuda.device(rows.device):
        geom = dot_geometry(n, d, q.shape[0], sm_count(torch.cuda.current_device()),
                            mode, rtile)
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = lib.semcode_dot_max(
            rows.data_ptr(), q.data_ptr(), out.data_ptr(), n, d, q.shape[0],
            MODES[mode], rtile, geom.grid, geom.stages, geom.raw_stages,
            geom.smem_bytes, stream,
        )
    if err != 0:
        raise RuntimeError(f"dot_max kernel launch failed: CUDA error {err}")
    dot_max.launches += 1
    dot_max.mode_launches[mode] += 1
    return out


dot_max.launches = 0  # kernel launches (not plain-version calls)
dot_max.mode_launches = dict.fromkeys(MODES, 0)  # the same, by mode
