"""Int8 dot-max kernel: each query's largest dot product over a corpus.

Replaces the Pallas kernel that ``tools/dot_pallas.py::make_kernel`` builds
(``pallas_call`` at line 89), the TPU's int8 GEMM rate probe. The function:

    out[i] = max_r  sum_k q[i, k] * rows[r, k]      (Q,) int32, exact

The TPU kernel writes each maximum broadcast over 128 lanes, a ``(Q, 128)``
array whose columns all hold the same value: an artifact of the TPU's output
layout, not reproduced here.

Modes:

- ``"s32"``: s8 x s8 -> s32 on the tensor cores (``mma.sync`` m16n8k32).
- ``"bf16"``: the TPU tool's ``bf16cast`` form (dot_pallas.py:64-72): the
  int8 operands are widened to bf16, the products summed in an f32
  accumulator (``mma.sync`` m16n8k16) and the sum converted to int32 before
  the maximum. That is exact only while every partial sum stays below 2^24,
  i.e. ``d * 127**2 < 2**24`` (``d <= 1040``) for values in [-127, 127], so
  the wrapper refuses a larger ``d`` in this mode (the TPU tool has the same
  limit, unstated); with ``d % 128 == 0`` the largest is 1024. A -128 in
  both operands lowers the limit to d = 1024.

The CUDA kernel (``csrc/dot_max.cu``) keeps the first ``top2_scan``
design's tiling (still ``top2_scan``'s bf16/f32 path): ``rtile`` rows (64,
128 or 256; the TPU tool's row-tile sweep) x 64 queries per block of 256
threads, synchronous staging of 128-byte depth chunks and ``mma.sync``, so
``d % 128 == 0`` is required. Each block reduces its tile to 64 per-query
maxima and folds them into the output with ``atomicMax``; an integer
maximum does not depend on the order, so the result is deterministic. On
int8 operands its time is that old tiling's GEMM with no selection: the
yardstick that ``top2_scan``'s int8 kernel (TMA, ``wgmma``, selection in
registers) is held against at one shape.

What bounds it on an H100 at 1M x 384 int8, Q=512: 3.9e11 int8 operations
(0.2 ms at the 1,979 TOP/s int8 peak; 0.4 ms at the bf16 rate in bf16 mode)
against 384 MB of rows (0.11 ms at 3.35 TB/s): operations bound it.

On a CPU tensor the wrapper runs ``dot_max_reference``, the plain torch
version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .build import KernelLibrary

MODES = {"s32": 0, "bf16": 1}
RTILES = (64, 128, 256)
BF16_MAX_DIM = 1040  # d * 127**2 < 2**24: the f32 sums stay exact
INT32_MIN = -(2**31)
# elements of the (Q, rows) float64 product the plain version holds at once
_PLAIN_CHUNK_ELEMS = 1 << 27


def _bind(lib: ctypes.CDLL) -> None:
    # rows, q, out, n, d, nq, mode, rtile, stream
    lib.semcode_dot_max.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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
        raise ValueError(f"dot_max stages 128-byte depth chunks: needs d % 128 "
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
    q = q.contiguous()
    for t in (rows, q):
        if t.data_ptr() % 16:
            raise ValueError("dot_max needs 16-byte aligned rows")
    n, d = rows.shape
    out = torch.full((q.shape[0],), INT32_MIN, dtype=torch.int32, device=rows.device)
    lib = _library.get()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = lib.semcode_dot_max(
            rows.data_ptr(), q.data_ptr(), out.data_ptr(), n, d, q.shape[0],
            MODES[mode], rtile, stream,
        )
    if err != 0:
        raise RuntimeError(f"dot_max kernel launch failed: CUDA error {err}")
    dot_max.launches += 1
    return out


dot_max.launches = 0  # kernel launches (not plain-version calls)
