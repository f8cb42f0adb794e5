"""The int8 dot-max kernel against the library's int8 GEMM: the H100 rate probe.

Counterpart of ``tools/dot_pallas.py``. The kernel (``ops/dot_max.py``,
``csrc/dot_max.cu``) streams int8 corpus rows in ``rtile``-row tiles
against resident int8 queries and keeps each query's running maximum; its
yardstick is the same contraction through ``torch._int_mm`` (cuBLASLt's
int8 GEMM) with the same max consumer, which plays the JAX tool's
``xla_s8s8`` line. The yardstick is timed here only: the port never calls
it on a path.

    python -m semcode_tpu_torch.tools.dot_cuda [rtile ...]    (default 64 128 256)

Env: N (1000000), DIM (384), BATCH (512), CHUNK_B (16), SECS (6.0);
SEMCODE_TORCH_DEVICE=cpu runs the plain versions on the CPU. Corpus and
queries are ``rng.integers(-127, 128)`` from numpy seed 0, as the JAX tool.

Prints one JSON line per config: {mode, [rtile,] ms_per_batch, tops,
compile_s, device}; the kernel lines ``cuda_s8s8_s32`` and
``cuda_s8s8_bf16cast`` also carry ``max_equal``, whether the kernel's
output equals the yardstick's. ``ms_per_batch`` is CHUNK_B back-to-back
calls between two CUDA events, repeated for SECS; ``compile_s`` is the
first call, which includes the kernel's nvcc build in a fresh process. A
config the wrapper refuses (bf16 past d = 1040) prints {mode, rtile, error}.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops.dot_max import RTILES, dot_max
from ._timing import chained_ms, device_name, env_number, first_call

# elements of the (Q, rows) int32 product the yardstick holds at once
_YARDSTICK_CHUNK_ELEMS = 1 << 27
KERNEL_MODES = (("s32", "cuda_s8s8_s32"), ("bf16", "cuda_s8s8_bf16cast"))


def int_mm_max(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(Q,) int32 ``torch._int_mm(q, rows.T).amax(1)``, over row chunks so
    the (Q, N) int32 product stays bounded.

    cuBLASLt's int8 GEMM takes more than 16 query rows and a multiple of 8
    rows per chunk: the queries are padded with zero rows (dropped from the
    result) and a ragged chunk with copies of its first row (a repeated row
    does not change a maximum)."""
    nq, d = q.shape
    m = max(24, -(-nq // 8) * 8)
    a = q if m == nq else torch.cat([q, q.new_zeros((m - nq, d))])
    step = max(8, _YARDSTICK_CHUNK_ELEMS // m // 8 * 8)
    best = None
    for lo in range(0, rows.shape[0], step):
        b = rows[lo:lo + step]
        if b.shape[0] % 8:
            b = torch.cat([b, b[:1].expand(8 - b.shape[0] % 8, d)])
        part = torch._int_mm(a, b.T)[:nq].amax(dim=1)
        best = part if best is None else torch.maximum(best, part)
    return best


def main(argv: Optional[Sequence[str]] = None,
         environ: Optional[Mapping[str, str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    env = os.environ if environ is None else environ
    n = env_number(env, "N", 1_000_000)
    dim = env_number(env, "DIM", 384)
    batch = env_number(env, "BATCH", 512)
    chunk_b = env_number(env, "CHUNK_B", 16)
    secs = env_number(env, "SECS", 6.0)
    rtiles = [int(a) for a in argv] or list(RTILES)
    device = resolve_device()
    card = device_name(device)

    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.integers(-127, 128, (n, dim), dtype=np.int8)).to(device)
    q = torch.from_numpy(rng.integers(-127, 128, (batch, dim), dtype=np.int8)).to(device)
    ops = 2.0 * batch * n * dim

    def emit(mode, fn, compile_s, **extra):
        ms = chained_ms(fn, device, chunk_b, secs)
        print(json.dumps({
            "mode": mode, **extra,
            "ms_per_batch": round(ms, 4),
            "tops": round(ops / (ms * 1e-3) / 1e12, 1),
            "compile_s": round(compile_s, 3),
            "device": card,
        }), flush=True)

    yardstick = lambda: int_mm_max(rows, q)  # noqa: E731
    want, compile_s = first_call(yardstick, device)
    emit("torch_int_mm_s8s8", yardstick, compile_s)
    for rtile in rtiles:
        for mode, label in KERNEL_MODES:
            kernel = lambda m=mode, r=rtile: dot_max(rows, q, mode=m, rtile=r)  # noqa: E731
            try:
                got, compile_s = first_call(kernel, device)
            except ValueError as exc:  # a refused config is the result
                print(json.dumps({"mode": label, "rtile": rtile,
                                  "error": str(exc)}), flush=True)
                continue
            emit(label, kernel, compile_s, rtile=rtile,
                 max_equal=bool(torch.equal(got, want)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
