"""Dot-rate microbench: which library formulation of the corpus dot runs fastest?

Counterpart of ``tools/dot_rate.py``. Times pure dot formulations (no
selection, no rescore, no index machinery) through the library's GEMMs,
each consumed by a per-query max, over row chunks so the (Q, N) product
stays bounded:

  s8s8      ``torch._int_mm`` (Q,d) s8 x (R,d) s8 -> s32, f32 rescale
            epilogue, max consumer
  s8s8_raw  the same without the rescale epilogue
  s8s8_t    the corpus stored transposed, (d, R), with the rescale
  bf16      a bf16-resident corpus (rows scaled to f32, then bf16; twice the
            bytes) against bf16 queries
  s8s8_big  s8s8_raw with the queries tiled 2x along Q (2Q rows per pass)
  s4s4, s4s4_cast
            int4 x int4: PyTorch offers no int4 GEMM on this card, so these
            print {mode, error}

    python -m semcode_tpu_torch.tools.dot_rate [mode ...]
        (default s8s8 s8s8_raw s8s8_t bf16 s4s4)

Env: N (1000000), DIM (384), BATCH (512), CHUNK_B (16), SECS (6.0);
SEMCODE_TORCH_DEVICE=cpu runs on the CPU. On the card cuBLASLt's int8 GEMM
needs BATCH > 16 and N, DIM multiples of 8; a mode it refuses prints
{mode, error}. Prints one JSON line per mode: {mode, n, dim, batch,
chunk_b, ms_per_batch, tops, corpus_gbps, compile_s, device}, timed as
CHUNK_B back-to-back calls between two CUDA events, repeated for SECS.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ._timing import chained_ms, device_name, env_number, first_call

DEFAULT_MODES = ("s8s8", "s8s8_raw", "s8s8_t", "bf16", "s4s4")
NO_INT4 = ("PyTorch has no int4 x int4 GEMM on this card and the port adds no "
           "kernel for one")
# elements of the (Q, rows) product held at once
_CHUNK_ELEMS = 1 << 27


def _rowwise_max(n_rows: int, n_q: int, block) -> torch.Tensor:
    """max over row chunks [lo, hi) of ``block(lo, hi)``, a (Q,) maximum;
    chunks are multiples of 8 rows (cuBLASLt's int8 rule)."""
    step = max(8, _CHUNK_ELEMS // n_q // 8 * 8)
    best = None
    for lo in range(0, n_rows, step):
        part = block(lo, min(lo + step, n_rows))
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
    modes = list(argv) or list(DEFAULT_MODES)
    device = resolve_device()
    card = device_name(device)

    rng = np.random.default_rng(0)
    corpus_i8 = rng.integers(-127, 128, (n, dim), dtype=np.int8)
    scales = (rng.random(n, dtype=np.float32) + 0.5) / 127.0
    q_i8 = rng.integers(-127, 128, (batch, dim), dtype=np.int8)
    q_scales = (rng.random(batch, dtype=np.float32) + 0.5) / 127.0
    v8 = torch.from_numpy(corpus_i8).to(device)
    scl = torch.from_numpy(scales).to(device)
    q8 = torch.from_numpy(q_i8).to(device)
    qsc = torch.from_numpy(q_scales).to(device)
    macs = float(n) * dim * batch
    corpus_bytes = float(n) * dim  # the int8 corpus read

    def s8(a, b, lo, hi, rescale):
        raw = torch._int_mm(a, b)
        if not rescale:
            return raw.amax(dim=1)
        return (raw.to(torch.float32) * qsc[:, None] * scl[None, lo:hi]).amax(dim=1)

    def timed(fn, label, n_q=batch, read_bytes=corpus_bytes, macs_mult=1):
        _, compile_s = first_call(fn, device)
        ms = chained_ms(fn, device, chunk_b, secs)
        print(json.dumps({
            "mode": label, "n": n, "dim": dim, "batch": n_q,
            "chunk_b": chunk_b, "ms_per_batch": round(ms, 4),
            "tops": round(2.0 * macs_mult * macs / (ms * 1e-3) / 1e12, 1),
            "corpus_gbps": round(read_bytes / (ms * 1e-3) / 1e9, 1),
            "compile_s": round(compile_s, 3), "device": card,
        }), flush=True)

    for mode in modes:
        try:
            if mode == "s8s8":
                timed(lambda: _rowwise_max(n, batch, lambda lo, hi: s8(
                    q8, v8[lo:hi].T, lo, hi, True)), mode)
            elif mode == "s8s8_raw":
                timed(lambda: _rowwise_max(n, batch, lambda lo, hi: s8(
                    q8, v8[lo:hi].T, lo, hi, False)), mode)
            elif mode == "s8s8_t":
                v8t = v8.T.contiguous()  # (d, R)
                timed(lambda: _rowwise_max(n, batch, lambda lo, hi: s8(
                    q8, v8t[:, lo:hi], lo, hi, True)), mode)
                del v8t
            elif mode == "bf16":
                vbf = (v8.to(torch.float32) * scl[:, None]).to(torch.bfloat16)
                qbf = q8.to(torch.bfloat16)
                timed(lambda: _rowwise_max(n, batch, lambda lo, hi: (
                    qbf @ vbf[lo:hi].T).amax(dim=1)), mode,
                    read_bytes=2 * corpus_bytes)
                del vbf
            elif mode == "s8s8_big":
                q2 = torch.cat([q8, q8])  # (2Q, d)
                timed(lambda: _rowwise_max(n, 2 * batch, lambda lo, hi: s8(
                    q2, v8[lo:hi].T, lo, hi, False)), mode, n_q=2 * batch,
                    macs_mult=2)
            elif mode in ("s4s4", "s4s4_cast"):
                print(json.dumps({"mode": mode, "error": NO_INT4}), flush=True)
            else:
                print(json.dumps({"mode": mode, "error": "unknown"}), flush=True)
        except (RuntimeError, ValueError) as exc:  # report per mode, keep going
            print(json.dumps({"mode": mode,
                              "error": f"{type(exc).__name__}: {str(exc)[:300]}"}),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
