"""Chained A/B of the exact-scan routes: full matrix vs the top2_scan kernel.

Counterpart of ``tools/scan_ab.py``. Measures the flat index's batched
path (``FlatIndex.search_device_batched``, CHUNK_B batches per timed group)
with ``scan_impl`` flipped between "xla" (the full (Q, R) score matrix
through ``torch._int_mm`` and an exact top-fetch) and "pallas" (the
``top2_scan`` kernel: int8 rows read once, top-2 per 128-row block, then an
exact top-fetch of the survivors). Both routes rescore with the f32 mirror.

    python -m semcode_tpu_torch.tools.scan_ab [N] [DIM] [BATCH] [CHUNK_B] [SECS]
        (defaults 1000000 384 256 16 10.0)

SEMCODE_TORCH_DEVICE=cpu runs on the CPU. The corpus is the JAX tool's
Gaussian mixture from numpy seed 0. Prints one JSON line: QPS, ms per batch
and first-call seconds for both routes, and the routes' top-10 agreement
(the kernel route keeps two candidates per 128-row block, so three of a
query's true top-10 in one block cost it one).
"""

from __future__ import annotations

import json
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..index.flat import FlatIndex
from ._timing import chained_ms, device_name, first_call


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if len(argv) > 0 else 1_000_000
    dim = int(argv[1]) if len(argv) > 1 else 384
    batch = int(argv[2]) if len(argv) > 2 else 256
    chunk_b = int(argv[3]) if len(argv) > 3 else 16
    secs = float(argv[4]) if len(argv) > 4 else 10.0
    k = 10
    device = resolve_device()

    rng = np.random.default_rng(0)
    # Gaussian-mixture corpus (the JAX tool's, bench.py's shape of difficulty)
    n_centers = max(64, n // 1000)
    centers = rng.standard_normal((n_centers, dim), dtype=np.float32)
    idx = FlatIndex(dim, metric="cosine", dtype="int8", capacity=n, device=device)
    step = 250_000
    for i in range(0, n, step):
        m = min(step, n - i)
        x = centers[rng.integers(0, n_centers, m)] + 0.35 * rng.standard_normal(
            (m, dim), dtype=np.float32
        )
        idx.add(x)
    q = centers[rng.integers(0, n_centers, batch)] + 0.35 * rng.standard_normal(
        (batch, dim), dtype=np.float32
    )
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    qs = torch.from_numpy(np.stack([q] * chunk_b)).to(device)
    idx._ensure_device()  # one-time device state stays out of compile_s

    out = {"n": n, "dim": dim, "batch": batch, "chunk_b": chunk_b,
           "device": device_name(device)}
    ids_by_impl = {}
    for impl in ("xla", "pallas"):
        idx.scan_impl = impl
        search = lambda: idx.search_device_batched(qs, k)  # noqa: E731
        (_, ids), compile_s = first_call(search, device)
        ids_by_impl[impl] = ids[0].cpu().numpy()
        ms = chained_ms(search, device, 1, secs) / chunk_b
        out[f"{impl}_qps"] = round(batch / (ms * 1e-3), 1)
        out[f"{impl}_ms_per_batch"] = round(ms, 4)
        out[f"{impl}_compile_s"] = round(compile_s, 3)
    a, b = ids_by_impl["xla"], ids_by_impl["pallas"]
    agree = np.mean(
        [len(set(r1.tolist()) & set(r2.tolist())) / k for r1, r2 in zip(a, b)]
    )
    out["top10_agreement"] = round(float(agree), 4)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
