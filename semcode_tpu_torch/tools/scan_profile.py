"""Stage decomposition of the flat index's exact scan.

Counterpart of ``tools/scan_profile.py``: times progressively larger slices
of the search step, each over CHUNK_B batches between two CUDA events, with
the route's own functions (``index/scan.py``):

  dot          int8 query quantization + corpus dot + f32 rescale, consumed
               by a per-query max (the read + tensor-core floor)
  dot_kernel   the ``dot_max`` kernel (``ops/dot_max.py``, s32, 128-row
               tiles) at the same shape: the dot without the rescale, on
               the int8 top2_scan kernel's pipeline (TMA ring, wgmma) with
               a maximum for its epilogue; against ``norescore`` with
               SCAN_IMPL=pallas it shows what the selection and the rest of
               the route add to the GEMM
  dotsel       + the valid-row mask and the exact top-FETCH selection
  dotseltop    + the final top-K
  norescore    ``search_device_batched`` with the f32 mirror off
  full         ``search_device_batched`` with the fused rescore on
  gather       only the rescore stage: gather (Q, FETCH) f32 mirror rows and
               score them with a true-f32 batched product, against fixed
               random candidate ids (under the residual tier:
               ``gather_residual``, two int8 gathers + reconstruction, and
               ``gather_resid_only``, the residual gather alone)
  gather_vpu   the same gather scored with an elementwise multiply + sum

The JAX tool's ``approx_max_k`` exists only on a TPU: every selection here
is exact (``stable_topk``), and each line says ``"selection": "exact"``
with ``"rt": null`` (the recall target has no counterpart).

    python -m semcode_tpu_torch.tools.scan_profile [mode ...]   (default: all)

Env: N (1000000), DIM (384), BATCH (256), CHUNK_B (16), SECS (8.0), FETCH
(128), SCAN_IMPL ("auto", the index's default: the full-matrix route;
"pallas" for the top2_scan kernel); SEMCODE_TORCH_DEVICE=cpu runs on the
CPU. Prints one JSON line per mode: {mode, n, dim, batch, chunk_b, fetch,
rt, selection, scan_impl, ms_per_batch, qps, compile_s, device}.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from ..device import f32_matmul, resolve_device
from ..index.flat import FlatIndex
from ..index.scan import (
    _SCORE_BLOCK_ELEMS,
    _score_block,
    _select_xla,
    quantize_queries_device,
    stable_topk,
)
from ..ops.dot_max import dot_max
from ._timing import chained_ms, device_name, env_number, first_call

DEFAULT_MODES = ("dot", "dot_kernel", "dotsel", "dotseltop", "norescore",
                 "full", "gather", "gather_vpu")
K = 10


def main(argv: Optional[Sequence[str]] = None,
         environ: Optional[Mapping[str, str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    env = os.environ if environ is None else environ
    n = env_number(env, "N", 1_000_000)
    dim = env_number(env, "DIM", 384)
    batch = env_number(env, "BATCH", 256)
    chunk_b = env_number(env, "CHUNK_B", 16)
    secs = env_number(env, "SECS", 8.0)
    fetch = env_number(env, "FETCH", 128)
    scan_impl = env.get("SCAN_IMPL") or "auto"
    modes = list(argv) or list(DEFAULT_MODES)
    device = resolve_device()
    card = device_name(device)

    rng = np.random.default_rng(0)
    n_centers = max(64, n // 1000)
    centers = rng.standard_normal((n_centers, dim), dtype=np.float32)
    # the rescore tier resolves by the device-memory budget as in production
    idx = FlatIndex(dim, metric="cosine", dtype="int8", capacity=n,
                    rescore_mode="auto", scan_impl=scan_impl, device=device)
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
    qb = torch.from_numpy(q).to(device)
    qs = torch.stack([qb] * chunk_b)  # (B, Q, d)

    vecs, norms, valid, scales, rescore, tags = idx._ensure_device()
    rows = vecs.shape[0]
    # fixed random candidate ids for the isolated gather stages
    pos = torch.from_numpy(rng.integers(0, rows, (batch, fetch))).to(device)

    def dot():
        qq, qsc = quantize_queries_device(qb)
        step_q = max(1, _SCORE_BLOCK_ELEMS // rows)
        return torch.cat([
            _score_block(qq[lo:lo + step_q], vecs, scales, "int8",
                         qsc[lo:lo + step_q]).amax(dim=1)
            for lo in range(0, batch, step_q)
        ])

    def dot_kernel():
        qq, _ = quantize_queries_device(qb)
        return dot_max(vecs, qq, mode="s32", rtile=128)

    def dotsel(with_topk):
        qq, qsc = quantize_queries_device(qb)
        s, p = _select_xla(qq, qsc, vecs, norms, valid, scales, "int8",
                           idx.metric, fetch, False)
        if with_topk:
            s, sel = stable_topk(s, K)
            p = torch.gather(p, 1, sel)
        return s, p

    def gather_scored(cand):
        return f32_matmul(cand, qb[:, :, None])[:, :, 0].amax(dim=1)

    def timed(fn, label, batched=False):
        """``fn`` scans one batch, or all CHUNK_B of them if ``batched``."""
        _, compile_s = first_call(fn, device)
        if batched:
            ms = chained_ms(fn, device, 1, secs) / chunk_b
        else:
            ms = chained_ms(fn, device, chunk_b, secs)
        print(json.dumps({
            "mode": label, "n": n, "dim": dim, "batch": batch,
            "chunk_b": chunk_b, "fetch": fetch, "rt": None,
            "selection": "exact", "scan_impl": scan_impl,
            "ms_per_batch": round(ms, 4),
            "qps": round(batch / (ms * 1e-3), 1),
            "compile_s": round(compile_s, 3), "device": card,
        }), flush=True)

    for mode in modes:
        if mode == "dot":
            timed(dot, "dot")
        elif mode == "dot_kernel":
            timed(dot_kernel, "dot_kernel")
        elif mode == "dotsel":
            timed(lambda: dotsel(False), "dotsel")
        elif mode == "dotseltop":
            timed(lambda: dotsel(True), "dotseltop")
        elif mode == "norescore":
            idx._dev = (vecs, norms, valid, scales, None, tags)
            timed(lambda: idx.search_device_batched(qs, K), "norescore", batched=True)
            idx._dev = (vecs, norms, valid, scales, rescore, tags)
        elif mode == "full":
            idx.fetch_width = fetch
            timed(lambda: idx.search_device_batched(qs, K), "full", batched=True)
        elif mode == "gather":
            if isinstance(rescore, tuple):
                rsd, rscl = rescore
                timed(lambda: gather_scored(
                    vecs[pos].to(torch.float32) * scales[pos][:, :, None]
                    + rsd[pos].to(torch.float32) * rscl[pos][:, :, None]),
                    "gather_residual")
                timed(lambda: gather_scored(
                    rsd[pos].to(torch.float32) * rscl[pos][:, :, None]),
                    "gather_resid_only")
            elif rescore is not None:
                timed(lambda: gather_scored(rescore[pos]), "gather")
        elif mode == "gather_vpu":
            if rescore is not None and not isinstance(rescore, tuple):
                timed(lambda: (rescore[pos] * qb[:, None, :]).sum(dim=2).amax(dim=1),
                      "gather_vpu")
        else:
            print(json.dumps({"mode": mode, "error": "unknown"}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
