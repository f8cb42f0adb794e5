"""Joint (rescore_mode, fetch, rescore_width) sweep of the flat index's scan.

Counterpart of ``tools/scan_tune.py``. For each config it builds one
FlatIndex (int8 storage) over the same seeded corpus and measures batched
QPS (``search_device_batched``, CHUNK_B batches between two CUDA events)
and recall@10 against an exact f32 oracle (TF32 held off) computed on the
device.

    python -m semcode_tpu_torch.tools.scan_tune [config ...]
        config = mode:fetch[:W], e.g. f32:128 residual:64:32
        (default f32:128 residual:128 residual:64)

``mode`` is the index's ``rescore_mode`` (auto | f32 | residual | off) and
W its ``rescore_width`` (omitted = 0, the auto policy: an explicit fetch
then gathers the whole fetch; -1 = full fetch). The JAX tool's third field,
the ``approx_max_k`` recall target ``rt``, has no counterpart: the port's
selection is exact, and a config that names one prints {config, error}.

Env: N (1000000), DIM (384), BATCH (256), CHUNK_B (16), SECS (8.0), N_Q
(512, at least BATCH); SEMCODE_TORCH_DEVICE=cpu runs on the CPU. The index
takes its default route, the full-matrix scan, as the JAX tool's did. The
corpus is the Gaussian mixture of chip_smoke.py (``tools/_corpus.mixture``)
from a seeded ``torch.Generator`` on the device. Prints {"stage":
"oracle_done"}, then one JSON line per config: {mode, fetch, rt, w, batch,
recall_at_10, qps, ms_per_batch, build_s, compile_s, selection, device}.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..index.flat import FlatIndex
from ._corpus import mixture, oracle_topk, queries_near
from ._timing import chained_ms, device_name, env_number, first_call, synchronize

DEFAULT_CONFIGS = ("f32:128", "residual:128", "residual:64")
K = 10


def parse_config(cfg: str) -> Tuple[str, int, int]:
    """``mode:fetch[:W]`` -> (mode, fetch, W); raises ValueError otherwise,
    in particular for the JAX tool's ``mode:fetch:rt[:W]``."""
    parts = cfg.split(":")
    try:
        if len(parts) not in (2, 3):
            raise ValueError
        return parts[0], int(parts[1]), int(parts[2]) if len(parts) == 3 else 0
    except ValueError:
        raise ValueError(
            f"config {cfg!r} is not mode:fetch[:W]; the JAX tool's recall "
            "target rt has no counterpart (the port's selection is exact)"
        ) from None


def main(argv: Optional[Sequence[str]] = None,
         environ: Optional[Mapping[str, str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    env = os.environ if environ is None else environ
    n = env_number(env, "N", 1_000_000)
    dim = env_number(env, "DIM", 384)
    batch = env_number(env, "BATCH", 256)
    chunk_b = env_number(env, "CHUNK_B", 16)
    secs = env_number(env, "SECS", 8.0)
    n_q = max(env_number(env, "N_Q", 512), batch)
    configs = list(argv) or list(DEFAULT_CONFIGS)
    device = resolve_device()
    card = device_name(device)

    gen = torch.Generator(device=device).manual_seed(42)
    x_dev = mixture(gen, n, dim)
    q_dev = queries_near(gen, x_dev, n_q)
    oracle_ids = oracle_topk(x_dev, q_dev, K).cpu().numpy()
    print(json.dumps({"stage": "oracle_done"}), flush=True)
    x_host = x_dev.cpu().numpy()
    queries = q_dev.cpu().numpy()
    del x_dev

    qs_chunk = torch.stack(
        [q_dev[(i * batch) % n_q:(i * batch) % n_q + batch] for i in range(chunk_b)]
    )
    q_batches = [queries[i:i + batch] for i in range(0, n_q, batch)]

    for cfg in configs:
        try:
            mode, fetch, w = parse_config(cfg)
            idx = FlatIndex(dim, metric="ip", dtype="int8", capacity=n,
                            rescore_mode=mode, fetch_width=fetch,
                            rescore_width=w, device=device)
        except ValueError as exc:
            print(json.dumps({"config": cfg, "error": str(exc)}), flush=True)
            continue
        t0 = time.perf_counter()
        idx.add(x_host)
        synchronize(device)
        build_s = time.perf_counter() - t0

        got = np.concatenate([idx.search(qb, k=K)[1] for qb in q_batches])
        rec = float(np.mean([
            len(set(a.tolist()) & set(b.tolist())) / K
            for a, b in zip(got, oracle_ids)
        ]))
        search = lambda: idx.search_device_batched(qs_chunk, K)  # noqa: E731
        _, compile_s = first_call(search, device)
        ms = chained_ms(search, device, 1, secs) / chunk_b
        print(json.dumps({
            "mode": mode, "fetch": fetch, "rt": None, "w": w, "batch": batch,
            "recall_at_10": round(rec, 4),
            "qps": round(batch / (ms * 1e-3), 1),
            "ms_per_batch": round(ms, 4),
            "build_s": round(build_s, 3), "compile_s": round(compile_s, 3),
            "selection": "exact", "device": card,
        }), flush=True)
        del idx
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
