"""End-to-end API serving SLO harness (BASELINE config 5).

Counterpart of the JAX package's ``tools/bench_api.py``. Builds a
VectorStore with a synthetic corpus, mounts the real aiohttp app
(``semcode_tpu_torch.api.main.create_app``: auth -> micro-batcher -> embed
-> index scan -> device rerank -> hits) on a localhost socket, and drives
``POST /query`` at fixed concurrency with aiohttp's test client. Reports
end-to-end p50/p99 latency and QPS — the full product path including HTTP
framing, JSON, batching, the query embed on the card, and hit assembly —
plus the failed requests (any status but 200) and the answers that came
back without hits (the store is never empty, so those are retrieval
failures the pipeline degraded to a fallback).

The chunk bodies and metadata are the JAX harness's (~2 KB bodies with
varied identifiers). The vectors are made on the engine's device from a
seeded ``torch.Generator`` instead of ``jax.random``, so the corpus is not
the JAX harness's bit for bit. ``--impl`` picks the exact-scan route:
``auto`` (the full score matrix) or ``pallas`` (the ``top2_scan`` kernel).
It runs on CUDA unless ``SEMCODE_TORCH_DEVICE=cpu`` asks for the CPU:

    python -m semcode_tpu_torch.tools.bench_api --rows 20000 --concurrency 32 --secs 10
    SEMCODE_TORCH_DEVICE=cpu python -m semcode_tpu_torch.tools.bench_api --rows 500 --secs 1
"""

from __future__ import annotations

import argparse
import asyncio
import json
import tempfile
import time
from pathlib import Path
from typing import Awaitable, Callable, Optional

import numpy as np
import torch

API_KEY = "bench"

_QUESTIONS = [
    "how does the ivf index rebuild its cluster layout",
    "where is the api key checked for incoming requests",
    "function that quantizes rows to int8 on device",
    "how are tombstoned rows removed from search results",
    "what happens when the embedding provider is unavailable",
    "streaming insert placement into free cluster slots",
    "how does the chunker split very long files",
    "top-k merge across mesh shards",
]

# realistic chunk bodies (~0.7 KB x 3, varied identifiers) so the serving
# numbers include the second-stage rerank's real host cost — one-line
# bodies would make its tokenization stage look free
_VERBS = ("parse", "build", "merge", "scan", "flush", "encode", "route")
_NOUNS = ("cluster", "payload", "snapshot", "registry", "batch", "shard")


def _body(i: int) -> str:
    v, n = _VERBS[i % len(_VERBS)], _NOUNS[(i // 7) % len(_NOUNS)]
    return (
        f'"""{v.capitalize()} the {n} state for request {i}."""\n'
        f"def {v}_{n}_{i % 997}(ctx, retries={i % 5}):\n"
        f"    state = ctx.lookup('{n}_{i % 53}')\n"
        f"    for attempt in range(retries + 1):\n"
        f"        result = state.{v}(timeout_ms={100 + i % 400})\n"
        f"        if result.ok:\n"
        f"            return result.value\n"
        f"    raise RuntimeError('{v} {n} failed after retries')\n"
    ) * 3


class _Payload:
    __slots__ = ("id", "text", "vector", "metadata")

    def __init__(self, i: int, v: np.ndarray):
        self.id = f"chunk-{i:07d}"
        self.text = _body(i)
        self.vector = v
        self.metadata = {
            "repo": f"repo-{i % 8}",
            "path": f"src/mod_{i % 97}.py",
            "language": "python",
            "symbol": f"{_VERBS[i % len(_VERBS)]}_"
                      f"{_NOUNS[(i // 7) % len(_NOUNS)]}_{i % 997}",
            "start_line": 1,
            "end_line": 24,
        }


def build_store(rows: int, dim: int, workdir: Path, config_overrides=None,
                device=None, seed: int = 3):
    """Synthetic corpus store: unit Gaussian vectors made on the engine's
    device, metadata shaped like real chunk payloads."""
    from ..index.store import VectorStore
    from ..settings import AppSettings

    config = AppSettings(
        workspace_root=workdir / "workspace",
        index_snapshot_dir=workdir / "index",
        embedding_provider="tpu-hash",
        embedding_dimension=dim,
        index_kind="flat",
        index_dtype="int8",
        telemetry_enabled=True,
        api_key=API_KEY,
        **(config_overrides or {}),
    )
    store = VectorStore(config, dim=dim, device=device)
    store.connect()
    gen = torch.Generator(device=store.device).manual_seed(seed)
    x = torch.randn(rows, dim, generator=gen, device=store.device)
    x /= torch.clamp(x.norm(dim=1, keepdim=True), min=1e-9)
    vecs = x.cpu().numpy()
    store.upsert_embeddings(
        [_Payload(i, vecs[i]) for i in range(rows)], batch_size=4096
    )
    return config, store


async def drive(client, concurrency: int, secs: float, label: str) -> dict:
    """``POST /query`` from ``concurrency`` workers for ``secs`` seconds;
    ``label`` keeps one window's questions apart from another's."""
    headers = {"X-API-Key": API_KEY}
    lat: list = []
    stop_at = time.perf_counter() + secs
    done = failed = empty = cached = 0
    errors: list = []
    stage_ms: dict = {}
    stage_q = 0
    batch_sizes: list = []  # the size of the pipeline call each answer rode

    async def worker(wid: int):
        nonlocal done, failed, empty, cached, stage_q
        i = wid
        while time.perf_counter() < stop_at:
            # UNIQUE question per request: with the pipeline's per-question
            # LRU cache (which query_batch honors too) a small repeated
            # pool would measure the cache path, not the engine
            q = f"{_QUESTIONS[i % len(_QUESTIONS)]} {label} {wid}-{i}"
            t0 = time.perf_counter()
            async with client.post(
                "/query", json={"question": q, "top_k": 10}, headers=headers
            ) as resp:
                j = await resp.json()
                status = resp.status
            i += 1
            if status != 200:
                failed += 1
                if len(errors) < 5:
                    errors.append([status, (j or {}).get("detail")])
                continue
            lat.append((time.perf_counter() - t0) * 1000)
            done += 1
            if not j.get("sources"):
                empty += 1
            meta = j.get("meta") or {}
            if meta.get("cached"):
                cached += 1
            batch_sizes.append(max(int(meta.get("batch_size") or 1), 1))
            bt = meta.get("batch_timings_ms")
            if bt:
                bs = max(int(meta.get("batch_size") or 1), 1)
                stage_q += 1
                for k, v in bt.items():
                    stage_ms[k] = stage_ms.get(k, 0.0) + float(v) / bs

    t0 = time.perf_counter()
    await asyncio.gather(*(worker(w) for w in range(int(concurrency))))
    total = time.perf_counter() - t0
    return {
        "qps": done / total,
        "p50_ms": float(np.percentile(lat, 50)) if lat else None,
        "p99_ms": float(np.percentile(lat, 99)) if lat else None,
        "requests": done,
        "failed": failed,
        "empty": empty,
        "errors": errors,
        "concurrency": int(concurrency),
        "cached": cached,
        # how the micro-batcher grouped the answered requests: the mean
        # size of the call an answer rode, and the calls that implies
        "batch_mean": float(np.mean(batch_sizes)) if batch_sizes else None,
        "pipeline_calls": sum(1 / b for b in batch_sizes),
        # mean per-QUERY stage cost (batch timings / batch size), ms —
        # the attribution table for the engine-vs-host question
        "stage_ms": {
            k: v / stage_q for k, v in stage_ms.items()
        } if stage_q else {},
    }


async def profiled_window(client, concurrency: int, requests: int) -> dict:
    """``requests`` queries at ``concurrency`` under ``torch.profiler``
    (CUDA activity): the card's busy share of the window's wall time, and
    its kernel launches by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..utils import tracing

    headers = {"X-API-Key": API_KEY}
    sent = 0

    async def worker(wid: int):
        nonlocal sent
        while sent < requests:
            sent += 1
            q = f"{_QUESTIONS[sent % len(_QUESTIONS)]} profiled {wid}-{sent}"
            async with client.post(
                "/query", json={"question": q, "top_k": 10}, headers=headers
            ) as resp:
                await resp.read()
                if resp.status != 200:
                    raise RuntimeError(f"profiled /query answered {resp.status}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        await asyncio.gather(*(worker(w) for w in range(int(concurrency))))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = 0.0
    launches: dict = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or tracing.is_span_event(ev):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        busy_ms += dev_us / 1e3
        launches[ev.key[:60]] = launches.get(ev.key[:60], 0) + ev.count
    top = sorted(launches.items(), key=lambda kv: -kv[1])[:8]
    return {"requests": requests, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms if wall_ms else None,
            "launches": sum(launches.values()), "top_launches": top}


def run_api_bench(
    rows: int = 20000, dim: int = 384, concurrency: int = 32,
    secs: float = 10.0, config_overrides=None, *, impl: str = "auto",
    warm_secs: float = 2.5, device=None, profile_requests: int = 0,
    during: Optional[Callable[[object], Awaitable[object]]] = None,
) -> dict:
    """Build the store, serve it, warm up at the same concurrency, then
    time ``secs`` seconds of ``POST /query``.

    ``impl`` is the exact-scan route (``index_scan_impl``). ``during``, an
    async callable given the test client, runs beside the timed window
    (its result under "during"); ``profile_requests`` > 0 adds a profiled
    window of that many requests on the card ("profile")."""
    from aiohttp.test_utils import TestClient, TestServer

    from ..api.main import create_app
    from ..services.indexer import IndexerService

    overrides = {"index_scan_impl": impl, **(config_overrides or {})}
    with tempfile.TemporaryDirectory(prefix="semcode_api_bench_") as tmp:
        t0 = time.perf_counter()
        config, store = build_store(rows, dim, Path(tmp), overrides, device)
        build_s = time.perf_counter() - t0
        indexer = IndexerService(config=config, vector_store=store,
                                 device=store.device)
        app = create_app(config=config, indexer=indexer, device=store.device)

        async def go():
            client = TestClient(TestServer(app))
            await client.start_server()
            try:
                # warm OUTSIDE the timed window at the SAME concurrency, so
                # the batcher's micro-batch shapes and the kernel build are
                # behind it — otherwise the first timed window pays them
                await drive(client, concurrency, warm_secs, "warm-up")
                timed = drive(client, concurrency, secs, "variant")
                if during is None:
                    out = await timed
                else:
                    out, side = await asyncio.gather(timed, during(client))
                    out["during"] = side
                if profile_requests > 0 and store.device.type == "cuda":
                    out["profile"] = await profiled_window(
                        client, concurrency, profile_requests)
                return out
            finally:
                await client.close()

        stats = asyncio.run(go())
    stats.update(rows=rows, dim=dim, impl=impl, device=str(store.device),
                 build_s=build_s)
    if store.device.type == "cuda":
        stats["device_name"] = torch.cuda.get_device_name(store.device)
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=20000)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--concurrency", type=int, default=32)
    ap.add_argument("--secs", type=float, default=10.0)
    ap.add_argument("--impl", choices=("auto", "pallas"), default="auto")
    args = ap.parse_args(argv)
    out = run_api_bench(args.rows, args.dim, args.concurrency, args.secs,
                        impl=args.impl)
    print(json.dumps(out))
    return 0 if out["failed"] == 0 and out["empty"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
