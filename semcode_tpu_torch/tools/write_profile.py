"""Time the index's writes on the card: bulk builds, streaming writes and
the self-ingest.

For each mesh (one shard, and 4 shards on the one card as chip_smoke's phase
9 lays them out) it times, with a synchronise after each step:

  ingest       phase 3's self-ingest of ``semcode_tpu/`` into an int8
               kernel-route flat store (hash embedder), twice: the first
               warms the embedder, the second is the figure
  flat_build   N x DIM int8 rows with the f32 mirror added from the host in
               two steps (3/5 of N, then the rest), so the capacity's
               doubling leaves room to stream
  flat_add     WRITES adds of ROWS rows each into that room
  flat_update  WRITES ``update_rows`` of ROWS random existing rows
  flat_remove  WRITES removals of ROWS random live rows
  ivf_build    an int8 IVF (NLIST lists, 10 k-means iterations) of IVF_N
               rows with its f32 mirror, built in one ``bulk`` block of
               131,072-row adds, as chip_smoke's phase 4b
  ivf_grow     the first streaming add of ROWS rows, which grows the mirror
               by an eighth (the bulk block sized it to IVF_N rows exactly,
               a multiple of 128) and places the rows
  ivf_add      WRITES - 1 more streaming adds, each placed into the
               layout's free slots (``_place_rows``)

Each step's rows come from ``tools/_corpus.py``'s seeded mixture, made on
the card. The script uses only the indexes' public constructors and
writers, so the same file times another checkout of the package when it is
copied into that checkout's ``tools``.

    python -m semcode_tpu_torch.tools.write_profile [--tag NAME]

Env: N (1000000), IVF_N (901120: below 2 GiB of mirror after its growth,
so streaming adds are placed and not sent to the pending tail), DIM (384),
NLIST (1024), ROWS (32), WRITES (40), SHARDS ("1,4");
SEMCODE_TORCH_DEVICE=cpu runs on the CPU. Prints one JSON line per step:
{tag, step, shards, n, rows, ms (the median for streaming steps, else the
step's time), mean_ms, max_ms, max_at (the write that took max_ms),
peak_bytes (the card's most allocated bytes since the step before),
device}.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..index.flat import FlatIndex
from ..index.ivf import IVFIndex
from ..parallel.mesh import make_mesh
from ._corpus import mixture
from ._timing import device_name, env_number, synchronize

ROOT = Path(__file__).resolve().parents[2]


def timed(fn, device: torch.device) -> float:
    """Milliseconds of ``fn()`` on the host clock, the card synchronised
    before and after."""
    synchronize(device)
    t0 = time.perf_counter()
    fn()
    synchronize(device)
    return (time.perf_counter() - t0) * 1e3


def ingest_ms(mesh, workdir: Path) -> float:
    from ..index.store import VectorStore
    from ..services import IndexerService
    from ..settings import AppSettings

    cfg = AppSettings(workspace_root=workdir, index_kind="flat",
                      index_scan_impl="pallas", rag_provider="fallback",
                      rag_query_cache_size=0)
    svc = IndexerService(config=cfg, vector_store=VectorStore(cfg, mesh=mesh),
                         device=mesh.home.type)
    return timed(lambda: svc.index_repository([ROOT / "semcode_tpu"],
                                              "semcode_tpu"), mesh.home)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="", help="names the checkout in each line")
    tag = ap.parse_args().tag
    env = os.environ
    n, ivf_n = env_number(env, "N", 1_000_000), env_number(env, "IVF_N", 901_120)
    dim, nlist = env_number(env, "DIM", 384), env_number(env, "NLIST", 1024)
    rows, writes = env_number(env, "ROWS", 32), env_number(env, "WRITES", 40)
    shard_counts = [int(s) for s in env.get("SHARDS", "1,4").split(",")]
    dev = resolve_device()
    dev = torch.device("cuda", 0) if dev.type == "cuda" else dev
    name = device_name(dev)

    def emit(step, shards, size, times):
        times = times if isinstance(times, list) else [times]
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else None)
        print(json.dumps({"tag": tag, "step": step, "shards": shards, "n": size,
                          "rows": rows, "ms": statistics.median(times),
                          "mean_ms": statistics.fmean(times), "max_ms": max(times),
                          "max_at": times.index(max(times)),
                          "peak_bytes": peak, "device": name}),
              flush=True)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

    def t(fn):
        return timed(fn, dev)

    for shards in shard_counts:
        mesh = make_mesh((shards,), ("data",), devices=[dev] * shards)
        gen = torch.Generator(device=dev).manual_seed(42)
        with tempfile.TemporaryDirectory() as tmp:
            ingest_ms(mesh, Path(tmp) / "warm")
            emit("ingest", shards, 0, ingest_ms(mesh, Path(tmp) / "timed"))

        x = mixture(gen, n, dim).cpu().numpy()
        idx = FlatIndex(dim, metric="ip", dtype="int8", scan_impl="pallas",
                        mesh=mesh)
        first = 3 * n // 5
        emit("flat_build", shards, n,
             t(lambda: (idx.add(x[:first]), idx.add(x[first:]))))
        if idx.capacity - idx.size < rows * writes:
            raise SystemExit(f"no room to stream: capacity {idx.capacity}")
        new = mixture(gen, rows * writes, dim).cpu().numpy()
        emit("flat_add", shards, n, [
            t(lambda i=i: idx.add(new[i * rows:(i + 1) * rows]))
            for i in range(writes)])
        rng = np.random.default_rng(0)
        emit("flat_update", shards, n, [
            t(lambda i=i: idx.update_rows(
                rng.choice(n, rows, replace=False), new[i * rows:(i + 1) * rows]))
            for i in range(writes)])
        emit("flat_remove", shards, n, [
            t(lambda: idx.remove(rng.choice(n, rows, replace=False)))
            for _ in range(writes)])
        del idx, x

        xi = mixture(gen, ivf_n, dim)
        ivf = IVFIndex(dim, nlist=nlist, nprobe=32, metric="ip", dtype="int8",
                       kmeans_iters=10, mesh=mesh)

        def build():
            with ivf.bulk(expected_rows=ivf_n):
                for lo in range(0, ivf_n, 131072):
                    ivf.add(xi[lo:lo + 131072])

        emit("ivf_build", shards, ivf_n, t(build))
        new = mixture(gen, rows * writes, dim).cpu().numpy()
        emit("ivf_grow", shards, ivf_n, t(lambda: ivf.add(new[:rows])))
        emit("ivf_add", shards, ivf_n, [
            t(lambda i=i: ivf.add(new[i * rows:(i + 1) * rows]))
            for i in range(1, writes)])
        if ivf._pend is not None:
            raise SystemExit("streaming adds went to the pending tail")
        del ivf, xi
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
