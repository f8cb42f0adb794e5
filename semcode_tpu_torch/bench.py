"""Headline benchmark of the PyTorch engine: query throughput at matched
recall on one CUDA card.

The counterpart of the JAX package's ``bench.py``: the same knobs (read
from the environment when ``main`` runs), the same sections in the same
order, and the same JSON line, re-emitted after every section so that a
kill keeps what was measured (the LAST line is authoritative):

    {"metric": ..., "value": QPS, "unit": "qps", "vs_baseline": ratio,
     "extras": {...}}

Everything O(N * dim) happens on the device: the clustered corpus (unit
rows around ``max(64, N // 1000)`` Gaussian centers, 0.35 noise) is made
from seeded ``torch.Generator``s, the exact f32 recall oracle is a chunked
device matmul with TF32 held off, and the IVF build consumes the device
tensor. A corpus above 6 GiB of f32 (1M x 3072) is streamed in chunks of
at most 3 GB, each made again, bit for bit, wherever it is needed.

Sections: the IVF build (nlist 1024, int8 + fused device rescore); the
flagship (exact-mode recall@10, per-dispatch QPS, single-call p50/p99,
chunked dispatch of 16 batches through ``search_device_batched``); the
numpy IVF-equivalent CPU baseline (median of 3, sampled and extrapolated);
then probing, serving, small_batch, under_ingest, filtered, highdim_3072
(1M x 3072 int8, nlist 1024, nprobe 16, whose f32 mirror would exceed the
rescore budget, so the auto tier is the two-level int8 residual) and api
(``tools.bench_api`` in process).

Unlike the JAX script, no failure is swallowed: a section that raises is
named under ``extras["failed"]`` and the process exits non-zero after its
last line; a section skipped for budget is named under
``extras["skipped"]``. ``extras`` also names the device, the card's power
limit and the two engine kernels' launch counts. It runs on CUDA, or on
the CPU when ``SEMCODE_TORCH_DEVICE=cpu`` asks (without either it exits
non-zero):

    python -m semcode_tpu_torch.bench
    SEMCODE_TORCH_DEVICE=cpu BENCH_N=20000 BENCH_NLIST=64 BENCH_NPROBE=8 \\
        BENCH_QUERIES=64 BENCH_BATCH=32 BENCH_SECS=0.5 BENCH_HIGHDIM_N=4096 \\
        BENCH_HIGHDIM_MIN_N=4096 BENCH_API=0 python -m semcode_tpu_torch.bench

Throughput is measured by enqueueing a group of searches and fetching only
the last result to the host (``.cpu()``, which waits for the device);
latency is one search plus its result's fetch.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from .device import resolve_device
from .ops import ivf_scan as ivf_ops
from .ops import scan_top2
from .tools._corpus import mixture_centers, mixture_chunk, oracle_parts, queries_near

K = 10
# the seeds of the JAX script's PRNG keys: centers, chunks, queries
SEEDS = (41, 42, 7)
HIGHDIM_SEEDS = (141, 142, 17)
HIGHDIM_DIM = 3072
HIGHDIM_QUERIES = 256
# a corpus whose f32 rows exceed this is streamed in chunks of at most
# GEN_CHUNK_BYTES
WHOLE_MAX_BYTES = 6 << 30
GEN_CHUNK_BYTES = 3 << 30
# expected_rows = N + GROW_HEADROOM sizes the mirror exactly, with room for
# under_ingest's writer stream (WRITES x WRITE_ROWS rows), so the stream
# scatters into the mirror instead of growing it
GROW_HEADROOM = 6144
WRITES, WRITE_ROWS = 20, 256
# the JAX script's timing windows (seconds): the CPU baseline's per pass
# (three passes), the shortest of small_batch's and of 1M x 3072's batch-8
# legs, 1M x 3072's shortest exact window, and the (least, most) of
# under_ingest's (the writer must finish in it) and filtered's; the time
# timed_qps aims to leave between syncs, and chunked_qps's calls between
# fetches
BASELINE_ROW_SECS = 2.0
BASELINE_CENTROID_SECS = 0.7
BATCH8_MIN_SECS = 3.0
HIGHDIM_EXACT_MIN_SECS = 4.0
UNDER_INGEST_SECS = (5.0, 10.0)
FILTERED_SECS = (3.0, 5.0)
SYNC_SECS = 2.0
CHUNKED_CALLS = 4


@dataclass(frozen=True)
class Knobs:
    """The JAX script's environment knobs, with its defaults."""

    n: int
    dim: int
    nlist: int
    nprobe: int
    n_queries: int
    batch: int
    serve_batch: int
    secs: float
    dtype: str
    scan_impl: str
    budget_s: float
    run_api: bool
    run_highdim: bool
    highdim_n: int
    highdim_min_n: int
    stream: bool

    @classmethod
    def from_env(cls) -> "Knobs":
        env = os.environ
        n_queries = int(env.get("BENCH_QUERIES", 512))
        return cls(
            n=int(env.get("BENCH_N", 1_000_000)),
            dim=int(env.get("BENCH_DIM", 384)),
            nlist=int(env.get("BENCH_NLIST", 1024)),
            nprobe=int(env.get("BENCH_NPROBE", 32)),
            n_queries=n_queries,
            batch=min(int(env.get("BENCH_BATCH", 512)), n_queries),
            serve_batch=int(env.get("BENCH_SERVE_BATCH", 8)),
            secs=float(env.get("BENCH_SECS", 15)),
            dtype=env.get("BENCH_DTYPE", "int8"),
            scan_impl=env.get("BENCH_SCAN_IMPL", "auto"),
            budget_s=float(env.get("BENCH_BUDGET_S", 1150)),
            run_api=env.get("BENCH_API", "1") == "1",
            run_highdim=env.get("BENCH_HIGHDIM", "1") == "1",
            highdim_n=int(env.get("BENCH_HIGHDIM_N", 1_000_000)),
            highdim_min_n=int(env.get("BENCH_HIGHDIM_MIN_N", 1_000_000)),
            stream=env.get("BENCH_STREAM") == "1",
        )


class Result:
    """The progressively updated JSON line, its clock and its budget.

    ``emit`` is lock-guarded: a daemon heartbeat re-emits the current state
    every 2 minutes, so a kill during a blocked device call still leaves
    the latest measured state, with its stage, as the last line."""

    def __init__(self, budget_s: float):
        self.t_start = time.perf_counter()
        self.budget_s = budget_s
        self.value = None
        self.metric = "incomplete: no QPS measurement yet"
        self.vs_baseline = None
        self.extras = {"failed": {}, "skipped": {}}
        self._lock = threading.Lock()
        self._stop = threading.Event()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t_start

    def remaining(self) -> float:
        return self.budget_s - self.elapsed()

    def log(self, msg: str) -> None:
        print(f"[bench +{self.elapsed():.0f}s] {msg}", file=sys.stderr, flush=True)

    def emit(self) -> None:
        with self._lock:
            payload = {
                "metric": self.metric,
                "value": self.value,
                "unit": "qps",
                "vs_baseline": self.vs_baseline,
                "extras": json.loads(json.dumps(self.extras)),
            }
            print(json.dumps(payload), flush=True)

    def stage(self, name: str) -> None:
        """Record the section in flight (heartbeat re-emits show it)."""
        with self._lock:
            self.extras["stage"] = name
            self.extras["elapsed_s"] = round(self.elapsed(), 1)

    def start_heartbeat(self, period_s: float = 120.0) -> None:
        def beat():
            while not self._stop.wait(period_s):
                with self._lock:
                    self.extras["elapsed_s"] = round(self.elapsed(), 1)
                self.emit()

        threading.Thread(target=beat, daemon=True).start()

    def stop_heartbeat(self) -> None:
        self._stop.set()


def recall_of(got: np.ndarray, oracle: np.ndarray) -> float:
    return float(
        np.mean(
            [
                len(set(a.tolist()) & set(b.tolist())) / oracle.shape[1]
                for a, b in zip(got, oracle)
            ]
        )
    )


def baseline_qps(centroid_s: float, per_row_s: float, nprobe: int,
                 mean_rows: float) -> float:
    """The CPU baseline's extrapolation: one query scores every centroid,
    then ``nprobe`` clusters of ``mean_rows`` rows each."""
    return 1.0 / (centroid_s + per_row_s * nprobe * mean_rows)


def kernel_launches() -> dict:
    """The engine kernels' launch counters (kernel launches only, never a
    plain-version call)."""
    return {"top2_scan": scan_top2.top2_scan.launches,
            "ivf_scan": ivf_ops.ivf_scan.launches}


def record_launches(res: "Result", name: str, before: dict) -> None:
    """The launches since ``before`` as section ``name``'s, and the totals."""
    after = kernel_launches()
    res.extras.setdefault("section_launches", {})[name] = {
        k: after[k] - before[k] for k in after}
    res.extras["kernel_launches"] = after


def power_limit_w(device: torch.device) -> Optional[float]:
    """The card's power limit in watts as nvidia-smi reports it; None on
    the CPU."""
    if device.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    line = out.stdout.strip().splitlines()[device.index or 0]
    return float(line.rsplit(",", 1)[1].strip().split()[0])


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# -- corpus and oracle ------------------------------------------------------------


class Corpus:
    """The seeded mixture: ``n`` rows around ``n_centers`` centers, whole in
    one chunk or streamed in ``n_chunks`` chunks of ``gchunk`` rows (the
    last one cut to ``n``). Chunk ``i`` is keyed by ``(chunk_seed, i)``, so
    ``chunk(i)`` makes the same bits every time it is called."""

    def __init__(self, n: int, dim: int, n_centers: int, seeds: Tuple[int, int],
                 device: torch.device, whole: bool):
        self.n, self.dim, self.whole = n, dim, whole
        self.n_chunks = 1 if whole else max(2, -(-(n * dim * 4) // GEN_CHUNK_BYTES))
        self.gchunk = -(-n // self.n_chunks)
        self.chunk_seed = seeds[1]
        gen = torch.Generator(device=device).manual_seed(seeds[0])
        self.centers = mixture_centers(gen, n_centers, dim)

    def chunk(self, i: int) -> torch.Tensor:
        """Chunk ``i``: all ``gchunk`` rows made, as the JAX script makes
        them (the last chunk's rows past ``n`` are never used)."""
        return mixture_chunk(self.chunk_seed, i, self.centers, self.gchunk)

    def rows_in(self, i: int) -> int:
        return min(self.gchunk, self.n - i * self.gchunk)

    def chunks(self) -> Iterator[Tuple[int, torch.Tensor]]:
        """(first row, rows) of every chunk, each made anew."""
        for i in range(self.n_chunks):
            yield i * self.gchunk, self.chunk(i)[: self.rows_in(i)]


def oracle_sub(dim: int) -> int:
    """Rows per oracle product: ~256 MiB of f32 rows, 8k to 128k."""
    return max(8192, min(131072, (1 << 28) // (dim * 4)))


def rescore_tier(index) -> str:
    """The device rescore tier an IVF index took: f32, residual or none."""
    frescore = index._mir.frescore if index._mir is not None else None
    if frescore is None:
        return "none"
    return "residual" if isinstance(frescore, tuple) else "f32"


def cpu_baseline(sample: np.ndarray, centroids: np.ndarray, qv: np.ndarray,
                 nprobe: int, mean_rows: float, row_secs: float,
                 centroid_secs: float):
    """The numpy IVF-equivalent scan timed on a sample of real rows, median
    of three passes of ``row_secs`` (rows) and ``centroid_secs``
    (centroids), extrapolated to ``nprobe`` clusters of ``mean_rows`` rows.
    Returns (qps, per_row_s, spread of the passes)."""
    per_rows, cent_ss = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        reps = 0
        while time.perf_counter() - t0 < row_secs:
            s = sample @ qv
            kk = min(K, len(s))
            np.argpartition(-s, kk - 1)[:kk]
            reps += 1
        per_rows.append((time.perf_counter() - t0) / max(reps * len(sample), 1))
        t0 = time.perf_counter()
        creps = 0
        while time.perf_counter() - t0 < centroid_secs:
            cq = centroids @ qv
            np.argpartition(-cq, nprobe)[:nprobe]
            creps += 1
        cent_ss.append((time.perf_counter() - t0) / max(creps, 1))
    per_row = float(np.median(per_rows))
    centroid_s = float(np.median(cent_ss))
    spread = max(per_rows) / max(min(per_rows), 1e-12)
    return baseline_qps(centroid_s, per_row, nprobe, mean_rows), per_row, spread


# -- timing -------------------------------------------------------------------------


def timed_qps(index, batches, secs: float, mode: str, nprobe=None):
    """Per-dispatch QPS over ``secs``, and p50/p99 (ms) of 8 single calls
    with their result fetch. A sync about every SYNC_SECS, never fewer
    than 4 searches between syncs."""
    index.search_device(batches[0], K, mode=mode, nprobe=nprobe)[0].cpu()  # warm
    lat = []
    for _ in range(8):
        t0 = time.perf_counter()
        index.search_device(batches[0], K, mode=mode, nprobe=nprobe)[0].cpu()
        lat.append(time.perf_counter() - t0)
    bsz = batches[0].shape[0]
    inner = max(4, min(32, int(SYNC_SECS / max(np.percentile(lat, 50), 1e-4))))
    t_start = time.perf_counter()
    n_done = 0
    while time.perf_counter() - t_start < secs:
        outs = []
        for i in range(inner):
            outs.append(index.search_device(batches[i % len(batches)], K,
                                            mode=mode, nprobe=nprobe))
            n_done += bsz
        outs[-1][0].cpu()
    total_s = time.perf_counter() - t_start
    return (n_done / total_s, float(np.percentile(lat, 50) * 1000),
            float(np.percentile(lat, 99) * 1000))


def group_qps(index, batches, secs: float, group: int, mode: str, nprobe=None) -> float:
    """QPS of groups of ``group`` searches, each group ended by a fetch."""
    index.search_device(batches[0], K, mode=mode, nprobe=nprobe)[0].cpu()  # warm
    bsz = batches[0].shape[0]
    t_s = time.perf_counter()
    n_done = 0
    while time.perf_counter() - t_s < secs:
        outs = [index.search_device(batches[i % len(batches)], K, mode=mode,
                                    nprobe=nprobe) for i in range(group)]
        n_done += group * bsz
        outs[-1][0].cpu()
    return n_done / (time.perf_counter() - t_s)


def chunked_qps(index, batches, secs: float, *, mode="exact", nprobe=None,
                chunk_b=16) -> float:
    """QPS of ``chunk_b`` batches a call through ``search_device_batched``,
    CHUNKED_CALLS calls between fetches."""
    qs_chunk = torch.stack([batches[i % len(batches)] for i in range(chunk_b)])
    bsz = int(batches[0].shape[0])
    index.search_device_batched(qs_chunk, K, mode=mode, nprobe=nprobe)[0].cpu()
    t_start = time.perf_counter()
    n_done = 0
    while time.perf_counter() - t_start < secs:
        outs = [index.search_device_batched(qs_chunk, K, mode=mode, nprobe=nprobe)
                for _ in range(CHUNKED_CALLS)]
        n_done += CHUNKED_CALLS * chunk_b * bsz
        outs[-1][0].cpu()
    return n_done / (time.perf_counter() - t_start)


def search_ids(index, batches, **kw) -> np.ndarray:
    """Top-K ids of every batch, stacked on the host."""
    return np.concatenate([index.search_device(b, K, **kw)[1].cpu().numpy()
                           for b in batches]).astype(np.int64)


# -- the run ------------------------------------------------------------------------


class Run:
    """What the sections share: the knobs, the line, the device, the corpus
    and its oracle, the index and the query batches."""

    def __init__(self, knobs: Knobs, res: Result, device: torch.device):
        self.knobs, self.res, self.device = knobs, res, device
        self.corpus: Optional[Corpus] = None
        self.x_dev: Optional[torch.Tensor] = None  # the whole corpus, if kept
        self.q_dev: Optional[torch.Tensor] = None
        self.oracle_ids: Optional[np.ndarray] = None
        self.flagship_recall: Optional[float] = None
        self.row_tags: Optional[np.ndarray] = None
        self.ivf = None
        self.q_batches: list = []
        self.serve_batches: list = []

    def recall(self, mode: str) -> float:
        got = search_ids(self.ivf, self.q_batches, mode=mode)
        return recall_of(got, self.oracle_ids[: got.shape[0]])


def build_corpus(run: Run) -> None:
    kn = run.knobs
    whole = kn.n * kn.dim * 4 <= WHOLE_MAX_BYTES and not kn.stream
    run.corpus = corpus = Corpus(kn.n, kn.dim, max(64, kn.n // 1000), SEEDS[:2],
                                 run.device, whole)
    t0 = time.perf_counter()
    # in whole mode chunk 0 IS the corpus; streamed, it also seeds the
    # queries (the same distribution as every other chunk)
    x0 = corpus.chunk(0)
    gen = torch.Generator(device=run.device).manual_seed(SEEDS[2])
    run.q_dev = queries_near(gen, x0, kn.n_queries)
    run.q_batches = [run.q_dev[i:i + kn.batch]
                     for i in range(0, kn.n_queries - kn.batch + 1, kn.batch)]
    run.serve_batches = [run.q_dev[i:i + kn.serve_batch]
                         for i in range(0, min(kn.n_queries, 32 * kn.serve_batch),
                                        kn.serve_batch)]
    run.x_dev = x0[: kn.n] if whole else None
    del x0
    sync(run.device)
    run.res.log(f"device corpus+queries in {time.perf_counter() - t0:.1f}s "
                f"({'whole' if whole else f'{corpus.n_chunks} streamed chunks'})")


def build_oracle(run: Run) -> None:
    t0 = time.perf_counter()
    parts = [(0, run.x_dev)] if run.corpus.whole else run.corpus.chunks()
    run.oracle_ids = oracle_parts(parts, run.q_dev, K, oracle_sub(run.knobs.dim))
    run.res.log(f"device exact-f32 oracle in {time.perf_counter() - t0:.1f}s")


def build_index(run: Run) -> None:
    from .index.ivf import IVFIndex

    kn, res = run.knobs, run.res
    t0 = time.perf_counter()
    ivf = IVFIndex(kn.dim, nlist=kn.nlist, nprobe=kn.nprobe, metric="ip",
                   dtype=kn.dtype, kmeans_iters=10, scan_impl=kn.scan_impl,
                   device=run.device)
    # 1% of rows tagged (a small repo among many) for the filtered section
    run.row_tags = (np.arange(kn.n) % 100 == 0).astype(np.int32)
    # bulk: the adds only fill the mirror; one train + balanced assign +
    # pack runs at the block's exit
    with ivf.bulk(expected_rows=kn.n + GROW_HEADROOM):
        if run.corpus.whole:
            ivf.add(run.x_dev, tags=run.row_tags)
        else:
            for base, xc in run.corpus.chunks():
                ivf.add(xc, tags=run.row_tags[base:base + xc.shape[0]])
                res.log(f"  streamed ingest: {base + xc.shape[0]}/{kn.n} rows")
                del xc
    sync(run.device)
    build_s = time.perf_counter() - t0
    run.ivf = ivf
    res.extras.update(build_s=round(build_s, 1), ivf_cmax=ivf.cmax,
                      rescore_tier=rescore_tier(ivf))
    res.log(f"IVF build: {build_s:.1f}s (nlist={ivf.nlist}, cmax={ivf.cmax}, "
            f"rescore tier {rescore_tier(ivf)})")


def flagship(run: Run) -> float:
    """Exact-mode recall, per-dispatch QPS and latency, then chunked
    dispatch; returns the better QPS."""
    kn, res, ivf = run.knobs, run.res, run.ivf
    t0 = time.perf_counter()
    recall = run.recall("exact")
    res.log(f"exact recall@10={recall:.4f} (section {time.perf_counter() - t0:.1f}s)")
    res.extras["recall_at_10_exact"] = round(recall, 4)
    qps_single, p50, p99 = timed_qps(ivf, run.q_batches, min(kn.secs, 20), "exact")
    res.log(f"exact scan: {qps_single:.0f} QPS per-dispatch (batch={kn.batch}), "
            f"single-call p50={p50:.1f}ms p99={p99:.1f}ms per batch")
    res.extras.update(batch_p50_ms=round(p50, 1), batch_p99_ms=round(p99, 1),
                      qps_per_dispatch=round(qps_single, 1))
    res.value = round(qps_single, 1)
    res.metric = (
        f"query throughput at recall@10={recall:.4f} "
        f"(N={kn.n}, dim={kn.dim}, {kn.dtype}, exact scan, per-dispatch; "
        f"chunked-dispatch measurement pending)"
    )
    res.emit()
    run.flagship_recall = recall
    if res.remaining() <= 120:
        res.extras["skipped"]["dispatch_chunked"] = (
            f"{res.remaining():.0f}s left <= 120s")
        res.log("skip chunked dispatch: budget low")
        return qps_single
    qps_chunk = chunked_qps(ivf, run.q_batches, min(kn.secs, 20))
    res.log(f"exact scan, chunked dispatch (B=16 batches/call): {qps_chunk:.0f} QPS")
    res.extras["dispatch_chunked"] = True
    return max(qps_chunk, qps_single)


def baseline_section(run: Run, qps: float) -> None:
    kn, res, ivf = run.knobs, run.res, run.ivf
    # the layout as built: the writer stream adds rows past N later
    assign = ivf._assign[: kn.n][ivf._alive[: kn.n]]
    counts = np.bincount(assign, minlength=ivf.nlist)
    mean_rows = float(counts.mean())
    probe_cl = np.argsort(-counts)[:4]
    rows_idx = np.flatnonzero(np.isin(assign, probe_cl))[:8192]
    if run.corpus.whole:
        sample = run.x_dev[torch.from_numpy(rows_idx).to(run.device)]
    else:  # streamed: the rows as the index's mirror holds them
        sample = ivf._f32_chunk(rows_idx)
    sample = sample.cpu().numpy()
    qv = run.q_dev[0].cpu().numpy()
    base_qps, per_row, spread = cpu_baseline(
        sample, ivf.centroids, qv, kn.nprobe, mean_rows,
        BASELINE_ROW_SECS, BASELINE_CENTROID_SECS)
    res.extras["cpu_baseline_pass_spread"] = round(spread, 2)
    res.log(f"CPU IVF-equivalent baseline (median of 3): {base_qps:.1f} QPS "
            f"({per_row * 1e9:.1f} ns/row x {kn.nprobe}x{mean_rows:.0f} rows, "
            f"pass spread {spread:.2f}x)")
    res.value = round(qps, 1)
    res.metric = (
        f"query throughput at recall@10={run.flagship_recall:.4f} "
        f"(N={kn.n}, dim={kn.dim}, {kn.dtype} + fused f32 device rescore, exact "
        f"scan mode, nlist={kn.nlist}, 1 chip; CPU baseline = numpy "
        f"IVF-equivalent nprobe={kn.nprobe}, sampled+extrapolated)"
    )
    res.extras["cpu_baseline_qps"] = round(base_qps, 1)
    res.vs_baseline = round(qps / base_qps, 2)


# -- sections ---------------------------------------------------------------------


def sec_probing(run: Run) -> None:
    kn, res, ivf = run.knobs, run.res, run.ivf
    rec = run.recall("ivf")
    res.extras["recall_at_10_probing"] = round(rec, 4)
    qps, p50, p99 = timed_qps(ivf, run.q_batches,
                              min(kn.secs / 2, max(5, res.remaining() / 10)), "ivf")
    res.extras.update(probing_qps=round(qps, 1), probing_p50_ms=round(p50, 1),
                      probing_p99_ms=round(p99, 1))
    res.log(f"probing (kernel={ivf._pallas_mode()}): {qps:.0f} QPS, recall={rec:.4f}")


def sec_serving(run: Run) -> None:
    kn, res, ivf = run.knobs, run.res, run.ivf
    batches = run.serve_batches
    ivf.search_device(batches[0], K)[0].cpu()  # warm the shape
    lat = []
    for i in range(64):
        t0 = time.perf_counter()
        ivf.search_device(batches[i % len(batches)], K)[0].cpu()
        lat.append((time.perf_counter() - t0) * 1000)
    res.extras.update(
        serving_batch=kn.serve_batch,
        serving_p50_ms=round(float(np.percentile(lat, 50)), 1),
        serving_p99_ms=round(float(np.percentile(lat, 99)), 1),
        serving_auto_mode=ivf._pick_mode(kn.serve_batch, kn.nprobe, K),
    )
    res.log(f"serving micro-batch p50={res.extras['serving_p50_ms']}ms "
            f"p99={res.extras['serving_p99_ms']}ms "
            f"(auto={res.extras['serving_auto_mode']})")


def sec_small_batch(run: Run) -> None:
    """Probing against exact at the serving batch, probing also at nprobe
    16 (the reference's Milvus default), where it reads half as much."""
    kn, res, ivf = run.knobs, run.res, run.ivf
    batches = run.serve_batches
    secs = max(BATCH8_MIN_SECS, min(kn.secs / 4, res.remaining() / 12))
    qe, _, _ = timed_qps(ivf, batches, secs, "exact")
    qi32, _, _ = timed_qps(ivf, batches, secs, "ivf")
    qi16, _, _ = timed_qps(ivf, batches, secs, "ivf", nprobe=16)
    qi16c = chunked_qps(ivf, batches, secs, mode="probe", nprobe=16)
    res.extras["small_batch_probing16_chunked_qps"] = round(qi16c, 1)
    res.log(f"small-batch probing16 chunked (B=16/call): {qi16c:.0f} QPS")
    got = search_ids(ivf, batches, mode="ivf", nprobe=16)
    rec16 = recall_of(got, run.oracle_ids[: got.shape[0]])
    res.extras.update(
        small_batch_exact_qps=round(qe, 1),
        small_batch_probing_qps=round(qi32, 1),
        small_batch_probing16_qps=round(qi16, 1),
        recall_at_10_probing16=round(rec16, 4),
        small_batch_auto_mode=ivf._pick_mode(kn.serve_batch, kn.nprobe, K),
    )
    res.log(f"small-batch(b={kn.serve_batch}): exact={qe:.0f} probing32={qi32:.0f} "
            f"probing16={qi16:.0f} QPS (recall@16probe={rec16:.4f})")


def writer_stream(index, dim: int, stop: threading.Event, written: list,
                  streams: list) -> None:
    """Add WRITES batches of WRITE_ROWS rows (seeded, 0.3-scaled Gaussian),
    unless ``stop`` is set first; each acknowledged batch goes to
    ``written`` as (row ids, its first row), and the CUDA stream the writes
    ran on to ``streams``."""
    wrng = np.random.default_rng(7)
    if index.device.type == "cuda":
        streams.append(torch.cuda.current_stream(index.device))
    for _ in range(WRITES):
        if stop.is_set():
            return
        x = (wrng.standard_normal((WRITE_ROWS, dim)) * 0.3).astype(np.float32)
        rows = index.add(x)
        written.append((np.asarray(rows), x[0]))


def read_back_misses(index, written: list) -> int:
    """Acknowledged writes read back: each written batch's first row,
    searched as a query, must come back at top-1. Returns the misses."""
    if not written:
        return 0
    q = torch.from_numpy(np.stack([x for _, x in written])).to(index.device)
    top1 = index.search_device(q, K)[1][:, 0].cpu().numpy()
    want = np.array([rows[0] for rows, _ in written])
    return int((top1 != want).sum())


def under_ingest(index, query: torch.Tensor, secs: float) -> Tuple[dict, list]:
    """Reader latency while a writer thread streams inserts into ``index``.

    Returns the figures and the broken checks: the writer must finish,
    every id a reader got must be a row that existed by the time its
    search returned, every acknowledged batch must read back, and the
    writer's CUDA stream must be the readers'."""
    stop = threading.Event()
    written, streams, errors = [], [], []

    def writer():
        try:
            writer_stream(index, index.dim, stop, written, streams)
        except BaseException as exc:  # noqa: BLE001 - re-raised by the reader
            errors.append(exc)

    lat, bad_ids = [], 0
    wt = threading.Thread(target=writer, daemon=True)
    wt.start()
    t_s = time.perf_counter()
    while time.perf_counter() - t_s < secs:
        t0 = time.perf_counter()
        ids = index.search_device(query, K)[1].cpu().numpy()
        lat.append((time.perf_counter() - t0) * 1000)
        existed = index.rows_allocated
        bad_ids += int(((ids < 0) | (ids >= existed)).sum())
    stop.set()
    wt.join(timeout=60)
    if wt.is_alive():
        raise RuntimeError("the writer thread did not finish within 60 s")
    if errors:
        raise errors[0]
    out = {
        "under_ingest_rows": sum(len(rows) for rows, _ in written),
        "under_ingest_p50_ms": round(float(np.percentile(lat, 50)), 1),
        "under_ingest_p99_ms": round(float(np.percentile(lat, 99)), 1),
        "under_ingest_reads": len(lat),
        "under_ingest_bad_ids": bad_ids,
        "under_ingest_read_back_misses": read_back_misses(index, written),
    }
    problems = []
    if out["under_ingest_rows"] != WRITES * WRITE_ROWS:
        problems.append(f"the writer wrote {out['under_ingest_rows']} of "
                        f"{WRITES * WRITE_ROWS} rows in the readers' {secs:.1f} s")
    if bad_ids:
        problems.append(f"{bad_ids} ids a reader got were no row of the index")
    if out["under_ingest_read_back_misses"]:
        problems.append(f"{out['under_ingest_read_back_misses']} of {len(written)} "
                        "acknowledged batches did not read back at top-1")
    if index.device.type == "cuda":
        reader = torch.cuda.current_stream(index.device)
        if any(s != reader for s in streams):
            problems.append("the writer's CUDA stream is not the readers'")
    return out, problems


def sec_under_ingest(run: Run) -> None:
    res = run.res
    least, most = UNDER_INGEST_SECS
    secs = min(most, max(least, res.remaining() / 10))
    out, problems = under_ingest(run.ivf, run.serve_batches[0], secs)
    res.extras.update(out)
    res.log(f"under ingest ({out['under_ingest_rows']} rows): reader "
            f"p50={out['under_ingest_p50_ms']}ms p99={out['under_ingest_p99_ms']}ms "
            f"over {out['under_ingest_reads']} reads")
    if problems:
        raise RuntimeError("; ".join(problems))


def sec_filtered(run: Run) -> None:
    kn, res, ivf = run.knobs, run.res, run.ivf
    allow = np.asarray([1], dtype=np.int32)
    f_ids = ivf.search_device(run.q_batches[0], K, allow_tags=allow)[1].cpu().numpy()
    ok = bool((f_ids >= 0).all() and (run.row_tags[f_ids.ravel()] == 1).all())
    # recall against the filtered-subset oracle: exact top-k over the
    # tagged rows alone
    tag_idx = np.flatnonzero(run.row_tags[: kn.n])
    if run.corpus.whole:
        parts = [(0, run.x_dev[torch.from_numpy(tag_idx).to(run.device)])]
    else:
        # streamed corpora: the tagged rows as the index's mirror holds
        # them (the residual reconstruction, the values the engine
        # rescores with), 16k at a time, so this oracle measures the
        # filter and the selection
        parts = ((lo, ivf._f32_chunk(tag_idx[lo:lo + 16384]))
                 for lo in range(0, tag_idx.size, 16384))
        res.extras["filtered_oracle_basis"] = "reconstructed"
    f_oracle = tag_idx[oracle_parts(parts, run.q_dev, K, oracle_sub(kn.dim))]
    got = search_ids(ivf, run.q_batches, allow_tags=allow)
    f_rec = recall_of(got, f_oracle[: got.shape[0]])
    res.extras["filtered_recall_at_10"] = round(f_rec, 4)
    res.log(f"filtered recall@10 vs filtered-subset oracle: {f_rec:.4f}")
    secs = max(FILTERED_SECS[0], min(FILTERED_SECS[1], res.remaining() / 20))
    t_s = time.perf_counter()
    n_done = 0
    while time.perf_counter() - t_s < secs:
        outs = []
        for i in range(32):
            outs.append(ivf.search_device(run.q_batches[i % len(run.q_batches)], K,
                                          allow_tags=allow))
            n_done += kn.batch
        outs[-1][0].cpu()
    res.extras.update(
        filtered_qps_1pct=round(n_done / (time.perf_counter() - t_s), 1),
        filtered_hits_all_match=ok,
    )
    res.log(f"filtered search 1%: {res.extras['filtered_qps_1pct']} QPS, all-match={ok}")


def sec_highdim(run: Run) -> None:
    # free the 384-d corpus and index before the wide build
    run.serve_batches.clear()
    run.q_batches.clear()
    run.ivf = None
    run.x_dev = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
        run.res.log(f"highdim: {torch.cuda.memory_allocated(run.device) / 2**30:.2f} "
                    "GiB allocated on the card before the build")
    run_highdim(run)


def sec_api(run: Run) -> None:
    """The served path in process (HTTP -> auth -> micro-batcher -> embed
    -> VectorStore -> hits) on its own 20,000-row store."""
    from .tools.bench_api import run_api_bench

    res = run.res
    stats = run_api_bench(rows=20000, dim=run.knobs.dim, concurrency=32,
                          secs=max(5.0, min(12.0, res.remaining() / 6)),
                          device=run.device)
    res.extras.update(
        api_qps=stats["qps"],
        api_p50_ms=stats["p50_ms"],
        api_p99_ms=stats["p99_ms"],
        api_concurrency=stats["concurrency"],
        api_rows=stats["rows"],
        api_stage_ms=stats.get("stage_ms"),
    )
    res.log(f"API e2e: {stats['qps']} QPS at c={stats['concurrency']}, "
            f"p50={stats['p50_ms']}ms p99={stats['p99_ms']}ms "
            f"stages/query={stats.get('stage_ms')}")
    if stats["failed"] or stats["empty"]:
        raise RuntimeError(f"{stats['failed']} requests failed and {stats['empty']} "
                           f"came back without hits: {stats.get('errors')}")


def run_highdim(run: Run) -> None:
    """1M x 3072 int8 (text-embedding-3-large's width): streamed bulk build,
    the auto rescore tier, exact recall and QPS, then probing against exact
    at batch 8."""
    from .index.ivf import IVFIndex

    kn, res = run.knobs, run.res
    hn, hd = kn.highdim_n, HIGHDIM_DIM
    t0 = time.perf_counter()
    corpus = Corpus(hn, hd, hn // 1000, HIGHDIM_SEEDS[:2], run.device, whole=False)
    gen = torch.Generator(device=run.device).manual_seed(HIGHDIM_SEEDS[2])
    q_dev = queries_near(gen, corpus.chunk(0), HIGHDIM_QUERIES)
    h_oracle = oracle_parts(corpus.chunks(), q_dev, K, oracle_sub(hd))
    res.log(f"highdim corpus+oracle in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    hivf = IVFIndex(hd, nlist=1024 if hn >= 500_000 else 128, nprobe=16,
                    metric="ip", dtype="int8", kmeans_iters=10, device=run.device)
    with hivf.bulk(expected_rows=hn):
        for _, xc in corpus.chunks():
            hivf.add(xc)
            del xc
    sync(run.device)
    build_s = time.perf_counter() - t0
    tier = rescore_tier(hivf)
    res.log(f"highdim build: {build_s:.1f}s (cmax={hivf.cmax}, rescore tier {tier})")
    if run.device.type == "cuda":
        res.log(f"highdim: peak {torch.cuda.max_memory_allocated(run.device) / 2**30:.2f} "
                "GiB allocated on the card by the build")
    res.extras.update(d3072_build_s=round(build_s, 1), d3072_cmax=hivf.cmax,
                      d3072_rescore_tier=tier)
    res.emit()

    big = [q_dev]
    small = [q_dev[i:i + 8] for i in range(0, HIGHDIM_QUERIES, 8)]
    rec = recall_of(search_ids(hivf, big, mode="exact"), h_oracle)
    secs = min(kn.secs / 2, max(HIGHDIM_EXACT_MIN_SECS, res.remaining() / 20))
    qps = group_qps(hivf, big, secs, 16, "exact")
    res.extras.update(d3072_recall_at_10=round(rec, 4), d3072_qps=round(qps, 1))
    res.emit()
    rec16 = recall_of(search_ids(hivf, small, mode="ivf", nprobe=16), h_oracle)
    secs = max(BATCH8_MIN_SECS, min(kn.secs / 4, res.remaining() / 20))
    qe8 = group_qps(hivf, small, secs, 16, "exact")
    qi8 = group_qps(hivf, small, secs, 16, "ivf", nprobe=16)
    # chained probing at the serving batch: 16 batches a call
    qi8c = None
    if res.remaining() > 120:
        qi8c = chunked_qps(hivf, small, secs, mode="probe", nprobe=16)
        res.log(f"highdim probing16 chunked (B=16/call): {qi8c:.0f} QPS")
    else:
        res.extras["skipped"]["d3072_chunked"] = f"{res.remaining():.0f}s left <= 120s"
    res.extras.update(
        d3072_small_batch_probing16_chunked_qps=round(qi8c, 1) if qi8c else None,
        d3072_small_batch_exact_qps=round(qe8, 1),
        d3072_small_batch_probing16_qps=round(qi8, 1),
        d3072_recall_at_10_probing16=round(rec16, 4),
        d3072_auto_mode_b8=hivf._pick_mode(8, 16, K),
    )
    res.log(f"highdim {hn}x{hd}: exact {qps:.0f} QPS @ recall {rec:.4f}; batch-8 "
            f"exact {qe8:.0f} vs probing16 {qi8:.0f} QPS @ {rec16:.4f} "
            f"(auto={res.extras['d3072_auto_mode_b8']})")


def guard(run: Run, name: str, min_secs: float, fn: Callable[[Run], None]) -> None:
    """Run one optional section: skipped when less than ``min_secs`` of
    the budget is left, named in ``failed`` when it raises; either way the
    line is emitted after it, with the section's kernel launches."""
    res = run.res
    if res.remaining() < min_secs:
        res.extras["skipped"][name] = f"{res.remaining():.0f}s left < {min_secs}s"
        res.log(f"skip {name}: {res.remaining():.0f}s left < {min_secs}s")
        res.emit()
        return
    res.stage(name)
    before = kernel_launches()
    try:
        fn(run)
    except Exception as exc:  # noqa: BLE001 - named in the line, exit non-zero
        res.extras["failed"][name] = repr(exc)
        res.log(f"section {name} failed:\n{traceback.format_exc()}")
    finally:
        record_launches(res, name, before)
    res.emit()


def main() -> int:
    kn = Knobs.from_env()
    res = Result(kn.budget_s)
    res.log(f"corpus N={kn.n} dim={kn.dim} nlist={kn.nlist} nprobe={kn.nprobe} "
            f"{kn.dtype} budget={kn.budget_s:.0f}s")
    res.extras["kernel_launches"] = kernel_launches()
    # a first line before any device work, and a heartbeat thereafter
    res.stage("device")
    res.emit()
    res.start_heartbeat()
    try:
        try:
            device = resolve_device()
            res.extras["device"] = (torch.cuda.get_device_name(device)
                                    if device.type == "cuda" else "cpu")
            res.extras["power_limit_w"] = power_limit_w(device)
        except Exception as exc:  # noqa: BLE001 - no card: named, exit non-zero
            res.extras["failed"]["device"] = repr(exc)
            res.log(f"no device to run on: {exc}")
            res.emit()
            return 1
        run = Run(kn, res, device)
        # the flagship path: nothing after it can run without it
        core = (("corpus_gen", build_corpus), ("oracle", build_oracle),
                ("ivf_build", build_index))
        try:
            for name, fn in core:
                res.stage(name)
                fn(run)
            res.stage("flagship")
            before = kernel_launches()
            qps = flagship(run)
            res.stage("cpu_baseline")
            baseline_section(run, qps)
            record_launches(res, "flagship", before)
        except Exception as exc:  # noqa: BLE001 - named in the line, exit non-zero
            res.extras["failed"][res.extras["stage"]] = repr(exc)
            res.log(f"stage {res.extras['stage']} failed:\n{traceback.format_exc()}")
            res.emit()
            return 1
        res.emit()  # the flagship number is on record

        guard(run, "probing", 60, sec_probing)
        guard(run, "serving", 30, sec_serving)
        guard(run, "small_batch", 45, sec_small_batch)
        # under_ingest before filtered, as the JAX script orders them
        guard(run, "under_ingest", 30, sec_under_ingest)
        guard(run, "filtered", 30, sec_filtered)
        # highdim before the API: if anything falls off the budget's end,
        # let it be the cheap API figure
        if kn.dim == 384 and kn.n >= kn.highdim_min_n and kn.run_highdim:
            guard(run, "highdim_3072", 420, sec_highdim)
        if kn.run_api:
            guard(run, "api", 100, sec_api)
        res.stage("done")
        res.log(f"done in {res.elapsed():.0f}s")
        res.emit()
        return 1 if res.extras["failed"] else 0
    finally:
        res.stop_heartbeat()


if __name__ == "__main__":
    raise SystemExit(main())
