"""One run of one cell: set-up, the measured window, the check, the line.

    python -m perfbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the configuration's corpus and query pool on the device from
``--seed``, builds the index as an ingest would (``IVFIndex.bulk`` + ``add``
in chunks; ``build_s`` times those calls alone) and warms the mix's one
batch shape. The window then drives ``IVFIndex.search_device`` in a closed
loop for ``--seconds``: each client sends its next batch when the previous
answer is on the host. With ``--trace 1`` a slice of the window runs under
``torch.profiler`` and the line carries the per-layer metrics instead of
the end-to-end ones.

After the window the index is freed, the corpus is made again from the
seed, and every answer of the window is judged against the plain reference
(``reference.py``): ``failed`` counts malformed rows, ``score_err`` is the
widest gap between a returned score and the f32 product of its query and
row, ``miss_share`` the share of answer slots that hold neither the exact
top-k nor the IVF top-k at the stated nprobe, and ``recall_miss`` the share
of the exact top-k that the answers miss. The index's quantizer, which
defines the IVF answer set, is judged too: ``assign_off_nearest``,
``assign_far`` and ``centroid_excess`` (``reference.quantizer_numbers``).
Each is held to its limit in ``limits/<workload>.json``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` (traced
runs) and ``checks`` (each number compared, with its limit).
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import threading
import time
import traceback
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from . import corpus, kernels, reference, roofline, spec
from .trace import SPAN, Trace, from_profile

FORBIDDEN = ("jax", "jaxlib", "flax", "semcode_tpu")
# least warm-up: calls and seconds of the cell's own batch shape
WARM_CALLS, WARM_SECONDS = 10, 1.0
# the traced slice starts a third into the window and lasts this long
TRACE_SECONDS = 0.5
CHECKS = ("failed", "score_err", "miss_share", "recall_miss", "assign_off_nearest",
          "assign_far", "centroid_excess")


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the run may not load, each
    compared whole (``semcode_tpu_torch`` is not ``semcode_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rescore_tier(index) -> str:
    """The device rescore tier the index took: f32, residual or none."""
    mir = index._mir
    frescore = mir.frescore if mir is not None else None
    if frescore is None:
        return "none"
    return "residual" if isinstance(frescore, tuple) else "f32"


# -- set-up -----------------------------------------------------------------


@dataclass
class Setup:
    index: object
    pool: torch.Tensor
    build_s: float


def build(cell: spec.Cell, seed: int, device: torch.device) -> Setup:
    """The corpus and pool from ``seed``, then the index built from the
    corpus in ingest chunks (only the port's calls are timed)."""
    from semcode_tpu_torch.index.ivf import IVFIndex

    cfg, ix = cell.config, cell.config["index"]
    t0 = time.perf_counter()
    rows = corpus.make_rows(cfg, seed, device)
    pool = corpus.make_pool(cfg, cell.traffic, rows, seed)
    tags = corpus.row_tags(cfg)
    tagged = int(cfg.get("tag_every", 0)) > 0
    sync(device)
    log(f"corpus {tuple(rows.shape)} and pool {tuple(pool.shape)} made in "
        f"{time.perf_counter() - t0:.3f} s")
    # an option the configuration leaves out is the shipped default
    extra = {k: ix[k] for k in ("rescore_mode",) if k in ix}
    index = IVFIndex(int(cfg["dim"]), nlist=int(ix["nlist"]), nprobe=int(ix["nprobe"]),
                     metric=ix["metric"], dtype=ix["dtype"],
                     kmeans_iters=int(ix["kmeans_iters"]), device=device, **extra)
    n = rows.shape[0]
    t0 = time.perf_counter()
    with index.bulk(expected_rows=n):
        for _, lo, hi in corpus.chunk_bounds(n, corpus.chunk_rows(cfg)):
            index.add(rows[lo:hi], tags=tags[lo:hi] if tagged else None)
    sync(device)
    build_s = time.perf_counter() - t0
    del rows
    gc.collect()
    tier = rescore_tier(index)
    log(f"index built in {build_s:.3f} s: nlist {index.nlist}, cmax {index.cmax}, "
        f"rescore tier {tier}")
    if tier != cfg["rescore_tier"]:
        raise RuntimeError(f"the index took the {tier} rescore tier; the "
                           f"configuration states {cfg['rescore_tier']}")
    return Setup(index, pool, build_s)


# -- the window ----------------------------------------------------------------


@dataclass
class Window:
    """What the window sent and got back. ``batch_of[c]`` is the pool batch
    of call ``c``; ``answers[c]`` its (scores, ids) on the host, or None
    where the call raised."""

    batch: int
    seconds: float = 0.0
    latency_s: List[float] = field(default_factory=list)
    batch_of: List[int] = field(default_factory=list)
    answers: list = field(default_factory=list)
    errors: List[str] = field(default_factory=list)
    trace: Optional[Trace] = None
    lock: threading.Lock = field(default_factory=threading.Lock)


def search_call(index, traffic: dict):
    """The call the window drives, ended when both answers are on the host."""
    k, mode = int(traffic["k"]), traffic.get("mode", "auto")
    nprobe, allow = traffic.get("nprobe"), traffic.get("allow_tags")

    def call(q):
        s, i = index.search_device(q, k, nprobe=nprobe, mode=mode, allow_tags=allow)
        return s.cpu(), i.cpu()

    return call


def batches_of(pool: torch.Tensor, batch: int) -> List[torch.Tensor]:
    if pool.shape[0] % batch:
        raise ValueError(f"pool of {pool.shape[0]} is not a whole number of "
                         f"batches of {batch}")
    return [pool[o:o + batch] for o in range(0, pool.shape[0], batch)]


def warm(call, batches, device) -> None:
    t0 = time.perf_counter()
    n = 0
    while n < WARM_CALLS or time.perf_counter() - t0 < WARM_SECONDS:
        call(batches[n % len(batches)])
        n += 1
    sync(device)


def client_loop(call, batches, first: int, stride: int, t_end: float, win: Window,
                tracer=None) -> None:
    """One closed-loop client: call number j sends pool batch
    ``(first + j * stride) % len(batches)``."""
    j = 0
    while True:
        t0 = time.perf_counter()
        if t0 >= t_end:
            return
        b = (first + j * stride) % len(batches)
        span = tracer.span() if tracer is not None else nullcontext()
        try:
            with span:
                out = call(batches[b])
            err = None
        except Exception as exc:  # noqa: BLE001 - counted as failed, named on stderr
            out, err = None, f"{type(exc).__name__}: {exc}"
        t1 = time.perf_counter()
        with win.lock:
            c = len(win.batch_of)
            win.latency_s.append(t1 - t0)
            win.batch_of.append(b)
            win.answers.append(out)
            if err is not None:
                win.errors.append(err)
        if tracer is not None:
            tracer.after(c, t1)
        j += 1


class Tracer:
    """Runs ``torch.profiler`` over a slice of client 0's calls: from a
    third into the window for TRACE_SECONDS, spans around each call."""

    def __init__(self, t_start: float, seconds: float, device: torch.device):
        self.t_on = t_start + seconds / 3
        self.t_off = None
        self.device = device
        self.prof = None
        self.calls: List[int] = []
        self.active = False
        self.done = False
        self.t_began = 0.0
        self.wall_s = 0.0

    @staticmethod
    def profiler(device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    @classmethod
    def prime(cls, device: torch.device) -> None:
        """One empty profile in set-up: the first start of the device
        tracer initialises it, which takes seconds."""
        with cls.profiler(device):
            sync(device)

    def span(self):
        if not self.done and not self.active and time.perf_counter() >= self.t_on:
            self.prof = self.profiler(self.device)
            self.prof.start()
            self.active = True
            self.t_began = time.perf_counter()
            self.t_off = self.t_began + TRACE_SECONDS
        if self.active:
            return torch.profiler.record_function(SPAN)
        return nullcontext()

    def after(self, call_no: int, t1: float) -> None:
        if not self.active:
            return
        self.calls.append(call_no)
        if t1 >= self.t_off and len(self.calls) >= 3:
            self._stop()

    def _stop(self) -> None:
        sync(self.device)
        self.wall_s = time.perf_counter() - self.t_began
        self.prof.stop()
        self.active, self.done = False, True

    def finish(self) -> Optional[Trace]:
        if self.active:  # the window closed first
            self._stop()
        if self.prof is None:
            return None
        return from_profile(self.prof, self.calls, self.wall_s)


def run_window(setup: Setup, traffic: dict, seconds: float, trace: bool,
               device: torch.device) -> Window:
    """``traffic["clients"]`` closed-loop clients for ``seconds``; client 0
    runs on this thread and carries the traced slice."""
    call = search_call(setup.index, traffic)
    batch, clients = int(traffic["batch"]), int(traffic.get("clients", 1))
    batches = batches_of(setup.pool, batch)
    win = Window(batch)
    t_start = time.perf_counter()
    t_end = t_start + seconds
    tracer = Tracer(t_start, seconds, device) if trace else None
    threads = [threading.Thread(target=client_loop,
                                args=(call, batches, c, clients, t_end, win))
               for c in range(1, clients)]
    for t in threads:
        t.start()
    client_loop(call, batches, 0, clients, t_end, win, tracer)
    for t in threads:
        t.join()
    sync(device)
    win.seconds = time.perf_counter() - t_start
    if tracer is not None:
        win.trace = tracer.finish()
    return win


# -- the check ---------------------------------------------------------------


@dataclass
class Answers:
    """Every answered query of a window: its pool row, ids and scores."""

    qidx: np.ndarray    # (M,) int64
    ids: np.ndarray     # (M, k) int64
    scores: np.ndarray  # (M, k) float32
    raised: int         # queries whose call raised

    @classmethod
    def of(cls, win: Window, k: int) -> "Answers":
        qidx, ids, scores, raised = [], [], [], 0
        for b, out in zip(win.batch_of, win.answers):
            if out is None:
                raised += win.batch
                continue
            s, i = out
            qidx.append(np.arange(b * win.batch, (b + 1) * win.batch))
            ids.append(i.numpy().astype(np.int64).reshape(win.batch, -1))
            scores.append(s.numpy().astype(np.float32).reshape(win.batch, -1))
        if not qidx:
            return cls(np.zeros(0, np.int64), np.zeros((0, k), np.int64),
                       np.zeros((0, k), np.float32), raised)
        return cls(np.concatenate(qidx), np.concatenate(ids),
                   np.concatenate(scores), raised)


def malformed(ans: Answers, n: int, k: int, allowed: Optional[np.ndarray]) -> np.ndarray:
    """(M,) bool: rows that are not k distinct live ids in range, with
    finite scores in non-increasing order (and, under a filter, allowed)."""
    ids, s = ans.ids, ans.scores
    if ids.shape[1] != k:
        return np.ones(len(ids), dtype=bool)
    bad = ~np.isfinite(s).all(axis=1) | ((ids < 0) | (ids >= n)).any(axis=1)
    bad |= (np.diff(s, axis=1) > 0).any(axis=1)
    srt = np.sort(ids, axis=1)
    bad |= (srt[:, 1:] == srt[:, :-1]).any(axis=1)
    if allowed is not None:
        bad |= ~allowed[np.clip(ids, 0, n - 1)].all(axis=1)
    return bad


def hits(ids: np.ndarray, ref: np.ndarray, sub: int = 1 << 17) -> np.ndarray:
    """(M,) number of each row's ids that are in its reference row."""
    out = np.empty(len(ids), dtype=np.int64)
    for lo in range(0, len(ids), sub):
        a, r = ids[lo:lo + sub], ref[lo:lo + sub]
        out[lo:lo + sub] = (a[:, :, None] == r[:, None, :]).any(axis=2).sum(axis=1)
    return out


@dataclass
class Judged:
    numbers: dict          # each of CHECKS
    recall_at_10: float


def judge(ans: Answers, refs: dict, rows: torch.Tensor, pool: torch.Tensor,
          allowed: Optional[np.ndarray], k: int, quantizer: dict) -> Judged:
    """The window's answers against the reference's answer sets, and the
    index's quantizer against the rows."""
    n = rows.shape[0]
    bad = malformed(ans, n, k, allowed)
    ok = ~bad
    qidx, ids, scores = ans.qidx[ok], ans.ids[ok], ans.scores[ok]
    exact = refs["exact"][1].cpu().numpy()
    got_exact = hits(ids, exact[qidx])
    got = got_exact
    if "ivf" in refs:
        got = np.maximum(got, hits(ids, refs["ivf"][1].cpu().numpy()[qidx]))
    total = len(ans.qidx) + ans.raised
    score_err = 0.0
    if len(qidx):
        keys = (qidx[:, None] * n + ids).ravel()
        uniq, inv = np.unique(keys, return_inverse=True)
        prod = reference.pair_scores(rows, pool, uniq // n, uniq % n)
        score_err = float(np.abs(scores.ravel() - prod[inv]).max())
    answered = max(len(qidx), 1)
    recall = float(got_exact.sum() / (max(total, 1) * k))
    return Judged(
        numbers={"failed": int(bad.sum()) + ans.raised,
                 "score_err": score_err,
                 "miss_share": float(1.0 - got.sum() / (answered * k)) if len(qidx) else 1.0,
                 "recall_miss": 1.0 - recall,
                 **reference.quantizer_numbers(rows, quantizer["centroids"],
                                               quantizer["assign"])},
        recall_at_10=recall,
    )


def state_of(index, n: int) -> dict:
    """The index's quantizer, copied to the host before it is freed: the
    centroids and each row's cluster, judged against the rows and then
    defining the IVF answer set."""
    return {"centroids": np.array(index.centroids, dtype=np.float32, copy=True),
            "assign": np.array(index._assign[:n], dtype=np.int64, copy=True)}


def references(cell: spec.Cell, seed: int, pool: torch.Tensor, quantizer: dict,
               device: torch.device, control: bool = False):
    """The corpus made again from the seed, and the reference's answers for
    the whole pool: exact, and IVF at the mix's nprobe."""
    cfg, traffic = cell.config, cell.traffic
    rows = corpus.make_rows(cfg, seed, device)
    nprobe = int(traffic.get("nprobe") or cfg["index"]["nprobe"])
    probes = reference.probe_table(pool, quantizer["centroids"], nprobe)
    assign = torch.from_numpy(quantizer["assign"]).to(device)
    allowed = allowed_rows(cell)
    allow_dev = torch.from_numpy(allowed).to(device) if allowed is not None else None
    refs = reference.topk(rows, pool, int(traffic["k"]), allow=allow_dev,
                          probes=probes, assign=assign)
    ctrl = None
    if control:
        ctrl = reference.topk(rows, pool, int(traffic["k"]), allow=allow_dev,
                              control=True)["exact"]
    return rows, refs, probes, allowed, ctrl


def allowed_rows(cell: spec.Cell) -> Optional[np.ndarray]:
    allow = cell.traffic.get("allow_tags")
    if allow is None:
        return None
    return np.isin(corpus.row_tags(cell.config), np.asarray(allow, dtype=np.int32))


# -- metrics -----------------------------------------------------------------


@dataclass
class ReadContext:
    """What a per-layer reader may read: the traced slice, the cell, for
    each traced call the distinct clusters its batch probes, and the build's
    seconds on the host clock."""

    trace: Trace
    cell: spec.Cell
    probed: List[int]
    build_s: float
    roofline: object = roofline


def probed_per_call(win: Window, probes: torch.Tensor) -> List[int]:
    if win.trace is None:
        return []
    per_batch = probes.view(-1, win.batch, probes.shape[1]).any(dim=1).sum(dim=1).cpu()
    return [int(per_batch[win.batch_of[c]]) for c in win.trace.calls]


def e2e_values(win: Window, judged: Judged, setup_s: float) -> dict:
    done = sum(win.batch for a in win.answers if a is not None)
    return {
        "qps": done / win.seconds,
        "p95_ms": float(np.percentile(np.asarray(win.latency_s), 95) * 1e3),
        "recall_at_10": judged.recall_at_10,
        "setup_s": setup_s,
    }


def device_info(device: torch.device, count: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(out.stdout.split()[device.index or 0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return info


# -- one run -----------------------------------------------------------------


def kernel_cache(step) -> None:
    """``kernels.install`` or ``kernels.keep``; where the program no longer
    offers what they use, it builds its kernels itself as it would."""
    try:
        log(f"kernel cache, {step.__name__}: {step() or 'nothing'}")
    except (ImportError, AttributeError, TypeError, OSError) as exc:
        log(f"kernel cache, {step.__name__}: skipped ({type(exc).__name__}: {exc})")


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float) -> dict:
    """One run of ``cell``; returns the result object (``t0``: the process's
    start on the host clock, where set-up begins)."""
    k = int(cell.traffic["k"])
    setup = build(cell, seed, device)
    call = search_call(setup.index, cell.traffic)
    t_warm = time.perf_counter()
    if device.type == "cuda":
        kernel_cache(kernels.install)
    warm(call, batches_of(setup.pool, int(cell.traffic["batch"])), device)
    if device.type == "cuda":
        kernel_cache(kernels.keep)
    if trace:
        Tracer.prime(device)
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s (warm-up {time.perf_counter() - t_warm:.3f} s); "
        f"window of {seconds} s")
    win = run_window(setup, cell.traffic, seconds, trace, device)
    lat = np.asarray(win.latency_s)
    quarters = [1e3 * float(np.median(q)) for q in np.array_split(lat, 4) if len(q)]
    log(f"window: {len(win.batch_of)} calls in {win.seconds:.3f} s; median ms a call "
        f"by quarter {[round(q, 4) for q in quarters]}")
    dev = device_info(device, cell.chips)
    quantizer = state_of(setup.index, int(cell.config["rows"]))
    pool, build_s = setup.pool, setup.build_s
    del setup, call
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    rows, refs, probes, allowed, _ = references(cell, seed, pool, quantizer, device)
    judged = judge(Answers.of(win, k), refs, rows, pool, allowed, k, quantizer)
    log(f"reference and check in {time.perf_counter() - t_ref:.3f} s")
    for err in sorted(set(win.errors))[:5]:
        log(f"a call raised: {err}")
    result = {"correct": False, "attempted": len(win.batch_of) * win.batch,
              "failed": judged.numbers["failed"]}
    if trace:
        metrics = {}
        if win.trace is not None:
            ctx = ReadContext(win.trace, cell, probed_per_call(win, probes), build_s)
            for m in cell.per_layer:
                value = cell.reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            dev["busy_s"] = win.trace.busy_s()
            dev["window_s"] = win.trace.wall_s
    else:
        # a metric split by the cells that report it (qps.serve, qps.bulk)
        # is the quantity its name starts with
        values = e2e_values(win, judged, setup_s)
        metrics = {m["name"]: {"value": values[m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = dev
    if trace and win.trace is not None:
        result["breakdown"] = win.trace.breakdown()
    checks = {name: {"value": judged.numbers[name], "limit": cell.limits.get(name)}
              for name in CHECKS}
    result["correct"] = all(c["limit"] is not None and c["value"] <= c["limit"]
                            for c in checks.values()) and result["attempted"] > 0
    result["checks"] = checks
    return result


def print_result(result: dict) -> None:
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)


def parse(argv):
    p = argparse.ArgumentParser(prog="python -m perfbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{args.workload} needs {cell.chips} CUDA card(s); {avail} available")
        return 2
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), t0)
    except Exception:  # noqa: BLE001 - the run fails without a result
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        log(f"the run loaded modules it may not: {found}")
        return 3
    print_result(result)
    return 0
